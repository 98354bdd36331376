#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (src/repro_torch).

    python3 chip_smoke.py            # needs one CUDA card, nvcc, the repo

Phases (any failure exits non-zero; no phase catches its own failure):

  1. builds the CUDA kernels from src/repro_torch/csrc (one nvcc per
     source, in parallel) and prints the build seconds;
  2. prints the card's name and power limit (nvidia-smi);
  3. holds each kernel against its plain PyTorch version on CUDA tensors,
     int8 and int4, at the main path's shapes (C = 50 workers, one
     (256, 128) block per CNN5 leaf; the downlink at C = 1) and at one
     large leaf (2^20 elements x C = 50), every wire_agg mode with partial
     and all-lost masks; prints max errors and median CUDA-event times,
     and keeps the large leaf's int4 quant_pack_ef and wire_agg times and
     the int8 dequant_unpack of all 50 workers as rows of their own
     (quant_pack runs each tile over a cluster of 8 CTAs; wire_agg stages
     a strip of rows of all workers by TMA; dequant_unpack is a 2D grid
     whose warps store 512 contiguous bytes an instruction); the int8
     decode's library yardstick is one broadcast multiply (int8 x f32),
     checked bitwise against the plain version and timed from a CUDA
     graph as the kernel is; and the large-leaf int4 wire_agg mean with
     25, the partial mask's and all 50 workers delivered (its time
     follows the delivered count);
  4. checks the engine on a small input: one round on the card against
     the same round on the CPU (plain versions), same data and draws;
  5. drives the main path: `repro_torch.experiments.run` on the
     `low-bandwidth-int4` scenario (C = 50, CNN5 width 8, int4 uplink,
     int8 downlink) for 3 rounds with the launch counts reset just before
     and read just after; every kernel must have launched 10 leaves x 3
     rounds = 30 times; prints each round's delivered count (the workers
     wire_agg does not mask out); then profiles one more round;
  6. the serve slice's kernels against their plain versions on the card:
     flash_attention at the RecurrentGemma-9B prefill shape (B 4, S 4096,
     16 heads over 1 kv head, hd 256, window 2048, bf16), at a ragged
     shape (q_offset > 0, kv_len < Sk, fully masked rows) and in f32,
     each asserting its route (bf16: the tensor-core kernel, counted as
     flash_attention; f32: the CUDA-core kernel, flash_attention_f32);
     rglru_scan (the TMA-fed staged kernel) at (4, 4096, 4096) f32 and
     at the ragged (3, 1000, 1000), (2, 1, 128) and (1, 4097, 4096),
     states and final state; device, eager, plain and library
     (SDPA for flash) times and the bounds, and at the flash main shape
     the CUDA-core kernel the tensor-core one replaces (bf16, same
     inputs; it must be slower) and the f32 path;
  7. a small serve check: reduced recurrentgemma-9b in f32, prompt 96
     (past its window of 64), on the card against the CPU from the same
     params (through the bridge): logits and greedy tokens;
  8. drives the serve path: `repro_torch.launch.serve.serve` on
     recurrentgemma-9b at full width (reduced=False, random weights from
     a seed), batch 4, prompt 4096, gen 32, counts reset just before and
     read just after: each prefill launches flash_attention (the
     tensor-core kernel) 12 times and rglru_scan 26 times, decode
     neither (a warm-up pass and the timed pass: 24 and 52 in all);
     then profiles one more prefill and one decode step;
     then flash_attention at StableLM-3B's head dim 80 (bf16 in the
     tensor-core forward's 80 build: Q.K^T as five k-slices, P.V as an
     n64 and an n16 wgmma over a 16-column tail box): the prefill's shape
     (B 4, S 4096, 32 heads, MHA, causal) in bf16 and f32, each asserting
     its route and timed beside SDPA, and ragged hd-80 and hd-72 cases
     (the tail box past S and past hd); and StableLM-3B served at full width
     the same way (batch 4, prompt 4096, gen 32): each prefill launches
     the hd-80 forward 32 times, decode none (64 in all);
  9. the mesh slice's kernels against their plain versions on the card:
     pso_update (Eq. 8) bitwise in f32 and bf16, clip on and off, at the
     largest SmolLM-360M leaf stacked over W = 2 (2 x 32 x 960 x 2560)
     and at a ragged leaf; the training forward and the flash backward
     against `attention_bwd_ref` and against autograd of `attention_ref`
     at the SmolLM shape (B 2, S 2048, 15 heads over 5, hd 64, causal) in
     bf16 and f32 and at a windowed, ragged GQA shape, each asserting its
     route as in phase 6; device, eager, plain and library times and the
     bounds of the training forward at the SmolLM shape (library: SDPA's
     forward alone) and of the backward (library: SDPA's backward alone
     from one stored forward; SDPA forward + backward beside the kernels'
     forward + backward), each beside the CUDA-core kernels it replaces
     (which must be slower, and the backward also slower than its plain
     version) and the f32 path;
 10. a small mesh check: two M-DSL rounds of reduced smollm-360m in f32
     (W = 2) on the card against the same rounds on the CPU, same
     params, batches and draws;
 11. drives the mesh training path: `repro_torch.experiments.run` on
     `mesh/smollm-smoke` at full width (reduced=False, seq_len 2048, W
     2, B 2, bf16, random weights from a seed) for 3 rounds, counts
     reset just before and read just after: per round flash_attention
     launches 32 layers x (2 workers x 2 (forward, remat recompute) + 3
     evaluations) = 224 times, its backward 32 x 2 = 64 times and
     pso_update once per leaf, 11 times, and the CUDA-core flash kernels
     (the _f32 counters) never; then profiles one more round; then the
     training forward and the backward at StableLM-3B's hd 80 (B 2, S
     2048, 32 heads, MHA, causal; bf16 in the tensor cores' 80 build) and
     at RecurrentGemma-9B's hd 256 (B 2, S 2048, 16 heads over 1, window
     2048; bf16 in the tensor cores' 256 build, no path runs it yet),
     bf16 and f32, and ragged hd-80, hd-72 and hd-256 GQA cases (the
     hd-80 build's tail box past S and past hd), as the other backward
     cases, each asserting its build, the bf16 backward timed beside
     SDPA's backward alone (and at hd 256 beside the CUDA-core kernels
     it replaces); and one M-DSL round of
     StableLM-3B at full width with the depth cut to 2 layers (W 2, B 1,
     S 2048, bf16; after a warm-up round) through `Transformer.loss`:
     launches as phase 11's per layer, losses finite;
 12. the straggler engine on a small input: `straggler/deadline-tight`
     cut to C = 4, width 2, 3 rounds, fading off, quorum 3 and a deadline
     between two workers' airtimes (round 0 has late uploads and holds,
     round 1 drains them), through `run_prepared` on the card against
     the same rounds on the CPU with the same data, init and draws:
     selected, delivered, late, drained, buffered and held equal, the
     global params within the small mesh rounds' f32 rule (the dense
     f32 wire quantizes nothing), and the held rounds' global params
     bitwise unchanged on the card;
 13. drives the straggler path: `straggler/deadline-tight` as registered
     (C = 50, CNN5 w8, the dense f32 wire) for 3 rounds, then with the
     int4 uplink and int8 downlink, counts reset just before and read
     just after each; prints each round's late, drained, buffered, held
     and accuracy; asserts a late upload in the registered run, and in
     the int4 run quant_pack and dequant_unpack 2 x 10 leaves x 3 rounds
     = 60 times each, 30 at C = 50 (the uplink) and 30 at C = 1 (the
     downlink), as the wrappers count them by worker count, and
     the fused kernels never (phase 3 holds quant_pack and
     dequant_unpack at int4 C = 50 and times them);
 14. `faults/churn` as registered (K = 16, w2, 10 rounds): transmitted
     and held a round; transmitted <= selected in every round and < in
     some;
 15. `fleet/million-score` as registered (P = 10^6, K = 16, AWGN,
     Rayleigh) and `fleet/million-uniform` with the int4 uplink and int8
     downlink, 5 rounds each: the table's bytes (36 x 10^6), each round's
     cohort churn (slots reseated); in the int4 run quant_pack_ef,
     wire_agg, quant_pack and dequant_unpack once a leaf a round;
 16. SmolLM-360M at full width (phase 11's spec) with a deadline between
     the two workers' airtimes (pathloss 0 and 6 dB; worker 1 late
     whenever selected), 3 rounds: seconds a round, peak memory, losses,
     late and drained (late in round 1, drained later), and phase 11's
     launch counts every round;
 17. the obs path: `low-bandwidth-int4` as in phase 5 with
     `run.obs.enabled`, the CSV mirror and a profiler window over round
     2, counts reset just before and read just after: the stream, read
     back with the port's `read_events`, has round rows equal to the
     record's bit for bit, stage spans (phase host) covering LocalUpdate,
     ScoreSelect, Uplink, Aggregate, Downlink, BestTracking, Step and
     Eval with each round's stages summing to no more than its Step,
     KernelEvents naming the four wire kernels with backend cuda and
     interpret false, and a run_end carrying final_acc; each wire kernel
     launches 30 times, as in phase 5; the Chrome trace holds the stage
     and "round" ranges and round 2's device launches (quant_pack_kernel
     20, dequant_kernel 10, wire_agg_kernel 10); prints each round's time
     beside phase 5's (obs off) and its per-stage host times, then the
     steady rounds of four more runs, obs off and on in turns;
 18. mesh checkpoints: `mesh/smollm-smoke` at full width (phase 11's
     spec) for 2 rounds with `run.ckpt_dir` and obs on: ckpt_steps [0,
     1], phase 11's launches a round, the latest checkpoint restored into
     a template of the live params on the card bitwise equal to them;
     prints the checkpoint's size, one more save's time (device to host,
     savez, rename) and the restore's, and removes the directory;
 19. F2, one record per seed: `low-bandwidth-int4` at full width (3
     rounds) twice more and the int4 `straggler/deadline-tight` run
     twice, bit for bit equal in every recorded loss, accuracy and count
     (the first also with phase 5's record); round times beside phase
     5's;
 20. the sweep: `python -m repro_torch.launch.train --sweep
     paper/fig3-iid,paper/fig3-noniid1,paper/fig3-noniid2 --sweep-axis
     algo.algorithm=fedavg,dsl,multi_dsl,mdsl --jobs 2 --set
     run.rounds=3` (12 cells at full width, C = 50, CNN5 w8, over 2
     spawned processes on the card); three cells' records equal, bit
     for bit apart from the round times, the same cells run with jobs = 1
     in this process, with the same launches; each cell's wall time and
     launches (the child's own) and the grid's wall time;
 21. per-step Eq. 8: `low-bandwidth-int4` with `algo.pso_every_step=true`
     at full width for 2 rounds, counts reset just before and read just
     after: pso_update launches (512 / 64) x 4 steps x 10 leaves = 320
     times a round, the wire kernels 10 times a round each; one step's
     kernel route (`core/pso.pso_step`) against the plain per-step
     formula on the same stacked leaves, bitwise in f32, and pso_update
     timed at the largest of them (device, eager, plain, bound), its
     launches cycling through 4 copies of the inputs so that the 50 MB
     L2 cannot hold them from one launch to the next;
 22. the figure drivers through their CLIs: `fig3_accuracy --quick --jobs
     2`, `fig1_metric --quick`, `comm_efficiency --quick --json` and
     `population_bench --quick --json` (P up to 10^6); each record has
     the reference's keys (the --json ones those of the root
     BENCH_stragglers.json and BENCH_population.json); headline rows and
     wall times, and the seconds of phases 19-22;
 23. the scan's backward (csrc/rglru_scan_bwd.cu) against its plain
     version on the card, dh0, da and db bitwise at RecurrentGemma-9B's
     training shape (2, 2048, 4096) and at the ragged (3, 1000, 1000),
     (2, 1, 128) and (1, 4097, 4096); at the training shape and (3, 1000,
     1000) also against autograd of `rglru_scan_ref` within 2 f32 ulps an
     element; device (CUDA graph), eager and plain times and the bound
     (20 bytes an element) at the training shape, and the forward's
     there (library: none for either);
 24. a small training check: two M-DSL rounds of reduced
     recurrentgemma-9b (rglru, rglru, swa) in f32 (W = 2) on the card
     against the same rounds on the CPU, as phase 10 (its tolerances);
     rglru_scan 2 x 14, rglru_scan_bwd 2 x 4 and the CUDA-core flash
     kernels 2 x 7 and 2 x 2 (hd 32 in f32), pso_update once a leaf a
     round;
 25. RecurrentGemma-9B training at full width, the depth cut to one
     (rglru, rglru, swa) group (1,705,070,592 params), W 1, B 2, S 2048,
     bf16, through `Transformer.loss` under the mesh engine as phase 11's
     StableLM-3B round: a warm-up round and a timed round; per round
     rglru_scan 2 x (2 + 2) = 8, rglru_scan_bwd 2, flash_attention 4 and
     flash_attention_bwd 1 (the hd-256 builds; the backward's first
     path), pso_update once a leaf, the _f32 counters never; losses and
     global params finite; seconds a round and peak memory (one worker:
     at W 2 the engine's per-worker state of the 1.71 B params, f32
     error-feedback residuals included, ran out of the 80 GB card);
 26. a small xLSTM serve check: reduced xlstm-350m (mlstm, slstm) in f32,
     prompt 300 (past one mLSTM chunk of 256), on the card against the
     CPU from the same params: logits within 5e-4, greedy tokens equal,
     no kernel launched;
 27. xLSTM-350M served at full width through `launch.serve.serve`
     (batch 4, prompt 4096, gen 32, bf16, random weights): no kernel
     launches; prefill and decode tok/s, peak memory, and one sLSTM
     layer's prefill alone (host ms, a time step's us, its share of the
     prefill over the 3 sLSTM layers);
 28. `mesh/xlstm-smoke` at full width through `experiments.run`
     (reduced=false, seq_len 2048, W 2, B 2, bf16) for 2 rounds: losses
     and global params finite, pso_update once a leaf a round and no
     other launch; seconds a round and peak memory;
 29. the forward at this slice's shapes against its plain version on the
     card, each asserting its route (the tensor-core forward): Qwen3-MoE's
     prefill (B 4, S 4096, 32 heads over 4, hd 128, causal; the 128
     build), SeamlessM4T's encoder (B 4, S 4096, 16 heads, MHA, hd 64, no
     mask), its cross decode (one query over 4096 frames, no mask) and
     ragged GQA cases with 7 query heads a kv head (non-causal with Sq !=
     Sk and kv_len < Sk; causal with a query offset); device, eager,
     plain and library (SDPA) times and the bounds of the first three;
     the training forward and the backward at Qwen3's training shape (B
     2, S 2048, 32 over 4, hd 128, causal; the 128 build) and at a ragged
     non-causal GQA shape, against the plain versions and autograd, the
     former timed beside SDPA's backward alone;
 30. small MoE serves: reduced qwen3-moe-30b-a3b and arctic-480b in f32,
     at capacity factor 1.25 (decode drops picks) and dropless, on the
     card against the CPU from the same params: logits, greedy tokens;
 31. Qwen3-MoE-30B-A3B served at full width and depth (48 layers,
     30,220,746,752 params in the reference's count, random bf16 weights
     from a seed) through `launch.serve.serve`, batch 4, prompt 4096, gen
     32, counts reset just before and read just after: each prefill
     launches the hd-128 forward 48 times, decode none; prefill and
     decode tok/s and peak memory; then one more prefill profiled: GEMMs
     (the experts' bmm included), flash, MoE's sort/scatter/gather and
     the rest;
 32. Arctic-480B at full width with the depth cut to 2 layers (one card
     holds two of its 27.2 GB layers), served the same way through the
     serve module's `generate`: the forward twice a prefill;
 33. small encoder-decoder and prefix serves: reduced
     seamless-m4t-large-v2 (frames encoded into the cache) and
     llava-next-34b (a prefix before the prompt) in f32, card against
     CPU, as phase 30;
 34. SeamlessM4T-large-v2 served at full width and depth (frames (4,
     4096, 1024), prompt 4096, gen 32): per prefill 24 non-causal encoder,
     24 causal self- and 24 non-causal cross-attention forwards (the
     encoder and the cross K/V are in the timed prefill), per decode step
     the 24 cross forwards (Sq 1 over the memory, through the kernel);
 35. LLaVA-NeXT-34B served at full width and depth (a 2880-token prefix
     and prompt 4096, gen 32, batch 4; 67.9 GB of weights): the forward
     once a layer a prefill;
 36. Qwen3-MoE training at full width with the depth cut to 2 layers
     (W 1, B 2, S 2048, bf16) through `Transformer.loss` (its aux loss
     included) under the mesh engine, as phase 25: per round the hd-128
     forward 2 x 4 and backward 2 x 1, pso_update once a leaf, the _f32
     counters never; losses, global params and the aux finite, the aux
     > 0; seconds a round and peak memory;
 37. the sharded mesh path (`launch/steps`, `sharding/*`, DTensor over
     a one-rank NCCL group's 1 x 1 ("data", "model") mesh):
     `build_step` for one M-DSL round of SmolLM-360M at full width (bf16,
     one worker, B 2, S 2048), every leaf placed as a DTensor whose shard
     is the tensor itself: the round's state and telemetry bitwise the
     one-process `swarm_dist` round's on the same state and draws; its
     launches as `mesh_launches_per_round` at W 1; s a round, peak;
 38. `build_serve_step` prefill and decode of Qwen3-MoE-30B-A3B at full
     width and depth on phase 31's weights (placed with no copy; run
     right after phase 31, whose weights the card holds then): greedy
     tokens equal to `launch.serve.generate`'s on the same prompts, the
     forward once a layer in the prefill, a peak within 1 GiB of phase
     31's; prefill s, decode tok/s;
 39. one Qwen3-MoE layer at full width (128 experts top 8, d 2048, bf16,
     tokens (4, 4096)) through `moe_ep`'s stages for 4 virtual shards:
     dropless within 2 bf16 ulps of the dense dispatch, the aux within
     1e-5; at the config's capacity factor both paths' drops printed;
 40. the dry-run (`launch/dryrun`, `op_costmodel`): each kernel
     operator's shape rule (its fake implementation) against a real
     launch at its main-path shape (shapes, dtypes, strides; no launch
     counted); the dispatcher's host cost a call (pso_update through its
     operator against its CUDA implementation called straight); phase
     37's step dry-run on fake tensors against the real
     round under the same cost model (FLOPs equal, the predicted peak of
     live bytes within 10% of the allocator's peak for the round), its
     breakdown printed; three production-mesh dry-runs as subprocesses
     started before phase 37 at the lowest priority
     (`python -m repro_torch.launch.dryrun`: SmolLM-360M and
     Qwen3-MoE-30B-A3B train_4k on the 256-rank mesh, RecurrentGemma-9B
     decode_32k on the 512-rank one), each record's per-rank peak
     against the card's memory and its dominant term;
 42. the worker-batched convolution (`worker_conv`, CNN5's three
     convolutions for all C workers a launch) at C 200: the forward at a
     training step's 64 images and the scoring's 2,048 (conv1's images
     shared), the input gradients of conv2 and conv3 and the three weight
     gradients, each held in f64 to the plain versions (the vmapped
     F.conv2d and its autograd) within the f32 bound of its sum chains,
     the weight gradient bitwise over two calls, timed beside cuDNN's
     grouped convolution called once (library); its launches on the main
     path are held to 3 forwards, 2 input gradients and 3 weight
     gradients a step, 3 forwards a scoring pass, 6 a round at C 1 (the
     global loss and the test accuracy); run before phase 41's line;
 41. prints the card line, the `kernels` JSON line (each row with its
     share of bound = bound_ms / ms; each kernel's first row with its
     launches in the int4 straggler run, the int4 population run, the
     mesh straggler run, the obs run, the mesh checkpoint run, the
     sweep's cells (phase 20), the per-step Eq.-8 run, phase 25's
     training rounds, phase 28's xLSTM rounds, phases 31-36's runs and
     phases 37-38's;
     each flash row with its cores,
     the CUDA-core kernel's and the f32 path's times; a row of the
     forward at the mesh shape, rows of quant_pack_ef, wire_agg and
     dequant_unpack at the large leaf, of quant_pack and dequant_unpack
     at the straggler uplink's int4 C = 50, of the forward and backward
     at hd 80, of the backward at hd 256 (its launches in phase 25), of
     pso_update at the per-step Eq. 8's CNN5 leaf, of rglru_scan at the
     training shape, of rglru_scan_bwd, of the forward at hd 128 (Qwen3),
     non-causal (SeamlessM4T's encoder) and at the cross decode, and of
     the backward at hd 128, and phase 42's worker_conv rows) and,
     last, the ok line.

Tolerances: payloads, scales, decodes and the wire_agg median bitwise;
the obs stream's round rows and the restored checkpoint bitwise;
the error-feedback residual within 1 ulp of |acc| (fmaf in the kernel,
one rounding from f64 in the plain version); wire_agg mean, sum and
trimmed mean within 2^-21 * sum|terms| (both sum in the same order, so
this is expected to be 0). flash_attention in bf16 within 2 bf16 ulps of
the plain output (the ulp taken at no less than 2^-16 of the largest
output), in f32 within 1e-5 of the largest output; rglru_scan bitwise,
states and final state, at every scan shape;
the small serve's logits within 5e-4 (as the CPU parity tests) and its
greedy tokens equal. pso_update bitwise. The flash backward: in f32
within 1e-5 of the largest |gradient| against both references; in bf16
within 2 bf16 ulps of `attention_bwd_ref` (the ulp taken at no less than
2^-12 of the largest gradient), and within 4 bf16 ulps of the largest
|gradient| against autograd of `attention_ref` (which forms
rowsum(dO * O) from the f32 output, the kernel from the bf16 one). The
small mesh rounds: losses within 5e-6, params and velocities within
2e-7, masks equal (as the CPU parity tests). The repeated paper runs
(phase 19), the sweep's cells against their jobs = 1 runs (phase 20) and
the per-step Eq. 8 (phase 21): bitwise. The scan's backward: bitwise
against its plain version, within 2 f32 ulps an element against
autograd of the plain loop (expected 0: the same rounded products and
sums; the ulps leave room for autograd adding a step's two gradient
terms in the other order, which is exact for two terms). The small
training check (phase 24): phase 10's. The small xLSTM serve (phase 26)
and the small MoE, encoder-decoder and prefix serves (phases 30 and 33):
logits within 5e-4, greedy tokens equal. Phase 29's flash cases: phases
6 and 9's rules. Phase 42's convolutions: within (n + 1) 2^-24 of the
sum of |terms| of the f64 plain version, n each kernel's longest f32 sum
chain (recursive summation's bound); the weight gradient bitwise over
two calls. Every timing line of phases 13-28 and 31-39 carries the card's
name and power limit.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
SUM_RTOL = 2.0 ** -21
ROUNDS, LEAVES = 3, 10
MAIN_BITS = {"quant_pack_ef": 4, "wire_agg": 4, "quant_pack": 8,
             "dequant_unpack": 8}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def time_ms(fn, reps: int) -> float:
    """Median over `reps` calls, each between two CUDA events: the time
    one eager call holds the device's queue, host launch gap included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int) -> float:
    """Device time per launch: `reps` launches captured in one CUDA graph,
    replayed between two CUDA events — no host launch gap in between."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cost(op, *args) -> tuple[int, int]:
    """(bytes, operations) of one call of a kernel operator: its one
    definition (`runtime.op_cost`), which the dry-run's cost model also
    reads."""
    from repro_torch.kernels import runtime
    ops, nbytes = runtime.op_cost(op, *args)
    return nbytes, ops


def kernel_bound(op, *args, ops_per_s: float = F32_OPS_PER_S
                 ) -> tuple[float, str]:
    return bound_ms(*cost(op, *args), ops_per_s)


def flash_masks(q, k, kw) -> tuple:
    """The flash operators' (causal, window, q_offset, kv_len) for the
    wrapper's keywords kw."""
    from repro_torch.kernels.flash_attention import ops as fops
    *_, q_offset, kv_len = fops._shapes(q, k, kw.get("q_offset"),
                                        kw.get("kv_len"))
    return (kw.get("causal", True), kw.get("window", 0), q_offset, kv_len)


# words in the names of the cuBLAS/CUTLASS GEMM kernels (a profile's
# GEMM share)
GEMM_WORDS = ("gemm", "gemv", "xmma", "cutlass", "sm90_", "nvjet")


def dev_us(e):
    """A profiler row's own device time, in µs (the field's name moved
    across torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_rows(prof) -> list:
    """A profile's device-side rows (kernels, copies, fills), largest own
    device time first. The host ops' rows repeat the device time of the
    kernels they launched, and every `record_function` range (the
    program's spans) also appears on the device timeline as an
    annotation spanning its kernels: the rows of every range the profile
    holds are left out, so no device time counts twice."""
    avg = prof.key_averages()
    spans = {e.key for e in avg if getattr(e, "is_user_annotation", False)}
    return sorted((e for e in avg
                   if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
                   and e.key not in spans), key=dev_us, reverse=True)


def ulp(x):
    import torch
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def kernel_checks(dev):
    """Phase 3. Returns {kernel: {max_abs_err, ms, plain_ms, bound_ms,
    bound_by}} at the main path's shapes, and the same at the large leaf
    (C = 50, rows 8192) for quant_pack_ef and wire_agg (int4) and for
    dequant_unpack over all 50 workers (int8, the dense route's decode)."""
    import torch
    from repro_torch.kernels.quant_pack import ops as qops
    from repro_torch.kernels.quant_pack import ref as qref
    from repro_torch.kernels.wire_agg import ops as wops
    from repro_torch.kernels.wire_agg import ref as wref

    g = torch.Generator(device=dev).manual_seed(0)
    out = {k: {"max_abs_err": 0.0} for k in
           ("quant_pack_ef", "wire_agg", "quant_pack", "dequant_unpack")}
    large = {k: {} for k in ("quant_pack_ef", "wire_agg", "dequant_unpack")}
    # the straggler route's dense int4 uplink: quant_pack and
    # dequant_unpack over all C = 50 workers, one block per leaf
    dense50 = {k: {} for k in ("quant_pack", "dequant_unpack")}

    def err(name, got, want):
        e = float((got.float() - want.float()).abs().max())
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
        return e

    def seeds(C):
        return torch.randint(0, 2**31 - 1, (C,), generator=g, device=dev,
                             dtype=torch.int32)

    shapes = {"main": 256, "large": 8192}        # rows per worker leaf
    for bits in (8, 4):
        for label, rows in shapes.items():
            C = 50
            x = 0.01 * torch.randn((C, rows, 128), generator=g, device=dev)
            r = 0.001 * torch.randn((C, rows, 128), generator=g, device=dev)
            x[0, :256] = 0.0
            x[1, :256], r[1, :256] = 0.0, 0.0      # all-zero block
            s = seeds(C)
            # quant_pack_ef
            kp, ks, kr = qops.quant_pack_ef_2d(x, r, s, bits=bits)
            pp, ps, pr = qref.quant_pack_ef_ref(x, r, s, bits=bits)
            torch.cuda.synchronize()
            check(torch.equal(kp, pp), f"quant_pack_ef payload bits={bits} "
                                       f"{label}")
            check(torch.equal(ks, ps), f"quant_pack_ef scales bits={bits}")
            e = max(err("quant_pack_ef", ks, ps), err("quant_pack_ef", kr, pr))
            check(bool(((kr - pr).abs() <= ulp(x + r)).all()),
                  f"quant_pack_ef residual > 1 ulp (max {e}) bits={bits}")
            if label == "large" and bits == 4:
                large["quant_pack_ef"]["max_abs_err"] = e
            # quant_pack (downlink: C = 1 on the main path)
            for Cq in ((1, C) if label == "main" else (C,)):
                xq, sq = x[:Cq].contiguous(), s[:Cq].contiguous()
                kq, kqs = qops.quant_pack_2d(xq, sq, bits=bits)
                pq, pqs = qref.quant_pack_ref(xq, sq, bits=bits)
                torch.cuda.synchronize()
                check(torch.equal(kq, pq) and torch.equal(kqs, pqs),
                      f"quant_pack bits={bits} C={Cq} {label}")
                e = err("quant_pack", kqs, pqs)
                if Cq == C and bits == 4:
                    dense50["quant_pack"]["max_abs_err"] = e
                # dequant_unpack
                kd = qops.dequant_unpack_2d(pq, pqs, bits=bits)
                pd = qref.dequant_unpack_ref(pq, pqs, bits=bits)
                torch.cuda.synchronize()
                check(torch.equal(kd, pd), f"dequant_unpack bits={bits} "
                                           f"C={Cq} {label}")
                e = err("dequant_unpack", kd, pd)
                if label == "large" and bits == 8:
                    large["dequant_unpack"]["max_abs_err"] = e
                if Cq == C and bits == 4 and label == "main":
                    dense50["dequant_unpack"]["max_abs_err"] = e
            # wire_agg: every mode, partial / all-lost masks, weights
            d = qref.dequant_unpack_ref(pp, ps, bits=bits)
            part = (torch.rand(C, generator=g, device=dev) > 0.3).float()
            w = torch.rand(C, generator=g, device=dev) + 0.5
            for mask_name, mask, wts in (
                    ("partial", part, torch.ones(C, device=dev)),
                    ("weighted", part, w),
                    ("all-lost", torch.zeros(C, device=dev), w)):
                for agg in ("mean", "sum", "median", "trimmed_mean"):
                    ka = wops.wire_agg_2d(pp, ps, mask, wts, bits=bits,
                                          aggregator=agg, trim_ratio=0.2)
                    pa = wref.wire_agg_ref(pp, ps, mask, wts, bits=bits,
                                           aggregator=agg, trim_ratio=0.2)
                    torch.cuda.synchronize()
                    e = err("wire_agg", ka, pa)
                    if agg == "median" or mask_name == "all-lost":
                        ok = torch.equal(ka, pa)
                    else:
                        tol = SUM_RTOL * (d.abs() * wts.reshape(C, 1, 1)
                                          ).sum(0)
                        ok = bool(((ka - pa).abs() <= tol).all())
                    check(ok, f"wire_agg {agg} {mask_name} bits={bits} "
                              f"{label}: max err {e}")
                    if label == "large" and bits == 4:
                        large["wire_agg"]["max_abs_err"] = max(
                            large["wire_agg"].get("max_abs_err", 0.0), e)
            print(f"[check] bits={bits} {label} (C=50, rows={rows}): "
                  f"all four kernels match their plain versions", flush=True)

            # timings: device time per launch (CUDA graph replay), one
            # eager call (host launch gap included), the plain version
            n, nb = C * rows * 128, rows // 256
            pbytes = n if bits == 8 else n // 2
            x1, s1 = x[:1].contiguous(), s[:1].contiguous()
            n1 = rows * 128
            pb1 = n1 if bits == 8 else n1 // 2
            q1, q1s = qref.quant_pack_ref(x1, s1, bits=bits)
            one = torch.ones(C, device=dev)
            # the library yardstick (timed here, used nowhere in the port):
            # the int8 decode is one broadcast multiply, int8 x f32 -> f32
            def lib_dequant(p, sc):
                return lambda: p.view(p.shape[0], -1, 256, 128) * \
                    sc[:, :, None, None]
            # name: (kernel call, plain call, workers, bytes moved, ops,
            # library call or None)
            cases = {
                "quant_pack_ef": (
                    lambda: qops.quant_pack_ef_2d(x, r, s, bits=bits),
                    lambda: qref.quant_pack_ef_ref(x, r, s, bits=bits), C,
                    *cost(qops.QUANT_PACK_EF, x, r, s, bits), None),
                "wire_agg": (
                    lambda: wops.wire_agg_2d(pp, ps, part, one, bits=bits),
                    lambda: wref.wire_agg_ref(pp, ps, part, one, bits=bits),
                    C, *cost(wops.WIRE_AGG, pp, ps, part, one, bits, "mean",
                             0.1), None),
                "quant_pack": (
                    lambda: qops.quant_pack_2d(x1, s1, bits=bits),
                    lambda: qref.quant_pack_ref(x1, s1, bits=bits), 1,
                    *cost(qops.QUANT_PACK, x1, s1, bits), None),
                # the straggler route's dense uplink of all C workers
                "quant_pack C=50": (
                    lambda: qops.quant_pack_2d(x, s, bits=bits),
                    lambda: qref.quant_pack_ref(x, s, bits=bits), C,
                    *cost(qops.QUANT_PACK, x, s, bits), None),
                "dequant_unpack": (
                    lambda: qops.dequant_unpack_2d(q1, q1s, bits=bits),
                    lambda: qref.dequant_unpack_ref(q1, q1s, bits=bits), 1,
                    *cost(qops.DEQUANT_UNPACK, q1, q1s, bits),
                    lib_dequant(q1, q1s) if bits == 8 else None),
                # the dense route's decode of all C stacked workers
                "dequant_unpack C=50": (
                    lambda: qops.dequant_unpack_2d(pp, ps, bits=bits),
                    lambda: qref.dequant_unpack_ref(pp, ps, bits=bits), C,
                    *cost(qops.DEQUANT_UNPACK, pp, ps, bits),
                    lib_dequant(pp, ps) if bits == 8 else None),
            }
            for name, (kern, plain, workers, nbytes, ops,
                       library) in cases.items():
                t = {"ms": graph_ms(kern, 20), "eager_ms": time_ms(kern, 50),
                     "plain_ms": time_ms(plain, 5), "library_ms": None}
                if library is not None:
                    lo = library()
                    torch.cuda.synchronize()
                    check(torch.equal(lo.reshape(plain().shape), plain()),
                          f"{name} bits={bits} {label}: the library call "
                          f"is not bitwise the plain version")
                    t["library_ms"] = graph_ms(library, 20)
                    del lo
                bnd, by = bound_ms(nbytes, ops)
                kept = (f" ({int(part.sum())} delivered)"
                        if name == "wire_agg" else "")
                print(f"[time] {name} bits={bits} {label} C={workers}{kept} "
                      f"rows={rows}: device {t['ms']:.5f} ms/launch, eager "
                      f"call {t['eager_ms']:.4f} ms, plain "
                      f"{t['plain_ms']:.4f} ms, library "
                      + ("none" if library is None else
                         f"{t['library_ms']:.5f} ms/launch (broadcast "
                         f"multiply)")
                      + f", bound {bnd:.3g} ms ({by}, {nbytes} B)",
                      flush=True)
                # the main path: int4 uplink + aggregate at C = 50, int8
                # downlink at C = 1, one block per leaf
                if label == "main" and bits == MAIN_BITS.get(name):
                    out[name].update(t, bound_ms=bnd, bound_by=by)
                # the large leaf: int4 uplink and aggregate, the int8
                # decode of all C workers
                key = name.split()[0]
                if label == "large" and (
                        (bits == 4 and name in ("quant_pack_ef", "wire_agg"))
                        or (bits == 8 and name == "dequant_unpack C=50")):
                    large[key].update(t, bound_ms=bnd, bound_by=by)
                if label == "main" and bits == 4 and name.endswith("C=50"):
                    dense50[key].update(t, bound_ms=bnd, bound_by=by)
            if label == "large" and bits == 4:
                # wire_agg skips the workers it masks out, so its time
                # follows the delivered count: the first k of C delivered
                by_k = {}
                for k in (C // 2, int(part.sum()), C):
                    mk = (torch.arange(C, device=dev) < k).float()
                    ka = wops.wire_agg_2d(pp, ps, mk, one, bits=bits)
                    pa = wref.wire_agg_ref(pp, ps, mk, one, bits=bits)
                    torch.cuda.synchronize()
                    check(bool(((ka - pa).abs() <= SUM_RTOL * d.abs().sum(0)
                                ).all()),
                          f"wire_agg mean, {k} delivered, large leaf")
                    by_k[k] = graph_ms(lambda: wops.wire_agg_2d(
                        pp, ps, mk, one, bits=bits), 20)
                large["wire_agg"]["ms_by_delivered"] = by_k
                print("[time] wire_agg bits=4 large C=50 rows=8192 by "
                      "delivered count: " + ", ".join(
                          f"{k}: {v:.5f} ms/launch" for k, v in by_k.items()),
                      flush=True)
    print("[check] max abs err vs plain (all shapes, both widths): " +
          ", ".join(f"{k} {v['max_abs_err']:.3g}" for k, v in out.items()),
          flush=True)
    return out, large, dense50


def small_round_check(dev):
    """Phase 4: one small round on the card (kernels) against the same
    round on the CPU (plain versions), same data, init and draws."""
    import torch
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.experiments import build, get_scenario, override
    from repro_torch.pytree import tree_leaves, tree_map

    spec = override(get_scenario("low-bandwidth-int4"), "data.num_workers=4",
                    "model.width_mult=2", "data.n_local=64",
                    "algo.local_epochs=1", "run.rounds=1")
    cpu = build(spec, device="cpu")
    data = tree_map(lambda t: t.cpu().numpy(), tuple(cpu.aux["data"]))
    gpu = build(spec, device=dev,
                data=type(cpu.aux["data"])(*data),
                init_params=tree_to_numpy(cpu.state.global_params))
    draws = cpu.draw(cpu.state)
    gdraws = type(draws)(*[None if v is None else
                           (tree_map(lambda t: t.to(dev), v))
                           for v in draws])
    cs, ctel = cpu.step(cpu.state, draws)
    gs, gtel = gpu.step(gpu.state, gdraws)
    check(torch.equal(ctel.mask, gtel.mask.cpu()), "small round: masks")
    # one int4 uplink level of the largest worker move over the delivered
    # count, plus one int8 downlink level of the global move: a 1e-7
    # difference from the convolutions can flip one stochastic rounding
    delivered = max(float(ctel.delivered), 1.0)
    worst, diffs = 0.0, []
    for c, gl, c0, w1, w0 in zip(tree_leaves(cs.global_params),
                                 tree_leaves(gs.global_params),
                                 tree_leaves(cpu.state.global_params),
                                 tree_leaves(cs.workers.params),
                                 tree_leaves(cpu.state.workers.params)):
        diff = (gl.cpu() - c).abs()
        tol = (float((w1 - w0).abs().max()) / 7.0 / delivered
               + float((c - c0).abs().max()) / 127.0 + 1e-5)
        worst = max(worst, float(diff.max()) / tol)
        diffs.append(diff.reshape(-1))
    mean = float(torch.cat(diffs).mean())
    check(worst <= 1.0 and mean <= 1e-5,
          f"small round: card vs CPU global params off (worst/tol "
          f"{worst:.3f}, mean {mean:.2e})")
    print(f"[small] one round C=4 w2 card vs CPU: masks equal, global "
          f"params mean |diff| {mean:.3e}, worst/tol {worst:.3f}",
          flush=True)


def profile_round(spec) -> None:
    """One more round of the main path under torch.profiler, after the
    counted run: the device's busy share of the round and its device
    time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiments import build

    prep = build(spec)
    state, _ = prep.step(prep.state, prep.draw(prep.state))    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = prep.step(state, prep.draw(state))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    names = ("LocalUpdate", "ScoreSelect", "Uplink", "Aggregate",
             "Downlink", "BestTracking")
    rows = device_rows(prof)
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    ours = sum(dev_us(e) for e in rows
               if e.key.startswith(("void (anonymous namespace)::quant_pack",
                                    "void (anonymous namespace)::dequant",
                                    "void (anonymous namespace)::wire_agg",
                                    "quant_pack", "dequant", "wire_agg"))) / 1e3
    print(f"[profile] one round: wall {wall_ms:.2f} ms (profiler on), device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"wire kernels {ours:.3f} ms, {sum(e.count for e in rows)} device "
          f"ops of {len(rows)} kinds", flush=True)
    # the host-side range of each stage: its wall time on the host and
    # the device time of the kernels it launched
    stages = {e.key: e for e in prof.key_averages()
              if e.key in names and str(e.device_type).endswith("CPU")}
    print("[profile] stages (host ms / device ms of its kernels): " + ", ".join(
        f"{k} {stages[k].cpu_time_total / 1e3:.2f}/"
        f"{getattr(stages[k], 'device_time_total', 0.0) / 1e3:.2f}"
        for k in names if k in stages), flush=True)
    for e in rows[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)


# -- the serve slice: flash attention and the RG-LRU scan -----------------

SERVE_ARCH = "recurrentgemma-9b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
# RecurrentGemma-9B: 12 groups of (RGLRU, RGLRU, SWA) + 2 RGLRU layers
PREFILL_LAUNCHES = {"flash_attention": 12, "rglru_scan": 26}
# flash: (label, B, Sq, Sk, H, K, hd, dtype, causal, window, q_offset,
# kv_len); the first is the main path's shape (one SWA prefill layer)
FLASH_CASES = [
    ("main", 4, 4096, 4096, 16, 1, 256, "bfloat16", True, 2048, None, None),
    # ragged, suffix-aligned, kv_len < Sk: rows at q_pos >= 927 see no key
    ("ragged", 2, 300, 1000, 6, 2, 128, "bfloat16", True, 128, 700, 800),
    ("f32", 2, 777, 777, 4, 4, 64, "float32", True, 100, None, None),
]
# (B, S, D): the main prefill's shape first, then ragged ones (S not a
# multiple of the stage rows, D not one of the channel tile; one step)
SCAN_SHAPES = [(4, 4096, 4096), (3, 1000, 1000), (2, 1, 128),
               (1, 4097, 4096)]
F32_RTOL = 1e-5
SERVE_LOGIT_TOL = 5e-4


def bf16_ulp(x):
    """The spacing of bf16 at |x| (x given in f32)."""
    import torch
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def flash_out_check(label, got, want):
    """The forward kernel's output against the plain one: in bf16 within
    2 bf16 ulps of the plain output, the ulp taken at no less than 2^-16
    of the largest output (the f32 sums' own error scale); in f32 within
    F32_RTOL of the largest output. Returns (max abs err, max |out|,
    the rule)."""
    import torch
    diff = (got.float() - want.float()).abs()
    amax = float(want.float().abs().max())
    if got.dtype == torch.bfloat16:
        floor = torch.full_like(diff, 2.0 ** -16 * amax)
        tol = 2 * bf16_ulp(torch.maximum(want.float().abs(), floor))
        ok = bool((diff <= tol).all())
        rule = "2 bf16 ulps"
    else:
        ok = float(diff.max()) <= F32_RTOL * amax
        rule = f"{F32_RTOL:g} x max|out|"
    err = float(diff.max())
    check(ok, f"flash_attention {label}: max abs err {err} exceeds {rule}")
    return err, amax, rule


def flash_route(dtype: str, hd: int, bwd: bool = False) -> str:
    """The counter a flash launch adds to: the tensor-core kernels take
    bf16 at hd 33 to 256 (hd % 8 == 0), forward and backward; the
    CUDA-core ones f32 and bf16 at hd <= 32."""
    tc = dtype == "bfloat16" and 32 < hd <= 256
    name = "flash_attention_bwd" if bwd else "flash_attention"
    return name if tc else name + "_f32"


def cuda_core_forward(q, k, v, causal, window, q_offset, lse=None):
    """One launch of the CUDA-core forward kernel (the one the bf16
    tensor-core kernel replaces) on the same inputs, for its time; the
    port itself never routes bf16 at these head dims to it."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as fops
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fops._lib().fa_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, H, K, hd,
        fops._DTYPES[q.dtype], int(causal), window, q_offset, Sk,
        1.0 / math.sqrt(hd), runtime.stream_ptr(q))
    runtime.check(err, "CUDA-core flash_attention")
    return out


def cuda_core_backward(q, k, v, out, do, lse, causal, window, q_offset):
    """One launch of the CUDA-core backward kernels on the same inputs,
    for their time (as cuda_core_forward)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as fops
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    err = fops._bwd_lib().fa_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, hd,
        fops._DTYPES[q.dtype], int(causal), window, q_offset, Sk,
        1.0 / math.sqrt(hd), runtime.stream_ptr(q))
    runtime.check(err, "CUDA-core flash_attention backward")
    return dq, dk, dv


def attention_f64(q, k, v, *, causal, window, q_offset, kv_len):
    """`attention_ref`'s dense masked softmax with its sums in f64 (one
    batch row and one kv head's group of q heads at a time, so that the
    f64 scores of LLaVA's 6976-token prefill fit beside the inputs;
    differentiable), in f64: the plain version's answer without its f32
    rounding."""
    import torch
    from repro_torch.kernels.flash_attention import ref as fref
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    mask = fref.attention_mask(Sq, Sk, causal=causal, window=window,
                               q_offset=q_offset,
                               kv_len=Sk if kv_len is None else kv_len,
                               device=q.device)
    G = H // K
    rows = []
    for b in range(B):
        heads = []
        for j in range(K):
            qd = q[b, :, j * G:(j + 1) * G].double().transpose(0, 1)
            kd, vd = (x[b, :, j].double() for x in (k, v))
            s = (qd @ kd.T / math.sqrt(hd)).masked_fill(~mask, -math.inf)
            p = torch.softmax(s, dim=-1).nan_to_num(0.0)   # no key: 0
            heads.append((p @ vd).transpose(0, 1))
            del s, p
        rows.append(torch.cat(heads, dim=1))
    return torch.stack(rows)


def flash_case_check(dev, case, g, exact: bool = False):
    """Kernel against plain on one case; returns (max_abs_err, inputs).
    With `exact` the plain version runs on the inputs cast to f64 (its
    sums in f64), for rows of thousands of unmasked keys, where the f32
    plain version's own sums miss the 2-ulp rule at outputs near 0."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    (label, B, Sq, Sk, H, K, hd, dtype, causal, window, q_offset,
     kv_len) = case
    dt = getattr(torch, dtype)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, K, hd), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, K, hd), generator=g, device=dev).to(dt)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    runtime.reset_counts()
    got = fops.flash_attention(q, k, v, **kw)
    route = flash_route(dtype, hd)
    check(runtime.counts() == {route: 1}, f"flash_attention {label}: "
          f"launched {runtime.counts()}, expected {{{route!r}: 1}}")
    plain = attention_f64 if exact else fref.attention_ref
    want = plain(q, k, v, causal=causal, window=window,
                 q_offset=Sk - Sq if q_offset is None else q_offset,
                 kv_len=kv_len)
    torch.cuda.synchronize()
    if exact:
        want = want.float()
        label = f"{label} (against the plain version in f64)"
    err, amax, rule = flash_out_check(label, got, want)
    if kv_len is not None and window:
        pos = q_offset + torch.arange(Sq, device=dev)
        empty = pos - window >= kv_len - 1
        check(bool(empty.any()) and bool((got[:, empty] == 0).all()),
              f"flash_attention {label}: fully masked rows are not 0")
    print(f"[check] flash_attention {label} {dtype} B={B} Sq={Sq} Sk={Sk} "
          f"H={H} K={K} hd={hd} window={window} ({route}): max abs err "
          f"{err:.3g} (max |out| {amax:.3g}; within {rule})", flush=True)
    return err, (q, k, v, kw)


def serve_kernel_checks(dev):
    """Phase 7: the serve slice's two kernels against their plain
    versions on the card, at the main prefill's shapes and more; times,
    library times and bounds at the main shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref

    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    errs = [flash_case_check(dev, c, g) for c in FLASH_CASES]
    q, k, v, kw = errs[0][1]
    B, S, H, hd = q.shape
    K = k.shape[2]
    mask = fref.attention_mask(S, S, causal=True, window=kw["window"],
                               q_offset=0, kv_len=S, device=dev)
    pairs = int(mask.sum()) * B * H          # unmasked (query, key) pairs
    nbytes, _ = cost(fops.FLASH, q, k, v, *flash_masks(q, k, kw))
    bnd, by = kernel_bound(fops.FLASH, q, k, v, *flash_masks(q, k, kw),
                           ops_per_s=BF16_OPS_PER_S)
    # the library yardstick: one SDPA call with the same boolean mask
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).expand(B, H, S, hd).contiguous()
    vt = v.transpose(1, 2).expand(B, H, S, hd).contiguous()
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    plain = fref.attention_ref(q, k, v, causal=True, window=kw["window"])
    sdpa_err = float((sdpa.transpose(1, 2).float() - plain.float()).abs()
                     .max())
    del sdpa, plain
    t = {"ms": graph_ms(lambda: fops.flash_attention(q, k, v, **kw), 10),
         "eager_ms": time_ms(lambda: fops.flash_attention(q, k, v, **kw), 10),
         "plain_ms": time_ms(lambda: fref.attention_ref(
             q, k, v, causal=True, window=kw["window"]), 3),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, attn_mask=mask), 10),
         # the CUDA-core kernel the tensor-core one replaces, same inputs
         "cuda_core_ms": graph_ms(lambda: cuda_core_forward(
             q, k, v, True, kw["window"], 0), 3)}
    del qt, kt, vt
    # the f32 path (the CUDA-core kernel) at this shape
    qf, kf, vf = q.float(), k.float(), v.float()
    t["f32_ms"] = graph_ms(lambda: fops.flash_attention(qf, kf, vf, **kw), 3)
    del qf, kf, vf
    out["flash_attention"] = dict(t, max_abs_err=max(e for e, _ in errs),
                                  bound_ms=bnd, bound_by=by)
    print(f"[time] flash_attention main (B={B} S={S} H={H} K={K} hd={hd} "
          f"window={kw['window']} bf16, tensor cores): device {t['ms']:.4f} "
          f"ms/launch, eager call {t['eager_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.3f} ms, library (SDPA, bool mask) "
          f"{t['library_ms']:.4f} ms (max |SDPA - plain| {sdpa_err:.3g}), "
          f"the CUDA-core kernel it replaces {t['cuda_core_ms']:.4f} ms, the "
          f"f32 path {t['f32_ms']:.4f} ms; bound {bnd:.4g} ms ({by}; "
          f"{pairs} pairs at 4 hd operations, {nbytes} B)", flush=True)
    check(t["ms"] < t["cuda_core_ms"], "flash_attention main: the "
          "tensor-core kernel is not faster than the CUDA-core one")
    del q, k, v, mask, errs
    torch.cuda.empty_cache()

    # the scan, bitwise (states and final state), at every shape; the
    # main prefill's shape last, for its times
    for B, S, D in SCAN_SHAPES[::-1]:
        a = torch.rand((B, S, D), generator=g, device=dev) * 0.5 + 0.499
        b = 0.1 * torch.randn((B, S, D), generator=g, device=dev)
        h0 = torch.randn((B, D), generator=g, device=dev)
        states, final = sops.rglru_scan(h0, a, b)
        want = sref.rglru_scan_ref(h0, a, b)
        torch.cuda.synchronize()
        err = float((states - want).abs().max())
        check(torch.equal(states, want) and torch.equal(final, want[:, -1]),
              f"rglru_scan ({B}, {S}, {D}): not bitwise equal to the plain "
              f"version (max abs err {err})")
        print(f"[check] rglru_scan B={B} S={S} D={D} f32 (plan "
              f"{sops._plan(B, S, D)}): states and final state bitwise "
              f"equal to the plain version", flush=True)
    nbytes, _ = cost(sops.RGLRU_SCAN, h0, a, b)
    bnd, by = kernel_bound(sops.RGLRU_SCAN, h0, a, b)
    t = {"ms": graph_ms(lambda: sops.rglru_scan(h0, a, b), 10),
         "eager_ms": time_ms(lambda: sops.rglru_scan(h0, a, b), 10),
         "plain_ms": time_ms(lambda: sref.rglru_scan_ref(h0, a, b), 3),
         "library_ms": None}
    out["rglru_scan"] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by)
    print(f"[time] rglru_scan main (B={B} S={S} D={D}): device "
          f"{t['ms']:.4f} ms/launch, eager call {t['eager_ms']:.4f} ms, "
          f"plain {t['plain_ms']:.3f} ms, library none, bound {bnd:.4g} ms "
          f"({by}, {nbytes} B)", flush=True)
    del a, b, h0, states, final, want
    torch.cuda.empty_cache()
    return out


def small_serve_check(dev):
    """Phase 8: reduced recurrentgemma-9b in f32, prompt past its window
    of 64, on the card (kernels) against the CPU (plain versions) from
    the same params carried over by the bridge."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_arch(SERVE_ARCH).reduced(),
                              dtype="float32")
    model = Transformer(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0), "cpu")
    gpu_params = bridge.transformer_params_from_numpy(
        cfg, bridge.tree_to_numpy(cpu_params), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 96),
                           generator=torch.Generator().manual_seed(1))
    want = generate(model, cpu_params, tokens, 8)
    got = generate(model, gpu_params, tokens.to(dev), 8)
    err = float((got.logits.cpu() - want.logits).abs().max())
    check(err <= SERVE_LOGIT_TOL,
          f"small serve: card vs CPU logits max abs err {err}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          "small serve: greedy tokens differ between card and CPU")
    check(got.launches == {"prefill": {"flash_attention_f32": 1,
                                       "rglru_scan": 2}, "decode": {}},
          f"small serve: launches {got.launches}")
    print(f"[small] serve {cfg.name} f32 B=2 prompt 96 gen 8, card vs CPU: "
          f"logits max abs err {err:.3g} (tol {SERVE_LOGIT_TOL:g}), greedy "
          f"tokens equal, launches {got.launches}", flush=True)


def serve_main_path():
    """Phase 9: the serve path at full width through the user's entry
    point, counts reset just before and read just after."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve

    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    rec = serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                gen_len=SERVE_GEN, reduced=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {SERVE_ARCH} full width B={SERVE_BATCH} prompt "
          f"{SERVE_PROMPT} gen {SERVE_GEN}: prefill {rec['prefill_s']:.4f} s "
          f"({rec['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{rec['decode_s']:.4f} s for {SERVE_GEN - 1} steps "
          f"({rec['decode_tok_per_s']:.2f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init and warm-up; "
          f"timed-pass launches {rec['launches']}, all launches {counts}; "
          f"sample {rec['output_sample']}", flush=True)
    check(rec["output_shape"] == [SERVE_BATCH, SERVE_GEN],
          f"serve output shape {rec['output_shape']}")
    check(rec["logits_finite"], "serve logits not finite")
    check(rec["launches"]["prefill"] == PREFILL_LAUNCHES,
          f"one prefill launched {rec['launches']['prefill']}, expected "
          f"{PREFILL_LAUNCHES}")
    check(rec["launches"]["decode"] == {},
          f"decode launched {rec['launches']['decode']}, expected none")
    # the warm-up pass (prefill + one decode step) and the timed pass
    want = {k: 2 * n for k, n in PREFILL_LAUNCHES.items()}
    check(counts == want, f"serve launched {counts}, expected {want}")
    return counts


def profile_serve(dev) -> None:
    """One more full-width prefill and one decode step under
    torch.profiler, after the counted run: device time by kernel, split
    into GEMMs, the two hand-written kernels and the rest, and each
    one's device busy share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Transformer

    model = Transformer(get_arch(SERVE_ARCH))
    gen = torch.Generator(device=dev).manual_seed(2)
    params = model.init(gen, dev)
    tokens = torch.randint(0, model.cfg.vocab_size,
                           (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                           device=dev)

    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return out, prof, wall_ms

    def device_rows(prof):
        return sorted((e for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA")
                       and dev_us(e) > 0), key=dev_us, reverse=True)

    def ms_of(rows, *words):
        return sum(dev_us(e) for e in rows
                   if any(w in e.key.lower() for w in words)) / 1e3

    with torch.no_grad():
        cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, dev)
        (logits, cache), prof, wall_ms = profiled(
            lambda: model.prefill(params, {"tokens": tokens}, cache))
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        model.decode_step(params, tok, cache)       # warm, then one step
        _, dprof, dwall_ms = profiled(
            lambda: model.decode_step(params, tok, cache))

    rows = device_rows(prof)
    total = sum(dev_us(e) for e in rows) / 1e3
    flash = ms_of(rows, "fwd_tc_kernel", "flash_attention_kernel")
    scan = ms_of(rows, "rglru_scan_kernel")
    gemm = ms_of(rows, *GEMM_WORDS)
    print(f"[profile] one full-width prefill (B={SERVE_BATCH} S="
          f"{SERVE_PROMPT}): wall {wall_ms:.1f} ms (profiler on), device "
          f"busy {total:.1f} ms ({100 * total / wall_ms:.1f}%): GEMMs "
          f"{gemm:.1f} ms, flash_attention {flash:.1f} ms, rglru_scan "
          f"{scan:.1f} ms, other {total - gemm - flash - scan:.1f} ms; "
          f"{sum(e.count for e in rows)} device ops", flush=True)
    for e in rows[:14]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    rows = device_rows(dprof)
    total = sum(dev_us(e) for e in rows) / 1e3
    aten = sum(e.count for e in dprof.key_averages()
               if e.key.startswith("aten::"))
    print(f"[profile] one decode step (B={SERVE_BATCH}): wall "
          f"{dwall_ms:.1f} ms (profiler on), device busy {total:.2f} ms "
          f"({100 * total / dwall_ms:.1f}%), GEMMs "
          f"{ms_of(rows, *GEMM_WORDS):.2f} ms; {sum(e.count for e in rows)} "
          f"device ops, {aten} aten calls (nested included)", flush=True)
    for e in rows[:6]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    del params, cache
    torch.cuda.empty_cache()


# -- the mesh slice: the fused PSO update and the flash backward ----------

MESH_ARCH, MESH_W, MESH_B, MESH_S = "smollm-360m", 2, 2, 2048
MESH_SPEC = ("model.reduced=false", f"model.seq_len={MESH_S}",
             f"run.rounds={ROUNDS}")
# pso_update: (label, leaf shape); the first is the largest SmolLM-360M
# leaf (groups/b0/mlp/wi: 32 layers x 960 x 2560), stacked over W
PSO_CASES = [("main", (32, 960, 2560)), ("ragged", (1001,))]
# flash backward: as FLASH_CASES; the first is the SmolLM train shape
FLASH_BWD_CASES = [
    ("main", 2, 2048, 2048, 15, 5, 64, "bfloat16", True, 0, None, None),
    ("f32", 2, 2048, 2048, 15, 5, 64, "float32", True, 0, None, None),
    # windowed, ragged, suffix-aligned GQA; rows at q_pos >= 927 see no key
    ("ragged", 2, 300, 1000, 6, 2, 128, "bfloat16", True, 128, 700, 800),
]
BWD_F32_RTOL = 1e-5
LSE_ATOL = 1e-5          # the forward's log-sum-exp, f32, |lse| < ~20 here
MESH_LOSS_TOL, MESH_PARAM_TOL = 5e-6, 2e-7


def pso_checks(dev):
    """pso_update against its plain version, bitwise, and its times at
    the main leaf in bf16 (the main path's dtype)."""
    import torch
    from repro_torch.kernels.pso_update import ops as pops
    from repro_torch.kernels.pso_update import ref as pref

    g = torch.Generator(device=dev).manual_seed(3)
    W = MESH_W
    out = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for label, leaf in PSO_CASES:
            def draw(scale, shape):
                return (scale * torch.randn(shape, generator=g, device=dev)
                        ).to(dtype)
            w, wl = draw(0.1, (W,) + leaf), draw(0.1, (W,) + leaf)
            v, d = draw(0.01, (W,) + leaf), draw(1e-3, (W,) + leaf)
            wg = draw(0.1, leaf)
            for clip in (0.0, 0.02):
                co = torch.cat([torch.rand((W, 1), generator=g, device=dev),
                                torch.randn((W, 2), generator=g, device=dev),
                                torch.full((W, 1), clip, device=dev)],
                               1).contiguous()
                kw_, kv_ = pops.pso_update(co, w, v, wl, wg, d)
                pw_, pv_ = pref.pso_update_ref(co, w, v, wl, wg, d)
                torch.cuda.synchronize()
                e = float((kw_.float() - pw_.float()).abs().max())
                out["max_abs_err"] = max(out["max_abs_err"], e, float(
                    (kv_.float() - pv_.float()).abs().max()))
                check(torch.equal(kw_, pw_) and torch.equal(kv_, pv_),
                      f"pso_update {dtype} {label} clip={clip}: not bitwise "
                      f"equal to the plain version (max abs err {e})")
            print(f"[check] pso_update {str(dtype)[6:]} {label} W={W} "
                  f"leaf={leaf}, clip off and on: bitwise equal to the "
                  f"plain version", flush=True)
            if label == "main" and dtype == torch.bfloat16:
                nbytes, _ = cost(pops.PSO_UPDATE, co, w, v, wl, wg, d)
                bnd, by = kernel_bound(pops.PSO_UPDATE, co, w, v, wl, wg, d)
                t = {"ms": graph_ms(lambda: pops.pso_update(
                         co, w, v, wl, wg, d), 10),
                     "eager_ms": time_ms(lambda: pops.pso_update(
                         co, w, v, wl, wg, d), 10),
                     "plain_ms": time_ms(lambda: pref.pso_update_ref(
                         co, w, v, wl, wg, d), 3),
                     "library_ms": None}
                out.update(t, bound_ms=bnd, bound_by=by)
                print(f"[time] pso_update main (W={W}, leaf {leaf}, bf16): "
                      f"device {t['ms']:.4f} ms/launch, eager call "
                      f"{t['eager_ms']:.4f} ms, plain {t['plain_ms']:.3f} "
                      f"ms, library none, bound {bnd:.4g} ms ({by}, "
                      f"{nbytes} B)", flush=True)
            del w, wl, v, d, wg
    torch.cuda.empty_cache()
    return out


def flash_bwd_case(dev, case, g, exact: bool = False):
    """The training forward against the plain one and the backward kernel
    against `attention_bwd_ref` and autograd of `attention_ref` on one
    case; returns (max_abs_err vs the plain backward, the inputs, the
    forward's max_abs_err). With `exact` the training forward is held to
    `attention_f64` (as flash_case_check); the backward is always held to
    `attention_bwd_ref`, which forms rowsum(dO * O) from the kernel's
    bf16 output as the kernel does (an f64 autograd from the exact output
    misses dq and dk by up to ~800 bf16 ulps at gradients near 0, in the
    plain f32 version and the kernel alike)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    (label, B, Sq, Sk, H, K, hd, dtype, causal, window, q_offset,
     kv_len) = case
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, K, hd), generator=g, device=dev).to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window,
              q_offset=Sk - Sq if q_offset is None else q_offset,
              kv_len=kv_len)
    # the training forward (the one that writes the log-sum-exp) against
    # the plain forward at this shape: out, and lse (-inf on rows with
    # no valid key, in the same rows)
    runtime.reset_counts()
    out, lse = fops._forward(q, k, v, causal, window, q_offset, kv_len, True)
    route = flash_route(dtype, hd)
    check(runtime.counts() == {route: 1}, f"flash forward {label}: "
          f"launched {runtime.counts()}, expected {{{route!r}: 1}}")
    want, want_lse = fref.attention_ref(q, k, v, **kw, return_lse=True)
    if exact:
        want = attention_f64(q, k, v, **kw).float()
    torch.cuda.synchronize()
    fwd_err, amax, rule = flash_out_check(
        f"{label} (training forward{', f64 plain' if exact else ''})", out,
        want)
    fin = torch.isfinite(want_lse)
    check(torch.equal(torch.isfinite(lse), fin)
          and bool((lse[~fin] == want_lse[~fin]).all()),
          f"flash forward {label}: lse not -inf exactly where the plain "
          f"one is")
    lerr = float((lse[fin] - want_lse[fin]).abs().max())
    check(lerr <= LSE_ATOL, f"flash forward {label}: lse max abs err {lerr} "
                            f"exceeds {LSE_ATOL:g}")
    print(f"[check] flash forward (with lse) {label} {dtype} B={B} Sq={Sq} "
          f"Sk={Sk} H={H} K={K} hd={hd} window={window} ({route}): out max "
          f"abs err {fwd_err:.3g} (max |out| {amax:.3g}; within {rule}), lse "
          f"max abs "
          f"err {lerr:.3g} (within {LSE_ATOL:g}; {int((~fin).sum())} rows "
          f"-inf in both)", flush=True)
    del want, want_lse
    runtime.reset_counts()
    got = fops.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    route = flash_route(dtype, hd, bwd=True)
    check(runtime.counts() == {route: 1}, f"flash backward {label}: "
          f"launched {runtime.counts()}, expected {{{route!r}: 1}}")
    if route == "flash_attention_bwd":      # the tensor cores: which build
        build = fops._bwd_lib().fa_bwd_tc_build_head_dim(hd)
        check(build == fops.tc_head_dim(hd), f"flash backward {label}: "
              f"hd {hd} ran in build {build}, expected {fops.tc_head_dim(hd)}")
        route = f"{route}, build {build}"
    plain = fref.attention_bwd_ref(q, k, v, out, do, lse, **kw)
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(fref.attention_ref(*xs, **kw), xs, do)
    torch.cuda.synchronize()
    errs = []
    for name, refs in (("plain", plain), ("autograd", auto)):
        for n, a, b in zip("qkv", got, refs):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"flash backward {label} "
                                                 f"d{n} not finite")
            diff, amax = (a - b).abs(), float(b.abs().max())
            if dt == torch.float32:
                ok, rule = (float(diff.max()) <= BWD_F32_RTOL * amax,
                            f"{BWD_F32_RTOL:g} x max|grad|")
            elif name == "plain":
                floor = torch.full_like(b, 2.0 ** -12 * amax)
                ok = bool((diff <= 2 * bf16_ulp(torch.maximum(b.abs(),
                                                              floor))).all())
                rule = "2 bf16 ulps"
            else:
                ok = float(diff.max()) <= 4 * float(bf16_ulp(
                    torch.tensor(amax)))
                rule = "4 bf16 ulps of max|grad|"
            check(ok, f"flash backward {label} d{n} vs {name}: max abs err "
                      f"{float(diff.max())} exceeds {rule}")
            if name == "plain":
                errs.append(float(diff.max()))
            print(f"[check] flash backward {label} {dtype} d{n} vs {name} "
                  f"({route}): max abs err {float(diff.max()):.3g} (max |grad| "
                  f"{amax:.3g}; within {rule})", flush=True)
    if kv_len is not None and window:
        pos = kw["q_offset"] + torch.arange(Sq, device=dev)
        empty = pos - window >= kv_len - 1
        check(bool(empty.any()) and bool((got[0][:, empty] == 0).all()),
              f"flash backward {label}: fully masked rows get a gradient")
    del plain, auto, xs
    return max(errs), (q, k, v, out, do, lse, kw), fwd_err


def flash_bwd_checks(dev):
    """The backward kernel on every case; times and bounds at the main
    (SmolLM train) shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(4)
    results = [flash_bwd_case(dev, c, g) for c in FLASH_BWD_CASES]
    # both libraries: every hd % 8 == 0 up to 256 has a launch, no other,
    # as the wrappers' rule (`padded_head_dim`) says
    for hd in range(0, 265):
        want = hd % 8 == 0 and 0 < hd <= 256
        try:
            fops.padded_head_dim(hd)
            rule = True
        except ValueError:
            rule = False
        try:
            fops.require_bwd_head_dim(hd)
            ok = want
        except ValueError:
            ok = not want
        check(ok and rule == want and
              bool(fops._lib().fa_supports_head_dim(hd)) == want and
              bool(fops._bwd_lib().fa_bwd_supports_head_dim(hd)) == want,
              f"flash libraries: head_dim {hd} "
              f"{'refused' if want else 'accepted'}")
        # the tensor-core builds, forward and backward: the libraries'
        # and the wrappers' one rule
        build = fops.tc_head_dim(hd) if want and hd > 32 else 0
        for what, got in (
                ("forward", fops._lib().fa_tc_build_head_dim(hd)),
                ("backward", fops._bwd_lib().fa_bwd_tc_build_head_dim(hd))):
            check(got == build, f"flash {what} library: head_dim {hd} runs "
                                f"in build {got}, expected {build}")
    print("[check] flash libraries, forward and backward, and the wrappers' "
          "rule: head dims 8, 16, ..., 256 accepted, every other in 0-264 "
          "refused; the tensor-core builds, forward and backward, as "
          "`tc_head_dim` (hd 72 and 80 in the 80 build)", flush=True)
    err = max(r[0] for r in results)
    q, k, v, out, do, lse, kw = results[0][1]
    B, S, H, hd = q.shape
    K = k.shape[2]
    pairs = B * H * S * (S + 1) // 2          # unmasked (query, key) pairs
    G = H // K
    # the library yardsticks (timed here, used nowhere in the port): SDPA,
    # causal, with the kv heads repeated
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(G, 1).contiguous() \
        .requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(G, 1).contiguous() \
        .requires_grad_()
    dot = do.transpose(1, 2)

    # the training forward at this shape (its most launched shape: 224
    # launches a mesh round), with the log-sum-exp, against SDPA's
    # forward alone
    def fwd():
        return fops._forward(q, k, v, True, 0, None, None, True)

    masks = flash_masks(q, k, {"causal": True})
    nbytes, _ = cost(fops.FLASH_LSE, q, k, v, *masks)
    bnd, by = kernel_bound(fops.FLASH_LSE, q, k, v, *masks,
                           ops_per_s=BF16_OPS_PER_S)
    with torch.no_grad():
        tf = {"ms": graph_ms(fwd, 10), "eager_ms": time_ms(fwd, 10),
              "plain_ms": time_ms(lambda: fref.attention_ref(
                  q, k, v, causal=True, return_lse=True), 3),
              "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=True), 10),
              "cuda_core_ms": graph_ms(lambda: cuda_core_forward(
                  q, k, v, True, 0, 0, torch.empty_like(lse)), 5)}
    fwd_row = dict(tf, bound_ms=bnd, bound_by=by,
                   max_abs_err=results[0][2])
    print(f"[time] flash forward mesh (B={B} S={S} H={H} K={K} hd={hd} "
          f"causal bf16, with lse, tensor cores): device {tf['ms']:.4f} "
          f"ms/launch, eager call {tf['eager_ms']:.4f} ms, plain "
          f"{tf['plain_ms']:.3f} ms, library (SDPA forward, causal) "
          f"{tf['library_ms']:.4f} ms, the CUDA-core kernel it replaces "
          f"{tf['cuda_core_ms']:.4f} ms; bound {bnd:.4g} ms ({by}; {pairs} "
          f"pairs at 4 hd operations, {nbytes} B)", flush=True)
    check(tf["ms"] < tf["cuda_core_ms"], "flash forward mesh: the "
          "tensor-core kernel is not faster than the CUDA-core one")

    nbytes, _ = cost(fops.FLASH_BWD, q, k, v, out, do, lse, *masks)
    bnd, by = kernel_bound(fops.FLASH_BWD, q, k, v, out, do, lse, *masks,
                           ops_per_s=BF16_OPS_PER_S)

    def bwd():
        return fops.flash_attention_bwd(q, k, v, out, do, lse, **kw)

    def fwd_bwd():
        o, lz = fops._forward(q, k, v, True, 0, None, None, True)
        return fops.flash_attention_bwd(q, k, v, o, do, lz, **kw)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    # SDPA's backward alone: one stored forward, its graph kept
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    t = {"ms": graph_ms(bwd, 5), "eager_ms": time_ms(bwd, 10),
         "plain_ms": time_ms(lambda: fref.attention_bwd_ref(
             q, k, v, out, do, lse, **kw), 3),
         "library_ms": time_ms(lambda: torch.autograd.grad(
             o_sdpa, (qt, kt, vt), dot, retain_graph=True), 10),
         "library_fwd_bwd_ms": time_ms(sdpa, 10),
         "cuda_core_ms": graph_ms(lambda: cuda_core_backward(
             q, k, v, out, do, lse, True, 0, 0), 3)}
    del o_sdpa
    fb = time_ms(fwd_bwd, 10)
    # the f32 path (the CUDA-core kernels) at this shape
    f32 = [x.float() for x in (q, k, v, do)]
    with torch.no_grad():
        of, lf = fops._forward(*f32[:3], True, 0, None, None, True)
        t["f32_ms"] = graph_ms(lambda: fops.flash_attention_bwd(
            *f32[:3], of, f32[3], lf, **kw), 3)
        fwd_row["f32_ms"] = graph_ms(lambda: fops._forward(
            *f32[:3], True, 0, None, None, True), 3)
    del f32, of, lf
    print(f"[time] flash backward main (B={B} S={S} H={H} K={K} hd={hd} "
          f"causal bf16, tensor cores): device {t['ms']:.4f} ms/launch, "
          f"eager call {t['eager_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
          f"library (SDPA backward alone) {t['library_ms']:.4f} ms, the "
          f"CUDA-core kernels it replaces {t['cuda_core_ms']:.4f} ms, the f32 "
          f"path {t['f32_ms']:.4f} ms (forward {fwd_row['f32_ms']:.4f} ms); "
          f"kernel forward (with lse) + backward {fb:.4f} ms against library "
          f"(SDPA forward + backward, causal) {t['library_fwd_bwd_ms']:.4f} "
          f"ms; bound {bnd:.4g} ms ({by}; {pairs} pairs at 10 hd "
          f"operations, {nbytes} B)", flush=True)
    check(t["ms"] < t["cuda_core_ms"] and t["ms"] < t["plain_ms"],
          "flash backward main: the tensor-core kernels are not faster than "
          "the CUDA-core ones and the plain backward")
    del results, q, k, v, out, do, lse, qt, kt, vt
    torch.cuda.empty_cache()
    return (dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by,
                 fwd_bwd_ms=fb), fwd_row)


def small_mesh_check(dev, arch: str = MESH_ARCH):
    """Two M-DSL rounds of the reduced arch in f32 (W = 2) on the card
    (kernels) against the same rounds on the CPU (plain versions), from
    the same params (through the bridge), batches and draws."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.core import swarm_dist
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Transformer
    from repro_torch.pytree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = Transformer(cfg)
    gen = torch.Generator().manual_seed(5)
    cpu_params = model.init(gen, "cpu")
    gpu_params = bridge.transformer_params_from_numpy(
        cfg, bridge.tree_to_numpy(cpu_params), dev)
    dcfg = swarm_dist.DistSwarmConfig(num_spatial=MESH_W)
    step = swarm_dist.build_train_step(model.loss, dcfg)
    cs = swarm_dist.init_state(cpu_params, dcfg)
    gs = swarm_dist.init_state(gpu_params, dcfg)

    def to_dev(x):
        return None if x is None else tree_map(lambda t: t.to(dev), x)

    runtime.reset_counts()
    for r in range(2):
        toks = torch.randint(0, cfg.vocab_size, (MESH_W + 1, 2, 128),
                             generator=gen)
        batch = {"tokens": toks[:MESH_W],
                 "labels": torch.roll(toks[:MESH_W], -1, dims=-1)}
        ev = {"tokens": toks[MESH_W], "labels": torch.roll(toks[MESH_W], -1,
                                                           dims=-1)}
        draws = swarm_dist.sample_draws(gen, dcfg, cpu_params, "cpu",
                                        round_idx=r)
        cs, ci = step(cs, batch, ev, draws)
        gs, gi = step(gs, to_dev(batch), to_dev(ev),
                      type(draws)(*[to_dev(x) for x in draws]))
        torch.cuda.synchronize()
        check(torch.equal(ci.mask, gi.mask.cpu()), f"small mesh round "
                                                   f"{r + 1}: masks")
        lerr = max(float((gi.losses.cpu() - ci.losses).abs().max()),
                   abs(float(gi.global_loss) - float(ci.global_loss)))
        perr = max(float((a.cpu() - b).abs().max())
                   for f in ("params", "velocity", "global_params")
                   for a, b in zip(tree_leaves(getattr(gs, f)),
                                   tree_leaves(getattr(cs, f))))
        check(lerr <= MESH_LOSS_TOL and perr <= MESH_PARAM_TOL,
              f"small mesh round {r + 1}: card vs CPU losses off by {lerr}, "
              f"params/velocity off by {perr}")
        print(f"[small] mesh round {r + 1} {cfg.name} f32 W={MESH_W} card "
              f"vs CPU: masks equal, losses max abs err {lerr:.3g} (tol "
              f"{MESH_LOSS_TOL:g}), params and velocity {perr:.3g} (tol "
              f"{MESH_PARAM_TOL:g})", flush=True)
    counts = runtime.counts()
    # f32: the flash kernels take the CUDA-core route
    want = {(k + "_f32" if k.startswith("flash") else k): 2 * n
            for k, n in mesh_launches_per_round(
                cfg, len(tree_leaves(cpu_params))).items()}
    check(counts == want, f"small mesh rounds launched {counts}, expected "
                          f"{want}")


def mesh_launches_per_round(cfg, n_leaves: int, W: int = MESH_W) -> dict:
    """Kernel launches of one M-DSL round, by block kind: per attention
    layer (attn, swa) each worker's forward and remat recompute plus W + 1
    evaluations through the flash forward, and each worker's backward
    through the flash backward; the same per rglru layer through the scan
    and the scan's backward; none per mlstm or slstm layer (plain
    PyTorch); Eq. 8 once per leaf. Kernels with no launch are left out."""
    P = cfg.block_pattern
    kinds = [P[i % len(P)] for i in range(cfg.num_layers)]
    att = sum(k in ("attn", "swa") for k in kinds)
    rg = kinds.count("rglru")
    out = {"flash_attention": att * (2 * W + W + 1),
           "flash_attention_bwd": att * W,
           "rglru_scan": rg * (2 * W + W + 1), "rglru_scan_bwd": rg * W,
           "pso_update": n_leaves}
    return {k: n for k, n in out.items() if n}


def mesh_main_path():
    """The mesh training path at full width through the user's entry
    point, counts reset just before and read just after."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.pytree import tree_leaves

    spec = override(get_scenario("mesh/smollm-smoke"), *MESH_SPEC)
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec = result.record
    gp = result.state.global_params
    n_params = sum(x.numel() for x in tree_leaves(gp))
    tokens = MESH_W * MESH_B * MESH_S
    for t in range(ROUNDS):
        print(f"[mesh] round {t + 1}{' (warm-up)' if t == 0 else ''}: "
              f"{rec['step_time_s'][t]:.4f} s, global loss "
              f"{rec['global_loss'][t]:.5f}, worker losses "
              f"{rec['worker_losses'][t]}, selected {rec['selected'][t]}/"
              f"{MESH_W}, launches {rec['launches'][t]}", flush=True)
    steady = rec["step_time_s"][1:]
    print(f"[mesh] {MESH_ARCH} full width ({n_params} params, bf16) W="
          f"{MESH_W} B={MESH_B} S={MESH_S} ({tokens} tokens a round): "
          f"{statistics.mean(steady):.4f} s per round after the warm-up "
          f"({tokens / statistics.mean(steady):.1f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init; all launches "
          f"{counts}", flush=True)
    check(rec["device"] == torch.cuda.get_device_name(0),
          f"mesh run on {rec['device']}")
    check(all(math.isfinite(v) for v in rec["global_loss"]),
          "mesh global loss not finite")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(gp)),
          "mesh global params not finite")
    per_round = mesh_launches_per_round(get_arch(MESH_ARCH),
                                        len(tree_leaves(gp)))
    for t in range(ROUNDS):
        check(rec["launches"][t] == per_round,
              f"mesh round {t + 1} launched {rec['launches'][t]}, expected "
              f"{per_round}")
    want = {k: ROUNDS * n for k, n in per_round.items()}
    check(counts == want, f"mesh run launched {counts}, expected {want}")
    return counts, spec


def profile_mesh(spec) -> None:
    """One more full-width round under torch.profiler, after the counted
    run: the device's busy share, device time split into GEMMs, the flash
    forward and backward, pso_update and the rest, the top device ops and
    the stage ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.experiments import build

    prep = build(spec)
    state, _ = prep.step(prep.state, prep.draw(prep.state))     # warm
    draws = prep.draw(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prep.step(state, draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    names = ("LocalUpdate", "ScoreSelect", "Uplink", "Aggregate",
             "Downlink", "BestTracking")
    rows = device_rows(prof)

    def ms_of(*words):
        return sum(dev_us(e) for e in rows
                   if any(w in e.key.lower() for w in words)) / 1e3

    busy = sum(dev_us(e) for e in rows) / 1e3
    gemm = ms_of(*GEMM_WORDS)
    fwd = ms_of("fwd_tc_kernel", "flash_attention_kernel")
    bwd = ms_of("dkdv_tc_kernel", "dq_tc_kernel", "prep_tc_kernel",
                "dkdv_kernel", "dq_kernel", "dot_kernel")
    pso = ms_of("pso_update_kernel")
    print(f"[profile] one full-width mesh round: wall {wall_ms:.1f} ms "
          f"(profiler on), device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%): GEMMs {gemm:.1f} ms, flash "
          f"forward {fwd:.1f} ms, flash backward {bwd:.1f} ms, pso_update "
          f"{pso:.2f} ms, other {busy - gemm - fwd - bwd - pso:.1f} ms; "
          f"{sum(e.count for e in rows)} device ops", flush=True)
    stages = {e.key: e for e in prof.key_averages()
              if e.key in names and str(e.device_type).endswith("CPU")}
    print("[profile] stages (host ms / device ms of its kernels): " + ", ".join(
        f"{k} {stages[k].cpu_time_total / 1e3:.2f}/"
        f"{getattr(stages[k], 'device_time_total', 0.0) / 1e3:.2f}"
        for k in names if k in stages), flush=True)
    for e in rows[:14]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    del prep, state, draws
    torch.cuda.empty_cache()


# -- this slice: flash at every head dim, StableLM-3B ----------------------

HD_ARCH = "stablelm-3b"          # d_model 2560 over 32 heads: hd 80, MHA
HD_SERVE_BATCH, HD_SERVE_PROMPT, HD_SERVE_GEN = 4, 4096, 32
HD_MESH_LAYERS, HD_MESH_B, HD_MESH_S = 2, 1, 2048
# StableLM-3B's attention: the serve prefill's forward (bf16 in the
# tensor-core forward's 80 build) and the training shape's forward +
# backward (the backward in its 80 build too), bf16 and f32; RecurrentGemma-
# 9B's hd-256 backward (16 heads over 1, window 2048; the tensor cores'
# 256 build, two passes and head groups), which no model path runs yet
# (its training waits for the scan's backward). The ragged cases (Sq not
# a multiple of 64, a query offset, kv_len < Sk, GQA, fully masked rows)
# reach the hd-80 tail box past S and the hd-256 build's edges; they are
# checked, not timed.
HD80_FWD_CASES = [
    ("hd80", 4, 4096, 4096, 32, 32, 80, "bfloat16", True, 0, None, None),
    ("hd80 f32", 4, 4096, 4096, 32, 32, 80, "float32", True, 0, None, None),
    ("hd80 ragged", 2, 300, 1000, 6, 2, 80, "bfloat16", True, 128, 700,
     800),
    ("hd72 ragged", 1, 333, 333, 4, 4, 72, "bfloat16", False, 50, None,
     None),
]
HD_BWD_CASES = [
    ("hd80", 2, 2048, 2048, 32, 32, 80, "bfloat16", True, 0, None, None),
    ("hd80 f32", 2, 2048, 2048, 32, 32, 80, "float32", True, 0, None, None),
    ("hd256", 2, 2048, 2048, 16, 1, 256, "bfloat16", True, 2048, None, None),
    ("hd256 f32", 2, 2048, 2048, 16, 1, 256, "float32", True, 2048, None,
     None),
    ("hd256 ragged", 2, 300, 1000, 4, 2, 256, "bfloat16", True, 128, 700,
     800),
    ("hd80 ragged", 2, 300, 1000, 6, 2, 80, "bfloat16", True, 128, 700,
     800),
    ("hd72 ragged", 1, 333, 333, 4, 2, 72, "bfloat16", True, 100, None,
     None),
]


def hd80_forward_checks(dev):
    """The forward at StableLM-3B's prefill shape (B 4, S 4096, 32 heads,
    MHA, hd 80, causal) in bf16 and f32 against the plain version, each
    asserting its route; times, SDPA's and the bound. Returns the bf16
    row (with the f32 path's and SDPA's f32 times)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(6)
    row = {}
    for case in HD80_FWD_CASES:
        err, (q, k, v, kw) = flash_case_check(dev, case, g)
        if "ragged" in case[0]:
            row["ragged_max_abs_err"] = max(row.get("ragged_max_abs_err",
                                                    0.0), err)
            del q, k, v
            continue
        B, S, H, hd = q.shape
        pairs = B * H * S * (S + 1) // 2
        nbytes, _ = cost(fops.FLASH, q, k, v, *flash_masks(q, k, kw))
        bnd, by = kernel_bound(fops.FLASH, q, k, v, *flash_masks(q, k, kw),
                               ops_per_s=BF16_OPS_PER_S
                               if q.dtype == torch.bfloat16
                               else F32_OPS_PER_S)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t = {"ms": graph_ms(lambda: fops.flash_attention(q, k, v, **kw), 5),
             "eager_ms": time_ms(lambda: fops.flash_attention(q, k, v, **kw),
                                 5),
             "plain_ms": time_ms(lambda: fref.attention_ref(
                 q, k, v, causal=True), 2),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True), 5)}
        print(f"[time] flash_attention {case[0]} (B={B} S={S} H={H} hd={hd} "
              f"causal {case[7]}, {flash_route(case[7], hd)}): device "
              f"{t['ms']:.4f} ms/launch, eager call {t['eager_ms']:.4f} ms, "
              f"plain {t['plain_ms']:.3f} ms, library (SDPA, causal) "
              f"{t['library_ms']:.4f} ms; bound {bnd:.4g} ms ({by}; {pairs} "
              f"pairs at 4 hd operations, {nbytes} B)", flush=True)
        if q.dtype == torch.bfloat16:
            row = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by)
        else:
            row.update(f32_ms=t["ms"], f32_library_ms=t["library_ms"],
                       f32_max_abs_err=err)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return row


def hd80_serve_path():
    """StableLM-3B served at full width through the user's entry point
    (random bf16 weights from a seed), counts reset just before and read
    just after: each prefill launches the hd-80 forward once a layer, 32
    times, decode none; a warm-up pass and the timed pass."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve

    layers = get_arch(HD_ARCH).num_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    rec = serve(HD_ARCH, batch=HD_SERVE_BATCH, prompt_len=HD_SERVE_PROMPT,
                gen_len=HD_SERVE_GEN, reduced=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {HD_ARCH} full width (hd 80) B={HD_SERVE_BATCH} prompt "
          f"{HD_SERVE_PROMPT} gen {HD_SERVE_GEN}: prefill "
          f"{rec['prefill_s']:.4f} s ({rec['prefill_tok_per_s']:.1f} tok/s), "
          f"decode {rec['decode_s']:.4f} s for {HD_SERVE_GEN - 1} steps "
          f"({rec['decode_tok_per_s']:.2f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init and warm-up; "
          f"timed-pass launches {rec['launches']}, all launches {counts}; "
          f"sample {rec['output_sample']}", flush=True)
    check(rec["output_shape"] == [HD_SERVE_BATCH, HD_SERVE_GEN],
          f"{HD_ARCH} serve output shape {rec['output_shape']}")
    check(rec["logits_finite"], f"{HD_ARCH} serve logits not finite")
    check(rec["launches"] == {"prefill": {"flash_attention": layers},
                              "decode": {}},
          f"{HD_ARCH} serve: one pass launched {rec['launches']}, expected "
          f"{layers} hd-80 flash launches in the prefill and none in decode")
    check(counts == {"flash_attention": 2 * layers},
          f"{HD_ARCH} serve launched {counts}, expected "
          f"{{'flash_attention': {2 * layers}}}")
    return counts


def time_flash_bwd(label, q, k, v, out, do, lse, kw):
    """Device, eager, plain and SDPA-backward-alone times of the backward
    at one shape, and its bound (10 hd operations a unmasked pair)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    B, S, H, hd = q.shape
    K = k.shape[2]
    mask = fref.attention_mask(S, S, causal=kw["causal"], window=kw["window"],
                               q_offset=0, kv_len=S, device=q.device)
    pairs = int(mask.sum()) * B * H
    del mask
    nbytes, _ = cost(fops.FLASH_BWD, q, k, v, out, do, lse,
                     *flash_masks(q, k, kw))
    bnd, by = kernel_bound(fops.FLASH_BWD, q, k, v, out, do, lse,
                           *flash_masks(q, k, kw), ops_per_s=BF16_OPS_PER_S)
    G = H // K
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(G, 1).contiguous() \
        .requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(G, 1).contiguous() \
        .requires_grad_()
    dot = do.transpose(1, 2)
    # the masks here are causal with a window >= S: SDPA's is_causal
    check(kw["window"] == 0 or kw["window"] >= S, f"{label}: SDPA yardstick "
          f"needs window 0 or >= S")
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def bwd():
        return fops.flash_attention_bwd(q, k, v, out, do, lse, **kw)

    t = {"ms": graph_ms(bwd, 2), "eager_ms": time_ms(bwd, 3),
         "plain_ms": time_ms(lambda: fref.attention_bwd_ref(
             q, k, v, out, do, lse, **kw), 2),
         "library_ms": time_ms(lambda: torch.autograd.grad(
             o_sdpa, (qt, kt, vt), dot, retain_graph=True), 5)}
    print(f"[time] flash backward {label} (B={B} S={S} H={H} K={K} hd={hd} "
          f"window={kw['window']} bf16, {flash_route('bfloat16', hd, True)}):"
          f" device {t['ms']:.4f} ms/launch, eager call {t['eager_ms']:.4f} "
          f"ms, plain {t['plain_ms']:.3f} ms, library (SDPA backward alone) "
          f"{t['library_ms']:.4f} ms; bound {bnd:.4g} ms ({by}; {pairs} pairs "
          f"at 10 hd operations, {nbytes} B)", flush=True)
    del o_sdpa, qt, kt, vt
    return dict(t, bound_ms=bnd, bound_by=by)


def hd_backward_checks(dev):
    """The training forward and the backward at StableLM-3B's training
    shape (hd 80) and at RecurrentGemma-9B's attention shape (hd 256), in
    bf16 and f32, against the plain versions and autograd, each asserting
    its route; the bf16 backward times beside SDPA's backward alone.
    Returns {"hd80": row, "hd256": row}."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    g = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    for case in HD_BWD_CASES:
        err, inputs, _ = flash_bwd_case(dev, case, g)
        if "ragged" in case[0]:
            # on the row of the build it runs in (hd 72: the 80 build)
            row = rows[f"hd{fops.tc_head_dim(case[6])}"]
            row["ragged_max_abs_err"] = max(row.get("ragged_max_abs_err",
                                                    0.0), err)
        elif case[7] == "bfloat16":
            rows[case[0]] = dict(time_flash_bwd(case[0], *inputs),
                                 max_abs_err=err)
            if case[6] == 256:
                # the kernels this build replaces (the CUDA-core ones, the
                # port's bf16 hd-256 route before it), same inputs
                q, k, v, out, do, lse, kw = inputs
                cc = graph_ms(lambda: cuda_core_backward(
                    q, k, v, out, do, lse, kw["causal"], kw["window"],
                    kw["q_offset"]), 2)
                rows[case[0]]["cuda_core_ms"] = cc
                print(f"[time] flash backward {case[0]}: the CUDA-core "
                      f"kernels it replaces {cc:.4f} ms/launch, the "
                      f"tensor-core build {rows[case[0]]['ms']:.4f} ms",
                      flush=True)
                del q, k, v, out, do, lse
        else:
            rows[case[0].split()[0]]["f32_max_abs_err"] = err
        del inputs
        torch.cuda.empty_cache()
    return rows


def depth_cut_mesh_rounds(dev, arch: str, layers: int, W: int, B: int,
                          S: int, seed: int, note: str, card: str):
    """Two M-DSL rounds of `arch` at full width through the model's code
    (`Transformer.loss` under the mesh engine's train step), the depth cut
    to `layers` layers: W workers, B, S, bf16, random weights from
    `seed`, the `mesh/smollm-smoke` scenario's algorithm and wire. A
    warm-up round, then the timed round; counts reset just before the
    two and read just after, and held to `mesh_launches_per_round`
    twice. With MoE, also the aux loss of the trained global params on
    the last evaluation batch, finite and > 0. Returns the counts."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import swarm_dist
    from repro_torch.experiments import get_scenario
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Transformer
    from repro_torch.pytree import tree_leaves

    cfg = dataclasses.replace(get_arch(arch), num_layers=layers)
    spec = get_scenario("mesh/smollm-smoke")
    a = spec.algo
    dcfg = swarm_dist.DistSwarmConfig(num_spatial=W,
                                      local_steps=a.local_steps, tau=a.tau,
                                      hp=a.hp, comm=spec.comm)
    model = Transformer(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    state = swarm_dist.init_state(params, dcfg)
    step = swarm_dist.build_train_step(model.loss, dcfg)

    def batch(lead):
        toks = torch.randint(0, cfg.vocab_size, lead + (B, S),
                             generator=gen, device=dev)
        return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}

    runtime.reset_counts()
    times, losses = [], []
    for _ in range(2):
        draws = swarm_dist.sample_draws(gen, dcfg, state.global_params, dev,
                                        round_idx=state.round_idx)
        wb, eb = batch((W,)), batch(())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = step(state, wb, eb, draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(info.global_loss))
    counts = runtime.counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 2 * n for k, n in mesh_launches_per_round(
        cfg, len(tree_leaves(params)), W).items()}
    if cfg.num_experts:
        # MoE: the aux loss (in every loss above) of the trained global
        # params on the last evaluation batch, after the counts
        with torch.no_grad():
            aux = float(model.forward(state.global_params, eb)[1])
        check(math.isfinite(aux) and aux > 0,
              f"{arch} mesh round: MoE aux loss {aux}, expected finite > 0")
        note = f"{note}; MoE aux loss {aux:.6g}"
    print(f"[mesh] {arch} full width, depth cut to {layers} "
          f"({n_params} params, bf16, {note}) W={W} B={B} S={S}: round "
          f"{times[1]:.4f} s after a {times[0]:.4f} s warm-up "
          f"({W * B * S / times[1]:.1f} tok/s), global loss {losses}, "
          f"worker losses {info.losses.tolist()}, peak memory "
          f"{peak / 2**30:.2f} GiB; launches {counts} ({card})", flush=True)
    check(all(math.isfinite(x) for x in losses)
          and bool(torch.isfinite(info.losses).all()),
          f"{arch} mesh round: losses not finite")
    check(all(bool(torch.isfinite(x).all())
              for x in tree_leaves(state.global_params)),
          f"{arch} mesh round: global params not finite")
    check(counts == want, f"{arch} mesh rounds launched {counts}, "
                          f"expected {want}")
    del params, state, step, model
    torch.cuda.empty_cache()
    return counts


# -- this slice: the straggler and population engines ---------------------

FLEET_ROUNDS = 5
INT4_WIRE = ("comm.compressor=int4", "comm.downlink_compressor=int8")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.returncode == 0
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def straggler_small_spec():
    """`straggler/deadline-tight` cut to C = 4, width 2, 3 rounds, fading
    off, quorum 3, and the deadline between the airtimes of the workers
    at 18 and 16 dB (pathloss 0-6 dB over 20 dB): workers 2 and 3 go late
    whenever selected, so round 0 (everyone selected) delivers 2 < 3 and
    holds, parking all four, and round 1 drains them."""
    import dataclasses
    import torch
    from repro_torch.comm import budget, phy
    from repro_torch.configs.paper_cnn import paper_cnn
    from repro_torch.data.synthetic import MNIST_LIKE
    from repro_torch.experiments import get_scenario, override

    base = override(get_scenario("straggler/deadline-tight"),
                    "data.num_workers=4", "model.width_mult=2",
                    "data.n_local=64", "algo.local_epochs=1", "run.rounds=3",
                    "comm.quorum=3")
    base = dataclasses.replace(base, comm=base.comm._replace(fading="none"))
    comm = base.comm
    # the host's copy: only its leaf sizes enter the airtime (the payload
    # bytes), and the CPU draw keeps the deadline the run's own
    params = paper_cnn(MNIST_LIKE, 2, device="cpu").init(
        torch.Generator().manual_seed(0))
    air = budget.worker_airtime_s(
        comm, budget.worker_payload_bytes(comm, params, 4),
        phy.init_state(comm, 4).snr_db)
    return override(base, "comm.round_deadline_s="
                          f"{math.sqrt(float(air[1]) * float(air[2]))}")


def straggler_small_check(dev):
    """Phase 12: three rounds of the small straggler run on the card
    (through `run_prepared`, counts reset just before and read just after)
    against the same rounds on the CPU, same data, init and draws: masks
    and the straggler rows equal, global params within the f32 rule of
    the small mesh rounds, the held round's global params bitwise
    unchanged on the card."""
    import torch
    from repro_torch.bridge import tree_to_numpy
    from repro_torch.experiments import build, run_prepared
    from repro_torch.kernels import runtime
    from repro_torch.pytree import tree_leaves, tree_map

    spec = straggler_small_spec()
    cpu = build(spec, device="cpu")
    data = tree_map(lambda t: t.cpu().numpy(), tuple(cpu.aux["data"]))
    gpu = build(spec, device=dev, data=type(cpu.aux["data"])(*data),
                init_params=tree_to_numpy(cpu.state.global_params))
    draws, steps = [], {"cpu": [], "gpu": []}

    def record_draw(state):
        draws.append(cpu.draw(state))
        return draws[-1]

    def on_card(state):
        return type(draws[0])(*[None if v is None else tree_map(
            lambda t: t.to(dev), v) for v in draws[state.round_idx]])

    def stepper(prep, key):
        def step(state, d):
            nxt, m = prep.step(state, d)
            steps[key].append((state.global_params, nxt.global_params))
            return nxt, m
        return step

    crec = run_prepared(cpu._replace(draw=record_draw,
                                     step=stepper(cpu, "cpu")),
                        verbose=False).record
    runtime.reset_counts()
    grec = run_prepared(gpu._replace(draw=on_card, step=stepper(gpu, "gpu")),
                        verbose=False).record
    torch.cuda.synchronize()
    counts = runtime.counts()
    for k in ("selected", "delivered", "late", "drained", "buffered", "held"):
        check(crec[k] == grec[k], f"small straggler run: {k} card "
                                  f"{grec[k]} vs CPU {crec[k]}")
    check(sum(grec["late"]) > 0 and sum(grec["held"]) > 0
          and sum(grec["drained"]) > 0,
          f"small straggler run: late {grec['late']}, held {grec['held']}, "
          f"drained {grec['drained']}: expected some of each")
    worst, worst_abs = 0.0, 0.0
    for t, ((c0, c1), (g0, g1)) in enumerate(zip(steps["cpu"],
                                                 steps["gpu"])):
        if grec["held"][t]:
            check(all(torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                        tree_leaves(g1))),
                  f"small straggler run: held round {t} moved the global "
                  f"params on the card")
        # the dense f32 wire quantizes nothing, so no rounding level can
        # flip between card and CPU: the small mesh rounds' f32 rule, the
        # larger of MESH_PARAM_TOL and 1e-5 of the leaf's move this round
        for c, g, b0 in zip(tree_leaves(c1), tree_leaves(g1),
                            tree_leaves(c0)):
            err = float((g.cpu() - c).abs().max())
            tol = max(MESH_PARAM_TOL, 1e-5 * float((c - b0).abs().max()))
            worst, worst_abs = max(worst, err / tol), max(worst_abs, err)
    check(worst <= 1.0, f"small straggler run: card vs CPU global params "
                        f"off by {worst_abs:.3g} (worst/tol {worst:.3f})")
    print(f"[small] straggler C=4 w2, 3 rounds card vs CPU: late "
          f"{grec['late']}, drained {grec['drained']}, buffered "
          f"{grec['buffered']}, held {grec['held']} equal; held rounds "
          f"bitwise; global params max abs err {worst_abs:.3g} (worst/tol "
          f"{worst:.3f}, tol max({MESH_PARAM_TOL:g}, 1e-5 x the round's "
          f"move)); launches {counts}", flush=True)


def straggler_main_path(card: str) -> dict:
    """Phase 13: `straggler/deadline-tight` as registered (C = 50, CNN5
    w8, the dense f32 wire) for ROUNDS rounds, then with the int4 uplink
    and int8 downlink, counts reset just before and read just after each.
    The int4 run's dense route launches quant_pack and dequant_unpack once
    a leaf for the uplink (C = 50) and once for the downlink (C = 1) a
    round, the fused kernels never. Returns the int4 run's counts and its
    counts by worker count."""
    import torch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime

    out = {}, {}
    for label, sets in (("registered", ()), ("int4", INT4_WIRE)):
        spec = override(get_scenario("straggler/deadline-tight"),
                        f"run.rounds={ROUNDS}", *sets)
        runtime.reset_counts()
        t0 = time.perf_counter()
        rec = run(spec, verbose=False).record
        torch.cuda.synchronize()
        counts, by_workers = runtime.counts(), runtime.counts_by_workers()
        wall = time.perf_counter() - t0
        for t in range(ROUNDS):
            print(f"[straggler] {label} round {t + 1}: "
                  f"{rec['round_time_s'][t]:.4f} s, acc {rec['acc'][t]:.4f}, "
                  f"loss {rec['global_loss'][t]:.5f}, selected "
                  f"{rec['selected'][t]}/50, late {rec['late'][t]}, "
                  f"delivered {rec['delivered'][t]}, drained "
                  f"{rec['drained'][t]}, buffered {rec['buffered'][t]}, "
                  f"held {rec['held'][t]} ({card})", flush=True)
        print(f"[straggler] {label}: {ROUNDS} rounds of "
              f"straggler/deadline-tight (C=50, cnn5 w8) in {wall:.2f} s "
              f"incl. setup; launches {counts}, by worker count "
              f"{by_workers}", flush=True)
        check(all(math.isfinite(v) for v in rec["global_loss"])
              and all(0.0 <= v <= 1.0 for v in rec["acc"]),
              f"straggler {label}: loss or accuracy out of range")
        if label == "registered":
            check(any(v > 0 for v in rec["late"]),
                  f"straggler/deadline-tight: no upload late in "
                  f"{rec['late']}")
            check(without_conv(counts) == {},
                  f"straggler dense f32 run launched {counts}")
        else:
            per = LEAVES * ROUNDS
            want = {"quant_pack": 2 * per, "dequant_unpack": 2 * per}
            check(without_conv(counts) == want,
                  f"straggler int4 run launched {counts}, expected {want}")
            # the uplink at C = 50 and the downlink at C = 1, a leaf each
            want = {k: {1: per, 50: per} for k in want}
            check(without_conv(by_workers) == want,
                  f"straggler int4 run launched {by_workers} by worker "
                  f"count, expected {want}")
            out = counts, by_workers
    return out


def churn_path(card: str) -> None:
    """Phase 14: `faults/churn` as registered (K = 16, w2, 10 rounds):
    crashed workers transmit nothing, so transmitted <= selected every
    round and < in some round."""
    import torch
    from repro_torch.experiments import get_scenario, run
    from repro_torch.kernels import runtime

    spec = get_scenario("faults/churn")
    runtime.reset_counts()
    t0 = time.perf_counter()
    rec = run(spec, verbose=False).record
    torch.cuda.synchronize()
    counts, wall = runtime.counts(), time.perf_counter() - t0
    print(f"[churn] faults/churn (K=16, cnn5 w2, fault_prob 0.15 x 2 rounds,"
          f" quorum 4), {spec.run.rounds} rounds in {wall:.2f} s incl. setup "
          f"({card}); launches {counts}", flush=True)
    for key in ("selected", "transmitted", "late", "delivered", "drained",
                "held", "acc"):
        print(f"[churn]   {key}: {rec[key]}", flush=True)
    check(all(t <= s for t, s in zip(rec["transmitted"], rec["selected"]))
          and any(t < s for t, s in zip(rec["transmitted"], rec["selected"])),
          f"faults/churn: transmitted {rec['transmitted']} against selected "
          f"{rec['selected']}")
    check(all(math.isfinite(v) for v in rec["global_loss"]),
          "faults/churn: loss not finite")


def fleet_path(card: str) -> dict:
    """Phase 15: `fleet/million-score` as registered (P = 10^6, K = 16,
    AWGN, Rayleigh) and `fleet/million-uniform` with the int4 uplink and
    int8 downlink, FLEET_ROUNDS rounds each, counts reset just before and
    read just after each: the table's bytes, each round's cohort churn
    (slots reseated), and in the int4 run quant_pack_ef and wire_agg once
    a leaf a round under the reseated cohort. Returns the int4 counts."""
    import torch
    from repro_torch.core import population as pop
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime

    out = {}
    for name, sets in (("fleet/million-score", ()),
                       ("fleet/million-uniform", INT4_WIRE)):
        spec = override(get_scenario(name), f"run.rounds={FLEET_ROUNDS}",
                        *sets)
        runtime.reset_counts()
        t0 = time.perf_counter()
        res = run(spec, verbose=False)
        torch.cuda.synchronize()
        counts, wall = runtime.counts(), time.perf_counter() - t0
        rec = res.record
        K, P = rec["cohort_size"], rec["population"]
        prev, churn = list(range(K)), []
        for c in rec["cohort"]:
            churn.append(sum(a != b for a, b in zip(c, prev)))
            prev = c
        nbytes = pop.table_bytes(res.state.table)
        print(f"[fleet] {name}{' int4' if sets else ''}: P={P} K={K}, table "
              f"{nbytes} B on the card; {FLEET_ROUNDS} rounds in {wall:.2f} "
              f"s incl. setup ({card}); round times "
              f"{[round(v, 4) for v in rec['round_time_s']]} s; slots "
              f"reseated a round {churn}; acc {rec['acc']}; launches "
              f"{counts}", flush=True)
        check(nbytes == 36 * P == 36_000_000, f"{name}: table {nbytes} B")
        check(all(len(set(c)) == K and all(0 <= i < P for i in c)
                  for c in rec["cohort"]), f"{name}: cohorts not K-subsets")
        check(sum(churn[1:]) > 0, f"{name}: no slot reseated after round 0")
        check(all(math.isfinite(v) for v in rec["global_loss"]),
              f"{name}: loss not finite")
        if sets:
            per = LEAVES * FLEET_ROUNDS
            want = {"quant_pack_ef": per, "wire_agg": per,
                    "quant_pack": per, "dequant_unpack": per}
            check(without_conv(counts) == want,
                  f"{name} int4 launched {counts}, expected {want}")
            out = counts
        else:
            check(without_conv(counts) == {},
                  f"{name} (dense f32, AWGN) launched {counts}")
    return out


def mesh_straggler_path(card: str) -> dict:
    """Phase 16: `mesh/smollm-smoke` at full width with the straggler
    engine, ROUNDS rounds, counts reset just before and read just after:
    pathloss puts worker 1 6 dB below worker 0 and the deadline sits
    between their dense bf16 uploads' airtimes (`budget.worker_airtime_s`),
    so worker 1 goes late whenever selected (round 0 selects both) and
    its parked delta drains the next round. Flash, its backward and
    pso_update keep phase 11's counts a round."""
    import torch
    from repro_torch.comm import budget, phy
    from repro_torch.configs import get_arch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.models.transformer import Transformer
    from repro_torch.pytree import tree_leaves

    base = override(get_scenario("mesh/smollm-smoke"), *MESH_SPEC,
                    "comm.pathloss_spread_db=6", "comm.staleness_gamma=0.5")
    cfg = get_arch(MESH_ARCH)
    meta = Transformer(cfg).init(None, "meta")
    air = budget.worker_airtime_s(
        base.comm, budget.worker_payload_bytes(base.comm, meta, MESH_W),
        phy.init_state(base.comm, MESH_W).snr_db)
    deadline = math.sqrt(float(air[0]) * float(air[1]))
    spec = override(base, f"comm.round_deadline_s={deadline}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec, verbose=False)
    torch.cuda.synchronize()
    counts, wall = runtime.counts(), time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec = result.record
    for t in range(ROUNDS):
        print(f"[mesh-straggler] round {t + 1}"
              f"{' (warm-up)' if t == 0 else ''}: {rec['step_time_s'][t]:.4f}"
              f" s, global loss {rec['global_loss'][t]:.5f}, worker losses "
              f"{rec['worker_losses'][t]}, selected {rec['selected'][t]}/"
              f"{MESH_W}, late {rec['late'][t]}, drained {rec['drained'][t]}, "
              f"buffered {rec['buffered'][t]}, held {rec['held'][t]} "
              f"({card})", flush=True)
    steady = rec["step_time_s"][1:]
    print(f"[mesh-straggler] {MESH_ARCH} full width W={MESH_W} B={MESH_B} "
          f"S={MESH_S}, deadline {deadline:.1f} s between airtimes "
          f"{float(air[0]):.1f} / {float(air[1]):.1f} s: "
          f"{statistics.mean(steady):.4f} s a round after the warm-up, peak "
          f"memory {peak / 2**30:.2f} GiB, {wall:.1f} s with init ({card}); "
          f"launches {counts}", flush=True)
    check(rec["late"][0] == 1.0 and any(v > 0 for v in rec["drained"][1:]),
          f"mesh straggler: late {rec['late']}, drained {rec['drained']}")
    check(all(math.isfinite(v) for v in rec["global_loss"]),
          "mesh straggler: global loss not finite")
    check(all(bool(torch.isfinite(x).all())
              for x in tree_leaves(result.state.global_params)),
          "mesh straggler: global params not finite")
    per_round = mesh_launches_per_round(
        cfg, len(tree_leaves(result.state.global_params)))
    for t in range(ROUNDS):
        check(rec["launches"][t] == per_round,
              f"mesh straggler round {t + 1} launched {rec['launches'][t]}, "
              f"expected {per_round}")
    del result
    torch.cuda.empty_cache()
    return counts


# -- this slice: the obs event stream and mesh checkpoints ----------------

STAGES = ("LocalUpdate", "ScoreSelect", "Uplink", "Aggregate", "Downlink",
          "BestTracking")
# each wire kernel's device function, as the Chrome trace names it, and
# its launches in the one profiled round (quant_pack_kernel serves both
# quant_pack and quant_pack_ef)
TRACE_KERNELS = {"quant_pack_kernel": 2 * LEAVES, "dequant_kernel": LEAVES,
                 "wire_agg_kernel": LEAVES}
# blocks of (off, on, on, off) runs that time the obs stream's cost
TURN_BLOCKS = 3


def obs_path(card: str, main_rec: dict, main_counts: dict) -> dict:
    """Phase 17: first the obs stream's cost, from runs with obs off and on
    in turns (no profiler). Then `low-bandwidth-int4` at full width for
    ROUNDS rounds with the obs stream, its CSV mirror and a one-round
    profiler window (round 2), counts reset just before and read just
    after. The stream, read back with the port's reader: its round rows
    equal the record's bit for bit, its stages cover the pipeline, Step
    and Eval, its kernel events name the four wire kernels on the card
    (not the plain versions), and its run_end carries final_acc; the
    launches equal the obs-off main run's; the Chrome trace holds the
    stage ranges and each wire kernel's device launches. Prints each
    round's time beside the obs-off main run's and each round's
    per-stage host times."""
    import shutil
    import tempfile
    import torch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.obs import read_events

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="obs-", dir=ROOT / "build"))
    spec = override(get_scenario("low-bandwidth-int4"),
                    f"run.rounds={ROUNDS}", "run.obs.enabled=true",
                    "run.obs.csv=true", f"run.obs.dir={tmp}",
                    f"run.obs.profile_dir={tmp / 'prof'}",
                    "run.obs.profile_rounds=1")
    # the stream's cost first: a run after a profiled round reads slow
    # (PERF.md section 7). Runs with obs off and on in turns, no
    # profiler, rounds 2-3 of each (round 1 warms up); the cost counts
    # as resolved only where the two sides' samples do not overlap
    steady = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * TURN_BLOCKS:
        ab = override(spec, f"run.obs.enabled={mode == 'on'}",
                      "run.obs.csv=false", "run.obs.profile_dir=none")
        steady[mode] += run(ab, verbose=False).record["round_time_s"][1:]
    off, on = sorted(steady["off"]), sorted(steady["on"])
    cost = statistics.median(on) - statistics.median(off)
    verdict = (f"obs cost resolved: {cost:+.4f} s a round"
               if on[0] > off[-1] or on[-1] < off[0] else
               f"obs cost not resolved: the medians differ by {cost:+.4f} "
               f"s, inside the spread (off {off[0]:.4f}-{off[-1]:.4f}, on "
               f"{on[0]:.4f}-{on[-1]:.4f})")
    print(f"[obs] in turns ((off, on, on, off) x {TURN_BLOCKS}), rounds "
          f"2-3 of each run: obs off median {statistics.median(off):.4f} s "
          f"{[round(v, 4) for v in steady['off']]}, obs on median "
          f"{statistics.median(on):.4f} s "
          f"{[round(v, 4) for v in steady['on']]}; {verdict} ({card})",
          flush=True)
    runtime.reset_counts()
    result = run(spec, verbose=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    rec = result.record
    evs = read_events(result.events_path)
    rounds = [e for e in evs if e.kind == "round"]
    hist = json.loads(json.dumps(result.to_dict()))["metrics"]
    check([e.round for e in rounds] == list(range(ROUNDS)),
          f"obs: round events {[e.round for e in rounds]}")
    check({k for k, v in hist.items() if isinstance(v, list)
           and len(v) == ROUNDS} == set(rounds[0].metrics),
          "obs: round event keys differ from the record's per-round keys")
    check(all(hist[k][e.round] == v for e in rounds
              for k, v in e.metrics.items()),
          "obs: round events differ from the record's rows")
    stages = [e for e in evs if e.kind == "stage"]
    names = {e.stage for e in stages}
    check(set(STAGES) | {"Step", "Eval"} <= names,
          f"obs: stage spans {sorted(names)}")
    check({e.phase for e in stages} == {"host"},
          "obs: a stage span not phase=host")
    kernels = [e for e in evs if e.kind == "kernel"]
    check({e.name for e in kernels} == set(MAIN_BITS)
          and all(e.backend == "cuda" and not e.interpret for e in kernels)
          and all(e.info["bits"] == MAIN_BITS[e.name] for e in kernels),
          f"obs: kernel events {[(e.name, e.backend, e.interpret, e.info) for e in kernels]}")
    check(evs[0].kind == "run_start" and evs[-1].kind == "run_end"
          and evs[-1].status == "ok"
          and evs[-1].totals.get("final_acc") == rec["final_acc"],
          f"obs: stream ends {evs[-1]}")
    for name in MAIN_BITS:
        check(counts.get(name, 0) == main_counts[name] == ROUNDS * LEAVES,
              f"obs: {name} launched {counts.get(name, 0)} times, the "
              f"obs-off run {main_counts[name]}")
    trace = tmp / "prof" / f"{evs[0].run_id}.trace.json"
    check(trace.exists(), f"obs: no Chrome trace at {trace}")
    tev = json.loads(trace.read_text())["traceEvents"]
    tnames = {e.get("name") for e in tev}
    check(set(STAGES) | {"round"} <= tnames,
          f"obs: trace ranges lack {sorted(set(STAGES) - tnames)}")
    launched = {k: sum(1 for e in tev if e.get("cat") == "kernel"
                       and k in e.get("name", "")) for k in TRACE_KERNELS}
    check(launched == TRACE_KERNELS,
          f"obs: the trace's wire kernel launches {launched}, expected "
          f"{TRACE_KERNELS}")
    csv_rows = (Path(result.events_path).with_suffix(".csv").read_text()
                .strip().splitlines())
    check(len(csv_rows) == 1 + ROUNDS, f"obs: {len(csv_rows)} CSV lines")
    for t in range(ROUNDS):
        span = {e.stage: e.dur_s for e in stages if e.round == t}
        inner = sum(span[k] for k in STAGES)
        check(inner <= span["Step"],
              f"obs: round {t + 1} stages {inner} s over Step "
              f"{span['Step']} s")
        print(f"[obs] round {t + 1}{' (profiled)' if t == 1 else ''}: "
              f"{rec['round_time_s'][t]:.4f} s obs on, "
              f"{main_rec['round_time_s'][t]:.4f} s obs off (phase 5); "
              f"host ms Step {1e3 * span['Step']:.2f} = stages "
              f"{1e3 * inner:.2f} (" + ", ".join(
                  f"{k} {1e3 * span[k]:.2f}" for k in STAGES)
              + f") + sync and the rest; Eval {1e3 * span['Eval']:.2f} "
              f"({card})", flush=True)
    print(f"[obs] {len(evs)} events, {len(kernels)} kernel events "
          f"({', '.join(sorted(e.name for e in kernels))} on cuda), "
          f"launches {counts}; trace {trace.stat().st_size} B with "
          f"{launched} device launches in round 2", flush=True)
    shutil.rmtree(tmp)
    return counts


def mesh_checkpoint_path(card: str) -> dict:
    """Phase 18: `mesh/smollm-smoke` at full width (phase 11's spec) for 2
    rounds with `run.ckpt_dir` and the obs stream: the checkpoints of
    rounds 0 and 1, the latest restored into a template of the live
    params on the card and compared bitwise; phase 11's launch counts a
    round; the checkpoint's size, and the time of one more save (device
    to host, savez, rename) and of the restore. Removes the directory."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.obs import read_events
    from repro_torch.pytree import tree_leaves

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build"))
    spec = override(get_scenario("mesh/smollm-smoke"), *MESH_SPEC,
                    "run.rounds=2", f"run.ckpt_dir={tmp / 'ck'}",
                    "run.obs.enabled=true", f"run.obs.dir={tmp}")
    torch.cuda.empty_cache()
    runtime.reset_counts()
    result = run(spec, verbose=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    rec = result.record
    live = result.state.global_params
    check(rec["ckpt_steps"] == [0, 1], f"ckpt: steps {rec['ckpt_steps']}")
    per_round = mesh_launches_per_round(get_arch(MESH_ARCH),
                                        len(tree_leaves(live)))
    check(rec["launches"] == [per_round] * 2,
          f"ckpt: launches {rec['launches']}, expected {per_round} a round")
    mgr = CheckpointManager(tmp / "ck")
    t0 = time.perf_counter()
    step, back = mgr.restore(like=live)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == 1 and all(
        a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(tree_leaves(back), tree_leaves(live))),
        "ckpt: the restored params differ from the final global params")
    del back
    size = (tmp / "ck" / "ckpt_00000001.npz").stat().st_size
    n_params = sum(x.numel() for x in tree_leaves(live))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(2, live, metadata={"arch": MESH_ARCH})
    save_s = time.perf_counter() - t0
    evs = read_events(result.events_path)
    steps = [e.dur_s for e in evs if e.kind == "stage" and e.stage == "Step"]
    check(evs[-1].kind == "run_end" and evs[-1].status == "ok"
          and evs[-1].totals.get("final_loss") == rec["global_loss"][-1]
          and len(steps) == 2, f"ckpt: the stream ends {evs[-1]}")
    print(f"[ckpt] {MESH_ARCH} full width, 2 rounds with run.ckpt_dir and "
          f"obs: step {rec['step_time_s'][0]:.4f} / "
          f"{rec['step_time_s'][1]:.4f} s (Step spans {steps[0]:.4f} / "
          f"{steps[1]:.4f} s), global loss {rec['global_loss']}, "
          f"ckpt_steps {rec['ckpt_steps']} ({card})", flush=True)
    print(f"[ckpt] checkpoint {size} B ({size / 2**20:.1f} MiB) for "
          f"{n_params} params; one save {save_s:.3f} s (device to host, "
          f"savez, rename: {size / save_s / 1e9:.2f} GB/s), restore into "
          f"the card's template {restore_s:.3f} s, bitwise equal ({card})",
          flush=True)
    del result, live
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    return counts


# the round columns a paper record must repeat bit for bit (F2)
REPEAT_KEYS = ("acc", "global_loss", "selected", "delivered", "late",
               "drained", "buffered", "held", "uploaded_params", "bytes_up",
               "bytes_down", "airtime_s", "energy_j", "mean_snr_db")


def determinism_path(card: str, main_rec: dict) -> None:
    """Phase 19 (F2): `low-bandwidth-int4` at full width (ROUNDS rounds)
    twice more and the int4 `straggler/deadline-tight` run twice in this
    process: every recorded loss, accuracy and count bit for bit equal,
    the first with phase 5's record too. Prints the round times beside
    phase 5's."""
    import torch
    from repro_torch.experiments import get_scenario, override, run

    specs = {"low-bandwidth-int4": override(
                 get_scenario("low-bandwidth-int4"), f"run.rounds={ROUNDS}"),
             "straggler int4": override(
                 get_scenario("straggler/deadline-tight"),
                 f"run.rounds={ROUNDS}", *INT4_WIRE)}
    for label, spec in specs.items():
        recs = [run(spec, verbose=False).record for _ in range(2)]
        torch.cuda.synchronize()
        if label == "low-bandwidth-int4":
            recs.insert(0, main_rec)
        for k in REPEAT_KEYS:
            vals = [r.get(k) for r in recs]
            check(all(v == vals[0] for v in vals[1:]),
                  f"F2: {label} runs differ in {k}: {vals}")
        times = "; ".join(f"{[round(t, 4) for t in r['round_time_s']]}"
                          for r in recs)
        print(f"[F2] {label}: {len(recs)} runs equal bit for bit in "
              f"{', '.join(REPEAT_KEYS)}; loss {recs[0]['global_loss']}, "
              f"selected {recs[0]['selected']}, delivered "
              f"{recs[0]['delivered']}, late {recs[0].get('late')}; "
              f"s/round {times}"
              + (" (the first is phase 5's)" if len(recs) == 3 else "")
              + f" ({card})", flush=True)


SWEEP_ARGV = ["--sweep", "paper/fig3-iid,paper/fig3-noniid1,paper/fig3-noniid2",
              "--sweep-axis", "algo.algorithm=fedavg,dsl,multi_dsl,mdsl",
              "--jobs", "2", "--set", f"run.rounds={ROUNDS}"]
SWEEP_CHECKED = (0, 7, 11)       # fedavg/iid, mdsl/noniid1, mdsl/noniid2
L2_COPIES = 4                    # 4 x 30 MB: past the H100's 50 MB L2


def sweep_path(card: str) -> dict:
    """Phase 20: the paper's Fig.-3 grid through the CLI, `python -m
    repro_torch.launch.train --sweep ... --jobs 2` (3 cases x 4
    algorithms at full width, C = 50, CNN5 w8, ROUNDS rounds: 12 cells
    over 2 spawned processes on the card). Every cell's artifact has
    finite losses; the checked cells' records equal, bit for bit apart
    from the round times, the same cell run with jobs = 1 here, with the
    same launches. Prints each cell's line (wall and launches, the
    child's own) and the grid's wall time; returns the grid's launches."""
    import ast
    import os
    import re
    import tempfile
    from repro_torch.experiments import sweep
    from repro_torch.experiments.runner import load_result, sweep_cells
    from repro_torch.launch.train import build_sweep_specs, parser

    specs = build_sweep_specs(parser().parse_args(SWEEP_ARGV))
    cells = sweep_cells(specs)
    for _, path in cells:
        path.unlink(missing_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *SWEEP_ARGV], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stderr.splitlines()
             if ln.startswith("[sweep]")]
    for ln in lines:
        print(f"{ln} ({card})", flush=True)
    check(proc.returncode == 0, f"sweep CLI failed ({proc.returncode}):\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    check(len(lines) == len(cells) == 12,
          f"sweep: {len(lines)} cell lines for {len(cells)} cells")
    launches = [ast.literal_eval(re.search(r"launches=(\{.*?\})", ln)
                                 .group(1)) for ln in lines]
    print(f"[sweep] grid of {len(cells)} cells (3 cases x 4 algorithms, "
          f"C=50, cnn5 w8, {ROUNDS} rounds) over 2 spawned processes: "
          f"{wall:.1f} s wall for the CLI call, process start included; "
          f"{proc.stdout.strip()} ({card})", flush=True)
    recs = [load_result(path)["metrics"] for _, path in cells]
    check(all(math.isfinite(v) for r in recs for v in r["global_loss"]),
          "sweep: a cell's loss is not finite")
    drop = ("round_time_s",)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i in SWEEP_CHECKED:
            spec, _ = cells[i]
            t1 = time.perf_counter()
            res = sweep([spec], out_dir=tmp)[0]
            one = time.perf_counter() - t1
            mine = json.loads(json.dumps(res.record))
            theirs = recs[i]
            same = ({k: v for k, v in mine.items() if k not in drop}
                    == {k: v for k, v in theirs.items() if k not in drop})
            check(same, f"sweep: cell {i} ({spec.algo.algorithm}/"
                        f"{spec.data.case}) differs from its jobs = 1 run")
            print(f"[sweep] cell {i} {spec.algo.algorithm}/{spec.data.case}:"
                  f" the jobs=2 record equals the jobs=1 run here bit for "
                  f"bit (final acc {theirs['final_acc']}, loss "
                  f"{theirs['global_loss']}, selected {theirs['selected']});"
                  f" jobs=1 cell {one:.2f} s ({card})", flush=True)
    total = {}
    for la in launches:
        for k, n in la.items():
            total[k] = total.get(k, 0) + n
    return total


def pso_every_step_path(card: str) -> dict:
    """Phase 21: `low-bandwidth-int4` at full width with
    `algo.pso_every_step=true` for 2 rounds, counts reset just before
    and read just after: pso_update launches (n_local / bs) x E steps x
    10 leaves a round, the wire kernels as in phase 5. Then the kernel
    route of one step (`pso.pso_step` on the run's final worker state,
    the global best and seeded gradients) against the plain per-step
    formula on the same stacked leaves, bitwise in f32, and pso_update's
    times at the largest of them (fc1/w, C = 50 x 784 x 32). Returns the
    run's counts and that leaf's timing row."""
    import torch
    from repro_torch.core import pso
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.kernels.pso_update import ops as pops
    from repro_torch.kernels.pso_update import ref as pref
    from repro_torch.pytree import tree_leaves, tree_map

    rounds = 2
    spec = override(get_scenario("low-bandwidth-int4"),
                    f"run.rounds={rounds}", "algo.pso_every_step=true")
    a, d = spec.algo, spec.data
    steps = (d.n_local // a.batch_size) * a.local_epochs
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec, verbose=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    rec = result.record
    want = dict({k: rounds * LEAVES for k in MAIN_BITS},
                pso_update=steps * LEAVES * rounds)
    check(without_conv(counts) == want,
          f"per-step Eq. 8 launched {counts}, expected {want}")
    check(all(math.isfinite(v) for v in rec["global_loss"]),
          "per-step Eq. 8: loss not finite")
    print(f"[eq8-step] {rounds} rounds of low-bandwidth-int4 with "
          f"pso_every_step ({steps} steps x {LEAVES} leaves a round): "
          f"s/round {[round(t, 4) for t in rec['round_time_s']]}, loss "
          f"{rec['global_loss']}, acc {rec['acc']}, selected "
          f"{rec['selected']}; {wall:.2f} s incl. setup; launches {counts} "
          f"({card})", flush=True)

    st = result.state
    w = st.workers
    gen = torch.Generator(device="cuda").manual_seed(7)
    grads = tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                           device=x.device), w.params)
    C = d.num_workers
    draw = pso.sample_coefficients(gen, C, "cuda")
    co = pso.coefficients(draw)
    lr, clip = a.hp.learning_rate, a.hp.velocity_clip
    got = pso.pso_step(w, st.gbest.params, grads, co, lr, a.hp)
    worst = 0
    for gw, gv, x, v, wl, wg, g in zip(
            tree_leaves(got.params), tree_leaves(got.velocity),
            *(tree_leaves(t) for t in (w.params, w.velocity, w.best_params,
                                       st.gbest.params, grads))):
        b = lambda c: c.reshape((-1,) + (1,) * (x.ndim - 1))  # noqa: E731
        pv = (b(co.c0) * v + b(co.c1) * (wl - x) + b(co.c2) * (wg - x)
              - lr * g)
        if clip > 0:
            pv = pv.clamp(-clip, clip)
        pw = x + pv
        check(torch.equal(gv, pv) and torch.equal(gw, pw),
              f"per-step Eq. 8: kernel differs from the plain formula on a "
              f"{tuple(x.shape)} leaf")
        worst = max(worst, float((gw - pw).abs().max()))
    print(f"[eq8-step] one step of {len(tree_leaves(w.params))} stacked "
          f"leaves (C={C}) through pso_update equals the plain per-step "
          f"formula bit for bit (max |diff| {worst}) ({card})", flush=True)

    x, v, wl, wg, g = max(
        zip(*(tree_leaves(t) for t in (w.params, w.velocity, w.best_params,
                                       st.gbest.params, grads))),
        key=lambda leaf: leaf[0].numel())
    co = torch.stack([co.c0, co.c1, co.c2, torch.full_like(co.c0, clip)],
                     dim=1).contiguous()
    args = tuple(t.contiguous() for t in (x, v, wl, wg, -lr * g))
    n = wg.numel()
    nbytes, _ = cost(pops.PSO_UPDATE, co, *args)
    bnd, by = kernel_bound(pops.PSO_UPDATE, co, *args)
    # one launch moves 30 MB, which the card's 50 MB L2 would keep
    # between repeats: the timed launches cycle through L2_COPIES copies
    # of the inputs, so each reads them from device memory as the step
    # loop's launches, a leaf apart, mostly do
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(L2_COPIES - 1)]
    turn = iter(range(1 << 30))

    def launch(fn):
        return lambda: fn(co, *sets[next(turn) % L2_COPIES])

    row = {"max_abs_err": worst, "library_ms": None, "bound_ms": bnd,
           "bound_by": by,
           "ms": graph_ms(launch(pops.pso_update), 4 * L2_COPIES),
           "eager_ms": time_ms(launch(pops.pso_update), 4 * L2_COPIES),
           "plain_ms": time_ms(launch(pref.pso_update_ref), L2_COPIES)}
    print(f"[time] pso_update per-step Eq. 8 (C={C}, leaf "
          f"{tuple(x.shape[1:])}, f32, {L2_COPIES} copies of the inputs in "
          f"turn): device {row['ms']:.4f} ms/launch, eager call "
          f"{row['eager_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library none, bound {bnd:.4g} ms ({by}, {nbytes} B) ({card})",
          flush=True)
    del sets
    return counts, row


BENCH_KEYS = {
    "fig3_accuracy": {"results", "claims", "rounds", "dataset", "quick"},
    "fig1_metric": {"alphas", "label_ratio", "wd", "fedavg_acc", "eta",
                    "coeffs", "r2_train", "r2_test", "gaps", "dataset"},
    "comm_efficiency": {"n_params", "C", "rounds", "target_acc",
                        "aggregator", "downlink_compressor",
                        "adaptive_bits", "ref_algorithm", "ref_dense_bytes",
                        "fedavg_dense_bytes", "mdsl_dense_bytes",
                        "selection_saving_frac", "fedavg_total_uploads",
                        "mdsl_total_uploads", "saving_frac",
                        "mdsl_selected_trace", "fedavg_acc", "mdsl_acc",
                        "sweep", "phy_sweep", "byzantine_sweep",
                        "straggler_sweep"},
}


def figure_drivers(card: str) -> None:
    """Phase 22: the paper's figure drivers on the card through their
    CLIs: `fig3_accuracy --quick --jobs 2` (12 cells through the sweep),
    `fig1_metric --quick`, `comm_efficiency --quick --json` (with the
    straggler sweep) and `population_bench --quick --json` (P up to
    10^6). Each record has the reference's keys (the two --json records
    those of the root BENCH_stragglers.json and BENCH_population.json);
    prints each one's headline rows and wall time."""
    import contextlib
    import io
    from repro_torch.figures import (comm_efficiency, fig1_metric,
                                     fig3_accuracy, population_bench)
    from repro_torch.figures.common import ARTIFACTS, BENCH_OUT

    def drive(mod, argv):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main(argv)
        return time.perf_counter() - t0, out.getvalue()

    wall, _ = drive(fig3_accuracy, ["--quick", "--jobs", "2"])
    rec = json.loads((BENCH_OUT / "fig3_accuracy__torch.json").read_text())
    check(set(rec) == BENCH_KEYS["fig3_accuracy"]
          and len(rec["results"]) == 12, f"fig3: record keys {sorted(rec)}")
    print(f"[fig3] quick, 12 cells over 2 processes in {wall:.1f} s: final "
          f"acc " + ", ".join(f"{k} {v['final_acc']:.3f}"
                              for k, v in rec["results"].items())
          + f"; claims {rec['claims']} ({card})", flush=True)

    wall, _ = drive(fig1_metric, ["--quick"])
    rec = json.loads((BENCH_OUT / "fig1_metric__torch.json").read_text())
    check(set(rec) == BENCH_KEYS["fig1_metric"]
          and all(math.isfinite(v) for v in rec["fedavg_acc"]),
          f"fig1: record {sorted(rec)}")
    print(f"[fig1] quick in {wall:.1f} s: alphas {rec['alphas']}, FedAvg "
          f"acc {[round(v, 4) for v in rec['fedavg_acc']]}, eta "
          f"{[round(v, 3) for v in rec['eta']]}; Eq. 2 fit "
          f"{[round(v, 4) for v in rec['coeffs']]}, R2 train "
          f"{rec['r2_train']:.3f} test {rec['r2_test']}; gaps "
          f"{rec['gaps']} ({card})", flush=True)

    wall, _ = drive(comm_efficiency, ["--quick", "--json"])
    rec = json.loads((BENCH_OUT / "comm_efficiency__torch.json").read_text())
    check(set(rec) == BENCH_KEYS["comm_efficiency"],
          f"comm_efficiency: record keys {sorted(rec)}")
    srec = json.loads((ARTIFACTS / "BENCH_stragglers__torch.json")
                      .read_text())
    want = json.loads((ROOT / "BENCH_stragglers.json").read_text())
    check(set(srec) == set(want) and set(srec["runs"]) == set(want["runs"])
          and all(set(srec["runs"][k]) == set(want["runs"][k])
                  for k in want["runs"]),
          "comm_efficiency --json: keys differ from BENCH_stragglers.json")
    print(f"[comm] quick --json in {wall:.1f} s: selection saving "
          f"{rec['selection_saving_frac']:.3f}, final acc " + ", ".join(
              f"{k} {v['final_acc']:.3f}" for k, v in rec["sweep"].items())
          + "; stragglers " + ", ".join(
              f"{k} {v['final_acc']:.3f} late {sum(v['late'] or [0])}"
              for k, v in srec["runs"].items()) + f" ({card})", flush=True)

    wall, _ = drive(population_bench, ["--quick", "--json"])
    rec = json.loads((ARTIFACTS / "BENCH_population__torch.json")
                     .read_text())
    want = json.loads((ROOT / "BENCH_population.json").read_text())
    check(set(rec) == set(want) and len(rec["rows"]) == len(want["rows"])
          and all(set(r) == set(w) for r, w in zip(rec["rows"],
                                                  want["rows"]))
          and [r["population"] for r in rec["rows"]]
          == [1_000, 100_000, 1_000_000],
          "population_bench --json: keys differ from BENCH_population.json")
    for r in rec["rows"]:
        print(f"[population] P={r['population']} K={r['cohort']}: round "
              f"{r['round_s']} s (first {r['round0_s']}), schedule "
              f"{r['schedule_s']} s, scatter {r['scatter_s']} s, table "
              f"{r['table_mb']} MB, build {r['build_s']} s ({card})",
              flush=True)
    print(f"[population] quick --json in {wall:.1f} s ({card})", flush=True)


# -- this slice: the scan's backward, RecurrentGemma-9B training and the
# xLSTM blocks -------------------------------------------------------------

RG_ARCH = "recurrentgemma-9b"
XLSTM_ARCH = "xlstm-350m"
# the scan's backward: RecurrentGemma-9B's training shape first (its
# rglru layers at B 2, S 2048), then the forward's ragged shapes
SCAN_BWD_SHAPES = [(2, 2048, 4096), (3, 1000, 1000), (2, 1, 128),
                   (1, 4097, 4096)]
SCAN_BWD_ULPS = 2          # against autograd of the plain loop, per element
# one worker: the mesh engine keeps per-worker f32 error-feedback
# residuals and bf16 params, velocities and bests of the whole model, and
# RecurrentGemma-9B's 256,000 x 4096 embedding alone is 1.05 B of its
# 1.71 B params at depth 3; at W 2 the first round ran out of the card's
# 80 GB in the uplink (73.1 GiB held, 7.8 more asked for)
RG_MESH_LAYERS, RG_MESH_W, RG_MESH_B, RG_MESH_S = 3, 1, 2, 2048
XLSTM_SERVE_BATCH, XLSTM_SERVE_PROMPT, XLSTM_SERVE_GEN = 4, 4096, 32
XLSTM_SMALL_PROMPT = 300   # past one mLSTM chunk of 256
XLSTM_MESH_ROUNDS, XLSTM_MESH_S = 2, 2048


def scan_bwd_checks(dev):
    """Phase 23: the scan's backward kernel against its plain version on
    the card, bitwise (dh0, da, db) at every shape; at the training shape
    and one ragged shape also against autograd of `rglru_scan_ref`
    within SCAN_BWD_ULPS f32 ulps an element; device, eager and plain
    times and the bound at the training shape, and the same of the
    forward there. Returns {"rglru_scan_bwd": row, "rglru_scan": row}."""
    import torch
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.rglru_scan import ref as sref

    g = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    for i, (B, S, D) in enumerate(SCAN_BWD_SHAPES[::-1]):
        a = torch.rand((B, S, D), generator=g, device=dev) * 0.5 + 0.499
        b = 0.1 * torch.randn((B, S, D), generator=g, device=dev)
        h0 = torch.randn((B, D), generator=g, device=dev)
        gs = torch.randn((B, S, D), generator=g, device=dev)
        states = sops.rglru_scan_raw(h0, a, b)
        got = sops.rglru_scan_bwd_raw(h0, a, states, gs)
        want = sref.rglru_scan_bwd_ref(h0, a, states, gs)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"rglru_scan_bwd ({B}, {S}, {D}): not bitwise equal to the "
              f"plain version (max abs err {err})")
        line = (f"[check] rglru_scan_bwd B={B} S={S} D={D} f32 (plan "
                f"{sops._bwd_plan(B, S, D)}): dh0, da, db bitwise equal to "
                f"the plain version")
        if (B, S, D) in (SCAN_BWD_SHAPES[0], SCAN_BWD_SHAPES[1]):
            leaves = [t.clone().requires_grad_() for t in (h0, a, b)]
            auto = torch.autograd.grad(sref.rglru_scan_ref(*leaves), leaves,
                                       gs)
            ulps = max(float(((x - y).abs() / ulp(y).clamp_min(2.0 ** -149))
                             .max()) for x, y in zip(got, auto))
            check(ulps <= SCAN_BWD_ULPS, f"rglru_scan_bwd ({B}, {S}, {D}): "
                  f"{ulps} ulps from autograd of the plain loop (tol "
                  f"{SCAN_BWD_ULPS})")
            line += f"; {ulps:g} ulps from autograd of the plain loop"
            del leaves, auto
        print(line, flush=True)
        if i < len(SCAN_BWD_SHAPES) - 1:
            del a, b, h0, gs, states, got, want
    # the training shape (the last one walked): times and bounds
    n = B * S * D
    bnd, by = kernel_bound(sops.RGLRU_SCAN_BWD, h0, a, states, gs)
    t = {"ms": graph_ms(lambda: sops.rglru_scan_bwd_raw(h0, a, states, gs),
                        10),
         "eager_ms": time_ms(lambda: sops.rglru_scan_bwd_raw(h0, a, states,
                                                             gs), 10),
         "plain_ms": time_ms(lambda: sref.rglru_scan_bwd_ref(h0, a, states,
                                                             gs), 3),
         "library_ms": None}
    rows["rglru_scan_bwd"] = dict(t, max_abs_err=err, bound_ms=bnd,
                                  bound_by=by)
    print(f"[time] rglru_scan_bwd training shape (B={B} S={S} D={D}): "
          f"device {t['ms']:.4f} ms/launch, eager call {t['eager_ms']:.4f} "
          f"ms, plain {t['plain_ms']:.3f} ms, library none, bound {bnd:.4g} "
          f"ms ({by}, {20 * n + 8 * B * D} B; {bnd / t['ms']:.1%} of it)",
          flush=True)
    fbnd, fby = kernel_bound(sops.RGLRU_SCAN, h0, a, b)
    ft = {"ms": graph_ms(lambda: sops.rglru_scan_raw(h0, a, b), 10),
          "eager_ms": time_ms(lambda: sops.rglru_scan_raw(h0, a, b), 10),
          "plain_ms": time_ms(lambda: sref.rglru_scan_ref(h0, a, b), 3),
          "library_ms": None}
    fwant = sref.rglru_scan_ref(h0, a, b)
    check(torch.equal(sops.rglru_scan_raw(h0, a, b), fwant),
          "rglru_scan at the training shape: not bitwise the plain version")
    rows["rglru_scan"] = dict(ft, max_abs_err=0.0, bound_ms=fbnd,
                              bound_by=fby)
    print(f"[time] rglru_scan training shape (B={B} S={S} D={D}): device "
          f"{ft['ms']:.4f} ms/launch, eager call {ft['eager_ms']:.4f} ms, "
          f"plain {ft['plain_ms']:.3f} ms, bound {fbnd:.4g} ms ({fby}; "
          f"{fbnd / ft['ms']:.1%} of it)", flush=True)
    del a, b, h0, gs, states, got, want, fwant
    torch.cuda.empty_cache()
    return rows


def small_xlstm_serve_check(dev):
    """Phase 26: reduced xlstm-350m (mlstm, slstm) in f32, a prompt past
    one mLSTM chunk, on the card against the CPU from the same params
    (through the bridge): logits within SERVE_LOGIT_TOL, greedy tokens
    equal, no kernel launched."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_arch(XLSTM_ARCH).reduced(),
                              dtype="float32")
    model = Transformer(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(26), "cpu")
    gpu_params = bridge.transformer_params_from_numpy(
        cfg, bridge.tree_to_numpy(cpu_params), dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, XLSTM_SMALL_PROMPT),
                           generator=torch.Generator().manual_seed(27))
    want = generate(model, cpu_params, tokens, 8)
    got = generate(model, gpu_params, tokens.to(dev), 8)
    err = float((got.logits.cpu() - want.logits).abs().max())
    check(err <= SERVE_LOGIT_TOL,
          f"small xLSTM serve: card vs CPU logits max abs err {err}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          "small xLSTM serve: greedy tokens differ between card and CPU")
    check(got.launches == {"prefill": {}, "decode": {}},
          f"small xLSTM serve: launches {got.launches}")
    print(f"[small] serve {cfg.name} f32 B=2 prompt {XLSTM_SMALL_PROMPT} gen "
          f"8, card vs CPU: logits max abs err {err:.3g} (tol "
          f"{SERVE_LOGIT_TOL:g}), greedy tokens equal, no launches",
          flush=True)


def xlstm_serve_path(dev, card: str) -> None:
    """Phase 27: xLSTM-350M served at full width through the user's entry
    point (batch 4, prompt 4096, gen 32, bf16, random weights), counts
    reset just before and read just after (the xLSTM blocks launch no
    kernel of the port); then one sLSTM layer's prefill alone at that
    shape, host-timed, to size the sLSTM's per-step loop."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import serve
    from repro_torch.models import recurrent

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    rec = serve(XLSTM_ARCH, batch=XLSTM_SERVE_BATCH,
                prompt_len=XLSTM_SERVE_PROMPT, gen_len=XLSTM_SERVE_GEN,
                reduced=False, verbose=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(rec["output_shape"] == [XLSTM_SERVE_BATCH, XLSTM_SERVE_GEN],
          f"xLSTM serve output shape {rec['output_shape']}")
    check(rec["logits_finite"], "xLSTM serve logits not finite")
    check(counts == {} and rec["launches"] == {"prefill": {}, "decode": {}},
          f"xLSTM serve launched {counts}, expected none")
    # one sLSTM layer's prefill alone, at the serve shape
    cfg = get_arch(XLSTM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(27)
    p = recurrent.slstm_init(gen, cfg, dev)
    x = torch.randn((XLSTM_SERVE_BATCH, XLSTM_SERVE_PROMPT, cfg.d_model),
                    generator=gen, device=dev).to(getattr(torch, cfg.dtype))
    n_slstm = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "slstm"
                  for i in range(cfg.num_layers))
    with torch.no_grad():
        for _ in range(2):                    # the second is timed
            cache = recurrent.init_slstm_cache(cfg, XLSTM_SERVE_BATCH, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            recurrent.slstm_apply(p, x, cfg, mode="prefill",
                                  layer_cache=cache)
            torch.cuda.synchronize()
            slstm_s = time.perf_counter() - t1
    print(f"[serve] {XLSTM_ARCH} full width B={XLSTM_SERVE_BATCH} prompt "
          f"{XLSTM_SERVE_PROMPT} gen {XLSTM_SERVE_GEN} (bf16): prefill "
          f"{rec['prefill_s']:.4f} s ({rec['prefill_tok_per_s']:.1f} tok/s), "
          f"decode {rec['decode_s']:.4f} s for {XLSTM_SERVE_GEN - 1} steps "
          f"({rec['decode_tok_per_s']:.2f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init and warm-up; no "
          f"kernel launches; sample {rec['output_sample']} ({card})",
          flush=True)
    step_us = slstm_s / XLSTM_SERVE_PROMPT * 1e6
    print(f"[serve] {XLSTM_ARCH}: one sLSTM layer's prefill alone "
          f"{slstm_s * 1e3:.1f} ms host ({step_us:.1f} us a time step); "
          f"x {n_slstm} sLSTM layers = "
          f"{n_slstm * slstm_s / rec['prefill_s']:.1%} of the prefill "
          f"({card})", flush=True)
    del p, x
    torch.cuda.empty_cache()


def xlstm_mesh_path(card: str) -> dict:
    """Phase 28: `mesh/xlstm-smoke` at full width through
    `experiments.run` (reduced=False, seq_len 2048, W 2, B 2, bf16) for 2
    rounds, counts reset just before and read just after: pso_update once
    a leaf a round and nothing else; losses and global params finite.
    Returns the counts."""
    import torch
    from repro_torch.experiments import get_scenario, override, run
    from repro_torch.kernels import runtime
    from repro_torch.pytree import tree_leaves

    spec = override(get_scenario("mesh/xlstm-smoke"), "model.reduced=false",
                    f"model.seq_len={XLSTM_MESH_S}",
                    f"run.rounds={XLSTM_MESH_ROUNDS}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec, verbose=False)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rec = result.record
    gp = result.state.global_params
    n_leaves = len(tree_leaves(gp))
    n_params = sum(x.numel() for x in tree_leaves(gp))
    for t in range(XLSTM_MESH_ROUNDS):
        print(f"[mesh] {XLSTM_ARCH} round {t + 1}: "
              f"{rec['step_time_s'][t]:.4f} s, global loss "
              f"{rec['global_loss'][t]:.5f}, worker losses "
              f"{rec['worker_losses'][t]}, launches {rec['launches'][t]}",
              flush=True)
    print(f"[mesh] {XLSTM_ARCH} full width ({n_params} params, bf16) W="
          f"{MESH_W} B={spec.model.per_worker_batch} S={XLSTM_MESH_S}: "
          f"{rec['step_time_s'][-1]:.4f} s the last round, peak memory "
          f"{peak / 2**30:.2f} GiB; {wall:.1f} s with init; launches "
          f"{counts} ({card})", flush=True)
    check(rec["device"] == torch.cuda.get_device_name(0),
          f"xLSTM mesh run on {rec['device']}")
    check(all(math.isfinite(v) for v in rec["global_loss"])
          and all(math.isfinite(v) for r in rec["worker_losses"] for v in r),
          "xLSTM mesh losses not finite")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(gp)),
          "xLSTM mesh global params not finite")
    for t in range(XLSTM_MESH_ROUNDS):
        check(rec["launches"][t] == {"pso_update": n_leaves},
              f"xLSTM mesh round {t + 1} launched {rec['launches'][t]}, "
              f"expected pso_update {n_leaves} (once a leaf)")
    check(counts == {"pso_update": XLSTM_MESH_ROUNDS * n_leaves},
          f"xLSTM mesh run launched {counts}")
    del result, gp
    torch.cuda.empty_cache()
    return counts


# -- this slice: MoE, the encoder with cross-attention, prefix inputs ------

MOE_ARCH = "qwen3-moe-30b-a3b"       # 48 layers, 128 experts top 8, hd 128
ARCTIC_ARCH = "arctic-480b"          # 128 experts top 2 + a dense MLP
ENC_ARCH = "seamless-m4t-large-v2"   # 24 encoder + 24 cross decoder layers
VLM_ARCH = "llava-next-34b"          # a 2880-token prefix, hd 128, 56 / 8
BIG_BATCH, BIG_PROMPT, BIG_GEN = 4, 4096, 32
# Arctic's 35 layers hold 952 GB of bf16 weights; one layer is 27.2 GB
# (128 experts of 3 x 7168 x 4864, the dense MLP, attention), so two
# layers (54.9 GB with the embedding) are what one 80 GB card serves
ARCTIC_LAYERS = 2
# Qwen3 training: two layers (1,557,397,504 params) at W 1: the engine's
# per-worker state (bf16 params, velocity and bests, f32 error-feedback
# residuals) of the 48-layer model would not fit one card
MOE_MESH_LAYERS, MOE_MESH_W, MOE_MESH_B, MOE_MESH_S = 2, 1, 2, 2048
# the forward at this slice's shapes: Qwen3's prefill (hd 128, 32 heads
# over 4, causal), SeamlessM4T's encoder (hd 64, MHA, no mask) and its
# cross-attention at decode (one query over the 4096-frame memory), each
# timed (TIMED_FWD); then, checked only, the other prefill shapes the
# served models launch: Arctic's (56 heads over 8, causal), LLaVA's
# (the same heads over 2880 prefix + 4096 prompt tokens) and SeamlessM4T's
# decoder self-attention (MHA, causal); then ragged non-causal and causal
# GQA cases with 7 query heads a kv head, Sq != Sk and kv_len < Sk
NEW_FWD_CASES = [
    ("hd128 gqa", 4, 4096, 4096, 32, 4, 128, "bfloat16", True, 0, None,
     None),
    ("non-causal", 4, 4096, 4096, 16, 16, 64, "bfloat16", False, 0, None,
     None),
    ("cross decode", 4, 1, 4096, 16, 16, 64, "bfloat16", False, 0, None,
     None),
    ("arctic prefill", 4, 4096, 4096, 56, 8, 128, "bfloat16", True, 0, None,
     None),
    ("llava prefill", 4, 6976, 6976, 56, 8, 128, "bfloat16", True, 0, None,
     None),
    ("seamless self", 4, 4096, 4096, 16, 16, 64, "bfloat16", True, 0, None,
     None),
    ("non-causal ragged", 2, 333, 1000, 14, 2, 128, "bfloat16", False, 0,
     None, 900),
    ("hd128 gqa7 ragged", 2, 300, 1000, 14, 2, 128, "bfloat16", True, 0,
     700, 800),
]
# the backward at Qwen3's training shape (B 2, S 2048, 32 over 4, causal;
# the 128 build), and a ragged non-causal GQA case (the encoder's)
NEW_BWD_CASES = [
    ("hd128", 2, 2048, 2048, 32, 4, 128, "bfloat16", True, 0, None, None),
    ("hd128 non-causal ragged", 2, 333, 1000, 14, 2, 128, "bfloat16", False,
     0, None, 900),
]
TIMED_FWD = ("hd128 gqa", "non-causal", "cross decode")


def new_forward_checks(dev) -> dict:
    """Phase 29: the forward at this slice's shapes against the plain
    version, each asserting its route (bf16 at hd 64 and 128: the
    tensor-core forward); device, eager, plain and library (SDPA with the
    same mask, kv heads expanded outside the timing) times and the bound
    of the TIMED_FWD cases. Returns {label: row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref

    g = torch.Generator(device=dev).manual_seed(29)
    rows = {}
    for case in NEW_FWD_CASES:
        # against the plain version in f64: at 4096 unmasked keys the f32
        # plain version's own sums miss 2 bf16 ulps at outputs near 0
        err, (q, k, v, kw) = flash_case_check(dev, case, g, exact=True)
        if case[0] not in TIMED_FWD:
            rows[case[0]] = {"max_abs_err": err}
            del q, k, v
            torch.cuda.empty_cache()
            continue
        B, Sq, H, hd = q.shape
        Sk, K, causal = k.shape[1], k.shape[2], kw["causal"]
        pairs = B * H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
        nbytes, _ = cost(fops.FLASH, q, k, v, *flash_masks(q, k, kw))
        bnd, by = kernel_bound(fops.FLASH, q, k, v, *flash_masks(q, k, kw),
                               ops_per_s=BF16_OPS_PER_S)
        qt = q.transpose(1, 2)
        kt, vt = (x.transpose(1, 2).repeat_interleave(H // K, 1).contiguous()
                  for x in (k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        lib_err = float((lib.transpose(1, 2).float() - fref.attention_ref(
            q, k, v, causal=causal).float()).abs().max())
        del lib
        reps = 50 if Sq == 1 else 5
        t = {"ms": graph_ms(lambda: fops.flash_attention(q, k, v, **kw),
                            reps),
             "eager_ms": time_ms(lambda: fops.flash_attention(q, k, v, **kw),
                                 reps),
             "plain_ms": time_ms(lambda: fref.attention_ref(
                 q, k, v, causal=causal), 2),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal), reps)}
        print(f"[time] flash_attention {case[0]} (B={B} Sq={Sq} Sk={Sk} H={H} "
              f"K={K} hd={hd} causal={causal} bf16, "
              f"{flash_route(case[7], hd)}, build {fops.tc_head_dim(hd)}): "
              f"device {t['ms']:.4f} ms/launch, eager call "
              f"{t['eager_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, library "
              f"(SDPA, {'causal' if causal else 'no mask'}) "
              f"{t['library_ms']:.4f} ms (max |SDPA - plain| {lib_err:.3g}); "
              f"bound {bnd:.4g} ms ({by}; {pairs} pairs at 4 hd operations, "
              f"{nbytes} B)", flush=True)
        rows[case[0]] = dict(t, max_abs_err=err, bound_ms=bnd, bound_by=by)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def new_backward_checks(dev) -> dict:
    """Phase 29: the training forward and the backward at Qwen3-MoE's
    training shape (the 128 build) and a ragged non-causal GQA case,
    against the plain versions and autograd; the former timed beside
    SDPA's backward alone. Returns its row (the ragged case's error
    under `ragged_max_abs_err`)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(30)
    row = {}
    for case in NEW_BWD_CASES:
        # the ragged non-causal case's training forward against the plain
        # version in f64 (as phase 29's forward cases: a row sees 900 keys)
        err, inputs, _ = flash_bwd_case(dev, case, g,
                                        exact="non-causal" in case[0])
        if "ragged" in case[0]:
            row["ragged_max_abs_err"] = err
        else:
            row.update(time_flash_bwd(case[0], *inputs), max_abs_err=err)
        del inputs
        torch.cuda.empty_cache()
    return row


def small_family_check(dev, arch: str, seed: int, **overrides) -> dict:
    """Phases 30 and 33: a reduced config in f32 (with `overrides`) on the
    card against the CPU from the same params (through the bridge) and
    the same request (tokens, and the prefix or frames it takes), prompt
    24, gen 8: logits within SERVE_LOGIT_TOL, greedy tokens equal.
    Returns the card's launches."""
    import dataclasses
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate, make_request_batch
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                              **overrides)
    model = Transformer(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(seed), "cpu")
    gpu_params = bridge.transformer_params_from_numpy(
        cfg, bridge.tree_to_numpy(cpu_params), dev)
    req = make_request_batch(torch.Generator().manual_seed(seed + 1), cfg, 2,
                             24, "cpu")
    tokens = req.pop("tokens")
    want = generate(model, cpu_params, tokens, 8, **req)
    got = generate(model, gpu_params, tokens.to(dev), 8,
                   **{k: x.to(dev) for k, x in req.items()})
    err = float((got.logits.cpu() - want.logits).abs().max())
    what = f"small {cfg.name} serve {overrides or ''}"
    check(err <= SERVE_LOGIT_TOL, f"{what}: card vs CPU logits max abs err "
                                  f"{err}")
    check(torch.equal(got.tokens.cpu(), want.tokens),
          f"{what}: greedy tokens differ between card and CPU")
    check(want.launches == {"prefill": {}, "decode": {}},
          f"{what}: the CPU launched {want.launches}")
    print(f"[small] serve {cfg.name} f32 {overrides or ''} B=2 prompt 24 "
          f"gen 8 ({', '.join(req) or 'tokens only'}), card vs CPU: logits "
          f"max abs err {err:.3g} (tol {SERVE_LOGIT_TOL:g}), greedy tokens "
          f"equal, card launches {got.launches}", flush=True)
    return got.launches


def big_serve(dev, card: str, arch: str, seed: int, prefill_launches: int,
              decode_launches: int, layers: int = 0):
    """Phases 31, 32, 34 and 35: `arch` served at full width (the depth cut to
    `layers` where given) from random bf16 weights drawn from `seed`,
    batch 4, prompt 4096, gen 32: through `launch.serve.serve` with the
    params given, or with a depth cut through the serve module's
    `generate` (warm-up pass and timed pass, as `serve` runs them).
    Counts reset just before and read just after; one pass's prefill
    launches `prefill_launches` flash forwards (encoder included), each
    decode step `decode_launches`. Returns (record, counts, model,
    params)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import runtime
    from repro_torch.launch.serve import generate, make_request_batch, serve
    from repro_torch.models.transformer import Transformer
    from repro_torch.pytree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = Transformer(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    weights = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    runtime.reset_counts()
    t0 = time.perf_counter()
    if not layers:
        rec = serve(arch, batch=BIG_BATCH, prompt_len=BIG_PROMPT,
                    gen_len=BIG_GEN, reduced=False, params=params, seed=seed,
                    verbose=False)
    else:
        req = make_request_batch(gen, cfg, BIG_BATCH, BIG_PROMPT, dev)
        tokens = req.pop("tokens")
        generate(model, params, tokens, 2, **req)                # warm-up
        g = generate(model, params, tokens, BIG_GEN, **req)
        rec = {"prefill_s": g.prefill_s, "decode_s": g.decode_s,
               "prefill_tok_per_s": BIG_BATCH * BIG_PROMPT / g.prefill_s,
               "decode_tok_per_s": BIG_BATCH * (BIG_GEN - 1) / g.decode_s,
               "output_shape": list(g.tokens.shape),
               "output_sample": g.tokens[0, :8].tolist(),
               "launches": g.launches,
               "logits_finite": bool(torch.isfinite(g.logits).all())}
        del req, tokens, g
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    depth = f"depth cut to {layers}" if layers else "full depth"
    print(f"[serve] {arch} full width, {depth} ({n_params} params, "
          f"{cfg.param_count()} in the config's analytic count, which "
          f"leaves out the norms; {weights / 1e9:.2f} GB of bf16 weights "
          f"drawn in {init_s:.1f} s) "
          f"B={BIG_BATCH} prompt {BIG_PROMPT} gen {BIG_GEN}: prefill "
          f"{rec['prefill_s']:.4f} s ({rec['prefill_tok_per_s']:.1f} tok/s), "
          f"decode {rec['decode_s']:.4f} s for {BIG_GEN - 1} steps "
          f"({rec['decode_tok_per_s']:.2f} tok/s), peak memory "
          f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); {wall:.1f} s with "
          f"warm-up; timed-pass launches {rec['launches']}, all launches "
          f"{counts}; sample {rec['output_sample']} ({card})", flush=True)
    check(rec["output_shape"] == [BIG_BATCH, BIG_GEN],
          f"{arch} serve output shape {rec['output_shape']}")
    check(rec["logits_finite"], f"{arch} serve logits not finite")
    one = {"prefill": {"flash_attention": prefill_launches},
           "decode": ({"flash_attention": decode_launches * (BIG_GEN - 1)}
                      if decode_launches else {})}
    check(rec["launches"] == one, f"{arch} serve: one pass launched "
                                  f"{rec['launches']}, expected {one}")
    # the warm-up pass (prefill + one decode step) and the timed pass
    want = {"flash_attention": 2 * prefill_launches
            + decode_launches * BIG_GEN}
    check(counts == want, f"{arch} serve launched {counts}, expected {want}")
    return rec, counts, model, params


def kernels_under(e) -> list:
    """The device kernels (name, device, duration in µs) launched under a
    profiler event: its own and its CPU children's, recursively."""
    ks = list(e.kernels)
    for c in e.cpu_children:
        ks += kernels_under(c)
    return ks


def profile_moe_prefill(dev, card: str, model, params) -> None:
    """Phase 31: one more full-width Qwen3-MoE prefill under
    torch.profiler, each MoE layer inside a `moe_apply` range (a wrapper
    set for this prefill only): device time split into the flash
    forward, the MoE layers (their GEMMs: router and experts; the rest:
    routing, sort, dispatch, combine), the other GEMMs and the rest (the
    embedding lookup, the KV cache writes, norms, RoPE)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(31)
    tokens = torch.randint(0, model.cfg.vocab_size, (BIG_BATCH, BIG_PROMPT),
                           generator=gen, device=dev)
    moe_apply = moe.moe_apply

    def ranged(*args, **kwargs):
        with record_function("moe_apply"):
            return moe_apply(*args, **kwargs)

    with torch.no_grad():
        cache = model.init_cache(BIG_BATCH, BIG_PROMPT + BIG_GEN, dev)
        torch.cuda.synchronize()
        moe.moe_apply = ranged
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model.prefill(params, {"tokens": tokens}, cache)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            moe.moe_apply = moe_apply
    # the ranges' device-side annotations are spans, not kernels: kept
    # apart from the kernels' rows
    rows = sorted((e for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
                   and e.key != "moe_apply"),
                  key=dev_us, reverse=True)
    spans = sum(dev_us(e) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.key == "moe_apply") / 1e3

    def is_gemm(name):
        return any(w in name.lower() for w in GEMM_WORDS)

    total = sum(dev_us(e) for e in rows) / 1e3
    flash = sum(dev_us(e) for e in rows if "fwd_tc_kernel" in e.key) / 1e3
    gemm = sum(dev_us(e) for e in rows if is_gemm(e.key)) / 1e3
    # the range's host events (the profiler also gives each a device-side
    # annotation of the same name)
    ranges = [e for e in prof.events() if e.name == "moe_apply"
              and str(e.device_type).endswith("CPU")]
    moe_ks = [k for e in ranges for k in kernels_under(e)]
    moe_ms = sum(k.duration for k in moe_ks) / 1e3
    moe_gemm = sum(k.duration for k in moe_ks if is_gemm(k.name)) / 1e3
    check(total > 0, "Qwen3-MoE profile: no device time recorded")
    check(len(ranges) == model.cfg.num_layers and moe_ms > 0,
          f"Qwen3-MoE profile: {len(ranges)} moe_apply ranges with "
          f"{moe_ms} ms of device time under them")
    print(f"[profile] one full-width {MOE_ARCH} prefill (B={BIG_BATCH} S="
          f"{BIG_PROMPT}): wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{total:.1f} ms ({100 * total / wall_ms:.1f}%): flash_attention "
          f"{flash:.1f} ms; MoE layers {moe_ms:.1f} ms ({len(ranges)} "
          f"moe_apply ranges, whose device-side spans sum to {spans:.1f} "
          f"ms: GEMMs, router and experts' bmm, "
          f"{moe_gemm:.1f} ms; routing, sort, dispatch and combine "
          f"{moe_ms - moe_gemm:.1f} ms); other GEMMs {gemm - moe_gemm:.1f} "
          f"ms; other {total - flash - moe_ms - (gemm - moe_gemm):.1f} ms; "
          f"{sum(e.count for e in rows)} device ops ({card})", flush=True)
    for e in rows[:16]:
        print(f"[profile]   {dev_us(e) / 1e3:9.3f} ms x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    del cache
    torch.cuda.empty_cache()


def moe_train_rounds(dev, card: str) -> dict:
    """Phase 36: Qwen3-MoE training at full width, the depth cut to
    MOE_MESH_LAYERS, W 1, B 2, S 2048, bf16, through `Transformer.loss`
    (the aux loss included) under the mesh engine (phase 25's helper):
    launches as `mesh_launches_per_round` (the hd-128 forward and
    backward builds, pso_update once a leaf), the _f32 counters never;
    then the aux of the trained global params on a batch, finite and
    > 0."""
    return depth_cut_mesh_rounds(
        dev, MOE_ARCH, MOE_MESH_LAYERS, MOE_MESH_W, MOE_MESH_B, MOE_MESH_S,
        35, "hd 128", card)


# this slice: the sharded mesh path on a one-rank mesh (phases 37-39)
MESH_NAMES = ("data", "model")
STEP_B, STEP_S = 2, 2048        # phase 37: one worker (a 1 x 1 mesh), B 2
MOE_MESH_GEN = 8                # phase 38: greedy tokens a request
EP_SHARDS, EP_B, EP_S = 4, 4, 4096   # phase 39: one layer, n virtual shards


def one_rank_mesh(dev):
    """A one-rank process group (NCCL, its FileStore under build/) and
    its 1 x 1 ("data", "model") DeviceMesh on the card."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        torch.cuda.set_device(dev)
        store = ROOT / "build" / "chip_smoke_pg_store"
        store.parent.mkdir(parents=True, exist_ok=True)
        store.unlink(missing_ok=True)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1, device_id=dev)
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=MESH_NAMES)


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def mesh_step_path(dev, card: str) -> dict:
    """Phase 37: `launch.steps.build_step` for one M-DSL round of
    SmolLM-360M at full width (bf16, B 2, S 2048: one worker on the 1 x 1
    mesh), every state and batch leaf a DTensor (`steps.place`, shards
    that are the tensors themselves), counts reset just before the round
    and read just after; then the port's one-process
    `swarm_dist.build_train_step` on the same state, batches and draws:
    the round's state and telemetry bitwise equal. Returns the counts."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import swarm_dist
    from repro_torch.kernels import runtime
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import steps
    from repro_torch.pytree import tree_leaves
    from repro_torch.sharding import boundary

    mesh = one_rank_mesh(dev)
    cfg = get_arch(MESH_ARCH)
    built = steps.build_step(cfg, InputShape("train", STEP_S, STEP_B,
                                             "train"), mesh)
    dcfg, model = built.meta["dcfg"], built.meta["model"]
    check(dcfg.num_spatial == 1 and dcfg.worker_axes == ("data",),
          f"phase 37: {dcfg.num_spatial} workers over {dcfg.worker_axes}")
    gen = torch.Generator(device=dev).manual_seed(37)
    params = model.init(gen, dev)
    state = swarm_dist.init_state(params, dcfg)
    toks = torch.randint(0, cfg.vocab_size, (1, STEP_B, STEP_S),
                         generator=gen, device=dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    et = torch.randint(0, cfg.vocab_size, (steps.EVAL_BATCH, STEP_S),
                       generator=gen, device=dev)
    ev = {"tokens": et, "labels": torch.roll(et, -1, dims=-1)}
    draws = swarm_dist.sample_draws(gen, dcfg, params, dev, 0)
    lay = built.layouts
    st = steps.place(state, lay[0], mesh)
    check(all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(st.params), tree_leaves(state.params))),
        "phase 37: placing the state copied it")
    args = (st, steps.place(batch, lay[1], mesh), steps.place(ev, lay[2],
                                                              mesh), draws)
    # one untimed round first (DTensor's sharding-propagation caches and
    # first dispatch), so that both rounds timed below are warm
    warm = built.fn(*args)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_counts()
    boundary.reset_redistributions()
    t0 = time.perf_counter()
    ns, info = built.fn(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = runtime.counts()
    redis = boundary.redistributions()
    peak = torch.cuda.max_memory_allocated()
    plain = swarm_dist.build_train_step(
        model.loss, dcfg._replace(worker_axes=()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps, pinfo = plain(state, batch, ev, draws)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    n_leaves = len(tree_leaves(params))
    diffs = []
    for field in ("params", "velocity", "best_params", "global_params",
                  "gbest_params", "residual", "ps_residual", "best_loss",
                  "gbest_loss", "prev_theta_mean"):
        for a, b in zip(tree_leaves(getattr(ns, field)),
                        tree_leaves(getattr(ps, field))):
            if not torch.equal(full(a), b):
                diffs.append((field, float((full(a).float() - b.float())
                                           .abs().max())))
    for field in ("losses", "theta", "mask", "global_loss", "bytes_up"):
        if not torch.equal(full(getattr(info, field)),
                           getattr(pinfo, field)):
            diffs.append((field, None))
    want = mesh_launches_per_round(cfg, n_leaves, W=1)
    print(f"[mesh-steps] build_step train, {MESH_ARCH} full width (bf16, "
          f"W 1 on the 1 x 1 mesh, B {STEP_B}, S {STEP_S}): {step_s:.4f} s "
          f"a warm round (after one untimed; the one-process round after "
          f"it {plain_s:.4f} s), peak memory {peak / 2**30:.2f} GiB; launches "
          f"{counts}; inputs gathered to Replicate at the kernel boundary "
          f"{redis}; against the one-process round: "
          f"{'bitwise' if not diffs else diffs}; global loss "
          f"{float(full(info.global_loss)):.5f} ({card})", flush=True)
    print(f"[mesh-steps] launch/mesh.py's CHIP_HBM_BYTES "
          f"{launch_mesh.CHIP_HBM_BYTES}, this card's total_memory "
          f"{torch.cuda.get_device_properties(0).total_memory} ({card})",
          flush=True)
    check(not diffs, f"phase 37: the mesh round differs from the "
                     f"one-process round: {diffs}")
    check(counts == want, f"phase 37 launched {counts}, expected {want}")
    check(bool(torch.isfinite(full(info.global_loss))),
          "phase 37: global loss not finite")
    del ns, ps, st, state, params, args
    torch.cuda.empty_cache()
    return counts


def mesh_serve_path(dev, card: str, model, params, peak31: int) -> dict:
    """Phase 38: `launch.steps.build_serve_step` prefill and decode for
    Qwen3-MoE-30B-A3B at full width and depth on the 1 x 1 mesh, on
    phase 31's weights placed with no second copy (each DTensor's shard is
    the weight itself): greedy tokens of MOE_MESH_GEN steps equal to
    `launch.serve.generate`'s on the same prompts (batch 4, prompt 4096);
    prefill s, decode tok/s, launches (the forward once a layer in the
    prefill), and a peak within 1 GiB of phase 31's. Returns the mesh
    path's counts."""
    import gc
    import torch
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.launch.serve import generate, make_request_batch
    from repro_torch.pytree import tree_leaves
    from repro_torch.sharding import boundary

    mesh = one_rank_mesh(dev)
    cfg, G = model.cfg, MOE_MESH_GEN
    gen = torch.Generator(device=dev).manual_seed(38)
    tokens = make_request_batch(gen, cfg, BIG_BATCH, BIG_PROMPT,
                                dev)["tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    want = generate(model, params, tokens, G)
    gc.collect()
    torch.cuda.empty_cache()
    # the mesh path's own peak, from here on
    torch.cuda.reset_peak_memory_stats()
    pre = steps.build_step(cfg, InputShape("prefill", BIG_PROMPT, BIG_BATCH,
                                           "prefill"), mesh)
    dec = steps.build_step(cfg, InputShape("decode", BIG_PROMPT + G,
                                           BIG_BATCH, "decode"), mesh)
    check(pre.cfg == cfg, "phase 38: the mesh step changed the config")
    pp = steps.place(params, pre.layouts[0], mesh)
    check(all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(pp), tree_leaves(params))),
        "phase 38: placing the weights copied them")
    with torch.no_grad():
        cache = steps.place(model.init_cache(BIG_BATCH, BIG_PROMPT + G, dev),
                            dec.layouts[2], mesh)
        batch = steps.place({"tokens": tokens}, pre.layouts[1], mesh)
        # one untimed prefill and decode step first (DTensor's caches and
        # first dispatch): each writes the cache rows the timed ones write
        # again with the same values, and `pos` lives in the returned cache
        _, warm = pre.fn(pp, batch, cache)
        dec.fn(pp, steps.place(tokens[:, -1:], dec.layouts[1], mesh), warm)
        del warm
        torch.cuda.synchronize()
        runtime.reset_counts()
        boundary.reset_redistributions()
        t0 = time.perf_counter()
        logits, cache = pre.fn(pp, batch, cache)
        tok = torch.argmax(full(logits)[:, -1], dim=-1, keepdim=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        c_prefill = runtime.counts()
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(G - 1):
            logits, cache = dec.fn(pp, steps.place(tok, dec.layouts[1],
                                                   mesh), cache)
            tok = torch.argmax(full(logits)[:, -1], dim=-1, keepdim=True)
            out.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    counts = runtime.counts()
    redis = boundary.redistributions()
    peak = torch.cuda.max_memory_allocated()
    got = torch.cat(out, dim=1)
    print(f"[mesh-serve] build_serve_step, {MOE_ARCH} full width and depth "
          f"on the 1 x 1 mesh (phase 31's weights, no copy), B={BIG_BATCH} "
          f"prompt {BIG_PROMPT} gen {G}, warm (after one untimed prefill "
          f"and decode step): prefill {prefill_s:.4f} s "
          f"({BIG_BATCH * BIG_PROMPT / prefill_s:.1f} tok/s), decode "
          f"{decode_s:.4f} s for {G - 1} steps "
          f"({BIG_BATCH * (G - 1) / decode_s:.2f} tok/s; launch/serve's "
          f"generate on the same prompts: prefill {want.prefill_s:.4f} s, "
          f"{BIG_BATCH * (G - 1) / want.decode_s:.2f} tok/s), the mesh "
          f"path's peak memory {peak / 2**30:.2f} GiB (phase 31: "
          f"{peak31 / 2**30:.2f}); "
          f"launches {counts} (prefill {c_prefill}); gathered at the kernel "
          f"boundary {redis}; greedy tokens "
          f"{'equal' if torch.equal(got, want.tokens) else 'DIFFER'} "
          f"({got[0].tolist()}) ({card})", flush=True)
    check(torch.equal(got, want.tokens),
          f"phase 38: greedy tokens {got.tolist()} against launch/serve's "
          f"{want.tokens.tolist()}")
    check(counts == {"flash_attention": cfg.num_layers},
          f"phase 38 launched {counts}, expected the forward "
          f"{cfg.num_layers} times")
    check(abs(peak - peak31) <= 2**30,
          f"phase 38: peak {peak / 2**30:.2f} GiB, phase 31's "
          f"{peak31 / 2**30:.2f}")
    del pp, cache, logits, want
    return counts


def ep_virtual(params, h, cfg, n):
    """`moe_ep.moe_apply_ep`'s arithmetic for n expert shards in one
    process: each stage per shard, the exchanges as a tiled all-to-all
    (`buf.view(n, n, cap, ...).transpose(0, 1)`). Returns (y, aux, picks
    dropped at the send stage, picks dropped at the local stage)."""
    import torch
    from repro_torch.models import moe_ep
    B, S, D = h.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    El, T = E // n, B * S
    cap_send, cap_local = moe_ep.capacities(T, cfg, n)
    hs = [x.reshape(-1, D) for x in h.chunk(n)]
    routes = [moe_ep.route(x, params["router"], K) for x in hs]
    aux = moe_ep.aux_loss(sum(moe_ep.aux_stats(p, i, E) for p, _, i in
                              routes), T, cfg)
    packs = [moe_ep.pack_send(x, i, El, n, cap_send)
             for x, (_, _, i) in zip(hs, routes)]
    send_drops = sum(int((slot == n * cap_send).sum()) for _, slot in packs)

    def exchange(bufs):
        st = torch.stack(bufs)
        return list(st.view((n, n) + tuple(st.shape[2:])).transpose(0, 1))

    rx, re, rv = (exchange([p[k] for p, _ in packs]) for k in "xev")
    local_drops = 0
    backs = []
    for s in range(n):
        e = re[s].reshape(-1) - s * El
        got = torch.zeros(El, dtype=torch.int64, device=h.device)
        got.scatter_add_(0, e.clamp(0, El - 1),
                         (rv[s].reshape(-1) > 0).to(torch.int64))
        local_drops += int((got - cap_local).clamp_min(0).sum())
        sl = slice(s * El, (s + 1) * El)
        backs.append(moe_ep.expert_ffn(
            rx[s].reshape(n * cap_send, D), re[s].reshape(-1),
            rv[s].reshape(-1), s, El, cap_local, params["wi"][sl],
            params["wu"][sl], params["wo"][sl]))
    origin = exchange([b.view(n, cap_send, D) for b in backs])
    ys = [moe_ep.combine(origin[s].reshape(n * cap_send, D), packs[s][1],
                         routes[s][1], h.dtype) for s in range(n)]
    return torch.cat(ys).view(B, S, D), aux, send_drops, local_drops


def ep_layer_check(dev, card: str) -> None:
    """Phase 39: one Qwen3-MoE layer at full width (128 experts, top 8,
    d 2048, f 768, bf16; tokens (4, 4096)) through the EP stages for
    EP_SHARDS virtual shards on the card. Dropless (cf = E / K): y
    within 2 bf16 ulps of the dense `moe_apply`'s, the ulp taken at each
    token's largest |y| (y is an f32 sum over the K picks of bf16 expert
    rows, each rounded once: the two paths' expert products run as
    batches of 32 and of 128 experts, whose GEMMs may round an element
    of a row one ulp apart, which moves y by an ulp of the rows' scale,
    not of the element), the aux within 1e-5 of it relatively. At the
    config's own capacity factor both paths' drops printed: EP drops at
    two capacities by design (random tokens load the experts evenly and
    drop nothing there, so also tokens sharing one direction, which
    route most picks to the same few experts)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, moe_ep
    from repro_torch.models.layers import rmsnorm

    cfg = get_arch(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(39)
    params = moe.moe_init(gen, cfg, dev)
    x0 = torch.randn((EP_B, EP_S, cfg.d_model), generator=gen, device=dev,
                     dtype=torch.float32)
    u = torch.randn((cfg.d_model,), generator=gen, device=dev)
    E, K, T = cfg.num_experts, cfg.experts_per_token, EP_B * EP_S
    runs = [("random", float(E // K), x0),
            ("random", cfg.moe_capacity_factor, x0),
            ("sharing a direction", cfg.moe_capacity_factor, x0 + 4.0 * u)]
    for tokens, cf, xf in runs:
        x = xf.to(torch.bfloat16)
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        _, _, idx = moe_ep.route(h.reshape(T, -1), params["router"], K)
        counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
            0, idx.reshape(-1), torch.ones(T * K, dtype=torch.int64,
                                           device=dev))
        with torch.no_grad():
            c = dataclasses.replace(cfg, moe_capacity_factor=cf)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yd, auxd = moe.moe_apply(params, x, c)
            torch.cuda.synchronize()
            dense_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ye, auxe, send_drops, local_drops = ep_virtual(params, h, c,
                                                           EP_SHARDS)
            torch.cuda.synchronize()
            ep_ms = (time.perf_counter() - t0) * 1e3
            dense_drops = int((counts - moe.capacity(T, c)).clamp_min(0)
                              .sum())
            yd32, ye32 = yd.float(), ye.float()
            diff = (ye32 - yd32).abs()
            row = yd32.abs().amax(dim=-1, keepdim=True)
            ulps = float((diff / bf16_ulp(row)).max())
            n_diff = int((diff > 0).sum())
            rel = abs(float(auxe) - float(auxd)) / float(auxd)
            cap_send, cap_local = moe_ep.capacities(T, c, EP_SHARDS)
            print(f"[moe-ep] one {MOE_ARCH} layer, {tokens} tokens "
                  f"({EP_B}, {EP_S}), {EP_SHARDS} virtual shards, cf {cf}: "
                  f"dense capacity "
                  f"{moe.capacity(T, c)}, EP send {cap_send} and local "
                  f"{cap_local}; drops dense {dense_drops}, EP "
                  f"{send_drops} at the send and {local_drops} at the local "
                  f"stage; y max {float(diff.max()):.3e} at max |y| "
                  f"{float(yd32.abs().max()):.3f}, {n_diff} of "
                  f"{diff.numel()} elements differ, {ulps:.2f} bf16 ulps "
                  f"of the token's largest |y|; aux {float(auxe):.6f} "
                  f"against "
                  f"{float(auxd):.6f} (rel {rel:.2e}); eager {ep_ms:.1f} ms "
                  f"against the dense {dense_ms:.1f} ms ({card})",
                  flush=True)
            check(bool(torch.isfinite(ye32).all()), "phase 39: y not finite")
            if tokens == "sharing a direction":
                check(dense_drops > 0 and send_drops + local_drops > 0,
                      "phase 39: no drops with the tokens sharing a "
                      "direction")
            if cf == float(E // K):
                check(dense_drops == send_drops == local_drops == 0,
                      "phase 39: dropless dropped picks")
                check(ulps <= 2.0, f"phase 39: EP y {ulps:.2f} bf16 ulps "
                                   f"from the dense dispatch")
                check(rel <= 1e-5, f"phase 39: aux rel diff {rel:.2e}")
            del yd, ye, yd32, ye32, diff, row
    del params, x, x0, h
    torch.cuda.empty_cache()


# this slice: the dry-run and its cost model (phase 40)
DRYRUN_CELLS = (("smollm-360m", "train_4k", "single"),
                ("qwen3-moe-30b-a3b", "train_4k", "single"),
                ("recurrentgemma-9b", "decode_32k", "multi"))
# the same dry-runs' records with the table gathered for the lookup and
# the dense dispatch replicated, the layouts the port had before the
# vocab-parallel lookup and the expert-sharded dispatch (NVIDIA H100 80GB
# HBM3): per-rank peak, HBM and collective bytes
DRYRUN_GATHERED = {
    ("smollm-360m", "train_4k", "single"):
        (26611887972, 2192002315329, 17023438112),
    ("qwen3-moe-30b-a3b", "train_4k", "single"):
        (97416703108, 24489078097541, 860775855936),
    ("recurrentgemma-9b", "decode_32k", "multi"):
        (4081676304, 5850100624, 134533120)}
# the dense dispatch's expert products a rank in that Qwen3 record, all
# 128 experts at every f column on each of the 256 ranks
MOE_BMM_FLOPS_REPLICATED = 148485609357312
RG_DECODE_PEAK_MAX = 2.2e9      # the table's 2.10 GB temporary gone
LOOKUP_FNS = ("embed", "_vocab_parallel", "vocab_shard_lookup",
              "vocab_shard_grad")
DRYRUN_TAG = "__chip_smoke"
DRYRUN_TIMEOUT_S = 420          # each production-mesh dry-run
PEAK_TOL = 0.10                 # predicted against the allocator's peak


def start_dryruns() -> list:
    """Phase 40's production-mesh dry-runs, one `python -m
    repro_torch.launch.dryrun` each, all started at once: each makes its
    own fake process group of 256 or 512 ranks, which this process (it
    holds phase 37's NCCL group) cannot. They only trace on the CPU (fake
    tensors), at the lowest priority and one thread each, so they run
    beside phases 37-39 on the host's other cores. Their output goes to
    build/."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    runs = []
    for cell in DRYRUN_CELLS:
        log = ROOT / "build" / f"dryrun-{'-'.join(cell)}.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        arch, shape, mesh = cell
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--tag", DRYRUN_TAG], cwd=ROOT, env=env, stdout=out,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))
        runs.append((cell, proc, log))
    return runs


def stop_dryruns(runs) -> None:
    for _, proc, _ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def fake_kernel_checks(dev) -> None:
    """Each kernel operator's shape rule (its fake implementation, under
    FakeTensorMode) against a real launch at the main path's shape (PERF
    §6): the outputs' shapes, dtypes and strides (a size-1 dim's stride
    is free); the fake launches nothing."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import runtime
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.pso_update import ops as pops
    from repro_torch.kernels.quant_pack import ops as qops
    from repro_torch.kernels.rglru_scan import ops as sops
    from repro_torch.kernels.wire_agg import ops as wops

    g = torch.Generator(device=dev).manual_seed(40)
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def strides(t):
        return [s for s, n in zip(t.stride(), t.shape) if n > 1]

    seeds50 = torch.arange(50, dtype=i32, device=dev)
    x50 = rand(50, 256, 128)
    p4, s4 = qops.QUANT_PACK(x50, seeds50, 4)
    mask = (torch.arange(50, device=dev) < 30).float()
    x1, seeds1 = rand(1, 256, 128), seeds50[:1].contiguous()
    p8, s8 = qops.QUANT_PACK(x1, seeds1, 8)
    qf, kf, vf = rand(4, 4096, 16, 256, dtype=bf16), \
        rand(4, 4096, 1, 256, dtype=bf16), rand(4, 4096, 1, 256, dtype=bf16)
    qm, km, vm = rand(2, 2048, 15, 64, dtype=bf16), \
        rand(2, 2048, 5, 64, dtype=bf16), rand(2, 2048, 5, 64, dtype=bf16)
    om, lm = fops.FLASH_LSE(qm, km, vm, True, 0, 0, 2048)
    a4 = torch.rand((4, 4096, 4096), generator=g, device=dev)
    a2 = torch.rand((2, 2048, 4096), generator=g, device=dev)
    h4, h2 = rand(4, 4096), rand(2, 4096)
    wp = rand(2, 32, 960, 2560, dtype=bf16)
    cases = [
        ("quant_pack_ef int4 C=50 (256,128)", qops.QUANT_PACK_EF,
         (x50, 0.1 * x50, seeds50, 4)),
        ("wire_agg int4 mean C=50 (128,128) u8, 30 delivered", wops.WIRE_AGG,
         (p4, s4, mask, torch.ones(50, device=dev), 4, "mean", 0.1)),
        ("quant_pack int8 C=1 (256,128)", qops.QUANT_PACK, (x1, seeds1, 8)),
        ("dequant_unpack int8 C=1 (256,128)", qops.DEQUANT_UNPACK,
         (p8, s8, 8)),
        ("flash_attention bf16 (4, 4096, 16 over 1, 256) window 2048",
         fops.FLASH, (qf, kf, vf, True, 2048, 0, 4096)),
        ("flash_attention_lse bf16 (2, 2048, 15 over 5, 64) causal",
         fops.FLASH_LSE, (qm, km, vm, True, 0, 0, 2048)),
        ("flash_attention_bwd bf16 (2, 2048, 15 over 5, 64) causal",
         fops.FLASH_BWD, (qm, km, vm, om, torch.randn_like(om), lm, True, 0,
                          0, 2048)),
        ("rglru_scan f32 (4, 4096, 4096)", sops.RGLRU_SCAN,
         (h4, a4, rand(4, 4096, 4096))),
        ("rglru_scan_bwd f32 (2, 2048, 4096)", sops.RGLRU_SCAN_BWD,
         (h2, a2, rand(2, 2048, 4096), rand(2, 2048, 4096))),
        ("pso_update bf16 W=2 (32, 960, 2560)", pops.PSO_UPDATE,
         (rand(2, 4, dtype=f32).abs(), wp, 0.01 * wp, wp + 0.1, wp[0],
          1e-3 * wp))]
    for label, op, args in cases:
        real = op(*args)
        real = real if isinstance(real, tuple) else (real,)
        runtime.reset_counts()
        with FakeTensorMode() as fm:
            fake = op(*[fm.from_tensor(a) if torch.is_tensor(a) else a
                        for a in args])
        fake = fake if isinstance(fake, tuple) else (fake,)
        check(runtime.counts() == {}, f"phase 40: {label}'s shape rule "
              f"counted launches {runtime.counts()}")
        got = [(tuple(f.shape), f.dtype, strides(f), f.device.type)
               for f in fake]
        want = [(tuple(t.shape), t.dtype, strides(t), t.device.type)
                for t in real]
        check(got == want, f"phase 40: {label}: the shape rule gives "
                           f"{got}, the launch {want}")
        print(f"[dryrun] {label}: the shape rule's outputs "
              f"{[(s, str(d)[6:], st) for s, d, st, _ in got]} equal the "
              f"launch's", flush=True)
        del real, fake
    del cases, x50, p4, s4, qf, kf, vf, qm, km, vm, om, lm, a4, a2, wp
    torch.cuda.empty_cache()


def dispatch_cost(dev, card: str) -> None:
    """Host µs a call of pso_update on small tensors: through its
    operator (the dispatcher calls the Python CUDA implementation) and
    straight (`runtime.direct`'s path, the wrappers' on plain CUDA
    tensors); the best of 5 batches of 2000 calls each."""
    import torch
    from repro_torch.kernels.pso_update import ops as pops
    w = torch.randn((2, 64, 128), device=dev).to(torch.bfloat16)
    args = (torch.rand((2, 4), device=dev), w, w, w, w[0].contiguous(), w)

    def host_us(fn, n=2000):
        best = float("inf")
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
        return best
    via_op, direct = host_us(pops.PSO_UPDATE), host_us(pops._pso_cuda)
    print(f"[dryrun] pso_update host cost a call, (2, 64, 128) bf16: through "
          f"the operator {via_op:.2f} µs, straight {direct:.2f} µs (the "
          f"dispatcher's Python-kernel call {via_op - direct:.2f} µs) "
          f"({card})", flush=True)


def dryrun_step_check(dev, card: str) -> None:
    """Phase 37's step dry-run (fake tensors on the same 1 x 1 mesh)
    against the real round: the same cost model over the real tensors
    reads the same FLOPs, and the predicted peak of live bytes is within
    PEAK_TOL of the allocator's peak for the round (beyond what the card
    held before the round's inputs were made)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import InputShape
    from repro_torch.core import swarm_dist
    from repro_torch.launch import dryrun, op_costmodel, steps

    mesh = one_rank_mesh(dev)
    built = steps.build_step(get_arch(MESH_ARCH), InputShape(
        "train", STEP_S, STEP_B, "train"), mesh)
    fake, _, trace_s = dryrun.dry_run(built, mesh, "cuda")
    dcfg, model = built.meta["dcfg"], built.meta["model"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(37)
    params = model.init(gen, dev)
    state = swarm_dist.init_state(params, dcfg)
    cfg = built.cfg
    toks = torch.randint(0, cfg.vocab_size, (1, STEP_B, STEP_S),
                         generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}
    et = torch.randint(0, cfg.vocab_size, (steps.EVAL_BATCH, STEP_S),
                       generator=gen, device=dev, dtype=torch.int32)
    ev = {"tokens": et, "labels": torch.roll(et, -1, dims=-1)}
    draws = swarm_dist.sample_draws(gen, dcfg, params, dev, 0)
    lay = built.layouts
    args = (steps.place(state, lay[0], mesh), steps.place(batch, lay[1], mesh),
            steps.place(ev, lay[2], mesh), draws)
    del params, state
    warm = built.fn(*args)          # DTensor's caches warm, as phase 37
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, cm = op_costmodel.count_step(built.fn, args,
                                      parts=dryrun.arg_parts(built, args))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    real = cm.summary(out)
    del out, args
    torch.cuda.empty_cache()
    pred = fake["memory"]["peak_bytes"]
    miss = abs(pred - peak) / peak
    gib = 2 ** 30
    brk = fake["peak_breakdown"]
    top = list(brk["temporaries"].items())[:8]
    print(f"[dryrun] phase 37's step ({MESH_ARCH} full width, W 1, B "
          f"{STEP_B}, S {STEP_S}, the 1 x 1 mesh), traced on fake tensors in "
          f"{trace_s:.1f} s: predicted peak {pred / gib:.3f} GiB "
          f"(arguments {fake['memory']['argument_bytes'] / gib:.3f}, "
          f"temporaries at the peak "
          f"{(pred - fake['memory']['argument_bytes']) / gib:.3f}) against "
          f"the allocator's {peak / gib:.3f} GiB for the real round "
          f"({miss:.2%} apart; the counter over the real tensors reads "
          f"{real['memory']['peak_bytes'] / gib:.3f}); FLOPs fake "
          f"{fake['flops']} real {real['flops']}, HBM bytes fake "
          f"{fake['hbm_bytes']} real {real['hbm_bytes']} ({card})",
          flush=True)
    print(f"[dryrun] the predicted peak's breakdown: arguments "
          f"{ {k: round(v / gib, 4) for k, v in brk['arguments'].items() if v} } "
          f"GiB; temporaries by issuing function (top 8) "
          f"{ {k: round(v / gib, 4) for k, v in top} } GiB", flush=True)
    check(fake["flops"] == real["flops"], f"phase 40: the dry-run's FLOPs "
          f"{fake['flops']} against the real round's {real['flops']}")
    check(miss <= PEAK_TOL, f"phase 40: predicted peak {pred} B is "
          f"{miss:.2%} from the allocator's {peak} B (tolerance "
          f"{PEAK_TOL:.0%})")


def dryrun_records(runs, card: str) -> None:
    """Phase 40's production-mesh dry-runs: each record read back, its
    per-rank peak against the card's memory and its dominant term."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    gib = 2 ** 30
    for cell, proc, log in runs:
        try:
            proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"phase 40: the dry-run {cell} did not end in "
                 f"{DRYRUN_TIMEOUT_S} s (log {log})")
        path = dryrun.artifact_path(*cell, DRYRUN_TAG)
        check(proc.returncode == 0 and path.exists(),
              f"phase 40: the dry-run {cell} exited {proc.returncode}: "
              f"{log.read_text()[-2000:]}")
        rec = json.loads(path.read_text())
        check(rec.get("ok"), f"phase 40: the dry-run {cell} recorded "
                             f"{rec.get('error')}: "
                             f"{rec.get('traceback', '')[-1500:]}")
        peak, roof = rec["memory"]["peak_bytes"], rec["roofline"]
        coll = {k: v for k, v in rec["collectives"]["by_kind_bytes"].items()
                if v}
        layout_rows(cell, rec, card)
        print(f"[dryrun] {' x '.join(cell)} ({rec['devices']} ranks, fake "
              f"tensors on {rec['fake_device']}, traced in "
              f"{rec['trace_s']} s): per-rank peak {peak / gib:.2f} GiB of "
              f"the card's {launch_mesh.CHIP_HBM_BYTES / gib:.2f} "
              f"({'fits' if peak <= launch_mesh.CHIP_HBM_BYTES else 'does not fit'}); "
              f"{rec['flops_per_device']:.4g} FLOPs, "
              f"{rec['hbm_bytes_per_device']:.4g} HBM bytes, collectives "
              f"{coll}; dominant term {roof['dominant']} "
              f"({roof['bound_step_s']:.4g} s a step; compute "
              f"{roof['compute_s']:.4g}, memory {roof['memory_s']:.4g}, "
              f"collective {roof['collective_s']:.4g}); useful FLOPs "
              f"{roof['useful_flops_ratio']:.3f} ({card})", flush=True)


def layout_rows(cell: tuple, rec: dict, card: str) -> None:
    """A production dry-run's record against the gathered layouts'
    (`DRYRUN_GATHERED`): the per-rank peak, HBM and collective bytes,
    each beside those; its op table holds no all-gather from the lookup
    and no replicated dispatch, and the dense dispatch's expert products
    are at most 1/16 of the replicated dispatch's (16 expert shards);
    RecurrentGemma-9B's decode peaks under RG_DECODE_PEAK_MAX."""
    import gzip
    with gzip.open(ROOT / rec["ops_path"], "rt") as f:
        rows = json.load(f)
    name = " x ".join(cell)
    gathers = [r for r in rows if r["fn"] in {f"models/layers.py:{f}"
                                              for f in LOOKUP_FNS}
               and "all_gather" in r["op"]]
    check(not gathers, f"phase 40: {name} gathers the table: {gathers}")
    check(not [r for r in rows if r["fn"] == "models/moe.py:_replicated"],
          f"phase 40: {name} runs the replicated dispatch")
    bmm = sum(r["flops"] for r in rows
              if r["fn"] == "models/moe.py:expert_ffn")
    lookup = sum(r["coll_bytes"] for r in rows
                 if r["fn"] == "models/layers.py:_vocab_parallel")
    peak, hbm = rec["memory"]["peak_bytes"], rec["hbm_bytes_per_device"]
    coll = rec["collectives"]["total_bytes"]
    old = DRYRUN_GATHERED[cell]
    print(f"[layout] {name}: per-rank peak {peak} B (gathered: {old[0]}), "
          f"HBM {hbm} B (gathered: {old[1]}), collectives {coll} B "
          f"(gathered: {old[2]}), of which the lookup's all-reduce {lookup} B; the "
          f"dense dispatch's expert products {bmm} FLOPs a rank, "
          f"{rec['flops_per_device']} FLOPs in all; memory term "
          f"{rec['roofline']['memory_s']:.6g} s ({card})", flush=True)
    if cell[0] == MOE_ARCH:
        check(0 < bmm <= MOE_BMM_FLOPS_REPLICATED / 16,
              f"phase 40: {name}'s dense expert products {bmm} FLOPs a "
              f"rank, over 1/16 of the replicated dispatch's "
              f"{MOE_BMM_FLOPS_REPLICATED}")
    if cell[0] == RG_ARCH:
        check(peak < RG_DECODE_PEAK_MAX,
              f"phase 40: {name} peaks at {peak} B a rank")


# this slice: the vocab-parallel lookup and the expert-sharded dense
# dispatch over virtual shards on the card (phase 41): RecurrentGemma-9B's
# table (256000 x 4096 bf16) over a 16-way model axis, at its decode_32k
# tokens (128, 1) and its training batch (2, 2048; a quarter of the tokens
# from the first and last 64 rows, so that rows repeat within one shard
# and the gradient's order of accumulation shows); one Qwen3-MoE layer at
# full width over 16 expert shards, with f whole and cut 16 ways (the
# FSDP rules on the 16 x 16 mesh), at the config's capacity factor
LOOKUP_SHARDS = 16
DISPATCH_SHARDS, DISPATCH_B, DISPATCH_S = 16, 4, 4096
DISPATCH_ULPS = 2.0     # phase 39's rule, at each row's largest |value|


def _mesh_worker():
    """tests/torch_mesh_worker.py (torch and the port only): the virtual
    shards' functions that the CPU tests hold to the reference."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_mesh_worker
    return torch_mesh_worker


def row_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of each last-dim row's
    largest |want| (phase 39's rule)."""
    g, w = got.float(), want.float()
    row = w.abs().amax(dim=-1, keepdim=True)
    return float(((g - w).abs() / bf16_ulp(row)).max())


def lookup_layout_check(dev, card: str) -> None:
    """Phase 41, the lookup: `vocab_virtual` over LOOKUP_SHARDS shards
    against F.embedding and its autograd on the whole table: output and
    table gradient bitwise."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    mw = _mesh_worker()
    cfg = get_arch(RG_ARCH)
    V, D = cfg.vocab_size, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(41)
    table = (0.01 * torch.randn((V, D), generator=gen, device=dev)).to(
        torch.bfloat16)
    dec = torch.randint(0, V, (128, 1), generator=gen, device=dev)
    train = torch.randint(0, V, (RG_MESH_B, RG_MESH_S), generator=gen,
                          device=dev)
    flat = train.view(-1)
    flat[0::8] = torch.randint(0, 64, flat[0::8].shape, generator=gen,
                               device=dev)
    flat[4::8] = torch.randint(V - 64, V, flat[4::8].shape, generator=gen,
                               device=dev)
    for label, tok in (("decode", dec), ("training", train)):
        tok = tok.to(torch.int32)
        g = torch.randn(tuple(tok.shape) + (D,), generator=gen,
                        device=dev).to(torch.bfloat16)
        t = table.detach().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = F.embedding(tok, t)
        (gw,) = torch.autograd.grad(want, [t], g)
        torch.cuda.synchronize()
        whole_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out, gv = mw.vocab_virtual(table, tok, g, LOOKUP_SHARDS)
        torch.cuda.synchronize()
        virt_ms = (time.perf_counter() - t0) * 1e3
        rows = int((gw != 0).any(dim=-1).sum())
        same = {k: "bitwise" if torch.equal(a, b) else "DIFFERS"
                for k, a, b in (("out", out, want), ("grad", gv, gw))}
        print(f"[layout] {RG_ARCH}'s table ({V} x {D} bf16) over "
              f"{LOOKUP_SHARDS} virtual vocab shards, {label} tokens "
              f"{tuple(tok.shape)}: output {same['out']}, table gradient "
              f"({rows} rows touched) {same['grad']}; eager "
              f"{virt_ms:.1f} ms against the whole lookup's {whole_ms:.1f} "
              f"({card})", flush=True)
        check(torch.equal(out, want), f"phase 41: the {label} lookup over "
                                      f"vocab shards differs")
        check(torch.equal(gv, gw), f"phase 41: the {label} table gradient "
                                   f"over vocab shards differs")
        del t, want, gw, out, gv, g
    del table
    torch.cuda.empty_cache()


def dispatch_layout_check(dev, card: str) -> None:
    """Phase 41, the dispatch: `dispatch_virtual` over DISPATCH_SHARDS
    expert shards, with f whole and cut DISPATCH_SHARDS ways, against the
    whole `moe._dispatch` and its autograd: y and the expert weights'
    gradients within DISPATCH_ULPS bf16 ulps of each row's largest |value|
    (a row: a token's y, an expert's weight row), aux equal (the routing
    is the same code on the same inputs). The tokens' gradient runs
    through CUDA's atomic scatter-add in both and is printed."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm
    mw = _mesh_worker()
    cfg = get_arch(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(411)
    params = moe.moe_init(gen, cfg, dev)
    x = torch.randn((DISPATCH_B, DISPATCH_S, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    r = torch.randn(x.shape, generator=gen, device=dev)
    names = ("wi", "wu", "wo")

    def run(fn):
        p = {k: v.detach().requires_grad_(k in names)
             for k, v in params.items() if k != "norm"}
        h = rmsnorm(params["norm"], x, cfg.norm_eps).detach()
        h.requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = fn(p, h)
        grads = torch.autograd.grad((y.float() * r).sum() + aux,
                                    [p[k] for k in names] + [h])
        torch.cuda.synchronize()
        return (y.detach(), float(aux.detach()), grads,
                (time.perf_counter() - t0) * 1e3)

    yw, auxw, gw, whole_ms = run(lambda p, h: moe._dispatch(p, h, cfg))
    for n_mlp in (1, DISPATCH_SHARDS):
        y, aux, g, ms = run(lambda p, h: mw.dispatch_virtual(
            p, h, cfg, DISPATCH_SHARDS, n_mlp))
        uy = row_ulps(y, yw)
        ug = {k: row_ulps(a, b) for k, a, b in zip(names, g, gw)}
        ux = row_ulps(g[-1], gw[-1])
        print(f"[layout] one {MOE_ARCH} layer, tokens ({DISPATCH_B}, "
              f"{DISPATCH_S}), cf {cfg.moe_capacity_factor}, "
              f"{DISPATCH_SHARDS} virtual expert shards x {n_mlp} f "
              f"shards: y {uy:.2f} bf16 ulps of the token's largest |y|, "
              f"aux {aux} against {auxw}; gradients "
              + ", ".join(f"{k} {u:.2f}" for k, u in ug.items())
              + f" ulps of each row's largest, the tokens' {ux:.2f} "
              f"(printed); eager {ms:.1f} ms against the whole "
              f"dispatch's {whole_ms:.1f} ({card})", flush=True)
        check(bool(torch.isfinite(y.float()).all()), "phase 41: y not finite")
        check(uy <= DISPATCH_ULPS, f"phase 41: y {uy:.2f} bf16 ulps from "
                                   f"the whole dispatch ({n_mlp} f shards)")
        check(aux == auxw, f"phase 41: aux {aux} against {auxw}")
        for k, u in ug.items():
            check(u <= DISPATCH_ULPS, f"phase 41: the {k} gradient {u:.2f} "
                                      f"bf16 ulps ({n_mlp} f shards)")
        del y, g
    del params, x, r, yw, gw
    torch.cuda.empty_cache()


CONV_OPS = ("worker_conv", "worker_conv_dgrad", "worker_conv_wgrad")
# CNN5 at width x8 on 28 x 28 x 1 images: (Cin, Cout, H = W)
CONV_LAYERS = {"conv1": (1, 8, 28), "conv2": (8, 16, 14),
               "conv3": (16, 16, 7)}


def without_conv(counts: dict) -> dict:
    """A run's launch counts less the convolution's (every CNN run on the
    card launches it; the wire checks read the rest)."""
    return {k: n for k, n in counts.items() if k not in CONV_OPS}


def conv_launches(spec, rounds: int) -> dict:
    """{operator: {C: launches}} of `rounds` paper rounds of CNN5: a
    local step's 3 forwards, 2 input gradients (conv1's input is the
    image) and 3 weight gradients; 3 forwards for each of the two
    scoring passes at C; 3 at C = 1 for the global loss and 3 for the
    test of the global model the runner makes each round."""
    d, a = spec.data, spec.algo
    C, steps = d.num_workers, (d.n_local // a.batch_size) * a.local_epochs
    return {"worker_conv": {C: rounds * (3 * steps + 6), 1: rounds * 6},
            "worker_conv_dgrad": {C: rounds * 2 * steps},
            "worker_conv_wgrad": {C: rounds * 3 * steps}}


def worker_conv_checks(dev) -> list:
    """Phase 42: the worker-batched convolution at C 200 against its
    plain versions (the vmapped F.conv2d and its autograd, in f64 for
    workers 0, 101 and 199, within the f32 bound of each kernel's sum
    chains) and timed: the forward at CNN5's three layers for a training
    step's 64 images and the scoring's 2,048 (conv1's images shared),
    the input gradient of conv2 and conv3, the weight gradients of all
    three; device (a CUDA graph), eager, plain (ref.py: vmapped cuDNN)
    and library (cuDNN's grouped convolution called once) times; the
    weight gradient bitwise over two calls."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.worker_conv import ops, ref
    C, pick, rows = 200, [0, 101, 199], []
    aten_bwd = torch.ops.aten.convolution_backward

    def within(got, fn, args, chain, what):
        exact = fn(*[a[pick].cpu().double() if a.shape[0] == C else
                     a.cpu().double() for a in args])
        scale = fn(*[a[pick].cpu().double().abs() if a.shape[0] == C else
                     a.cpu().double().abs() for a in args])
        for g, e, m in zip(got if isinstance(got, tuple) else (got,),
                           exact if isinstance(exact, tuple) else (exact,),
                           scale if isinstance(scale, tuple) else (scale,)):
            err = (g[pick].cpu().double() - e).abs()
            tol = (chain + 1) * 2.0 ** -24 * m
            check(bool((err <= tol).all()),
                  f"worker_conv {what}: {float((err - tol).max()):.3g} over "
                  f"the f32 bound")
            yield float(err.max())

    for N in (64, 2048):
        for layer, (cin, cout, hw) in CONV_LAYERS.items():
            shared = N == 2048 and layer == "conv1"
            g = torch.Generator(device=dev).manual_seed(N + cin)
            x = torch.randn((1 if shared else C, N, cin, hw, hw), device=dev,
                            generator=g)
            w = torch.randn((C, 3, 3, cin, cout), device=dev, generator=g)
            b = torch.randn((C, cout), device=dev, generator=g)
            wo = w.permute(0, 4, 3, 1, 2).reshape(C * cout, cin, 3, 3)
            # cuDNN's call as vmap's batching rule makes it: grouped, or
            # with the images shared, one convolution of C x Cout filters
            xg = x[0] if shared else x.transpose(0, 1).reshape(
                N, C * cin, hw, hw)
            shape = (f"f32, C={C} x {N} images, {cin}->{cout} channels, "
                     f"{hw}x{hw}" + (", images shared" if shared else ""))
            # a CUDA graph keeps every launch's output: <= 8 GB of them
            reps = max(1, min(20, int(8e9 // (4 * C * N * cout * hw * hw))))
            cases = {"worker_conv": (
                lambda: ops.conv_raw(x, w, b, shared),
                lambda: ref.worker_conv_ref(x, w, b, shared),
                lambda: F.conv2d(xg, wo, padding=1, groups=1 if shared else C),
                (ops.WORKER_CONV, x, w, b, shared),
                (lambda u, v, c: ref.worker_conv_ref(u, v, c, shared),
                 (x, w, b), 9 * cin + 1))}
            if N == 64:
                gy = torch.randn((C, N, cout, hw, hw), device=dev,
                                 generator=g)
                gyg = gy.transpose(0, 1).reshape(N, C * cout, hw, hw)
                if layer != "conv1":
                    cases["worker_conv_dgrad"] = (
                        lambda: ops.dgrad_raw(gy, w),
                        lambda: ref.worker_conv_dgrad_ref(gy, w),
                        lambda: aten_bwd(gyg, xg, wo, None, [1, 1], [1, 1],
                                         [1, 1], False, [0, 0], C,
                                         [True, False, False]),
                        (ops.WORKER_CONV_DGRAD, gy, w),
                        (ref.worker_conv_dgrad_ref, (gy, w), 9 * cout))
                p = ops.plan(True, C, N, cin, cout, hw, hw)
                chain = (-(-N // p.imgs) * -(-p.imgs * hw * hw // p.groups)
                         + p.groups)
                cases["worker_conv_wgrad"] = (
                    lambda: ops.wgrad_raw(x, gy),
                    lambda: ref.worker_conv_wgrad_ref(x, gy, False),
                    lambda: aten_bwd(gyg, xg, wo, [C * cout], [1, 1], [1, 1],
                                     [1, 1], False, [0, 0], C,
                                     [False, True, True]),
                    (ops.WORKER_CONV_WGRAD, x, gy, False),
                    (lambda u, v: ref.worker_conv_wgrad_ref(u, v, False),
                     (x, gy), chain))
            for name, (kern, plain, lib, cost_args, (fn, args, chain)) in \
                    cases.items():
                out = kern()
                torch.cuda.synchronize()
                err = max(within(out, fn, args, chain, f"{name} {layer} "
                                 f"N={N}"))
                if name == "worker_conv_wgrad":
                    again = kern()
                    check(all(torch.equal(u, v) for u, v in zip(out, again)),
                          f"worker_conv_wgrad {layer}: two calls differ")
                del out
                bound, by = kernel_bound(*cost_args)
                row = {"name": f"{name} ({layer}, N {N})", "route": "cuda",
                       "source": "src/repro_torch/csrc/worker_conv.cu",
                       "replaces": "none: XLA's vmapped lax.conv "
                                   "(src/repro/models/cnn.py:37); cuDNN's "
                                   "per-worker grouped convolutions",
                       "shape": shape, "max_abs_err": err,
                       "ms": graph_ms(kern, reps), "eager_ms": time_ms(kern, 5),
                       "plain_ms": time_ms(plain, 3),
                       "library_ms": graph_ms(lib, min(reps, 5)),
                       "bound_ms": bound, "bound_by": by, "check": "pass"}
                print(f"[worker_conv] {row['name']}: {row['ms'] * 1e3:.1f} "
                      f"us (bound {bound * 1e3:.1f}, {by}), eager "
                      f"{row['eager_ms'] * 1e3:.1f}, plain "
                      f"{row['plain_ms'] * 1e3:.1f}, library "
                      f"{row['library_ms'] * 1e3:.1f}; max "
                      f"err {err:.3g}", flush=True)
                rows.append(row)
                torch.cuda.empty_cache()
            del x, w, b, xg, cases
            torch.cuda.empty_cache()
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (this smoke test runs on the card)")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.experiments import get_scenario, override, run
        from repro_torch.kernels import runtime
        from repro_torch.pytree import tree_leaves
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda", 0)
    # the reference computes in f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    runtime.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(runtime.SOURCES)}", flush=True)
    card = card_line()
    print(card, flush=True)

    stats, large_leaf, dense50 = kernel_checks(dev)
    small_round_check(dev)

    spec = override(get_scenario("low-bandwidth-int4"),
                    f"run.rounds={ROUNDS}")
    runtime.reset_counts()
    t0 = time.perf_counter()
    result = run(spec)
    torch.cuda.synchronize()
    counts = runtime.counts()
    wall = time.perf_counter() - t0
    rec = result.record
    for t in range(ROUNDS):
        print(f"[main] round {t + 1}: {rec['round_time_s'][t]:.4f} s "
              f"loss={rec['global_loss'][t]:.5f} acc={rec['acc'][t]:.4f} "
              f"selected={rec['selected'][t]}/{rec['num_workers']} "
              f"delivered={rec['delivered'][t]} (wire_agg's unmasked "
              f"workers)", flush=True)
    print(f"[main] {ROUNDS} rounds of low-bandwidth-int4 (C=50, cnn5 w8, "
          f"{rec['n_params']} params) in {wall:.2f} s incl. setup; "
          f"launches {counts}", flush=True)
    check(all(math.isfinite(v) for v in rec["global_loss"]), "loss finite")
    check(all(0.0 <= v <= 1.0 for v in rec["acc"]), "acc in [0, 1]")
    leaves = tree_leaves(result.state.global_params)
    check(len(leaves) == LEAVES and rec["n_params"] == 29018,
          f"cnn5 w8 has {len(leaves)} leaves, {rec['n_params']} params")
    check(all(bool(torch.isfinite(v).all()) for v in leaves),
          "global params finite")
    want = ROUNDS * LEAVES
    for name in stats:
        check(counts.get(name, 0) == want,
              f"{name} launched {counts.get(name, 0)} times on the main "
              f"path, expected {want}")
    # the convolutions: all C workers a launch
    conv_by_workers = {k: v for k, v in runtime.counts_by_workers().items()
                       if k in CONV_OPS}
    check(conv_by_workers == conv_launches(spec, ROUNDS),
          f"the convolutions launched {conv_by_workers} on the main path, "
          f"expected {conv_launches(spec, ROUNDS)}")

    profile_round(spec)

    serve_stats = serve_kernel_checks(dev)
    small_serve_check(dev)
    serve_counts = serve_main_path()
    profile_serve(dev)
    hd80_row = hd80_forward_checks(dev)
    hd80_serve_counts = hd80_serve_path()

    bwd_row, mesh_fwd_row = flash_bwd_checks(dev)
    mesh_stats = {"pso_update": pso_checks(dev),
                  "flash_attention_bwd": bwd_row}
    small_mesh_check(dev)
    mesh_counts, mesh_spec = mesh_main_path()
    profile_mesh(mesh_spec)
    hd_bwd_rows = hd_backward_checks(dev)
    hd80_mesh_counts = depth_cut_mesh_rounds(
        dev, HD_ARCH, HD_MESH_LAYERS, MESH_W, HD_MESH_B, HD_MESH_S, 8,
        "hd 80", card)

    straggler_small_check(dev)
    straggler_counts, straggler_by_workers = straggler_main_path(card)
    churn_path(card)
    fleet_counts = fleet_path(card)
    mesh_straggler_counts = mesh_straggler_path(card)
    obs_counts = obs_path(card, rec, counts)
    ckpt_counts = mesh_checkpoint_path(card)
    t0 = time.perf_counter()
    determinism_path(card, rec)
    sweep_counts = sweep_path(card)
    step_counts, step_row = pso_every_step_path(card)
    figure_drivers(card)
    print(f"[time] phases 19-22 (F2, the sweep, per-step Eq. 8, the figure "
          f"drivers): {time.perf_counter() - t0:.1f} s ({card})", flush=True)

    t0 = time.perf_counter()
    scan_rows = scan_bwd_checks(dev)
    small_mesh_check(dev, RG_ARCH)
    rg_counts = depth_cut_mesh_rounds(
        dev, RG_ARCH, RG_MESH_LAYERS, RG_MESH_W, RG_MESH_B, RG_MESH_S, 25,
        "hd 256", card)
    small_xlstm_serve_check(dev)
    xlstm_serve_path(dev, card)
    xlstm_counts = xlstm_mesh_path(card)
    print(f"[time] phases 23-28 (the scan's backward, RecurrentGemma-9B "
          f"training, the xLSTM blocks): {time.perf_counter() - t0:.1f} s "
          f"({card})", flush=True)

    t0 = time.perf_counter()
    new_fwd_rows = new_forward_checks(dev)
    new_bwd_row = new_backward_checks(dev)
    # reduced MoE in f32: 2 attention layers (hd 32: the CUDA-core
    # forward), at cf 1.25 (decode drops picks) and dropless (cf = E / K)
    small_moe = {"prefill": {"flash_attention_f32": 2}, "decode": {}}
    for arch in (MOE_ARCH, ARCTIC_ARCH):
        for kw in ({}, {"moe_capacity_factor": 2.0}):
            got = small_family_check(dev, arch, 300, **kw)
            check(got == small_moe, f"small {arch} serve launched {got}, "
                                    f"expected {small_moe}")
    moe_rec, moe_serve_counts, model, params = big_serve(
        dev, card, MOE_ARCH, 31, 48, 0)
    moe_peak = torch.cuda.max_memory_allocated()
    profile_moe_prefill(dev, card, model, params)
    t1 = time.perf_counter()
    mesh_serve_counts = mesh_serve_path(dev, card, model, params, moe_peak)
    mesh_time = time.perf_counter() - t1
    del model, params
    _, arctic_counts, model, params = big_serve(
        dev, card, ARCTIC_ARCH, 32, ARCTIC_LAYERS, 0, layers=ARCTIC_LAYERS)
    del model, params
    # reduced SeamlessM4T (2 encoder, 2 decoder layers with cross) and
    # LLaVA (a 16-token prefix): per prefill 6 and 2 CUDA-core forwards,
    # per decode step 2 (the cross-attention) and none
    got = small_family_check(dev, ENC_ARCH, 330)
    check(got == {"prefill": {"flash_attention_f32": 6},
                  "decode": {"flash_attention_f32": 2 * 7}},
          f"small {ENC_ARCH} serve launched {got}")
    got = small_family_check(dev, VLM_ARCH, 331)
    check(got == {"prefill": {"flash_attention_f32": 2}, "decode": {}},
          f"small {VLM_ARCH} serve launched {got}")
    # SeamlessM4T: per prefill 24 encoder (non-causal), 24 self (causal)
    # and 24 cross (non-causal) forwards; per decode step the 24 cross
    # forwards (one query over the 4096-frame memory, through the kernel)
    _, enc_counts, model, params = big_serve(dev, card, ENC_ARCH, 34, 72, 24)
    del model, params
    _, vlm_counts, model, params = big_serve(dev, card, VLM_ARCH, 35, 60, 0)
    del model, params
    moe_train_counts = moe_train_rounds(dev, card)
    print(f"[time] phases 29-36 (this slice's flash cases, MoE, the encoder "
          f"with cross-attention, prefix inputs): "
          f"{time.perf_counter() - t0 - mesh_time:.1f} s ({card})",
          flush=True)

    # phase 40's production-mesh dry-runs (CPU work in subprocesses at the
    # lowest priority, one thread each) start here, beside phases 37-39
    runs = start_dryruns()
    try:
        t0 = time.perf_counter()
        mesh_step_counts = mesh_step_path(dev, card)
        ep_layer_check(dev, card)
        print(f"[time] phases 37-39 (the sharded mesh path: build_step's "
              f"round, the mesh serve, EP at Qwen3's layer width): "
              f"{time.perf_counter() - t0 + mesh_time:.1f} s ({card})",
              flush=True)
        t0 = time.perf_counter()
        fake_kernel_checks(dev)
        dispatch_cost(dev, card)
        dryrun_step_check(dev, card)
        dryrun_records(runs, card)
    finally:
        stop_dryruns(runs)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"[time] phase 40 (the dry-run: the kernels' shape rules, phase "
          f"37's step predicted and measured, three production-mesh "
          f"dry-runs, started before phase 37): "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    t0 = time.perf_counter()
    lookup_layout_check(dev, card)
    dispatch_layout_check(dev, card)
    print(f"[time] phase 41 (the vocab-parallel lookup and the expert-"
          f"sharded dispatch over virtual shards): "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)

    src = {"quant_pack_ef": ("quant_pack",
                             "src/repro/kernels/quant_pack/quant_pack.py:172"),
           "wire_agg": ("wire_agg",
                        "src/repro/kernels/wire_agg/wire_agg.py:125"),
           "quant_pack": ("quant_pack",
                          "src/repro/kernels/quant_pack/quant_pack.py:120"),
           "dequant_unpack": ("quant_pack",
                              "src/repro/kernels/quant_pack/quant_pack.py:222")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src[name][0]}.cu",
                "replaces": src[name][1], "launches": counts[name],
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                "eager_ms": s["eager_ms"], "check": "pass"}
               for name, s in stats.items()]
    # the large leaf (C = 50, rows 8192): not a main-path shape; the
    # launches are each kernel's on the main path
    shapes = {"quant_pack_ef": "int4, C=50 x (8192, 128) f32",
              "wire_agg": "int4 mean, C=50 x (4096, 128) u8 -> (8192, 128)",
              "dequant_unpack": "int8, C=50 x (8192, 128) (the dense "
                                "route's decode of all workers)"}
    for name, shape in shapes.items():
        row = next(k for k in kernels if k["name"] == name)
        kernels.append(dict(
            row, name=f"{name} (large leaf)",
            shape=f"{shape}; not on the main path",
            **{key: large_leaf[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "eager_ms")}))
    next(k for k in kernels if k["name"] == "wire_agg (large leaf)")[
        "ms_by_delivered"] = large_leaf["wire_agg"]["ms_by_delivered"]
    replaces = {
        "flash_attention":
            "src/repro/kernels/flash_attention/flash_attention.py:97",
        "rglru_scan": "src/repro/kernels/rglru_scan/rglru_scan.py:48"}
    kernels += [{"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": serve_counts[name],
                 "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                 "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                 "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                 "eager_ms": s["eager_ms"], "check": "pass"}
                for name, s in serve_stats.items()]
    # flash_attention also runs on the mesh path: its launches there, and
    # a row of its own at the mesh shape (its most launched one)
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    fa["launches_mesh"] = mesh_counts["flash_attention"]
    kernels.append(dict(
        fa, name="flash_attention (mesh shape)",
        launches=mesh_counts["flash_attention"], launches_mesh=None,
        **{key: mesh_fwd_row[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "eager_ms", "cuda_core_ms", "f32_ms")}))
    replaces = {
        "pso_update": "src/repro/kernels/pso_update/pso_update.py:42",
        # no TPU kernel: XLA's autodiff of chunked_attention
        "flash_attention_bwd": "src/repro/models/layers.py:129 (XLA autodiff "
                               "of chunked_attention; no TPU kernel)"}
    kernels += [{"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": mesh_counts[name],
                 "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                 "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                 "bound_by": s["bound_by"], "library_ms": s["library_ms"],
                 "eager_ms": s["eager_ms"], "check": "pass"}
                for name, s in mesh_stats.items()]
    # the flash kernels' route, and the times of the CUDA-core kernels
    # they replace (bf16) and of the f32 path (the CUDA-core kernels)
    for k in kernels:
        if k["name"].startswith("flash_attention"):
            st = (mesh_stats["flash_attention_bwd"]
                  if k["name"] == "flash_attention_bwd" else
                  mesh_fwd_row if "mesh" in k["name"]
                  else serve_stats["flash_attention"])
            k.update(cores="tensor cores", cuda_core_ms=st["cuda_core_ms"],
                     f32_ms=st["f32_ms"])
    next(k for k in kernels if k["name"] == "flash_attention_bwd")[
        "library_fwd_bwd_ms"] = \
        mesh_stats["flash_attention_bwd"]["library_fwd_bwd_ms"]
    # this slice: the forward at hd 80 (StableLM-3B's serve prefill; its
    # launches on that path, and on the depth-2 training round), the
    # backward at hd 80 (that round) and at hd 256 (no path runs it yet)
    fa = next(k for k in kernels if k["name"] == "flash_attention")
    kernels.append(dict(
        fa, name="flash_attention (hd 80, StableLM-3B serve shape)",
        shape="bf16 (4, 4096, 32, 80), MHA, causal; the 80 build",
        launches=hd80_serve_counts["flash_attention"],
        launches_mesh=hd80_mesh_counts["flash_attention"],
        cuda_core_ms=None, **hd80_row))
    bwd = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    kernels.append(dict(
        bwd, name="flash_attention_bwd (hd 80, StableLM-3B training shape)",
        shape="bf16 (2, 2048, 32, 80), MHA, causal; the 80 build",
        launches=hd80_mesh_counts["flash_attention_bwd"], cuda_core_ms=None,
        f32_ms=None, library_fwd_bwd_ms=None, **hd_bwd_rows["hd80"]))
    kernels.append(dict(
        bwd, name="flash_attention_bwd (hd 256, RecurrentGemma-9B shape)",
        shape="bf16 (2, 2048, 16, 256), 1 kv head, window 2048; the 256 "
              "build (two passes, head groups)",
        launches=rg_counts["flash_attention_bwd"],
        path="RecurrentGemma-9B training, depth cut to 3 layers (phase 25)",
        f32_ms=None, library_fwd_bwd_ms=None, **hd_bwd_rows["hd256"]))
    # this slice: on each kernel's first row, its launches (at every
    # shape) in the int4 straggler run, the int4 population run and the
    # mesh straggler run; and rows of the straggler route's dense int4
    # uplink and decode over all C = 50 workers (its main-path shape)
    for k in kernels:
        if " (" not in k["name"]:
            k["launches_straggler"] = straggler_counts.get(k["name"], 0)
            k["launches_population"] = fleet_counts.get(k["name"], 0)
            k["launches_mesh_straggler"] = mesh_straggler_counts.get(
                k["name"], 0)
            k["launches_obs"] = obs_counts.get(k["name"], 0)
            k["launches_mesh_ckpt"] = ckpt_counts.get(k["name"], 0)
            k["launches_sweep"] = sweep_counts.get(k["name"], 0)
            k["launches_pso_every_step"] = step_counts.get(k["name"], 0)
    for name in ("quant_pack", "dequant_unpack"):
        row = {key: v for key, v in next(
            k for k in kernels if k["name"] == name).items()
            if not key.startswith("launches_")}
        kernels.append(dict(
            row, name=f"{name} (straggler uplink, int4 C=50)",
            # the run's launches at C = 50 (the uplink's; the int8
            # downlink's are at C = 1)
            shape="int4, C=50 x (256,128)",
            launches=straggler_by_workers[name][50],
            **{key: dense50[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "eager_ms")}))
    # this slice: pso_update at its paper-path shape (per-step Eq. 8)
    pso = next(k for k in kernels if k["name"] == "pso_update")
    kernels.append(dict(
        {key: v for key, v in pso.items()
         if not key.startswith("launches_")},
        name="pso_update (per-step Eq. 8, CNN5 fc1 leaf)",
        shape="f32, C=50 x (784, 32); 10 leaves a step, 32 steps a round",
        launches=step_counts["pso_update"], **step_row))
    # this slice: the scan's backward and the scan at RecurrentGemma-9B's
    # training shape (their launches in phase 25's two rounds), and each
    # kernel's launches in the training and xLSTM mesh runs
    for k in kernels:
        if " (" not in k["name"]:
            k["launches_rg_train"] = rg_counts.get(k["name"], 0)
            k["launches_xlstm_mesh"] = xlstm_counts.get(k["name"], 0)
    scan = next(k for k in kernels if k["name"] == "rglru_scan")
    kernels.append(dict(
        {key: v for key, v in scan.items()
         if not key.startswith("launches_")},
        name="rglru_scan (RecurrentGemma-9B training shape)",
        shape="f32 (2, 2048, 4096)", launches=rg_counts["rglru_scan"],
        path="RecurrentGemma-9B training, depth cut to 3 layers (phase 25)",
        **scan_rows["rglru_scan"]))
    kernels.append(dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/csrc/rglru_scan_bwd.cu",
        replaces="src/repro/models/recurrent.py:112 (XLA autodiff of "
                 "associative_scan; no TPU kernel)",
        launches=rg_counts["rglru_scan_bwd"], shape="f32 (2, 2048, 4096)",
        path="RecurrentGemma-9B training, depth cut to 3 layers (phase 25)",
        check="pass", **scan_rows["rglru_scan_bwd"]))
    # this slice: the forward at hd 128 (Qwen3-MoE's prefill; LLaVA's and
    # Arctic's serve and Qwen3's training run the same build), the
    # non-causal forward (SeamlessM4T's encoder; its self- and
    # cross-attention in the same run) and its cross decode, the backward
    # at hd 128 (Qwen3's training); each kernel's launches in this slice's
    # runs on its first row
    for k in kernels:
        if " (" not in k["name"]:
            k["launches_moe_serve"] = moe_serve_counts.get(k["name"], 0)
            k["launches_arctic_serve"] = arctic_counts.get(k["name"], 0)
            k["launches_seamless_serve"] = enc_counts.get(k["name"], 0)
            k["launches_llava_serve"] = vlm_counts.get(k["name"], 0)
            k["launches_moe_train"] = moe_train_counts.get(k["name"], 0)
    fa = {key: v for key, v in next(
        k for k in kernels if k["name"] == "flash_attention").items()
        if not key.startswith("launches")}
    kernels.append(dict(
        fa, name="flash_attention (hd 128 GQA, Qwen3-MoE prefill shape)",
        shape="bf16 (4, 4096, 32 over 4, 128), causal; the 128 build",
        launches=moe_serve_counts["flash_attention"],
        launches_arctic_serve=arctic_counts["flash_attention"],
        launches_llava_serve=vlm_counts["flash_attention"],
        launches_moe_train=moe_train_counts["flash_attention"],
        path="Qwen3-MoE-30B-A3B served at full width (phase 31)",
        cuda_core_ms=None, f32_ms=None,
        ragged_max_abs_err=new_fwd_rows["hd128 gqa7 ragged"]["max_abs_err"],
        arctic_prefill_max_abs_err=new_fwd_rows["arctic prefill"][
            "max_abs_err"],
        llava_prefill_max_abs_err=new_fwd_rows["llava prefill"][
            "max_abs_err"],
        **new_fwd_rows["hd128 gqa"]))
    kernels.append(dict(
        fa, name="flash_attention (non-causal, SeamlessM4T encoder shape)",
        shape="bf16 (4, 4096, 16, 64), MHA, no mask; the 64 build",
        launches=enc_counts["flash_attention"],
        launches_per_prefill={"encoder, non-causal": 24,
                              "self, causal": 24, "cross, non-causal": 24},
        path="SeamlessM4T-large-v2 served at full width (phase 34)",
        cuda_core_ms=None, f32_ms=None,
        ragged_max_abs_err=new_fwd_rows["non-causal ragged"]["max_abs_err"],
        self_causal_max_abs_err=new_fwd_rows["seamless self"]["max_abs_err"],
        **new_fwd_rows["non-causal"]))
    kernels.append(dict(
        fa, name="flash_attention (cross decode, Sq 1 over 4096 frames)",
        shape="bf16 q (4, 1, 16, 64) over k, v (4, 4096, 16, 64), no mask; "
              "the 64 build",
        launches=enc_counts["flash_attention"],
        launches_per_decode_step=24,
        path="SeamlessM4T-large-v2 served at full width (phase 34)",
        cuda_core_ms=None, f32_ms=None, **new_fwd_rows["cross decode"]))
    bwd = {key: v for key, v in next(
        k for k in kernels if k["name"] == "flash_attention_bwd").items()
        if not key.startswith("launches")}
    kernels.append(dict(
        bwd, name="flash_attention_bwd (hd 128 GQA, Qwen3-MoE training "
                  "shape)",
        shape="bf16 (2, 2048, 32 over 4, 128), causal; the 128 build",
        launches=moe_train_counts["flash_attention_bwd"],
        path="Qwen3-MoE training, depth cut to 2 layers (phase 36)",
        cuda_core_ms=None, f32_ms=None, library_fwd_bwd_ms=None,
        **new_bwd_row))
    # this slice: each kernel's launches on the sharded mesh path (phase
    # 37's build_step round, phase 38's mesh serve) on its first row
    for k in kernels:
        if " (" not in k["name"]:
            k["launches_mesh_steps"] = mesh_step_counts.get(k["name"], 0)
            k["launches_mesh_serve"] = mesh_serve_counts.get(k["name"], 0)
    # phase 42: the worker-batched convolution at C 200, each row with
    # its operator's launches as counted in the main path's 3 rounds (C =
    # 50 and the global model's C = 1), in all and a round
    t0 = time.perf_counter()
    conv_rows = worker_conv_checks(dev)
    print(f"[time] phase 42 (worker_conv at C 200): "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    for row in conv_rows:
        op = row["name"].split(" ")[0]
        row["launches"] = counts.get(op, 0)
        row["launches_per_round"] = counts.get(op, 0) / ROUNDS
    kernels.extend(conv_rows)
    for k in kernels:
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
