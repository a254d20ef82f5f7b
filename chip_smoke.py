#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``hetu_tpu_torch``) on one NVIDIA
GPU: the quickest proof that the port still builds, runs and agrees with
itself on the card.

Run from the root of the repository on a machine with an H100:

    python3 chip_smoke.py [--seed 0]

Phases, in order; any failure ends the run with a non-zero exit and
without the final result line:

1. device — the card's name and power limit; TF32 off.
2. build  — nvcc builds every CUDA source of the port (one process per
   source, all started together).
3. kernel — each kernel (flash forward, flash backward dK/dV and dQ;
   then, in kernel_moe, the row gather, its scatter-add by both routes
   (through the MoE routing's inverse maps, the route the MoE step runs,
   bitwise against the sorted route too; and on sorted ids, timed with its
   split into sort, segments and kernel) and the top-k gate from E 7 to
   65536) against its plain PyTorch version on the card, at the main
   paths' shapes and at edge cases (stated tolerances), then timed with
   CUDA events beside its plain version, one PyTorch library call as a
   yardstick (never used by the port) and its roofline bound.  The
   tensor-core flash kernels (bf16; f32 runs the scalar ones) also at
   edges of their tiles and ring, at head dims 20 to 128, on the attention
   layer's transposed views and on unaligned inputs, two launches bitwise
   equal, with each case's route and the kernels' TFLOP/s and share of
   the bound; and the whole backward (delta, operands, both kernels)
   beside SDPA's backward.
4. slice  — GPT-2-small (published widths, seeded random weights in the
   JAX package's layout, loaded through ``interop.params_from_jax``)
   served by ``ServeEngine`` + ``ContinuousBatchingScheduler`` over 16
   seeded requests; every kernel of the path must have launched, and the
   kernel path's prefill logits must agree with the plain path's.
5. profile — where a prefill step and a decode step spend their time: the
   host clock, the card's busy share and its largest kernels
   (torch.profiler).
6. train  — GPT-2-small at ``bench.py`` ``bench_gpt``'s width and shape
   (B 16, S 1024, bf16, flash, recomputation, fused CE, AdamW): the kernel
   path's loss and every gradient against the plain path's on one batch,
   then 10 ``Executor.run("train")`` steps on one seeded batch (finite,
   falling loss; 2·L flash forwards and L of each backward kernel a step),
   step time, tokens/s, MFU, peak memory and one profiled step.
7. train_moe — the MoE transformer at ``MoEConfig``'s widths (V 32000,
   H 512, 4 layers, 8 heads, ffn 2048, 8 experts, top-2, capacity factor
   1.25), bf16, B 32 x S 512.  On one batch the kernel path (top-k
   kernel, gather dispatch and combine) against two paths that launch
   none of the three kernels: the plain path (the plain gate and the
   gather's plain version), held to the loss limit, the same routes in
   every layer and every gradient; and the einsum dispatch, held to the
   loss limit and the same routes in the first layer.  Then 10 Executor
   steps (finite, falling loss; L gates, 2·L gathers and 2·L scatter-adds
   a step), step time, tokens/s, MFU, peak memory and one profiled step.
7b. train_moe_gates — examples/moe_gates_train.py's loop at MoEConfig's
   widths (one MoELayer, D 512, E 8, FFN 2048, capacity factor 1.25,
   experts in bf16, a fixed head over 10 classes, CE plus aux,
   Adam(3e-3), T 16384 tokens) for the gates the top-k gate never
   produces: hash (by Zipf-skewed vocabulary ids), k-top-1 (k 2),
   balanced assignment (Sinkhorn) and SAM.  For each, on one batch the
   kernel path (the gather dispatch and combine, their scatter-adds
   through the routing's inverse maps) against the plain path: loss,
   identical routes (the balanced assignment's only at near ties of its
   Sinkhorn iterate, ``balance_near_ties``) and every gradient, the
   layer input's included; then 10 Adam steps (finite, falling loss; 2
   gathers, 2 scatter-adds and no top-k gate a step), step time,
   tokens/s, dropped_frac and peak memory.
8. llama_serve — Llama-2-7B at full width (LlamaConfig's defaults) and
   16 of its 32 layers (cut for the script's time limit; the paged,
   migrate and server phases serve this engine), bf16, flash,
   weights drawn on the card from ``--seed``; ``ServeEngine`` +
   ``ContinuousBatchingScheduler`` with 8 slots x 1024 (cut from
   max_position 4096) over 16 seeded requests (prompts of 4-512 tokens,
   8-64 generated); 16 flash forwards a prefill; the kernel path's
   last-position prefill logits against the plain path's on the same
   weights; a profiled prefill and decode step.
9. paged_serve — ``PagedServeEngine`` (16-token pages, 64-token chunks)
   under the scheduler against the slot engine: (a) GPT-2-small in f32,
   the slice phase's burst; (b) Llama-2-7B in bf16, llama_serve's burst
   on llama_serve's serving copy against its plain path, and the chunked
   prefill's last logits (chunks of 64 and 256) against the one-pass
   prefill's; (c) a 384-token system prompt before 16 distinct turns,
   prefix sharing on against off (16 hits of 384 tokens, a lower peak of
   pages).  Every request's tokens held to the near-tie rule
   (``near_tie_divergence``), no flash launch, every page freed once a
   burst drains; TTFT, decode, chunk times, pages, hits, COW copies and
   a profiled paged prefill and decode step.
10. migrate — live KV-slot migration in this process
   (``serve/migrate.py``): ``migrate_inflight`` moves a burst whose 8
   admitted requests are mid-decode (the rest queued) from one engine to
   another on three routes, slot -> slot, slot -> paged and paged ->
   paged: (a) GPT-2-small in f32, the slice phase's burst, every stream
   token-exact against the unmigrated burst; (b) Llama-2-7B in bf16 on
   llama_serve's serving copy, its burst held to llama_serve's streams by
   the near-tie rule.  The adopter adopts one slot per mid-decode request
   and prefills only the queued prompts (its flash forwards: one a layer
   for each, on a slot engine); every slot and page is freed once the
   burst drains.  Then llama_serve's burst drained slot -> slot through
   one payload (``export_payload`` -> ``adopt_payload``) with each codec:
   the imported rows bitwise the exported ones (none, bf16) or within
   blockmax / 254 (int8, at least 1.9x fewer bytes on the wire); payload
   bytes, export, pack, unpack and import ms (and per GB), the re-prefill
   of the same contexts on the adopter and the crossover between the two.
11. server — the front end over the van (``serve/server.py`` over
   ``ps/van.py``, loopback; one ``InferenceClient`` thread a request, all
   released at once): (a) GPT-2-small at the slice's configuration, its
   burst straight through the scheduler and then through
   ``InferenceServer``; (b) Llama-2-7B's burst on llama_serve's serving
   copy; each response ok, the streams held to the straight run by the
   near-tie rule, one flash forward a layer a prefill; client latency,
   TTFT and tokens/s against the straight run; (c) a GPT-2-small engine
   that crashes after a fixed count of decode rounds, ``restart_engine``
   with a fresh engine on the same weights: every request ok, at least
   one requeued, one restart, healthy again, streams by the near-tie
   rule, the time from the crash to the first token after it; (d)
   ``migrate_inflight`` over two ``BlobChannel`` s in 1 MiB chunks:
   GPT-2-small f32 token-exact, and llama_serve's burst slot -> slot with
   each codec (the migrate phase's row and byte gates), send and receive
   ms, the wire's rate and the crossover against re-prefill beside the
   in-process hand-off.
11b. pool — the serving pool (``serve/pool.py``) over GPT-2-small at its
   published widths (V 50257, max_position 1024), three members of 8
   slots x 512 sharing one copy of the weights, the slice's 16 seeded
   requests sent by one thread each through ``pool.generate``: (a) f32
   (the scalar flash forward), every member held at the start of decode
   round 2; the busiest drained mid-decode (over the van, codec none;
   then in process) once its peers have room, or killed: every response
   ok and token-exact to the burst straight through one scheduler, one
   slot moved for each running request, no prefill token on the
   survivors for the migrated ones, ``pool_failovers`` after the kill;
   then ``revive_member`` and new requests on it; (b) bf16 (wgmma), the
   seeded chaos run of the reference's chaos test: a preemption and an
   engine kill from one ``FaultSchedule`` fired every 6 decode rounds of
   the pool through ``FaultInjector`` and ``run_fault_events`` under three
   looping workers; every response ok, each stream by the near-tie rule,
   each ``fault.serve_*`` instant paired with its ``serve.migrate`` /
   ``serve.failover`` span and ranked first by ``diagnose``; detection
   and recovery ms, drain ms and bytes, TTFT p50/p99, tokens/s, peak
   memory.  The flash forwards: one a layer a prefill, re-prefills
   included.
11c. crosshost — the cross-process pool (``serve/crosshost.py``): three
   GPT-2-small member PROCESSES (published widths, weights drawn by
   ``build_engine`` from the seed) of 8 slots x 512 on the card, this
   process their controller over the van the pool owns.  (a) f32: the
   16-request burst through ``pool.generate``, token-exact to the burst
   straight through one scheduler here on the same spec's weights; a
   planned drain of the busiest member over the wire (codec none) while
   the members are parked at a decode round (live slots moved, no
   prefill token for them on the target, the source exits 0, no
   failover); a SIGKILL of a parked member (suspect, lost, ``failover``
   re-prefills on the survivor), then ``revive_member`` (a fresh process
   that takes a new request); a SIGSTOP shorter than lease + grace
   (suspected once, cleared once, no failover); (b) bf16: the seeded
   chaos run of the reference's member kill and suspend, each fault
   paired with its recovery on the merged fleet timeline of the
   workdir's per-process streams, every stream by the near-tie rule.
   The members' flash forwards (scraped from their metrics): one a
   layer a prefill, re-prefills included; no member loads jax.
   Spawn-to-READY seconds, the drain's wire bytes and ms, detection and
   recovery ms, each member's peak memory.
11d. vanchaos — the replicated durable tier (``ps/replica.py``) and the
   standby controller (``resilience/standby.py``): two GPT-2-small member
   processes (published widths, 8 slots x 512) over a replicated pair of
   van processes.  (a) f32: the 16-request burst with both members
   parked at a decode round, the primary van SIGKILLed by the seeded
   ``van_kill`` schedule: the backup promoted (incarnation 2), the pool
   and its members rebound, every stream token-exact to the burst
   straight through one scheduler, ``fault.van_kill`` paired with
   ``van.promote`` on the merged fleet timeline; the automatic resilver
   onto a fresh van (every open table bitwise equal on both vans); a
   second held round kills the promoted primary (incarnation 3).  (b)
   the fence: a SIGSTOPped primary promoted past at the table layer, a
   stale handle refused with ``VanFenced`` after SIGCONT, its retry on
   the backup.  (c) bf16: a controller process streaming seeded
   requests is SIGKILLed after 3 accepts, and a standby process
   self-promotes (PROMOTED, ALLDONE, every accepted rid ok).  The members'
   flash forwards (their last dumps): one a layer a prefill; no member,
   van or standby process loads jax.  Spawn-to-READY seconds, promotion,
   rebind and resilver times, resilver bytes, re-sent submits, the
   standby's times, each member's peak memory.
11e. traffic — the traffic plane (``traffic/loadgen.py``,
   ``traffic/autoscale.py``) over the cross-process pool: three
   GPT-2-small member slots (published widths, f32, 8 slots x 512), the
   reference bench's SLO classes and shedding, two slots parked before
   the trace.  r1, the ok requests a second one member sustains, is
   measured closed-loop (32 requests of the trace's shape, 8 in flight);
   a seeded open-loop trace of 40 s (two tenants, a 10x diurnal spike on
   a base rate of 0.3 r1, the bronze tenant bursting) is replayed through
   ``replay`` while the autoscaler (the reference bench's policy) revives
   and drains members; a calm tail waits for the fleet to shrink.  Hard:
   at least one scale up and one down, each a ``traffic.scale`` span with
   its reason on the merged fleet timeline; every accepted request ok,
   shed or timeout; every ok request that a drain moved, and 64 others
   drawn with the seed, token-exact to a straight run on the members'
   weights (a moved slot prefilled nothing on its adopter); the members'
   flash forwards one a layer a prefill, > 0; no member loads jax; the
   trace's bytes those of the spec synthesized again.  Per tenant ok,
   shed and timeout counts and TTFT p50/p99 (gold's against its 2.5 s
   budget, not a gate), ok-QPS, each action's decision-to-READY and
   READY-to-first-route times, the time at each fleet size, a tick's
   scrape time.
12. train_llama — Llama-2-7B's widths at 4 layers (cut from 32), bf16,
   flash, recomputation, fused CE, AdamW, B 4 x S 4096: the kernel-vs-plain
   gate, then 10 Executor steps (2·L forwards and L of each backward kernel
   a step), step time, tokens/s, MFU, peak memory, one profiled step.
13. train_bert — BERT-base (BASELINE.json's config #3), bf16, flash,
   dropout 0.1, B 16 x S 512 from ``examples/bert_pretrain.py``'s
   synthetic stream, no attention mask (the non-causal kernels): a masked
   forward takes the plain path and launches no kernel; the kernel-vs-plain
   gate with both paths drawing dropout from the same generators; 10
   Executor steps (L of each kernel a step), step time, samples/s, MFU,
   peak memory, one profiled step.
14. train_ctr — device-resident Wide & Deep at ``bench.py`` bench_ctr's
   widths, uncut (a [33 000 000, 16] f32 table drawn on the card, 26
   sparse and 13 dense fields, hidden (256, 256), B 2048, SGD(0.01)): the
   kernel path against the plain path (``emb_impl="xla"`` and the
   deduplicate sum by ``index_add_``), one step from the same state on a
   uniform and a Zipf-skewed batch (loss and dense parameters bitwise,
   touched rows within the bound of a sequential f32 sum carried through
   the update, 10^5 untouched rows unchanged); 10 sparse steps on one batch
   (finite, falling loss; 1 gather and 1 scatter-add a step; peak memory
   under the table plus 1 GB), step time, samples/s, bench_ctr's roofline,
   one profiled step; the masked step over BucketedLoader's buckets; the
   gather (cold rows) and the deduplicate sum at the step's shapes against
   their plain versions, timed beside them, ``index_select`` /
   ``index_add_`` and the bound.
15. ps_ctr — ``WideDeep`` (Adam) on 1M-row ``PSEmbedding`` rows through
   ``examples/ctr_wdl.py``'s pipeline (prefetch, pull, step, push), B 2048,
   20 steps: bench_ctr's PS leg (sgd, no cache), then an adagrad table
   behind the HET cache (131072 rows, lfuopt); then both again on the
   table key-range-partitioned over two van servers, each in a process
   of its own on loopback (``PSEmbedding(endpoints=...)``, the remote HET
   cache); falling loss, a hit rate above 0; pull, step and push times,
   samples/s and the van bytes a step; and the replay gate: the
   in-process sgd arm's initial rows and pushes replayed on the
   partitioned table leave it equal to the in-process table (rtol 1e-6,
   the count of bitwise rows printed).
15a. recsys — online CTR serving (``serve/recsys.py``): ``WideDeep`` at
   train_ctr's widths (26 sparse fields, emb dim 16, 13 dense, hidden (256,
   256)), f32 on the card, its weights drawn from the seed in the JAX
   package's layout, behind ``ServingEmbeddingCache`` s (131072 rows, LRU,
   pull_bound 1) over a van ``PartitionedPSTable`` of 1M x 16 f32 rows
   (adagrad) on two shard processes (ps_ctr's PS leg, cut from train_ctr's
   33M card-resident rows), engines of max_batch 256 from bucket 8.  (a)
   bench_ctr_serve's A/B: 4096 seeded single requests (Zipf(1.2) ids) in
   waves of 8 through ``RecsysBatcher.step``, cached against cache-less in
   alternating rounds: every request ok, one fixed batch of each bucket
   bitwise equal through both engines, every score within 1e-5 of a
   float64 CPU forward on the same rows, at most one shape a bucket, a hit
   rate above 0; QPS, TTFR p50/p99, hit rate, PS bytes and the median
   gather, dispatch and device_wait spans.  (b) a two-member
   ``RecsysPool`` while a trainer thread writes a version-encoded sentinel
   row over the van: every served sentinel at most pull_bound versions
   stale; ``kill_member`` fails over with every request ok;
   ``revive_member`` routes to the revived member again and closes the
   dead engine's cache once; 64 requests through ``pool.frontend()`` and a
   ``RecsysClient`` within 1e-6 of the same request in process.  (c) the
   reference chaos test's seeded shard SIGKILL under traffic: every
   request ok, degraded lookups, the shard restarted on its port and no
   cache left degraded, ``fault.kill_shard`` paired with
   ``serve.recsys_degrade``; kill -> first degraded answer, the window and
   restart -> recovered.  (d) an open-loop CTR trace (10 s, base 50/s, a
   10x diurnal peak, 65536 Zipf ranks over the 1M keys) through
   ``ctr_submitter``: every request ok, shed or timeout, one ok at least;
   counts, TTFR p50/p99 and the replay's lag behind the trace.  No kernel
   of the six launches.
15b. supervise — the training supervisor (``resilience/supervisor.py``):
   (a) GPT-2-small at its published widths (V 50257, max_position 1024;
   bf16, flash, remat, AdamW) and 6 of its 12 layers, B 8 x S 1024, 12
   ``Supervisor`` steps with
   two data faults (``retries_data`` 2, a ``recovery.retry`` span each),
   run twice in this process, uninterrupted and with no checkpoint
   directory (the card's reproducibility: bitwise or the twins' gap);
   then in a child process (no jax, no hetu_tpu) checkpointing every 4
   (keep 2) and held after step 5 while it is sent SIGTERM: it exits 0 at
   step 6 with checkpoints 4 and 6; checkpoint 6's body is corrupted and
   a second child skips it by its CRC, restores step 4 and finishes at
   12, its final checkpoint held to the uninterrupted arms (parameters,
   AdamW slots, step, rng words and (seed, seqnum) bitwise if the twins
   are, else within their gap); 2 L flash forwards and L of each
   backward kernel a step in every run; the step time supervised and
   bare, each save's and the restore's bytes and ms, SIGTERM -> exit and
   start -> first step.  (b) ps_ctr's PS leg (1M x 16 f32 adagrad rows
   over two van shard processes, WideDeep under Adam, B 2048) through
   ``train_guarded`` for 40 steps under the reference chaos test's seeded
   schedule (a shard SIGKILLed and restarted on its port, a NaN batch,
   two van faults), ``PSShardGuard`` snapshotting every 5: the counters,
   the repaired shard's rows and slots bitwise its snapshot of before the
   kill, the live shard unchanged, a falling loss, each fault paired with
   its recovery span; snapshot and repair ms, death -> repaired s.
15c. elastic — the multi-controller elastic training plane
   (``resilience/multicontroller.py``, ``resilience/memberproc.py``) and
   the standby's elastic takeover, over one van process: three worker
   processes (numpy over the van, neither torch nor jax) train a seeded
   regression on a [1024, 1024] f32 weights table (4 MiB) and a [3072,
   1024] staging table with rank-ordered apply, 6144 samples, global
   batch 768, lr 0.05, 48 steps.  (a) two clean in-process supervisors:
   complete covers, the final weights bitwise equal and within 1e-5 of
   max|w| of a plain numpy replay, a falling loss; (b) the seeded worker
   SIGKILL: the shrink at width 2, 5 survivor steps, a replacement grows
   the fleet back to 3, widths {2, 3}, the kill paired with
   ``elastic.reshard`` within 10 s; (c) the controller a process of its
   own, SIGKILLed by the seeded schedule under a standby process
   (``plane="elastic"``): PROMOTED and ALLDONE, incarnation >= 2, a
   ``takeover`` resize, a complete cover, the final weights bitwise (a)'s
   where no gradient was re-pushed, the kill paired with
   ``ctrl.takeover``.  No worker, controller or standby loads torch or
   jax.  The median step ms and the van's bytes a step of each arm, the
   detection, shrink, READY, grow and hand-off times; the phase's seconds
   against its 60 s budget.
15d. train_cnn — examples/cnn_resnet.py's ResNet-18 / CIFAR-10 (f32, B
   128, Momentum(0.9) under the cosine schedule) on its ``--subset`` of
   the synthetic CIFAR-10 through ``Dataloader`` and 20
   ``Executor.run("train")`` steps (finite, falling loss; the batch norms'
   buffers are the state's model state; no kernel of the six launches),
   ``validate``, a checkpoint round trip (the next step's loss bitwise);
   one step in f32 (TF32 off) against float64 through the same ReLU
   pattern, at the initial and the trained weights (loss, every gradient,
   the new statistics); step time, samples/s, the conv and fc FLOPs a
   step over the f32 peak, peak memory, one profiled step; then VGG-16
   (BN, DropOut from the step's generator), LeNet (MNIST padded to 32 x
   32) and the MLP, 10 steps each (finite, falling loss).
15e. train_rnn — examples/rnn_mnist.py's recurrent classifiers (rnn,
   lstm, gru; 28 rows of 28 pixels, hidden 128, B 128, Adam(1e-3)), 20
   Executor steps each on a 256-sample subset of the synthetic MNIST
   (finite, falling loss; no kernel of the six launches), one pass in f32
   against float64; step time, samples/s, peak memory, one profiled step.
15f. train_gcn — the 2-layer GCN (hidden 256, dropout 0.5, Adam(0.01)) on
   a seeded graph at ogbn-arxiv's sizes (169 343 nodes, 128 features, 40
   classes, 2 332 486 directed edges), 20 full-graph Executor steps
   (finite, falling loss; gcn_norm's degrees exact; no kernel launches),
   one pass in f32 against float64 through f32's ReLU pattern; step time,
   nodes/s, peak memory, one profiled step.
15g. gcn_sampled — the same graph published to in-process PS tables,
   GraphSAGE's sampling (fanouts 25, 10; 512 seeds) through
   ``NeighborSampler``, 8 padded batches normalised on the card and
   trained through the Executor (every sampled edge real, fan-in bounded,
   the loss of the last 3 batches below the first 3's); sample, pull and
   step times.
15h. ops_zoo — every op of the elementwise, shape, reduce and matmul
   families on the card against the CPU (index and shape ops exactly,
   arithmetic within 1e-6 of max|y|; ties for top-k, argsort, unique).
15i. train_compressed — examples/rec_compressed.py's loop (the
   EmbeddingMemoryCompression tool's run_compressed) at train_ctr's
   Criteo-Kaggle table: V 33 000 000, D 16, 26 fields, the example's head
   (one hidden layer of 32), Adam(5e-3), B 2048, 10 steps over 4
   Zipf-skewed batches, for the full table and each of the 16 trainable
   methods of the compression zoo (DPQ and MGQE cut to 2^22 rows: their
   [V, 4, 64] logits with gradient and Adam take 4 KiB a row); finite,
   falling loss, step time (host clock and CUDA events), samples/s, peak
   memory and parameter bytes against the full table's (the eight
   storage-compressing methods below it); the int8 serving form of the
   trained full table bitwise on the card and the CPU, DPQ's serving
   lookups against its hard path, the pruned table's ELL lookups bitwise,
   a DeepLight schedule (prune rate, then int8), PEP's retrain under its
   frozen mask, AutoDim's bi-level trainer and OptEmbed's flow; one pass
   of each method at V 2^20 in f32 against float64 through f32's discrete
   choices (codes, rounding, masks, ReLUs).  No kernel of the six
   launches.
15j. mesh, sharded, dppipe — two gloo rank processes on the card: the
   data- and tensor-parallel plane, the fully sharded GPT-MoE, then
   (dppipe) the elastic supervisor (GPT-2-small at 4 layers, dp 2, worker
   1 lost at step 2 and back at step 4, against a fault-free run; both
   ranks' states bitwise after the grow), the partial-reduce step (masks
   [1, 1], [1, 0], [0, 0] against the Executor and one process), the
   distributed GCN on an arxiv-sized graph (gather and ring routes
   against one process's ``coo_spmm``), the 1F1B pipeline (a tanh stack
   and GPT-2-small's blocks against the sequential stack) and HetPipe
   over a van (the protocol's replay, two workers under SSP, a staleness
   trip); each arm's flash launches exactly as counted from the code.
16. kernel_shapes — the three flash kernels at the new paths' shapes:
   (1, 32, S, 128) causal for S = 128, 512 and 1024 (the forward), (4, 32,
   4096, 128) causal and (16, 12, 512, 64) non-causal (forward and
   backward), each held against its plain version, timed beside it, SDPA
   and the bound.

The last three lines of standard output are the card's name and power
limit (as nvidia-smi gives them), the kernel report
``{"kernels": [...]}`` (all six kernels: the three flash kernels, the top-k
gate, the gather and the scatter-add, the last two with their CTR
launches and times; each with its launches by path, 0 on the CNN, RNN,
GCN, compression, recsys and elastic paths, and the dppipe path's) and
``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import itertools
import json
import os
import select
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# GPT-2-small at the serving bench's widths (bench.py bench_serve); the
# serving burst's prompt lengths and generation counts
V, H, L, NH, FFN, MAX_LEN, SLOTS, N_REQUESTS = (
    50304, 768, 12, 12, 3072, 512, 8, 16)
GPT_PROMPT, GPT_GEN = (4, 128), (8, 64)
HEAD_DIM = H // NH

# kernel-vs-plain tolerances on the card.  bf16: the kernel rounds the
# probabilities to bf16 against its running (per-tile) row max, the plain
# version against the final max, so O may differ by about one bf16 ulp of
# values of size ~1 (2^-7 = 7.8e-3); 2e-2 leaves headroom.  f32: only the
# order of f32 sums differs.  The LSE is f32 in both types.
TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# plus a relative term for bf16 outputs above 1, where one bf16 ulp
# (2^-8 relative) exceeds 4e-3
RTOL_O = {torch.bfloat16: 1e-2, torch.float32: 0.0}
TOL_LSE = 1e-4
# kernel path vs plain path, last-position prefill logits of the bf16
# model: twelve layers of bf16 rounding at different points (the plain
# composition normalises before rounding the probabilities)
TOL_LOGITS = 5e-2
# backward kernels vs the plain backward, dQ/dK/dV, as (ATOL, ATOL_ROW,
# RTOL): each element passes when |d| <= ATOL * max|ref| + ATOL_ROW *
# max|ref row| + RTOL * |ref|, where the row is the element's own output
# row (its query for dQ, its key for dK and dV).  ATOL is a floor for rows
# that are rounding noise (the first query's dQ is exactly zero in exact
# arithmetic, since dP_00 = delta_0 there).  A bound in absolute units
# alone cannot serve: along a causal sequence the gradients shrink (with
# randn inputs and scale 1/8, p_ij is about 1/i, so the rms of dK_j and
# dV_j is about sqrt(2.7 (1/j - 1/S)): 0.013 at j = 960 of 1024, while the
# first rows reach a few units), and a bound that spares the first rows
# waves through errors in the last tiles of the size of their values.
# Both versions round p and dS to the input type at the same points
# and sum in f32, so in f32 only the order of the sums may differ (2^-24
# per term; 1e-5 is a hundredfold margin).  In bf16 a sum summed in
# another order may land one ulp away when rounded to bf16 once at the end
# (one ulp is at most 2^-7 of the value), and a p or dS next to a rounding
# boundary may flip by one ulp, which moves an element near zero by about
# 2^-8 of its row's size.  The floors, 2^-16 (bf16) and 1e-6 (f32) of the
# largest element, stay far below the last tiles' values.
TOL_D = {torch.bfloat16: (2 ** -16, 2 ** -8, 2 ** -7),
         torch.float32: (1e-6, 1e-5, 1e-5)}
# the bf16 forward at the Llama and BERT shapes, held per output row as
# the backward is (an absolute bound is blind in the last rows of a long
# causal sequence), in TOL_D's form.  The kernel rounds each p to bf16
# against its running max, the plain version against the final one: each
# p may land one bf16 ulp apart, and the sum moves an output element by
# up to 2^-8 of sum_j p_j |v_j|, which exceeds the row's largest |O| where
# the row's terms cancel.  Over 6-13 M elements the tail of that reaches
# 2^-8 of the row max: TOL_D read 0.988 of its limit on an H100 at (1, 32,
# 1024, 128), and an emulation of the kernel's per-tile rounding on the
# CPU 1.13 at (16, 12, 512, 64).  A row term of 2^-7 keeps a margin of
# about two (0.49-0.61 in that emulation over three seeds) and refuses
# outputs 10 % off in the last query tile at S 4096.
TOL_F = {torch.bfloat16: (2 ** -16, 2 ** -7, 2 ** -7)}
# training step, kernel path vs plain path (attention_impl="xla") on one
# batch of the bf16 model.  The paths round at other points: the flash
# forward rounds p against the running max, the plain path the normalised
# probabilities; the plain backward rounds dP (a bf16 product) where the
# kernels keep it in f32 and round dS.  Sound kernels read a loss gap of
# 5.2e-5 and gradients within 1.22e-2 of each parameter's largest element
# on an H100 (seed 0); the limits leave a margin of 20 and of 2.5 over
# those readings.  The script also prints the gap between the plain bf16
# path and an f32 model: the size of a difference in bf16 rounding alone.
TOL_TRAIN_LOSS = 1e-3
TOL_TRAIN_GRAD = 3e-2  # max |dG| <= TOL_TRAIN_GRAD * max |G_plain|

# the training phase's shape: bench.py bench_gpt
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 16, 1024, 10, 1e-4

# the MoE training slice: MoEConfig's widths (hetu_tpu/models/
# moe_transformer.py:24-35), bf16, at bench.py bench_moe's T (B 32 x S 512)
MOE_V, MOE_H, MOE_L, MOE_NH, MOE_FFN, MOE_E, MOE_K, MOE_CF = (
    32000, 512, 4, 8, 2048, 8, 2, 1.25)
MOE_B, MOE_S, MOE_STEPS, MOE_LR = 32, 512, 10, 1e-4
MOE_T = MOE_B * MOE_S
MOE_C = max(1, int(MOE_CF * MOE_T * MOE_K / MOE_E))  # 5120 slots an expert
MOE_BENCH_D = 768  # bench.py bench_moe's layer width
# MoE kernels against their plain versions.  The gather copies rows and the
# scatter-add sums at most two rows in f32 and rounds once (a + b is the
# same in either order), so both must be bitwise equal to their plain
# versions at the path's shapes; so must a scatter of small integers
# (exact sums in any order), however many duplicates.  Under heavy
# duplicates of random values the plain version's atomics sum in another
# order: each f32 sum of n terms lies within (n - 1) * 2^-24 * sum|g| of the
# exact one, so the two within twice that, and a bf16 result may land one
# ulp (at most 2^-7 of the value) away.  The gate's indices must be equal;
# its gates differ at most by the rounding of exp and the division (1e-6
# in f32 for values <= 1) or one bf16 ulp of a value below 1 (2^-8).
TOL_GATES = {torch.float32: 1e-6, torch.bfloat16: 2 ** -8}

# the MoE gates: examples/moe_gates_train.py's loop at MoEConfig's widths
# (one MoELayer, D 512, E 8, FFN 4 D, capacity factor 1.25, experts in
# bf16, a fixed linear head over 10 classes, CE plus aux, Adam(3e-3)) over
# the MoE slice's T = 16384 tokens, for each gate the top-k gate never
# produces: hash (k 1, routed by Zipf-skewed vocabulary ids, so that load
# depends on the ids), ktop1 (k 2: capacity 5120), balance (Sinkhorn, 20
# rounds) and sam (k 1: capacity 2560)
GATES = ("hash", "ktop1", "balance", "sam")
GATES_FFN, GATES_CLASSES, GATES_STEPS, GATES_LR = 4 * MOE_H, 10, 10, 3e-3
GATES_KTOP1_K, GATES_ITERS = 2, 20
# Sinkhorn near ties: each of the 2 x iters normalisations subtracts a
# logsumexp whose rounding moves an entry by a few ulps of the largest
# magnitude in its row (XLA's and torch's sums, the card's and the
# CPU's, run in other orders); at 4 ulps a normalisation on each of two
# computations, two runs part by at most 16 x iters x eps x max_j |lp[t, j]|
# (measured between the packages on the CPU at [16384, 8]: 8.6e-6, a fifth
# of the bound at the smallest row max, log 8).  A route may differ only
# where the top two lp of a row lie that close.
BALANCE_TIE_ULPS = 16  # a Sinkhorn round

# Llama-2-7B (LlamaConfig's defaults; hetu_tpu/models/llama.py:31-45) at
# its widths; served at LLAMA_L = 8 of its LLAMA_DEPTH = 32 layers (cut
# for the whole script's time limit: the serving, paged, migration and
# front-end phases run its bursts, decodes and 8-slot drains; 16 until the
# mesh phase joined)
LLAMA_V, LLAMA_H, LLAMA_L, LLAMA_NH, LLAMA_FFN, LLAMA_P = (
    32000, 4096, 8, 32, 11008, 4096)
LLAMA_DEPTH = 32
LLAMA_HEAD_DIM = LLAMA_H // LLAMA_NH  # 128
# serving: 8 slots x 1024 (cut from max_position 4096: a 2.1 GB cache at
# 16 layers), one closed burst of 16 requests
LLAMA_SLOTS, LLAMA_MAX_LEN, LLAMA_REQUESTS = 8, 1024, 16
LLAMA_PROMPT, LLAMA_GEN = (4, 512), (8, 64)
LLAMA_FWD_S = (128, 512, 1024)  # the forward timed at (1, 32, S, 128)
# kernel path vs plain path, last-position prefill logits of the bf16
# Llama-2-7B, as a share of the largest |logit|: the two paths round p at
# other points, about one bf16 ulp (2^-8 relative) of each layer's
# attention output; added up in quadrature over 32 layers that is about
# 2.2e-2 of the residual stream, which the final RMSNorm and the head
# carry into the logits.  5e-2 leaves a margin of two over that estimate.
TOL_LLAMA_LOGITS = 5e-2
# paged serving: the pool's page of 16 tokens, the default chunk (4 pages).
# The near-tie rule's bound for f32 GPT-2-small: f32's unit roundoff 2^-24,
# times sqrt(768) products in each sum, times 12 layers (about 2e-5), with
# a margin of five; it is also TOL_O[float32].  bf16 Llama-2-7B is held to
# TOL_LLAMA_LOGITS.  The shared system prompt: 384 tokens (24 whole
# pages), a distinct user turn of 16-128 tokens for each of 16 requests,
# 8-64 generated each.  The chunked prefill is held at the model level at
# these prompt lengths and chunk sizes.
PAGE_SIZE = 16
TOL_F32_LOGITS = 1e-4
SYS_PROMPT, SYS_SUFFIX, SYS_GEN, SYS_REQUESTS = 384, (16, 128), (8, 64), 16
CHUNK_CHECK_PROMPTS, CHUNK_CHECK_SIZES = (7, 100, 300, 512), (64, 256)
# migration: the source's scheduler steps before every in-flight request
# moves (a slot engine's 8 admitted requests then hold 5 tokens each, none
# finished: 8 generated at least; a paged source steps on until its
# chunked prefills are done, at most 8 chunks of 64); a paged source's
# chunk budget a step, so that every prefill in flight advances a chunk
# each step; the drain's codecs
MIGRATE_STEPS, MIGRATE_CHUNKS = 4, 64
MIGRATE_CODECS = ("none", "bf16", "int8")
# the front end: one InferenceClient thread (and one listener) a request
# of a burst, the van on loopback, a server-side deadline far above a
# burst's wall time; the failover engine crashes once it has run 4
# decode rounds (every admitted request then holds 5 of its 8 or more
# tokens) and is restarted inside the grace window; the wire moves 1 MiB
# chunks
SERVER_TIMEOUT_S, FAILOVER_CRASH_AT, FAILOVER_GRACE_S = 300.0, 4, 60.0
WIRE_CHUNK = 1 << 20
# the serving pool: GPT-2-small at its published widths (V 50257,
# max_position 1024), three members of 8 slots x 512 sharing one copy of
# the weights; a drain or a kill lands while every member is held at the
# start of decode round POOL_HOLD_AT (each admitted request then holds 3
# of its 8 or more tokens); the chaos run fires a step of its schedule
# every POOL_ROUNDS_PER_STEP decode rounds of the pool, under traffic from
# POOL_WORKERS threads looping over the burst
POOL_V, POOL_P, POOL_MEMBERS, POOL_SLOTS, POOL_MAX_LEN = (
    50257, 1024, 3, 8, 512)
POOL_HOLD_AT, POOL_ROUNDS_PER_STEP, POOL_WORKERS = 2, 6, 3
POOL_TIMEOUT_S = 300.0
# the cross-process pool: the serving pool's model and slots in
# CROSS_MEMBERS member processes; a drain, a kill or a SIGSTOP lands while
# the members are parked at a decode round (CROSS_WAVE requests a member in
# flight); the lease is CROSS_LEASE_S + CROSS_GRACE_S of grace, and a
# suspend runs at CROSS_SUSPEND = (lease, grace, the SIGSTOP's seconds),
# 3x on either side
CROSS_MEMBERS, CROSS_WAVE = 3, 2
CROSS_LEASE_S, CROSS_GRACE_S = 1.0, 1.0
CROSS_SUSPEND = (0.5, 4.5, 1.5)
CROSS_WAIT_S = 60.0  # a lease decision's own deadline
# the durable tier under van death: the cross-process pool's model and
# slots in VAN_MEMBERS member processes over a replicated pair of van
# processes (the reference's chaos settings: promotion grace, receive
# timeout, revalidation cadence, resilver settle), each van kill landing
# while the members are parked at a decode round; the fence's SIGSTOP
# with a 1 s receive timeout; the standby's fleet (a controller process
# streaming VAN_CTRL_REQUESTS seeded requests of VAN_CTRL_TOKENS tokens,
# one every VAN_CTRL_GAP_S) SIGKILLed after at least VAN_ACCEPTS accepts,
# its standby claiming after VAN_LEASE_BOUND_S of silence
VAN_MEMBERS = 2
VAN_SPEC = {"promote_after_s": 0.3, "rcv_timeout_s": 1.5,
            "revalidate_s": 0.05, "resilver_settle_s": 0.2}
VAN_FENCE_RCV_S = 1.0
VAN_ACCEPTS, VAN_CTRL_REQUESTS, VAN_CTRL_TOKENS, VAN_CTRL_GAP_S = (
    3, 1000, 24, 0.1)
VAN_LEASE_BOUND_S = 2.0
# the pair is compared until it agrees, within ten times the 1 s a
# replica skips a backup it found unreachable
VAN_EQUAL_WAIT_S = 10.0
VAN_BUDGET_S = 90.0
# the traffic plane: the cross-process pool's model and slots in
# TRAFFIC_MAXM member slots, TRAFFIC_MINM of them serving when the trace
# starts (the rest parked by a close drain); r1, the ok requests a second
# one member sustains, measured closed-loop over TRAFFIC_R1_N requests of
# the trace's shape with TRAFFIC_R1_INFLIGHT in flight (after
# TRAFFIC_R1_WARM more); the trace's base rate TRAFFIC_BASE_SHARE * r1,
# so its TRAFFIC_PEAK_X peak asks three members' worth; the reference
# bench's SLO classes and autoscaler policy (bench.py bench_autoscale); a
# calm tail of at most TRAFFIC_TAIL_S waiting for the fleet to shrink;
# TRAFFIC_SAMPLE ok requests beside the drained ones held token-exact
TRAFFIC_MINM, TRAFFIC_MAXM = 1, 3
TRAFFIC_R1_N, TRAFFIC_R1_INFLIGHT, TRAFFIC_R1_WARM = 32, 8, 8
TRAFFIC_BASE_SHARE, TRAFFIC_PEAK_X, TRAFFIC_DURATION_S = 0.3, 10.0, 40.0
TRAFFIC_GEN, TRAFFIC_PROMPTS, TRAFFIC_PROMPT_LEN = 16, 64, 64
TRAFFIC_GOLD_SLO_S = 2.5
TRAFFIC_SLO_CLASSES = {
    "gold": {"priority": 2, "weight": 4.0,
             "ttft_slo_s": TRAFFIC_GOLD_SLO_S},
    "bronze": {"priority": 0, "weight": 1.0, "ttft_slo_s": None}}
TRAFFIC_POLICY = {"min_members": TRAFFIC_MINM,
                  "max_members": TRAFFIC_MAXM, "interval_s": 0.3,
                  "queue_high": 2.0, "queue_low": 0.5, "shed_high": 0.02,
                  "shed_low": 0.005, "up_ticks": 2, "down_ticks": 4,
                  "up_cooldown_s": 1.0, "down_cooldown_s": 2.0}
TRAFFIC_SCRAPE_S = 0.25
# the controller's journal holds every unresolved request with its prompt
# (up to 63 tokens): hundreds queue at the spike, past the 64 KB base
# snapshot of the pool's default 2048 ledger rows; four times that
TRAFFIC_LEDGER_ROWS = 8192
TRAFFIC_TAIL_S = 40.0
TRAFFIC_SAMPLE = 64
TRAFFIC_BUDGET_S = 120.0
# training: Llama-2-7B's widths, depth cut to 4 layers (f32 weights,
# gradients and AdamW's two slots: 17 GB; at 32 layers 108 GB), at the
# config's max_position and bench_gpt's 16384 tokens a step
LLAMA_TRAIN_L, LLAMA_TRAIN_B, LLAMA_TRAIN_S = 4, 4, 4096
LLAMA_STEPS, LLAMA_LR = 10, 1e-4

# BERT-base (BertConfig's defaults; BASELINE.json's config #3), B 16 x S 512
BERT_V, BERT_H, BERT_L, BERT_NH, BERT_FFN, BERT_P = (
    30522, 768, 12, 12, 3072, 512)
BERT_B, BERT_S, BERT_STEPS, BERT_LR, BERT_WD, BERT_DROPOUT = (
    16, 512, 10, 1e-4, 0.01, 0.1)

# CTR: bench.py bench_ctr's Wide & Deep at the scale of Criteo-Kaggle's
# hashed vocabulary (BASELINE.json's config #4), uncut: a [33M, 16] f32
# table on the card (2.11 GB), 26 sparse fields, 13 dense, hidden (256,
# 256), B 2048, SGD(0.01); the masked step over BucketedLoader's buckets of
# CTR_MASKED_SIZES; one batch of Zipf-skewed ids (a = 1.2, clipped to V)
# for long duplicate runs.  The PS leg: WideDeep with Adam(1e-3) on a
# 1M-row PSEmbedding (bench_ctr's PS leg: sgd, lr 0.01; then the example's
# adagrad table, lr 0.05, behind a 131072-row lfuopt HET cache)
CTR_V, CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN = (
    33_000_000, 26, 16, 13, (256, 256))
CTR_B, CTR_STEPS, CTR_LR, CTR_ZIPF_A = 2048, 10, 0.01, 1.2
CTR_MASKED_SIZES = (2048, 1500, 700, 37)
CTR_UNTOUCHED_SAMPLE = 100_000
CTR_PS_V, CTR_PS_CACHE, CTR_PS_STEPS, CTR_PS_LR = 1_000_000, 131072, 20, 1e-3
CTR_PS_SGD_LR = 0.01
# the remote arms: the same table key-range-partitioned over two van
# servers, each in a process of its own on loopback, ready within a minute
VAN_SERVERS, VAN_READY_S = 2, 60.0
_VAN_SERVER_SRC = (
    "import sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "from hetu_tpu_torch.ps import van\n"
    "print('READY', van.serve(0), flush=True)\n"
    "sys.stdin.read()\n")  # serves until the parent closes the pipe
CTR_GATHER_SETS = 32  # id sets the gather's timing cycles through

# online CTR serving (serve/recsys.py): train_ctr's Wide & Deep widths (26
# sparse fields, emb dim 16, 13 dense, hidden (256, 256)), f32, its weights
# drawn with numpy from the seed in the JAX package's layout; a van
# PartitionedPSTable of ps_ctr's PS-leg rows (1M x 16 f32, adagrad) over two
# shard processes; caches of ps_ctr's HET capacity, pull_bound 1, LRU;
# engines of max_batch 256 from bucket 8.  (a) bench_ctr_serve's A/B: 4096
# single requests (Zipf(1.2) ids, standard-normal dense) in waves of 8
# through RecsysBatcher.step, cached against cache-less in alternating
# rounds, two each; (b) a two-member RecsysPool under a trainer thread
# writing a version-encoded sentinel row, a member kill and revive, and 64
# requests over the wire; (c) a seeded shard SIGKILL under traffic; (d) an
# open-loop CTR trace (10 s, base 50/s, a 10x diurnal peak) through
# ctr_submitter
RECSYS_V, RECSYS_CACHE, RECSYS_PULL_BOUND = CTR_PS_V, CTR_PS_CACHE, 1
RECSYS_MAX_BATCH, RECSYS_MIN_BUCKET = 256, 8
RECSYS_REQUESTS, RECSYS_WAVE, RECSYS_ROUNDS = 4096, 8, 2
RECSYS_ADAGRAD_LR = 0.05
RECSYS_TOL_F64 = 1e-5   # a served probability vs a float64 CPU forward
RECSYS_TOL_WIRE = 1e-6  # over the wire vs the same request in process
RECSYS_SENTINEL_S = 1.5  # the trainer thread's run
RECSYS_WIRE_REQUESTS = 64
RECSYS_KILL_SCHEDULE = dict(steps=8, seed=1234, kill_shards=1, n_shards=2)
RECSYS_KILL_STEPS = 12
RECSYS_TRACE = dict(duration_s=10.0, base_qps=50.0, diurnal_peak_x=10.0,
                    n_prompts=65536, fields=CTR_F, dense_dim=CTR_DENSE,
                    key_space=CTR_PS_V)
RECSYS_WAIT_S = 30.0  # a wait's own deadline
RECSYS_BUDGET_S = 45.0

# the training supervisor: (a) GPT-2-small at its published widths (V
# 50257, max_position 1024; the train phase's bf16, flash, remat, fused CE,
# AdamW; 6 of its 12 layers) at B 8 x S 1024, 12 supervised steps, a
# checkpoint every 4, 2 kept, data faults at steps 2 and 9; the preempted child is held after
# step 5 while it is sent SIGTERM; the bare guarded step timed for 12 steps;
# a child's deadline, its start-up included.  (b) ps_ctr's PS leg (1M rows
# x 16 f32, the example's adagrad at lr 0.05, B 2048, 26 + 13 fields, the
# dense part under Adam 1e-3) over two van shard processes for 40 steps,
# the table snapshotted every 5, under the reference chaos test's seeded
# schedule
SUP_V, SUP_B, SUP_S, SUP_STEPS, SUP_LR = 50257, 8, 1024, 12, 1e-4
# of GPT-2-small's 12 layers: no gate of the arm needs depth (6 until the
# mesh phase joined)
SUP_L = 3
SUP_CKPT_EVERY, SUP_KEEP, SUP_HOLD_AT, SUP_BARE_STEPS = 4, 2, 5, 12
SUP_DATA_ERRORS = (2, 9)
SUP_CHILD_S = 300.0
SUP_PS_STEPS, SUP_PS_EVERY, SUP_PS_ADAGRAD_LR = 40, 5, 0.05
SUP_PS_SCHEDULE = dict(steps=SUP_PS_STEPS, seed=11, van_errors=2,
                       nan_steps=1, kill_shards=1, n_shards=2)
SUP_BUDGET_S = 100.0

# the multi-controller elastic training plane: one van process and three
# worker processes (numpy over the van: neither torch nor jax) training the
# plane's seeded regression (Y = X @ W_true + noise, mean-squared loss, SGD
# on the van), widened from the reference tests' 8 x 4 until the van sets a
# step's pace: [1024, 1024] f32 weights (4 MiB) and the ordered apply's
# [3 x 1024, 1024] staging table (12 MiB), 6144 samples, global batch 768
# (divisible by every width 1-3), lr 0.05, 48 steps; no public source
# defines this plane's table.  (a) two clean in-process supervisors; (b) a
# seeded worker SIGKILL, then a replacement; (c) the controller a process
# of its own over the van, SIGKILLed, a standby process adopting the fleet.
# Lease and grace are the supervisor's defaults; (b) and (c) pace the fleet
# by a sleep a step so that their faults land inside the run; a worker's
# READY, a standby's promotion and each wait within ELASTIC_WAIT_S.  The
# phase's processes share the host's cores: each worker gets its share of
# them as BLAS threads (OpenBLAS's default, a thread a core in each of
# three workers, leaves spinning threads that slow the van and the ordered
# apply)
ELASTIC_WORKERS, ELASTIC_FEATURES, ELASTIC_OUT = 3, 1024, 1024
ELASTIC_SAMPLES, ELASTIC_GB, ELASTIC_LR, ELASTIC_STEPS = 6144, 768, 0.05, 48
ELASTIC_LEASE_S, ELASTIC_GRACE_S, ELASTIC_CTRL_LEASE_S = 0.6, 0.4, 0.8
ELASTIC_PACE_S, ELASTIC_STANDBY_BOUND_S, ELASTIC_WAIT_S = 0.1, 0.5, 120.0
ELASTIC_REPLAY_TOL = 1e-5  # of max|w|: the twins against the numpy replay
ELASTIC_BUDGET_S = 60.0

# the CNN family: examples/cnn_resnet.py's configuration (ResNet-18, 10
# classes, f32, batch 128 of [3, 32, 32], Momentum(0.9) under
# CosineScheduler(0.1, t_max, warmup=steps_per_epoch // 10)) on its
# --subset of the synthetic CIFAR-10 (random labels, so the signal is
# memorisation of the repeated subset: 2 batches an epoch); then VGG-16
# (BN, DropOut 0.5) on the same shapes, LeNet on MNIST padded to 32 x 32
# and the MLP on its 784 features, 10 steps each at Momentum(0.01, 0.9)
CNN_B, CNN_STEPS, CNN_SUBSET, CNN_LR = 128, 20, 256, 0.1
CNN_ZOO_STEPS, CNN_ZOO_LR, CNN_VALID = 10, 0.01, 1024
# one step of the same weights and batch in f32 (TF32 off) against
# float64, the float64 pass through the f32 pass's ReLU pattern (a ReLU
# input within rounding of 0 lands on either side and keeps or drops that
# element's gradient, a discontinuity, not a rounding: 4.6e-2 of max|G|
# at B 128 on the card): the loss's relative gap, each gradient's max gap
# over its max |G|, the new statistics' gap over their max |s|
TOL_CNN_LOSS, TOL_CNN_GRAD, TOL_CNN_STATS = 1e-4, 1e-2, 1e-4
# train_rnn: examples/rnn_mnist.py's configuration, uncut (28 rows of 28
# pixels as T 28 x D 28, hidden 128, a Linear(128, 10) head on the last
# step, Adam(1e-3), B 128), 20 steps a cell on a 256-sample subset of the
# synthetic MNIST (random labels: the signal is memorisation); one step in
# f32 against float64 (no ReLU on this path): the loss's relative gap and
# each gradient's max gap over its max |G|
RNN_CELLS = ("rnn", "lstm", "gru")
RNN_B, RNN_STEPS, RNN_SUBSET, RNN_HIDDEN, RNN_LR = 128, 20, 256, 128, 1e-3
TOL_RNN_LOSS, TOL_RNN_GRAD = 1e-4, 1e-2
# train_gcn: the reference's 2-layer GCN at ogbn-arxiv's published sizes
# (169 343 nodes, 128 features, 40 classes, 1 166 243 directed edges, both
# directions added as examples/gnn_gcn.py does; the train split's 54 %
# labelled) on a seeded graph of 40 communities, one a class, GCN_INTRA of
# the edges inside a community and features a class mean plus noise of
# GCN_NOISE; the OGB arxiv GCN baseline's hidden 256, dropout 0.5 and
# Adam(0.01); 20 full-graph steps.  Cut by the reference model's own
# structure: 2 layers (OGB: 3), no batch norm, no bias.  One step in f32
# against float64 through f32's ReLU pattern, dropout off, at the same
# limits as train_rnn's
GCN_N, GCN_F, GCN_CLASSES, GCN_EDGES = 169_343, 128, 40, 1_166_243
GCN_HIDDEN, GCN_DROPOUT, GCN_LR, GCN_STEPS = 256, 0.5, 0.01, 20
GCN_TRAIN_SHARE, GCN_INTRA, GCN_NOISE = 0.54, 0.9, 2.0
TOL_GCN_LOSS, TOL_GCN_GRAD = 1e-4, 1e-2
# gcn_sampled: GraphSAGE's published sampling (Hamilton et al. 2017, sec.
# 4: K 2, fanouts 25 and 10, 512 seeds a batch) on the same graph,
# published to in-process PS tables (max degree 128); each batch padded to
# 512 (1 + 25 + 250) + 1 nodes and 512 (25 + 250) edges; 8 batches train
# the same GCN with Adam(0.01)
SAGE_FANOUTS, SAGE_SEEDS, SAGE_BATCHES, SAGE_MAX_DEGREE = (25, 10), 512, 8, 128
SAGE_PAD_NODES = SAGE_SEEDS * (1 + 25 + 250) + 1
SAGE_PAD_EDGES = SAGE_SEEDS * (25 + 250)
# ops_zoo: every op of the elementwise, shape, reduce and matmul families
# on the card against the same op on the CPU: index and shape ops (and the
# ops that round nothing) exactly, arithmetic within this share of the
# output's largest magnitude
TOL_ZOO = 1e-6
# train_compressed: examples/rec_compressed.py's train_one (the VLDB'24
# tool's run_compressed loop) at train_ctr's Criteo-Kaggle table, uncut:
# V CTR_V (33 000 000), D CTR_DIM (16), F CTR_F (26), B CTR_B (2048); the
# example's head mlp_tower(26 * 16, (32,), out_dim=1), Adam(5e-3), mean BCE
# with logits, 10 steps cycling over 4 batches of Zipf-skewed ids (a 1.2)
# labelled by the example's rule.  Every method of
# tests/test_embedding_compress.py's ALL_METHODS, with the example's
# constructor arguments where it has them (hash and robe 0.1, prune rate
# 0.7, dedup 0.2), else the module's defaults, and the "full" table.  Cut:
# DPQ and MGQE to 2^22 rows, their logits [V, 4, 64] f32 taking 1 KiB a
# row and 4 KiB with the gradient and Adam's moments (135 GB at 33M rows,
# 17.2 GB at 2^22).  One pass of each method at V 2^20 in f32 against
# float64 (train_rnn's limits), the discrete choices replayed
CMP_METHODS = ("full", "hash", "compo", "dpq", "mgqe", "tt", "dhe", "robe",
               "alpt", "prune", "pep", "optembed", "autosrh", "mde",
               "autodim", "dedup", "adapt")
CMP_STORAGE = ("hash", "compo", "tt", "dhe", "robe", "mde", "dedup",
               "adapt")  # test_methods_compress_storage's eight
CMP_CUT, CMP_V_CUT, CMP_F64_V = ("dpq", "mgqe"), 1 << 22, 1 << 20
CMP_STEPS, CMP_BATCHES, CMP_LR, CMP_HIDDEN = 10, 4, 5e-3, 32
CMP_RETRAIN_STEPS, CMP_FLOW_STEPS, CMP_GENERATIONS = 3, 3, 2

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_BF16_FLOP_S = 989e12    # dense bf16 tensor cores, H100 SXM data sheet
H100_F32_FLOP_S = 67e12      # f32 outside the tensor cores, H100 SXM data
#                              sheet (TF32 is off in this script)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------- timing

def device_ms(fn, runs: int = 60, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` call, from CUDA events.  A spin
    kernel keeps the stream busy while each pair of events and the call are
    enqueued, so the events time the device work, not the host's launch
    overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in ev:
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def flash_flops(b, h, s_q, s_k, d, causal, kernel="fwd"):
    """Operations of one flash kernel on these shapes, per (query, key) pair
    the causal mask leaves visible: ``fwd`` two products of 2*D (q.k, p.v);
    ``dkdv`` four (q.k, dO.v, p^T.dO, dS^T.q), 8*D; ``dq`` three (q.k,
    dO.v, dS.k), 6*D."""
    if causal:
        pairs = sum(min(max(i + s_k - s_q + 1, 0), s_k) for i in range(s_q))
    else:
        pairs = s_q * s_k
    return {"fwd": 4, "dkdv": 8, "dq": 6}[kernel] * d * pairs * b * h


def flash_bound(b, h, s_q, s_k, d, causal, elem_bytes=2, kernel="fwd"):
    """Least time (ms) an H100 could take for one flash kernel on these
    shapes: each input read once, each output written once, against the
    operations of :func:`flash_flops`:

    * ``fwd``: reads q, k, v; writes O and the f32 LSE;
    * ``dkdv``: reads q, k, v, dO and the f32 LSE and delta; writes dK and
      dV;
    * ``dq``: the same reads; writes dQ.
    """
    bh = b * h
    flops = flash_flops(b, h, s_q, s_k, d, causal, kernel)
    if kernel == "fwd":
        nbytes = (2 * s_q + 2 * s_k) * bh * d * elem_bytes + bh * s_q * 4
    else:
        reads = (2 * s_q + 2 * s_k) * bh * d * elem_bytes + 2 * bh * s_q * 4
        outs = (2 * s_k if kernel == "dkdv" else s_q) * bh * d * elem_bytes
        nbytes = reads + outs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases

def phase_device(card):
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")


def phase_build():
    from hetu_tpu_torch.ops.cuda_kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    build.build(*names)
    print(f"[build] {', '.join(names)}: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(build.NVCC_FLAGS)})")
    for n in names:
        for line in build.log_path(n).read_text().splitlines():
            if any(w in line.lower() for w in ("registers", "spill",
                                               "warning")):
                print(f"[build] {n}: {line.strip()}")


def _qkv(shape_q, s_k, dtype, gen):
    b, h, s_q, d = shape_q
    mk = lambda s: torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(s_q), mk(s_k), mk(s_k)


def phase_kernel(card):
    """The forward kernel against its plain version on each route (bf16 on
    tensor cores, f32 on the scalar kernel), at the main paths' shapes and
    at edge cases across the tensor-core kernel's tiles and ring, head dims
    20 (padded to 24), 32, 40 and 128, the attention layer's transposed
    views and an unaligned view; two launches bitwise equal; then timed at
    the serving and training shapes beside SDPA and the bound."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_plain, fwd_design, route,
    )
    gen = torch.Generator(device="cuda").manual_seed(1234)
    main = (TRAIN_B, NH, TRAIN_S, HEAD_DIM)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (16, 32, 64, 128, 256, 512):
            cases.append((dtype, (1, NH, s, HEAD_DIM), s, True, "main"))
        cases += [
            (dtype, main, TRAIN_S, True, "train"),
            (dtype, (2, NH, 128, HEAD_DIM), 128, False, "full"),
            (dtype, (1, NH, 64, HEAD_DIM), 256, True, "cross S_q<S_k"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, True, "ragged"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, False, "ragged full"),
            (dtype, (1, NH, 128, HEAD_DIM), 64, True, "S_q>S_k"),
            (dtype, (1, 2, 48, 128), 48, True, "D=128"),
            # across the tensor-core kernel's 64-row tiles and its ring
            (dtype, (1, 2, 100, HEAD_DIM), 190, True, "S_q<S_k ragged"),
            (dtype, (1, 2, 190, HEAD_DIM), 100, True, "S_q>S_k ragged"),
            (dtype, (1, 2, 1000, HEAD_DIM), 1000, True, "S=1000"),
            (dtype, (2, 3, 130, HEAD_DIM), 130, True, "S=130"),
            (dtype, (1, 1, 300, HEAD_DIM), 300, False, "B*H=1 full"),
            (dtype, (1, 3, 130, 32), 130, True, "D=32"),
            # D = 40 fills a 64-column box (zeros past 40); D = 20 is
            # padded to 24 by one copy (TMA rows are multiples of 16 bytes)
            (dtype, (1, 3, 130, 40), 150, True, "D=40"),
            (dtype, (1, 2, 70, 20), 90, True, "D=20 padded"),
            (dtype, (1, 3, 200, 128), 200, True, "D=128 S=200"),
            (dtype, (1, 3, 70, 128), 90, False, "D=128 full"),
            # strided inputs: read in place by TMA (bf16), or copied once
            (dtype, (2, NH, 256, HEAD_DIM), 256, True, "layer views",
             "views"),
            (dtype, (1, 2, 130, HEAD_DIM), 130, True, "unaligned",
             "unaligned"),
        ]
    max_err_train = None  # reported beside the timings at the same shape
    with torch.inference_mode():
        for dtype, shape, s_k, causal, tag, *layout in cases:
            if layout == ["views"]:
                q, k, v = _layer_views(shape, dtype, gen)[:3]
            else:
                q, k, v = (_relaid(t, *layout) if layout else t
                           for t in _qkv(shape, s_k, dtype, gen))
            o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
            o_p, lse_p = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            diff = (o.float() - o_p.float()).abs()
            err_o = diff.max().item()
            err_lse = (lse - lse_p).abs().max().item()
            ok = o.shape == o_p.shape and o.dtype == dtype \
                and bool((diff <= TOL_O[dtype]
                          + RTOL_O[dtype] * o_p.float().abs()).all()) \
                and err_lse <= TOL_LSE and bool(torch.isfinite(o).all())
            masked = shape[2] - s_k if causal and shape[2] > s_k else 0
            if masked:  # rows that see no key are exactly 0
                ok = ok and not o[:, :, :masked].any() \
                    and not o_p[:, :, :masked].any()
            kind, d_run = route(dtype, shape[3])
            print(f"[kernel] flash_attention {str(dtype)[6:]:8s} "
                  f"{tag:14s} q{tuple(shape)} S_k={s_k} causal={causal} "
                  f"route {kind} D={d_run}: "
                  f"max|dO|={err_o:.3e} (tol {TOL_O[dtype]:g} + "
                  f"{RTOL_O[dtype]:g}*|O|) "
                  f"max|dLSE|={err_lse:.3e} (tol {TOL_LSE:g})"
                  + (f" zero rows={masked}" if masked else "")
                  + f" {'ok' if ok else 'FAIL'}")
            check(ok, f"flash_attention disagrees with its plain version "
                      f"({tag}, {dtype}, q{tuple(shape)}, S_k={s_k})")
            if tag == "train" and dtype == torch.bfloat16:
                max_err_train = err_o

        # no atomics: each output row is written once by one CTA
        q, k, v = _layer_views(main, torch.bfloat16, gen)[:3]
        again = [flash_attention(q, k, v, causal=True, return_lse=True)
                 for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(*again))
        print(f"[kernel] flash_attention bf16 q{main} on the layer's views: "
              f"two launches bitwise equal: {same}")
        check(same, "two launches of the forward kernel differ")
        del again
        views_ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                             20)

        design = fwd_design()
        print(f"[kernel] flash_attention bf16 kernel as built: "
              f"{design['warpgroups']} warpgroup(s) on {design['queries']} "
              f"queries a CTA, a {design['stages']}-stage K/V ring")
        timings = {}
        for b, s in ((1, 128), (1, 512), (TRAIN_B, TRAIN_S)):
            q, k, v = _qkv((b, NH, s, HEAD_DIM), s, torch.bfloat16, gen)
            runs = 60 if b == 1 else 20
            ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                           runs)
            plain_ms = device_ms(
                lambda: flash_attention_plain(q, k, v, causal=True), runs)
            lib_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True), runs)
            bound_ms, bound_by = flash_bound(b, NH, s, s, HEAD_DIM, True)
            tflops = flash_flops(b, NH, s, s, HEAD_DIM, True) / ms / 1e9
            timings[(b, s)] = dict(ms=ms, plain_ms=plain_ms,
                                   library_ms=lib_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, tflops=tflops)
            print(f"[kernel] flash_attention bf16 causal q({b},{NH},{s},"
                  f"{HEAD_DIM}): kernel {ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s, {100 * bound_ms / ms:.1f} % of "
                  f"the bound), plain {plain_ms:.4f} ms, library (SDPA, "
                  f"yardstick only) {lib_ms:.4f} ms, {ms / lib_ms:.2f}x "
                  f"SDPA, bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
        print(f"[kernel] flash_attention bf16 causal q{main} on the layer's "
              f"transposed views: {views_ms:.4f} ms (read in place; "
              f"contiguous inputs {timings[(TRAIN_B, TRAIN_S)]['ms']:.4f} "
              f"ms) [{card}]")
    return max_err_train, timings, design


def grad_tolerance_share(got, ref, tol=TOL_D):
    """The largest share of its tolerance (``tol``: ``TOL_D`` for the
    gradients, ``TOL_F`` for the forward's output) that any element of
    ``got`` uses against ``ref`` (both ``[..., rows, D]``): at most 1
    passes.  Where ``ref`` is all zero, ``got`` must be too."""
    atol, atol_row, rtol = tol[ref.dtype]
    r = ref.float().abs()
    diff = (got.float() - ref.float()).abs()
    limit = atol * r.max() + atol_row * r.amax(-1, keepdim=True) + rtol * r
    share = torch.where(limit > 0, diff / limit.clamp_min(torch.finfo(
        torch.float32).tiny), torch.where(diff > 0, float("inf"), 0.0))
    return share.max().item()


def _relaid(t, layout):
    """``t``'s values in another memory layout: ``views``, a transposed
    ``[B, H, S, D]`` view of a ``[B, S, H, D]`` tensor, as the attention
    layer passes them; ``unaligned``, a contiguous view that starts 2 bytes
    past a 16-byte boundary (TMA cannot read it in place)."""
    if layout == "views":
        b, h, s, d = t.shape
        return torch.empty(b, s, h, d, dtype=t.dtype,
                           device=t.device).transpose(1, 2).copy_(t)
    if layout == "unaligned":
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)
    return t


def _bwd_inputs(shape_q, s_k, dtype, causal, gen, layout="contiguous"):
    """q, k, v, dO (in ``layout``, see :func:`_relaid`), and the LSE and
    delta the forward pass gives them."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention_plain,
    )
    q, k, v = _qkv(shape_q, s_k, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda",
                     dtype=torch.float32).to(dtype)
    q, k, v, do = (_relaid(t, layout) for t in (q, k, v, do))
    o, lse = flash_attention_plain(q, k, v, causal=causal)
    b, h, s_q, _ = q.shape
    delta = (do.float() * o.float()).sum(-1).reshape(b * h, s_q, 1)
    return q, k, v, do, lse, delta


def _layer_views(shape, dtype, gen):
    """q, k, v and dO as the attention layer hands them to the backward:
    transposed ``[B, H, S, D]`` views of the fused QKV projection's
    ``[B, S, 3, H, D]`` output and of the output projection's gradient
    ``[B, S, H, D]``; O and the LSE from the forward."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention_plain,
    )
    b, h, s, d = shape
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(
        dtype).transpose(1, 2)
    o, lse = flash_attention_plain(q, k, v, causal=True)
    return q, k, v, o, lse, do


def phase_kernel_bwd(card):
    """The two backward kernels against the plain backward, at the
    training step's shape and at edge cases that cross the tensor-core
    kernels' tile and ring edges; two launches bitwise equal; then timed at
    that shape, each kernel and the whole ``flash_attention_bwd`` (delta,
    operand preparation and both kernels, on the attention layer's
    transposed views) beside SDPA's backward."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        _operands, bwd_delta, flash_attention_bwd,
        flash_attention_bwd_dkdv, flash_attention_bwd_dq,
        flash_attention_bwd_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(4321)
    main = (TRAIN_B, NH, TRAIN_S, HEAD_DIM)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [
            (dtype, main, TRAIN_S, True, "main"),
            (dtype, (2, NH, 128, HEAD_DIM), 128, False, "full"),
            (dtype, (1, NH, 64, HEAD_DIM), 256, True, "cross S_q<S_k"),
            (dtype, (1, NH, 128, HEAD_DIM), 64, True, "S_q>S_k"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, True, "ragged"),
            (dtype, (1, NH, 100, HEAD_DIM), 100, False, "ragged full"),
            (dtype, (1, 2, 48, 128), 48, True, "D=128"),
            (dtype, (1, 2, 40, 32), 72, True, "D=32 ragged"),
            # across the tensor-core kernels' 64-row tiles and 3-stage ring
            (dtype, (1, 2, 1000, HEAD_DIM), 1000, True, "S=1000"),
            (dtype, (2, 3, 130, HEAD_DIM), 130, True, "S=130"),
            (dtype, (1, 2, 100, HEAD_DIM), 190, True, "S_q<S_k ragged"),
            (dtype, (1, 2, 190, HEAD_DIM), 100, True, "S_q>S_k ragged"),
            (dtype, (1, 3, 200, 128), 200, True, "D=128 S=200"),
            (dtype, (1, 3, 130, 32), 130, True, "D=32 S=130"),
            (dtype, (1, 2, 70, 20), 90, True, "D=20 padded"),
            (dtype, (1, 1, 257, HEAD_DIM), 257, True, "B*H=1"),
            (dtype, (1, 1, 300, HEAD_DIM), 300, False, "B*H=1 full"),
            # strided inputs: read in place by TMA (bf16), or copied once
            (dtype, (2, NH, 256, HEAD_DIM), 256, True, "layer views",
             "views"),
            (dtype, (1, 2, 130, HEAD_DIM), 130, True, "unaligned",
             "unaligned"),
        ]
    max_err = {}
    with torch.no_grad():
        for dtype, shape, s_k, causal, tag, *layout in cases:
            args = _bwd_inputs(shape, s_k, dtype, causal, gen, *layout)
            dk, dv = flash_attention_bwd_dkdv(*args, causal=causal)
            dq = flash_attention_bwd_dq(*args, causal=causal)
            want = flash_attention_bwd_plain(*args, causal=causal)
            torch.cuda.synchronize()
            ok, errs, shares = True, {}, {}
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      want):
                errs[name] = (got.float() - ref.float()).abs().max().item()
                shares[name] = grad_tolerance_share(got, ref)
                ok = ok and got.dtype == ref.dtype \
                    and got.shape == ref.shape \
                    and bool(torch.isfinite(got).all()) \
                    and shares[name] <= 1.0
            masked = shape[2] - s_k if causal and shape[2] > s_k else 0
            if masked:  # rows that see no key give dQ = 0 exactly
                ok = ok and not dq[:, :, :masked].any() \
                    and not want[0][:, :, :masked].any()
            atol, atol_row, rtol = TOL_D[dtype]
            print(f"[kernel] flash_attention_bwd {str(dtype)[6:]:8s} "
                  f"{tag:14s} q{tuple(shape)} S_k={s_k} causal={causal}: "
                  + " ".join(f"max|{n}|={e:.3e}" for n, e in errs.items())
                  + f" (tol {atol:g}*max|ref| + {atol_row:g}*max|ref row| "
                  f"+ {rtol:g}*|ref|; share "
                  f"of tol used " + " ".join(
                      f"{n} {s:.3g}" for n, s in shares.items()) + ")"
                  + (f" zero dQ rows={masked}" if masked else "")
                  + f" {'ok' if ok else 'FAIL'}")
            check(ok, f"flash backward kernels disagree with the plain "
                      f"backward ({tag}, {dtype}, q{tuple(shape)}, "
                      f"S_k={s_k})")
            if tag == "main" and dtype == torch.bfloat16:
                max_err = {"dkdv": max(errs["dk"], errs["dv"]),
                           "dq": errs["dq"]}

        args = _bwd_inputs(main, TRAIN_S, torch.bfloat16, True, gen)
        # no atomics: each output row is written once, so two launches
        # give the same bits
        again = [flash_attention_bwd_dkdv(*args, causal=True)
                 + (flash_attention_bwd_dq(*args, causal=True),)
                 for _ in range(2)]
        torch.cuda.synchronize()
        same = all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(*again))
        print(f"[kernel] flash_attention_bwd bf16 main q{main}: two launches "
              f"of each kernel bitwise equal: {same}")
        check(same, "two launches of the backward kernels differ")
        del again
        timings = {
            "dkdv": device_ms(lambda: flash_attention_bwd_dkdv(
                *args, causal=True), 20),
            "dq": device_ms(lambda: flash_attention_bwd_dq(
                *args, causal=True), 20)}
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            *args, causal=True), 20)
        q, k, v, o, lse, do = _layer_views(main, torch.bfloat16, gen)
        whole_ms = device_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=True), 20)
        # its parts outside the kernels
        delta_ms = device_ms(lambda: bwd_delta(do, o), 20)
        prep_ms = device_ms(lambda: _operands(q, k, v, do), 20)
    # the yardstick: SDPA's backward alone, on the same views
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (q, k, v), do, retain_graph=True), 20)
    print(f"[kernel] flash_attention_bwd bf16 causal q{main}, the "
          f"attention layer's transposed views: whole backward (delta, "
          f"operands, dK/dV and dQ kernels) {whole_ms:.4f} ms (delta alone "
          f"{delta_ms:.4f} ms, operand copies alone {prep_ms:.4f} ms), "
          f"library (SDPA backward, yardstick only) {lib_ms:.4f} ms, "
          f"{whole_ms / lib_ms:.2f}x [{card}]")
    report = {}
    for name in ("dkdv", "dq"):
        bound_ms, bound_by = flash_bound(*main[:2], TRAIN_S, TRAIN_S,
                                         HEAD_DIM, True, kernel=name)
        tflops = flash_flops(*main[:2], TRAIN_S, TRAIN_S, HEAD_DIM, True,
                             kernel=name) / timings[name] / 1e9
        report[name] = dict(ms=timings[name], plain_ms=plain_ms,
                            library_ms=lib_ms, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=max_err[name],
                            whole_bwd_ms=whole_ms)
        print(f"[kernel] flash_attention_bwd_{name} bf16 causal q{main}: "
              f"kernel {timings[name]:.4f} ms ({tflops:.1f} TFLOP/s, "
              f"{100 * bound_ms / timings[name]:.1f} % of the bound), plain "
              f"backward (dQ, dK, dV together) {plain_ms:.4f} ms, library "
              f"(SDPA backward, yardstick only) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}) [{card}]")
    return report


def jax_layout_weights(seed: int, max_position: int = MAX_LEN,
                       vocab: int | None = None,
                       layers: int | None = None) -> dict:
    """GPT-2-small parameters in the JAX package's layout and with its
    initialisers: normal(0.02) embeddings, Xavier-uniform MHA and Linear
    weights (``[in, out]``, stacked ``[L, ...]``), zero biases, unit
    LayerNorm scales.  ``vocab`` defaults to ``V``, ``layers`` to ``L``."""
    g = np.random.default_rng(seed)
    vocab = V if vocab is None else vocab
    nl = L if layers is None else layers

    def normal(*shape):
        return 0.02 * g.standard_normal(shape, dtype=np.float32)

    def xavier(*shape):  # (L, in, out)
        lim = np.float32(np.sqrt(6.0 / (shape[-2] + shape[-1])))
        return (g.random(shape, dtype=np.float32) * 2 - 1) * lim

    z = lambda *shape: np.zeros(shape, np.float32)
    o = lambda *shape: np.ones(shape, np.float32)
    return {
        "tok_emb": normal(vocab, H), "pos_emb": normal(max_position, H),
        "blocks": {
            "attn": {"qkv_weight": xavier(nl, H, 3 * H),
                     "qkv_bias": z(nl, 3 * H),
                     "out_weight": xavier(nl, H, H), "out_bias": z(nl, H)},
            "ln1": {"scale": o(nl, H), "bias": z(nl, H)},
            "ffn_in": {"weight": xavier(nl, H, FFN), "bias": z(nl, FFN)},
            "ffn_out": {"weight": xavier(nl, FFN, H), "bias": z(nl, H)},
            "ln2": {"scale": o(nl, H), "bias": z(nl, H)},
        },
        "ln_f_scale": o(H), "ln_f_bias": z(H),
    }


def burst(g, vocab, n, prompt_len, gen):
    """``n`` requests' (prompt, max_tokens), drawn from ``g``: a prompt
    length in the inclusive range ``prompt_len``, that many tokens of
    ``vocab``, then a generation count in the inclusive range ``gen``."""
    out = []
    for _ in range(n):
        prompt = [int(t) for t in g.integers(
            0, vocab, int(g.integers(prompt_len[0], prompt_len[1] + 1)))]
        out.append((prompt, int(g.integers(gen[0], gen[1] + 1))))
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_slice(card, seed, device="cuda"):
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.layers import MultiHeadAttention
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.ops.cuda_kernels import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    )
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeEngine, ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN, dtype=torch.bfloat16,
                    attention_impl="flash")
    t0 = time.perf_counter()
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(jax_layout_weights(seed),
                                                  cfg))
    engine = ServeEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                         device=device)
    del model
    _sync(device)
    print(f"[slice] GPT-2-small V={V} H={H} L={L} heads={NH} ffn={FFN} "
          f"bf16 flash, {SLOTS} slots x {MAX_LEN}: built in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card"
          if device == "cuda" else "")

    # warm every prompt bucket the run reaches and the decode step
    ContinuousBatchingScheduler(engine).run(
        [Request(prompt=[1] * n, max_tokens=2) for n in (10, 20, 40, 100)])

    g = np.random.default_rng(seed)
    requests = [Request(prompt=p, max_tokens=m) for p, m in burst(
        g, V, N_REQUESTS, GPT_PROMPT, GPT_GEN)]
    metrics = ServeMetrics()
    sched = ContinuousBatchingScheduler(engine, metrics=metrics)
    tracer = trace.enable()
    counters = (flash_attention, flash_attention_bwd_dkdv,
                flash_attention_bwd_dq)
    for c in counters:  # count the main path's launches only
        c.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    sched.run(requests)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, bwd_dkdv, bwd_dq = (c.launches for c in counters)
    trace.disable()

    prefills = [e for e in tracer.events if e["name"] == "serve.prefill"]
    decodes = [e for e in tracer.events if e["name"] == "serve.decode"]
    statuses = [r.status for r in requests]
    print(f"[slice] statuses: {statuses}")
    check(all(s == "ok" for s in statuses), "a request did not finish ok")
    check(all(len(r.tokens) == r.max_tokens for r in requests),
          "a request generated the wrong number of tokens")
    check(all(0 <= t < V for r in requests for t in r.tokens),
          "a generated token is outside the vocabulary")
    print(f"[slice] flash_attention.launches = {launches}, prefills = "
          f"{len(prefills)}, layers = {L}")
    check(len(prefills) == N_REQUESTS, "one prefill per request expected")
    check(launches == L * len(prefills) > 0,
          "flash_attention launches != layers x prefills")
    check(bwd_dkdv == bwd_dq == 0, "serving launched a backward kernel")

    n_tok = sum(len(r.tokens) for r in requests)
    snap = metrics.snapshot()
    step_ms = statistics.median(e["dur"] for e in decodes) / 1e3
    print(f"[slice] generated {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s [{card}]")
    print(f"[slice] TTFT p50 {snap['ttft_p50_s'] * 1e3:.2f} ms, p90 "
          f"{snap['ttft_p90_s'] * 1e3:.2f} ms [{card}]")
    print(f"[slice] decode step median {step_ms:.3f} ms over "
          f"{len(decodes)} steps ({SLOTS} slots) [{card}]")
    per_bucket = {}
    for e in prefills:
        per_bucket.setdefault(e["args"]["bucket"], []).append(e["dur"] / 1e3)
    for b in sorted(per_bucket):
        print(f"[slice] prefill bucket {b}: median "
              f"{statistics.median(per_bucket[b]):.3f} ms over "
              f"{len(per_bucket[b])} prompts [{card}]")

    # the kernel path against the plain path, same weights
    plain = copy.deepcopy(engine.model)
    for m in plain.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_impl = "xla"
    with torch.inference_mode():
        for n in (7, 33, 90, 128):
            ids = torch.tensor(g.integers(0, V, (1, n)), device=device)
            lk, _, _ = engine.model.prefill_with_cache(ids, last_index=n - 1)
            lp, _, _ = plain.prefill_with_cache(ids, last_index=n - 1)
            lk, lp = lk.float(), lp.float()
            check(lk.shape == (1, V) and bool(torch.isfinite(lk).all()),
                  "prefill logits are not finite [1, V]")
            err = (lk - lp).abs().max().item()
            top2 = lp[0].topk(2).values
            margin = (top2[0] - top2[1]).item()
            same = int(lk[0].argmax()) == int(lp[0].argmax())
            print(f"[slice] prompt {n}: kernel vs plain path logits "
                  f"max|d|={err:.3e} (tol {TOL_LOGITS:g}), top-2 margin "
                  f"{margin:.3e}, first token equal: {same}")
            check(err <= TOL_LOGITS, "kernel path logits disagree with the "
                                     "plain path")
            check(same or margin <= TOL_LOGITS,
                  "greedy first token differs beyond the tolerance")
    return launches, engine


def _device_intervals(prof):
    """(start, end, name) of every kernel, copy and set the profiler saw on
    the card, in microseconds."""
    from torch.autograd import DeviceType
    return [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(intervals):
    """Time the card was busy: the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for s, e, _ in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _short(kernel: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        kernel = kernel.replace(noise, "")
    return kernel[:110]


def phase_profile(engine, card, steps=20, vocab=V, tag=""):
    """Where the time of one serving step goes: the host clock around
    ``steps`` prefills (bucket 128) and ``steps`` decode steps (all slots
    active), then the same windows again under torch.profiler for the
    card's busy time and the kernels that take it.  The busy share divides
    the profiled busy time by the unprofiled wall time (the profiler slows
    the host, not the kernels); both unprofiled windows run before the
    profiler first starts.  Prompts draw from ``vocab``; ``tag`` prefixes
    the windows' names."""
    from torch.profiler import ProfilerActivity, profile
    g = np.random.default_rng(1)
    prompt = [int(t) for t in g.integers(0, vocab, 100)]
    slots = [engine.alloc_slot() for _ in range(engine.cache.num_slots)]
    for s in slots:
        engine.prefill(s, prompt)
    windows = {"prefill": lambda: engine.prefill(slots[0], prompt),
               "decode": engine.decode}

    def run(step):
        for _ in range(steps):
            step()
        torch.cuda.synchronize()

    wall_us = {}
    for name, step in windows.items():
        run(step)  # warm
        t0 = time.perf_counter()
        run(step)
        wall_us[name] = (time.perf_counter() - t0) * 1e6
    for name, step in windows.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(step)
        _profile_table(prof, tag + name, card, wall_us[name], steps)
    for s in slots:
        engine.release(s)


def _profile_table(prof, tag, card, wall_us, steps=1):
    """Print the card's busy share of ``wall_us`` (host time of ``steps``
    unprofiled steps) and its 8 largest kernels; returns the busy share."""
    iv = _device_intervals(prof)
    if not iv:
        print(f"[profile] {tag}: device time not measured (the profiler "
              f"recorded no kernel) [{card}]")
        return None
    busy = _busy_us(iv)
    print(f"[profile] {tag}: {wall_us / steps / 1e3:.3f} ms a step on the "
          f"host clock, card busy {busy / steps / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f} %), {len(iv) / steps:.0f} device "
          f"ops a step [{card}]")
    by_name, by_kind = {}, {}
    for s, e, n in iv:
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e - s, c + 1)
        by_kind[_kind(n)] = by_kind.get(_kind(n), 0.0) + e - s
    print(f"[profile] {tag}: split " + ", ".join(
        f"{k} {t / steps / 1e3:.3f} ms ({100 * t / busy:.1f} %)"
        for k, t in sorted(by_kind.items(), key=lambda x: -x[1])))
    for n, (t, c) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        print(f"[profile] {tag}:   {100 * t / busy:5.1f} % of busy "
              f"{t / steps:8.1f} us a step x{c / steps:<5g} {_short(n)}")
    return busy / wall_us


def _profiled_step(ex, state, batch, device, tag, card, wall_ms):
    """One more train step under torch.profiler: the busy share of
    ``wall_ms`` and the 8 largest kernels (``_profile_table``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, met = ex.run("train", state, batch)
        float(met["loss"])
        _sync(device)
    return state, _profile_table(prof, tag, card, wall_ms * 1e3)


def _kind(kernel: str) -> str:
    """The port's own kernels (flash; gather, scatter-add and gate),
    cuDNN's convolutions, cuBLAS's GEMMs, copies and fills, and the rest
    (PyTorch's elementwise and reduction kernels)."""
    if _short(kernel).startswith(("flash_fwd_", "flash_bwd_")):
        return "flash kernels"
    if _short(kernel).startswith(("gather_kernel", "scatter_add_kernel",
                                  "topk_small_kernel", "topk_group_kernel",
                                  "topk_wide_kernel")):
        return "gather, scatter-add and gate kernels"
    if any(t in kernel
           for t in ("cudnn", "fprop", "dgrad", "wgrad", "fft")):
        return "convolutions"
    if any(t in kernel for t in ("nvjet", "gemm", "xmma", "cutlass")):
        return "GEMMs"
    if any(t in kernel.lower() for t in ("copy", "memcpy", "memset")):
        return "copies and fills"
    return "other"


def _gpt_flops_per_token(model, seq):
    """bench.py's count: 6 x non-embedding params + 6 V H for the tied head
    + 12 L H S for attention."""
    c = model.c
    n_params = sum(p.numel() for p in model.parameters())
    n_nonemb = n_params - c.vocab_size * c.hidden_size \
        - c.max_position * c.hidden_size
    return (6 * n_nonemb + 6 * c.vocab_size * c.hidden_size
            + 12 * c.num_layers * c.hidden_size * seq), n_params


def _loss_and_grads(model, batch, fn=None, gen=None):
    """The training loss of ``batch`` under ``fn`` (default: the model's
    ``lm_loss_fn()``), dropout drawn from ``gen``, and every parameter's
    gradient."""
    params = dict(model.named_parameters())
    fn = model.lm_loss_fn() if fn is None else fn
    loss, _ = fn(params, {}, batch, gen, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def _check_grads(tag, grads_k, grads_p):
    """Every kernel-path gradient finite and within ``TOL_TRAIN_GRAD`` of
    the largest element of the plain path's."""
    ratios = {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} is not "
                                              f"finite")
        scale = gp.abs().max().item()
        err = (gk - gp).abs().max().item()
        ratios[name] = err / scale if scale > 0 else (0.0 if err == 0
                                                      else float("inf"))
    worst = sorted(ratios.items(), key=lambda x: -x[1])
    print(f"[{tag}] gradients of {len(ratios)} parameters: max|dG| / "
          f"max|G_plain| <= {worst[0][1]:.3e} (tol {TOL_TRAIN_GRAD:g}); "
          f"worst: " + ", ".join(f"{n} {r:.3e}" for n, r in worst[:3]))
    check(worst[0][1] <= TOL_TRAIN_GRAD,
          f"kernel path gradient of {worst[0][0]} disagrees with the plain "
          f"path")
    return worst[0][1]


def phase_train(card, seed, device="cuda"):
    """GPT-2-small training steps at bench_gpt's width and shape."""

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.layers import MultiHeadAttention
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.ops.cuda_kernels import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    )
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=TRAIN_S, dropout_rate=0.0,
                    dtype=torch.bfloat16, attention_impl="flash", remat=True,
                    fused_ce=True)
    t0 = time.perf_counter()
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, TRAIN_S), cfg))
    g = np.random.default_rng(seed + 1)
    batch = (torch.tensor(g.integers(0, V, (TRAIN_B, TRAIN_S)),
                          device=device),)
    _sync(device)
    print(f"[train] GPT-2-small V={V} H={H} L={L} heads={NH} ffn={FFN} "
          f"B={TRAIN_B} S={TRAIN_S} bf16 flash remat fused-CE AdamW"
          f"({TRAIN_LR:g}): built in {time.perf_counter() - t0:.1f} s")

    # the kernel path against the plain path, one batch, same weights
    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_impl = "xla"

    loss_k, grads_k = _loss_and_grads(model, batch)
    loss_p, grads_p = _loss_and_grads(plain, batch)
    del plain
    # the control: the same weights and batch through an f32 model (plain
    # attention, no recomputation), whose gap to the plain bf16 path is
    # what bf16 rounding alone moves the loss by
    ref = GPTModel(dataclasses.replace(cfg, dtype=torch.float32,
                                       attention_impl="xla", remat=False),
                   device=device)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_f32 = float(ref.lm_loss_fn()(dict(ref.named_parameters()), {},
                                          batch, None, False)[0])
    del ref
    check(np.isfinite(loss_k) and np.isfinite(loss_p), "a loss is not finite")
    print(f"[train] kernel path vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} "
          f"(tol {TOL_TRAIN_LOSS:g}); control, plain bf16 path vs f32 "
          f"model: loss {loss_f32:.6f}, |d|={abs(loss_p - loss_f32):.3e}")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          "kernel path loss disagrees with the plain path")
    _check_grads("train", grads_k, grads_p)
    del grads_k, grads_p

    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(TRAIN_LR), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = (flash_attention, flash_attention_bwd_dkdv,
                flash_attention_bwd_dq)
    for c in counters:  # count the main path's launches only
        c.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    print(f"[train] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train] launches in {TRAIN_STEPS} steps: flash_attention "
          f"{launches[0]}, bwd_dkdv {launches[1]}, bwd_dq {launches[2]} "
          f"(a step: {[n / TRAIN_STEPS for n in launches]}, expected "
          f"[{2 * L}, {L}, {L}])")
    check(launches == [2 * L * TRAIN_STEPS, L * TRAIN_STEPS,
                       L * TRAIN_STEPS],
          "the training step did not launch 2L forward and L of each "
          "backward kernel a step")

    step_s = statistics.median(times[1:])
    fpt, n_params = _gpt_flops_per_token(model, TRAIN_S)
    tokens = TRAIN_B * TRAIN_S
    mfu = fpt * tokens / step_s / H100_BF16_FLOP_S
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] step median {step_s * 1e3:.3f} ms (steps 2-"
          f"{TRAIN_STEPS}; first {times[0] * 1e3:.3f} ms), "
          f"{tokens / step_s:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"({fpt * tokens / 1e12:.2f} TFLOP a step by bench.py's count, "
          f"{n_params / 1e6:.1f} M params, over 989 TFLOP/s), peak "
          f"{peak_gib:.2f} GiB allocated [{card}]")

    _, busy = _profiled_step(ex, state, batch, device, "train step", card,
                             step_s * 1e3)
    return dict(launches=launches, step_ms=step_s * 1e3,
                tokens_per_s=tokens / step_s, mfu=mfu, peak_gib=peak_gib,
                busy_share=busy, losses=losses)


# ------------------------------------------------------------------ MoE

def _bits(t):
    """``t``'s bits as integers, so that equality is bitwise (-0.0 is not
    0.0, a NaN equals itself)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return t.contiguous().view(ints[t.dtype]) if t.dtype in ints else t


def tolerance_share(got, ref, tol=None):
    """The largest share of its tolerance that any element of ``got`` uses
    against ``ref`` (at most 1 passes): ``tol`` is a bound per element (a
    tensor or a number), and NaNs must sit where the reference has them;
    without one the gate is bitwise, and any difference uses an infinite
    share."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return float("inf")
    if tol is None:
        return 0.0 if torch.equal(_bits(got), _bits(ref)) else float("inf")
    diff = (got.double() - ref.double()).abs()
    # a NaN where the reference has one agrees (the softmax of a row of
    # -inf); a NaN anywhere else uses an infinite share
    diff = torch.where(got.isnan() & ref.isnan(), 0.0, diff)
    tol = torch.as_tensor(tol, dtype=torch.float64, device=diff.device)
    share = torch.where(tol > 0, diff / tol.clamp_min(1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
    share = share.nan_to_num(nan=float("inf"))
    return share.max().item() if share.numel() else 0.0


def scatter_tolerance(grads, ids, num_rows, ref):
    """The bound of the note on ``TOL_GATES`` for a scatter-add summed in
    another order: per row, 2 (n - 1) 2^-24 sum|g| over its n rows, plus
    one bf16 ulp (2^-7 |ref|) for a bf16 result."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_rows)
    n = torch.bincount(ids[valid], minlength=num_rows).double()
    s = torch.zeros(num_rows, grads.shape[1], dtype=torch.float64,
                    device=grads.device).index_add_(
        0, ids[valid], grads[valid].double().abs())
    tol = 2 * (n - 1).clamp_min(0)[:, None] * 2 ** -24 * s
    if ref.dtype == torch.bfloat16:
        tol = tol + 2 ** -7 * ref.double().abs()
    return tol


def moe_routing(t, e, k, capacity, gen, device="cuda"):
    """The path's row ids from seeded random logits, as ``MoELayer`` makes
    them: ``slot_token [E*C]`` (-1 for an empty slot) and ``token_slot
    [T*k]`` (-1 for a dropped route), the dispatch's and the combine's
    gather ids; and their inverse maps, ``token_slot [T, k]`` and
    ``slot_route [E*C, 1]``, which the gradients of those gathers read."""
    from hetu_tpu_torch.ops import make_slot_routes
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating_plain
    logits = torch.randn(t, e, generator=gen, device=device)
    gates, idx = topk_gating_plain(logits, k)
    slot_route, token_slot, _ = make_slot_routes(gates, idx, e, capacity)
    return (slot_route // k, token_slot.reshape(-1), token_slot,
            slot_route[:, None])


def inverse_of(ids, num_rows):
    """The inverse map of any ids: ``[num_rows, m]`` int32, row r listing
    the positions i with ``ids[i] == r`` in descending order, then -1 (m
    the largest count), so that the kernel has to sort them."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < num_rows)
    rows = ids[valid]
    pos = torch.arange(ids.numel(), device=ids.device)[valid]
    order = torch.argsort(rows, stable=True)
    rows, pos = rows[order], pos[order]
    counts = torch.bincount(rows, minlength=num_rows)
    col = torch.arange(rows.numel(), device=ids.device) \
        - (counts.cumsum(0) - counts)[rows]
    inv = torch.full((num_rows, max(1, int(counts.max()))), -1,
                     dtype=torch.int32, device=ids.device)
    inv[rows, col] = pos.to(torch.int32)
    return inv.sort(dim=1, descending=True).values


def _rows(n, d, dtype, gen, integers=False):
    if integers:  # small integers: every sum exact, in any order
        return torch.randint(-8, 9, (n, d), generator=gen, device="cuda",
                             dtype=torch.int32).to(dtype)
    return torch.randn(n, d, generator=gen, device="cuda").to(dtype)


def gather_bound(table, ids):
    """Least time (ms) for the gather: the ids and each distinct valid row
    read once, the output written once, over the HBM rate."""
    valid = ids[(ids >= 0) & (ids < table.shape[0])]
    row = table.shape[1] * table.element_size()
    nbytes = ids.numel() * 4 + torch.unique(valid).numel() * row \
        + ids.numel() * row
    return nbytes / H100_BYTES_PER_S * 1e3


def scatter_bound(grads, ids, num_rows):
    """Least time (ms) for the scatter-add: the ids and each valid gradient
    row read once, the ``[num_rows, D]`` result written once.  The adds
    (one per element of a valid row) are far below the bytes."""
    row = grads.shape[1] * grads.element_size()
    n_valid = int(((ids >= 0) & (ids < num_rows)).sum())
    nbytes = ids.numel() * 4 + n_valid * row + num_rows * row
    return nbytes / H100_BYTES_PER_S * 1e3


def topk_bound(t, e, k, elem_bytes=4):
    """Least time (ms) for the gate: logits read once, gates and int32
    indices written once."""
    return (t * e * elem_bytes + t * k * (elem_bytes + 4)) \
        / H100_BYTES_PER_S * 1e3


def phase_kernel_moe(card):
    """The gather, scatter-add and top-k kernels against their plain
    versions at the MoE step's shapes, at bench_moe's width and at edge
    cases; then timed at the step's shapes."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_gather_plain, embedding_scatter_add,
        embedding_scatter_add_inverse_plain, embedding_scatter_add_plain,
        topk_gating, topk_gating_plain,
    )
    gen = torch.Generator(device="cuda").manual_seed(2468)
    t, ec = MOE_T, MOE_E * MOE_C
    slot_token, token_slot, inv_disp, inv_comb = moe_routing(
        t, MOE_E, MOE_K, MOE_C, gen)
    heavy = torch.full((4096,), 37, dtype=torch.int32, device="cuda")
    mixed = torch.cat([heavy, torch.tensor([-1, 5, 37, 10 ** 6], device="cuda",
                                           dtype=torch.int32)])
    ragged = torch.randint(-3, 70, (300,), generator=gen, device="cuda")
    # each id in [-3, 70) twice, in a random order: at most two rows meet
    # on a destination, so the plain version's atomics cannot reorder a sum
    twice = torch.cat([torch.randperm(73, generator=gen, device="cuda") - 3
                       for _ in range(2)])
    errs = {}

    def report(name, tag, share, err, ok_extra=True):
        ok = share <= 1.0 and ok_extra
        print(f"[kernel_moe] {name} {tag}: max|d|={err:.3e} share of "
              f"tolerance used {share:.3g} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} disagrees with its plain version ({tag})")

    with torch.no_grad():
        # gather: (table rows, dtype, ids, tag) -- bitwise
        gathers = [
            (t, MOE_H, torch.bfloat16, slot_token, "dispatch"),
            (ec, MOE_H, torch.float32, token_slot, "combine"),
            (t, MOE_BENCH_D, torch.bfloat16, slot_token, "dispatch D=768"),
            (ec, MOE_BENCH_D, torch.float32, token_slot, "combine D=768"),
            (64, MOE_H, torch.bfloat16, torch.full((500,), -1, device="cuda"),
             "all invalid"),
            (64, 100, torch.bfloat16, ragged, "D=100 bf16"),
            (64, 100, torch.float32, ragged, "D=100 f32"),
            (64, 33, torch.bfloat16, ragged, "D=33 bf16"),
            (1, MOE_H, torch.float32, torch.zeros(1, dtype=torch.int32,
                                                  device="cuda"), "T=1"),
        ]
        for rows, d, dtype, ids, tag in gathers:
            table = _rows(rows, d, dtype, gen)
            got = embedding_gather(table, ids)
            ref = embedding_gather_plain(table, ids)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item() \
                if got.numel() else 0.0
            report("embedding_gather", f"{tag} {tuple(table.shape)} "
                   f"{str(dtype)[6:]} ids {ids.numel()}",
                   tolerance_share(got, ref), err)
            errs.setdefault("gather", 0.0)
            errs["gather"] = max(errs["gather"], err)

        # scatter-add: (grads rows, D, dtype, ids, num_rows, tag, integers,
        # bitwise)
        scatters = [
            (ec, MOE_H, torch.bfloat16, slot_token, t, "dispatch bwd", False,
             True),
            (t * MOE_K, MOE_H, torch.float32, token_slot, ec, "combine bwd",
             False, True),
            (ec, MOE_BENCH_D, torch.bfloat16, slot_token, t,
             "dispatch bwd D=768", False, True),
            (t * MOE_K, MOE_BENCH_D, torch.float32, token_slot, ec,
             "combine bwd D=768", False, True),
            (500, MOE_H, torch.float32, torch.full((500,), -1, device="cuda"),
             64, "all invalid", False, True),
            (146, 100, torch.bfloat16, twice, 64, "D=100 bf16", False, True),
            (146, 100, torch.float32, twice, 64, "D=100 f32", False, True),
            (300, 100, torch.float32, ragged, 64, "D=100 f32 x~5", False,
             False),
            (4100, MOE_H, torch.float32, mixed, 64, "heavy x4096 integers",
             True, True),
            (4100, MOE_H, torch.bfloat16, mixed, 64, "heavy x4096 integers",
             True, True),
            (4100, MOE_H, torch.float32, mixed, 64, "heavy x4096 randn",
             False, False),
            (4100, MOE_H, torch.bfloat16, mixed, 64, "heavy x4096 randn",
             False, False),
        ]
        for n, d, dtype, ids, num_rows, tag, ints, bitwise in scatters:
            grads = _rows(n, d, dtype, gen, integers=ints)
            got = embedding_scatter_add(grads, ids, num_rows)
            again = embedding_scatter_add(grads, ids, num_rows)
            ref = embedding_scatter_add_plain(grads, ids, num_rows)
            torch.cuda.synchronize()
            tol = None if bitwise else scatter_tolerance(grads, ids,
                                                         num_rows, ref)
            err = (got.float() - ref.float()).abs().max().item()
            report("embedding_scatter_add",
                   f"{tag} grads {tuple(grads.shape)} {str(dtype)[6:]} -> "
                   f"{num_rows} rows ({'bitwise' if bitwise else 'order bound'}"
                   f"; two launches equal)", tolerance_share(got, ref, tol),
                   err, tolerance_share(got, again) == 0.0)
            if bitwise:
                errs["scatter"] = max(errs.get("scatter", 0.0), err)

        # the scatter-add's inverse route (the MoE step's): bitwise against
        # its plain version, against the sorted route on the same ids and
        # against a second launch.  (tag, grads rows, D, dtype, ids,
        # inverse); new cases draw from a generator of their own
        gen_inv = torch.Generator(device="cuda").manual_seed(1357)
        drops = moe_routing(4096, MOE_E, MOE_K, int(0.5 * 4096 * MOE_K
                                                    / MOE_E), gen_inv)
        k4 = moe_routing(4096, MOE_E, 4, int(MOE_CF * 4096 * 4 / MOE_E),
                         gen_inv)
        small = moe_routing(512, MOE_E, MOE_K, int(MOE_CF * 512 * MOE_K
                                                   / MOE_E), gen_inv)

        def both(tag, r, d, dtypes=(torch.bfloat16, torch.float32)):
            """The dispatch's and the combine's gradient on routing r."""
            s_tok, t_slot, i_disp, i_comb = r
            return [(f"{tag} dispatch bwd", s_tok.numel(), d, dt, s_tok,
                     i_disp) for dt in dtypes] + \
                   [(f"{tag} combine bwd", t_slot.numel(), d, dt, t_slot,
                     i_comb) for dt in dtypes]

        inverses = [
            ("dispatch bwd", ec, MOE_H, torch.bfloat16, slot_token, inv_disp),
            ("combine bwd", t * MOE_K, MOE_H, torch.float32, token_slot,
             inv_comb),
            ("dispatch bwd D=768", ec, MOE_BENCH_D, torch.bfloat16,
             slot_token, inv_disp),
            ("combine bwd D=768", t * MOE_K, MOE_BENCH_D, torch.float32,
             token_slot, inv_comb),
            *both("cf 0.5 (heavy drops)", drops, MOE_H),
            *both("k=4 (m=4)", k4, MOE_H),
            *both("D=100", small, 100),
            *both("D=33", small, 33, (torch.bfloat16,)),
            ("all-empty inverse", 500, MOE_H, torch.float32,
             torch.full((500,), -1, device="cuda"),
             torch.full((64, 2), -1, dtype=torch.int32, device="cuda")),
            # any ids, up to 32 sources a row, listed in descending order
            *((f"ragged ids x~{n // 73}", n, 100, dt, ids,
               inverse_of(ids, 64))
              for n in (300, 600)
              for ids in [torch.randint(-3, 70, (n,), generator=gen_inv,
                                        device="cuda")]
              for dt in (torch.bfloat16, torch.float32)),
        ]
        for tag, n, d, dtype, ids, inv in inverses:
            grads = _rows(n, d, dtype, gen_inv)
            num_rows = inv.shape[0]
            got = embedding_scatter_add(grads, ids, num_rows, inverse=inv)
            again = embedding_scatter_add(grads, ids, num_rows, inverse=inv)
            ref = embedding_scatter_add_inverse_plain(grads, inv)
            sorted_route = embedding_scatter_add(grads, ids, num_rows)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            report("embedding_scatter_add inverse",
                   f"{tag} grads {tuple(grads.shape)} {str(dtype)[6:]} -> "
                   f"inverse {tuple(inv.shape)} (bitwise: plain, sorted "
                   f"route, two launches)", tolerance_share(got, ref), err,
                   tolerance_share(got, sorted_route) == 0.0
                   and tolerance_share(got, again) == 0.0)
            errs["scatter_inverse"] = max(errs.get("scatter_inverse", 0.0),
                                          err)

        # top-k: (T, E, k, dtype, tag, logits kind)
        topks = [
            (t, MOE_E, MOE_K, torch.float32, "path", "randn"),
            (t, MOE_E, MOE_K, torch.bfloat16, "bf16", "randn"),
            (4096, MOE_E, MOE_K, torch.float32, "all-equal rows", "equal"),
            (4096, MOE_E, MOE_E, torch.float32, "pairs of ties", "pairs"),
            (4096, MOE_E, MOE_E, torch.float32, "k = E", "randn"),
            (4096, 64, MOE_K, torch.float32, "E = 64", "randn"),
            (4096, 7, 3, torch.float32, "E = 7", "randn"),
            (512, 256, 4, torch.bfloat16, "E = 256 bf16", "randn"),
            (1, MOE_E, MOE_K, torch.float32, "T = 1", "randn"),
            # any E: one thread a token up to 32, G lanes up to 1024, a
            # warp over shared memory above, a scratch row past its size
            *((tt, e, k, dtype, f"E = {e} {str(dtype)[6:]}", "randn")
              for tt, e, k in ((4096, 32, 2), (4096, 33, 3), (1024, 300, 4),
                               (512, 1024, 2), (256, 2048, 2))
              for dtype in (torch.float32, torch.bfloat16)),
            (256, 64, 64, torch.float32, "k = E = 64", "randn"),
            (64, 20000, 2, torch.float32, "E = 20000", "randn"),
            (16, 65536, 4, torch.float32, "E = 65536 (scratch row)", "randn"),
            *((512, e, 3, torch.float32, f"rows of -inf E = {e}", "-inf")
              for e in (MOE_E, 300, 2048)),
        ]
        for tt, e, k, dtype, tag, kind in topks:
            if kind == "equal":
                logits = torch.zeros(tt, e, device="cuda", dtype=dtype)
            elif kind == "pairs":  # every value twice in each row
                half = torch.randn(tt, e // 2, generator=gen, device="cuda")
                logits = half.repeat_interleave(2, dim=1).to(dtype)
            elif kind == "-inf":
                # every fourth row all -inf (index 0 first); every other
                # row -inf but for one value, so that later passes pick
                # among -inf again
                logits = torch.randn(tt, e, generator=gen_inv,
                                     device="cuda").to(dtype)
                logits[0::4] = float("-inf")
                keep = torch.randint(0, e, (tt,), generator=gen_inv,
                                     device="cuda")
                lone = torch.full_like(logits, float("-inf"))
                lone.scatter_(1, keep[:, None], logits.gather(1,
                                                              keep[:, None]))
                logits[1::2] = lone[1::2]
            else:
                logits = torch.randn(tt, e, generator=gen,
                                     device="cuda").to(dtype)
            gates, idx = topk_gating(logits, k)
            g_ref, i_ref = topk_gating_plain(logits, k)
            torch.cuda.synchronize()
            err = (gates.float() - g_ref.float()).abs().max().item()
            report("topk_gating", f"{tag} logits ({tt}, {e}) "
                   f"{str(dtype)[6:]} k={k} (idx equal, gates tol "
                   f"{TOL_GATES[dtype]:g})",
                   tolerance_share(gates, g_ref, TOL_GATES[dtype]), err,
                   tolerance_share(idx, i_ref) == 0.0)
            if tag == "path":
                errs["topk"] = err

        # timings at the step's shapes: one dispatch and one combine call
        # for the gather and the scatter, summed (a layer makes both), and
        # one gate call
        x_disp = _rows(t, MOE_H, torch.bfloat16, gen)
        y_comb = _rows(ec, MOE_H, torch.float32, gen)
        g_disp = _rows(ec, MOE_H, torch.bfloat16, gen)
        g_comb = _rows(t * MOE_K, MOE_H, torch.float32, gen)
        logits = torch.randn(t, MOE_E, generator=gen, device="cuda")
        clamp = lambda ids, n: ids.long().clamp(0, n - 1)
        s_ids, c_ids = clamp(slot_token, t), clamp(token_slot, ec)
        calls = {
            "gather": [
                (lambda: embedding_gather(x_disp, slot_token),
                 lambda: embedding_gather_plain(x_disp, slot_token),
                 lambda: torch.index_select(x_disp, 0, s_ids),
                 gather_bound(x_disp, slot_token)),
                (lambda: embedding_gather(y_comb, token_slot),
                 lambda: embedding_gather_plain(y_comb, token_slot),
                 lambda: torch.index_select(y_comb, 0, c_ids),
                 gather_bound(y_comb, token_slot))],
            "scatter": [
                (lambda: embedding_scatter_add(g_disp, slot_token, t),
                 lambda: embedding_scatter_add_plain(g_disp, slot_token, t),
                 lambda: torch.zeros(t, MOE_H, dtype=g_disp.dtype,
                                     device="cuda").index_add_(
                     0, s_ids, g_disp),
                 scatter_bound(g_disp, slot_token, t)),
                (lambda: embedding_scatter_add(g_comb, token_slot, ec),
                 lambda: embedding_scatter_add_plain(g_comb, token_slot, ec),
                 lambda: torch.zeros(ec, MOE_H, dtype=g_comb.dtype,
                                     device="cuda").index_add_(
                     0, c_ids, g_comb),
                 scatter_bound(g_comb, token_slot, ec))],
            "scatter_inverse": [
                (lambda: embedding_scatter_add(g_disp, slot_token, t,
                                               inverse=inv_disp),
                 lambda: embedding_scatter_add_inverse_plain(g_disp,
                                                             inv_disp),
                 lambda: torch.zeros(t, MOE_H, dtype=g_disp.dtype,
                                     device="cuda").index_add_(
                     0, s_ids, g_disp),
                 scatter_bound(g_disp, slot_token, t)),
                (lambda: embedding_scatter_add(g_comb, token_slot, ec,
                                               inverse=inv_comb),
                 lambda: embedding_scatter_add_inverse_plain(g_comb,
                                                             inv_comb),
                 lambda: torch.zeros(ec, MOE_H, dtype=g_comb.dtype,
                                     device="cuda").index_add_(
                     0, c_ids, g_comb),
                 scatter_bound(g_comb, token_slot, ec))],
            "topk": [
                (lambda: topk_gating(logits, MOE_K),
                 lambda: topk_gating_plain(logits, MOE_K),
                 lambda: torch.softmax(torch.topk(logits, MOE_K).values, -1),
                 topk_bound(t, MOE_E, MOE_K))],
        }
        report_ms = {}
        for name, sites in calls.items():
            per = [dict(ms=device_ms(k_fn, 40), plain_ms=device_ms(p_fn, 20),
                        library_ms=device_ms(l_fn, 40), bound_ms=bound)
                   for k_fn, p_fn, l_fn, bound in sites]
            for site, m in zip(("dispatch", "combine"), per):
                label = f"{name} {site}" if len(per) > 1 else name
                print(f"[kernel_moe] {label} at the step's shape: kernel {m['ms']:.4f} ms, plain "
                      f"{m['plain_ms']:.4f} ms, library (yardstick only) "
                      f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.5f} "
                      f"ms (bytes) [{card}]")
            report_ms[name] = {f: sum(m[f] for m in per)
                               for f in ("ms", "plain_ms", "library_ms",
                                         "bound_ms")}
            report_ms[name]["bound_by"] = "bytes"
            report_ms[name]["max_abs_err"] = errs[name]
            if len(per) > 1:
                report_ms[name]["by_call"] = dict(zip(("dispatch", "combine"),
                                                      per))
        # the scatter-add by route.  The sorted route's time holds the sort;
        # the inverse route's headline adds the price of its design, the
        # build of slot_route (the forward's index_put of the route ids and
        # the division that gives slot_token)
        from hetu_tpu_torch.ops.moe_ops import slot_route_of
        ts_long, within = inv_disp.long(), inv_disp >= 0
        build_ms = device_ms(
            lambda: slot_route_of(ts_long, within, ec) // MOE_K, 40)

        def slot_token_only():  # what the step built before: token ids
            st = torch.full((ec + 1,), -1, dtype=torch.int32, device="cuda")
            st[torch.where(within, ts_long, ec)] = torch.arange(
                t, dtype=torch.int32, device="cuda")[:, None].expand(t,
                                                                     MOE_K)
            return st[:ec]
        token_only_ms = device_ms(slot_token_only, 40)
        print(f"[kernel_moe] slot_route build at the step's shape "
              f"(token_slot [{t}, {MOE_K}] -> [{ec}], then // {MOE_K}): "
              f"{build_ms:.4f} ms; the slot_token build it replaces "
              f"{token_only_ms:.4f} ms [{card}]")
        sorted_route = report_ms.pop("scatter")
        sorted_route["split"] = _scatter_split(
            card, {"dispatch": (g_disp, slot_token, t),
                   "combine": (g_comb, token_slot, ec)})
        inverse = report_ms.pop("scatter_inverse")
        inverse.update(kernel_ms=inverse["ms"], slot_route_build_ms=build_ms,
                       slot_token_build_ms=token_only_ms,
                       ms=inverse["ms"] + build_ms)
        report_ms["scatter"] = dict(
            inverse, max_abs_err=max(inverse["max_abs_err"],
                                     sorted_route["max_abs_err"]),
            by_route={"inverse": dict(inverse), "sorted": sorted_route})
        print(f"[kernel_moe] scatter-add, a layer's two calls: inverse route "
              f"{inverse['kernel_ms']:.4f} ms + slot_route build "
              f"{build_ms:.4f} ms = {inverse['ms']:.4f} ms; sorted route "
              f"{sorted_route['ms']:.4f} ms; bound "
              f"{inverse['bound_ms']:.5f} ms [{card}]")
        report_ms["topk"]["by_shape"] = _topk_by_shape(card, gen)
    return report_ms


def _scatter_split(card, sites, phase="kernel_moe"):
    """The sorted route's time split, at each call's shape: the stable sort
    of the ids, the rest of ``scatter_segments`` (the searchsorted and the
    casts) and the kernel alone on precomputed segments."""
    from hetu_tpu_torch.ops.cuda_kernels.embedding import (
        _scatter_sorted, scatter_segments,
    )
    split = {}
    for site, (grads, ids, num_rows) in sites.items():
        perm, offsets = scatter_segments(ids, num_rows)
        out = torch.empty(num_rows, grads.shape[1], dtype=grads.dtype,
                          device="cuda")
        sort_ms = device_ms(lambda: torch.sort(ids.to(torch.int32),
                                               stable=True), 40)
        segments_ms = device_ms(lambda: scatter_segments(ids, num_rows), 40)
        kernel_ms = device_ms(
            lambda: _scatter_sorted(grads, perm, offsets, out), 40)
        split[site] = dict(sort_ms=sort_ms,
                           searchsorted_and_casts_ms=segments_ms - sort_ms,
                           kernel_alone_ms=kernel_ms,
                           bound_ms=scatter_bound(grads, ids, num_rows))
        print(f"[{phase}] scatter-add {site}, sorted route split: sort "
              f"{sort_ms:.4f} ms, searchsorted and casts "
              f"{segments_ms - sort_ms:.4f} ms, kernel alone "
              f"{kernel_ms:.4f} ms (bound {split[site]['bound_ms']:.5f} "
              f"ms) [{card}]")
    return split


# the gate's timed shapes: (T, E, k, dtype); the first is the MoE step's
TOPK_SHAPES = ((MOE_T, MOE_E, MOE_K, torch.float32),
               (MOE_T, 64, MOE_K, torch.float32),
               (MOE_T, 256, MOE_K, torch.bfloat16),
               (4096, 1024, MOE_K, torch.float32))


def _topk_by_shape(card, gen):
    """The gate kernel's time at each of ``TOPK_SHAPES`` beside its plain
    version, the library call and the bound."""
    from hetu_tpu_torch.ops.cuda_kernels import topk_gating, topk_gating_plain
    out = {}
    for tt, e, k, dtype in TOPK_SHAPES:
        logits = torch.randn(tt, e, generator=gen, device="cuda").to(dtype)
        m = dict(ms=device_ms(lambda: topk_gating(logits, k), 40),
                 plain_ms=device_ms(lambda: topk_gating_plain(logits, k), 10),
                 library_ms=device_ms(lambda: torch.softmax(
                     torch.topk(logits.float(), k).values, -1).to(dtype), 40),
                 bound_ms=topk_bound(tt, e, k, logits.element_size()),
                 bound_by="bytes")
        key = f"[{tt}, {e}] {str(dtype)[6:]} k {k}"
        out[key] = m
        print(f"[kernel_moe] topk_gating {key}: kernel {m['ms']:.4f} ms, "
              f"plain {m['plain_ms']:.4f} ms, library {m['library_ms']:.4f} "
              f"ms, bound {m['bound_ms']:.5f} ms [{card}]")
    return out


def moe_jax_layout_weights(seed: int) -> dict:
    """MoE transformer parameters in the JAX package's layout and with its
    initialisers: normal(0.02) embeddings, Xavier-uniform attention and
    gate weights (``[in, out]``), He-normal experts (fan
    ``int(sqrt(E*D*F))``, the reference's rule for 3-D shapes), zero
    biases, unit LayerNorm scales."""
    g = np.random.default_rng(seed)
    h, e, f = MOE_H, MOE_E, MOE_FFN

    def normal(std, *shape):
        return np.float32(std) * g.standard_normal(shape, dtype=np.float32)

    def xavier(*shape):
        lim = np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
        return (g.random(shape, dtype=np.float32) * 2 - 1) * lim

    def he(*shape):
        return normal(np.sqrt(2.0 / int(np.sqrt(np.prod(shape)))), *shape)

    z = lambda *shape: np.zeros(shape, np.float32)
    o = lambda *shape: np.ones(shape, np.float32)
    p = {"tok_emb": normal(0.02, MOE_V, h), "pos_emb": normal(0.02, MOE_S, h)}
    for layer in range(MOE_L):
        p[f"layer{layer}"] = {
            "attn": {"qkv_weight": xavier(h, 3 * h), "qkv_bias": z(3 * h),
                     "out_weight": xavier(h, h), "out_bias": z(h)},
            "ln1": {"scale": o(h), "bias": z(h)},
            "ln2": {"scale": o(h), "bias": z(h)},
            "moe": {"gate": {"gate_w": xavier(h, e)},
                    "experts": {"w1": he(e, h, f), "b1": z(e, f),
                                "w2": he(e, f, h), "b2": z(e, h)}}}
    return p


def _moe_flops(routed):
    """Model FLOPs of one training step (forward and backward, 3x the
    forward): per token and layer, the attention projections (8 H^2), the
    scores and the weighted sum over the whole sequence (4 S H, as bench.py
    counts attention) and the gate (2 H E); per routed (token, choice) and
    layer, the expert FFN (4 H F); per token, the LM head (2 H V).  Routed
    routes are bounded by capacity: min(E*C, T*k), as bench.py bench_moe
    counts them."""
    per_token = MOE_L * (8 * MOE_H ** 2 + 4 * MOE_S * MOE_H
                         + 2 * MOE_H * MOE_E) + 2 * MOE_H * MOE_V
    return 3 * (MOE_T * per_token + MOE_L * routed * 4 * MOE_H * MOE_FFN)


def _moe_pass(model, batch):
    """The training loss of ``batch``, every gradient, and each layer's
    expert indices ``[T, k]``."""
    routes = []
    hooks = [layer.moe.gate.register_forward_hook(
        lambda mod, inp, out: routes.append(out[1].detach()))
        for layer in model.layers]
    try:
        loss, grads = _loss_and_grads(model, batch)
    finally:
        for h in hooks:
            h.remove()
    return routes, loss, grads


def _plain_gather_moe(moe, x, *, gate_input=None):
    """``MoELayer.forward``'s gather path written out with the gather's
    plain version (PyTorch indexing, differentiated by autograd) in place of
    the ``routed_gather`` kernels: the MoE layer of the plain path."""
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.ops.cuda_kernels import embedding_gather_plain
    tokens = x.reshape(-1, x.shape[-1])
    t, d = tokens.shape
    e, k = moe.experts.num_experts, getattr(moe.gate, "k", 1)
    capacity = max(1, int(moe.capacity_factor * t * k / e))
    gates, idx, aux = moe.gate(
        tokens if gate_input is None else gate_input.reshape(-1))
    slot_token, token_slot, _ = ops.make_slot_routing(gates, idx, e, capacity)
    xe = embedding_gather_plain(tokens, slot_token).reshape(e, capacity, d)
    ye = moe.experts(xe).reshape(e * capacity, d)
    picked = embedding_gather_plain(ye, token_slot.reshape(-1))
    out = (gates[..., None].to(picked.dtype)
           * picked.reshape(t, k, d)).sum(dim=1)
    return out.reshape(x.shape), aux


def phase_train_moe(card, seed, device="cuda"):
    """The MoE transformer's training step at MoEConfig's widths, bf16,
    B 32 x S 512: the kernel path against the plain path and the einsum
    dispatch on one batch, then 10 Executor steps."""

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import MoEConfig, MoETransformer
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add, topk_gating,
    )
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = MoEConfig(vocab_size=MOE_V, hidden_size=MOE_H, num_layers=MOE_L,
                    num_heads=MOE_NH, ffn_size=MOE_FFN, num_experts=MOE_E,
                    top_k=MOE_K, capacity_factor=MOE_CF, max_position=MOE_S,
                    dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = MoETransformer(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        moe_jax_layout_weights(seed), cfg))
    g = np.random.default_rng(seed + 2)
    batch = (torch.tensor(g.integers(0, MOE_V, (MOE_B, MOE_S)),
                          device=device),)
    _sync(device)
    print(f"[train_moe] MoE transformer V={MOE_V} H={MOE_H} L={MOE_L} "
          f"heads={MOE_NH} ffn={MOE_FFN} experts={MOE_E} top-{MOE_K} "
          f"cf={MOE_CF} (C={MOE_C}) B={MOE_B} S={MOE_S} bf16, AdamW"
          f"({MOE_LR:g}): built in {time.perf_counter() - t0:.1f} s")
    counters = (topk_gating, embedding_gather, embedding_scatter_add)

    # the kernel path against two plain paths, one batch, same weights:
    # "plain" is the same composition with the plain gate and the gather's
    # plain version (PyTorch indexing, differentiated by autograd), so the
    # two round alike up to the MoE outputs and route every token alike;
    # "einsum" is the dense-mask dispatch and combine, whose f32 GEMM
    # rounds the combine's sum otherwise: one bf16 ulp in a layer's output
    # then moves the gate logits of later layers and flips the experts of
    # the tokens whose top-3 logits nearly tie, a discontinuity of the
    # function, not a fault.  So the gradients are held against "plain",
    # and "einsum" is held to the loss limit and to identical routes in the
    # first layer, with the flips of the later layers printed.
    variants = {"plain": ("xla", "gather"), "einsum": ("xla", "einsum")}
    routes_k, loss_k, grads_k = _moe_pass(model, batch)
    results = {}
    for name, (impl, dispatch) in variants.items():
        other = copy.deepcopy(model)
        for layer in other.layers:
            layer.moe.gate.impl, layer.moe.dispatch_impl = impl, dispatch
            if name == "plain":
                layer.moe.forward = functools.partial(_plain_gather_moe,
                                                      layer.moe)
        for c in counters:
            c.launches = 0
        routes_p, loss_p, grads_p = _moe_pass(other, batch)
        check(all(c.launches == 0 for c in counters),
              f"the {name} MoE path launched a kernel")
        del other
        check(np.isfinite(loss_k) and np.isfinite(loss_p),
              "a loss is not finite")
        flips = [int((a != b).any(-1).sum()) for a, b in zip(routes_k,
                                                              routes_p)]
        print(f"[train_moe] kernel path vs {name} path: loss {loss_k:.6f} vs "
              f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} (tol "
              f"{TOL_TRAIN_LOSS:g}); tokens routed otherwise by layer: "
              f"{flips}")
        check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
              f"kernel path loss disagrees with the {name} path")
        check(flips[0] == 0, f"the {name} path routes the first layer "
                             f"otherwise")
        if name == "plain":
            check(not any(flips), "the plain path routes a token otherwise")
            grad_ratio = _check_grads("train_moe", grads_k, grads_p)
        else:
            worst = max((grads_k[n] - g).abs().max().item()
                        / g.abs().max().item() for n, g in grads_p.items())
            print(f"[train_moe] einsum path gradients (reported, not held): "
                  f"max|dG| / max|G_einsum| <= {worst:.3e}")
            if device == "cuda":
                print(f"[train_moe] peak "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                      f"allocated through the einsum path's [T, E, C] masks")
        results[name] = dict(loss_gap=abs(loss_k - loss_p), flips=flips)
        del grads_p
    del grads_k
    if device == "cuda":
        torch.cuda.empty_cache()

    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(MOE_LR), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:  # count the main path's launches only
        c.launches = 0
    losses, times, dropped = [], [], []
    for _ in range(MOE_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    print(f"[train_moe] losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(last: lm {float(met['lm_loss']):.4f}, aux "
          f"{float(met['aux_loss']):.5f})")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train_moe] launches in {MOE_STEPS} steps: topk_gating "
          f"{launches[0]}, embedding_gather {launches[1]}, "
          f"embedding_scatter_add {launches[2]} (a step: "
          f"{[n / MOE_STEPS for n in launches]}, expected "
          f"[{MOE_L}, {2 * MOE_L}, {2 * MOE_L}])")
    check(launches == [MOE_L * MOE_STEPS, 2 * MOE_L * MOE_STEPS,
                       2 * MOE_L * MOE_STEPS],
          "the MoE step did not launch L gates, 2L gathers and 2L scatters "
          "a step")

    with torch.no_grad():  # the routes each layer keeps, after the steps
        h = (model.tok_emb[batch[0]] + model.pos_emb[None]).to(cfg.dtype)
        for layer in model.layers:
            h = h + layer.attn(layer.ln1(h))
            m, _, met_l = layer.moe(layer.ln2(h), return_metrics=True)
            dropped.append(float(met_l["dropped_frac"]))
            h = h + m.to(h.dtype)
    routed = sum(round(MOE_T * MOE_K * (1 - d)) for d in dropped) / MOE_L
    step_s = statistics.median(times[1:])
    flops = _moe_flops(min(MOE_C * MOE_E, MOE_T * MOE_K))
    mfu = flops / step_s / H100_BF16_FLOP_S
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else 0.0
    print(f"[train_moe] dropped share of routes by layer: "
          f"{' '.join(f'{d:.4f}' for d in dropped)} (mean routed "
          f"{routed:.0f} of {MOE_T * MOE_K})")
    print(f"[train_moe] step median {step_s * 1e3:.3f} ms (steps 2-"
          f"{MOE_STEPS}; first {times[0] * 1e3:.3f} ms), "
          f"{MOE_T / step_s:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"({flops / 1e12:.3f} TFLOP a step, {flops / MOE_T / 1e6:.1f} "
          f"MFLOP a token, routes bounded by capacity, over 989 TFLOP/s), "
          f"peak {peak_gib:.2f} GiB allocated [{card}]")

    # the expert FFN alone, forward and backward, at the step's [E, C, D];
    # and its first product's forward both ways: bf16 tensor cores with an
    # f32 output (what _F32Bmm runs) and the up-cast f32 product
    experts = model.layers[0].moe.experts
    xe = torch.randn(MOE_E, MOE_C, MOE_H, device=device,
                     dtype=cfg.dtype).requires_grad_()
    if device == "cuda":
        def ffn():
            y = experts(xe)
            torch.autograd.grad(y, [xe, *experts.parameters()],
                                torch.ones_like(y))
        w1 = experts.w1.detach().to(cfg.dtype)
        x = xe.detach()
        out_f32 = device_ms(lambda: torch.bmm(x, w1,
                                              out_dtype=torch.float32), 10)
        upcast = device_ms(lambda: torch.bmm(x.float(), w1.float()), 10)
        print(f"[train_moe] expert FFN forward + backward at ({MOE_E}, "
              f"{MOE_C}, {MOE_H}): {device_ms(ffn, 10):.3f} ms a layer; "
              f"its first product [{MOE_E}, {MOE_C}, {MOE_H}] x [{MOE_E}, "
              f"{MOE_H}, {MOE_FFN}]: bf16 with f32 output {out_f32:.4f} ms, "
              f"up-cast f32 {upcast:.4f} ms [{card}]")

    _, busy = _profiled_step(ex, state, batch, device, "train_moe step",
                             card, step_s * 1e3)
    return dict(launches=launches, step_ms=step_s * 1e3,
                tokens_per_s=MOE_T / step_s, mfu=mfu, peak_gib=peak_gib,
                busy_share=busy, losses=losses, grad_ratio=grad_ratio,
                paths=results)


# ------------------------------------------------------------ MoE gates

def gates_capacity(kind):
    """An expert's slots: ``int(cf * T * k / E)``, k 2 for ktop1, else 1."""
    k = GATES_KTOP1_K if kind == "ktop1" else 1
    return max(1, int(MOE_CF * MOE_T * k / MOE_E))


def gates_jax_layout_weights(kind, seed):
    """One ``MoELayer``'s parameters in the JAX package's tree and with its
    initialisers: ``{"gate": {...}, "experts": {w1, b1, w2, b2}}``, the
    gate Xavier-uniform (``gate_w [D, E]``, SAM's ``centroids [E, D]``,
    hash none), the experts He-normal with zero biases."""
    g = np.random.default_rng(seed)
    d, e, f = MOE_H, MOE_E, GATES_FFN

    def xavier(*shape):
        lim = np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
        return (g.random(shape, dtype=np.float32) * 2 - 1) * lim

    def he(*shape):
        std = np.sqrt(2.0 / int(np.sqrt(np.prod(shape))))
        return np.float32(std) * g.standard_normal(shape, dtype=np.float32)

    gate = {"hash": {}, "sam": {"centroids": xavier(e, d)}}.get(
        kind, {"gate_w": xavier(d, e)})
    return {"gate": gate,
            "experts": {"w1": he(e, d, f), "b1": np.zeros((e, f), np.float32),
                        "w2": he(e, f, d), "b2": np.zeros((e, d), np.float32)}}


def gates_task(seed, device):
    """examples/moe_gates_train.py's task at T tokens of width D: features
    x [T, D], labels y = argmax(x w + 0.1 noise) over 10 classes, the fixed
    head [D, 10] (normal, 0.1); and the hash gate's ids, vocabulary ids
    drawn Zipf-skewed over MOE_V (the example routes by a label-independent
    id; a real model by the vocabulary id)."""
    g = np.random.default_rng(seed + 5)
    x = g.standard_normal((MOE_T, MOE_H), dtype=np.float32)
    w = g.standard_normal((MOE_H, GATES_CLASSES))
    y = (x @ w + 0.1 * g.standard_normal((MOE_T, GATES_CLASSES))).argmax(-1)
    head = np.float32(0.1) * g.standard_normal((MOE_H, GATES_CLASSES),
                                               dtype=np.float32)
    ids = zipf_ids(g, (MOE_T,), MOE_V)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in dict(x=x, y=y, head=head, ids=ids).items()}


def gates_layer(kind, seed, device):
    """The port's ``MoELayer`` with gate ``kind`` at the phase's widths,
    its weights from :func:`gates_jax_layout_weights` through interop."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.layers import (
        BalanceAssignmentGate, Expert, HashGate, KTop1Gate, MoELayer, SAMGate,
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    d, e = MOE_H, MOE_E
    gate = {"hash": lambda: HashGate(e),
            "ktop1": lambda: KTop1Gate(d, e, GATES_KTOP1_K, generator=gen),
            "balance": lambda: BalanceAssignmentGate(d, e, GATES_ITERS,
                                                     generator=gen),
            "sam": lambda: SAMGate(d, e, generator=gen)}[kind]()
    layer = MoELayer(gate, Expert(e, d, GATES_FFN, generator=gen,
                                  dtype=torch.bfloat16),
                     capacity_factor=MOE_CF).to(device)
    layer.load_state_dict(interop.params_from_jax(
        gates_jax_layout_weights(kind, seed), layer))
    return layer


def _gates_flops(kind, routed):
    """Model FLOPs of one training step (3x the forward): per token the
    gate (2 D E for a scoring gate, nothing for hash; SAM adds the group
    sum and its score, D + 2 D E / T a token) and the head (2 D C); per
    routed route the expert FFN (4 D F)."""
    d, e = MOE_H, MOE_E
    gate = {"hash": 0, "sam": 2 * d * e + d}.get(kind, 2 * d * e)
    per_token = gate + 2 * d * GATES_CLASSES
    extra = 2 * e * d if kind == "sam" else 0
    return 3 * (MOE_T * per_token + extra + routed * 4 * d * GATES_FFN)


def balance_near_ties(lp, iters=GATES_ITERS):
    """Rows of a Sinkhorn iterate ``lp [T, E]`` whose top two entries lie
    within the rounding of ``iters`` rounds (``BALANCE_TIE_ULPS``): the
    rows whose argmax two sound computations may read otherwise."""
    lp = lp.double()
    top2 = lp.topk(2, dim=-1).values
    eps = torch.finfo(torch.float32).eps
    return (top2[:, 0] - top2[:, 1]) <= \
        BALANCE_TIE_ULPS * iters * eps * lp.abs().amax(dim=-1)


def route_flips(kind, idx_ref, idx_got, lp=None):
    """``(flips, near_ties)``: the tokens routed otherwise, and the rows of
    the reference's Sinkhorn iterate ``lp`` at a near tie (balance only;
    0 otherwise).  Raises if a token is routed otherwise away from a near
    tie: for every other gate the routes must be identical."""
    differ = (idx_ref != idx_got).any(dim=-1)
    flips = int(differ.sum())
    near = balance_near_ties(lp) if kind == "balance" else \
        torch.zeros_like(differ)
    away = int((differ & ~near.to(differ.device)).sum())
    check(away == 0, f"[{kind}] {away} token(s) routed otherwise away from "
                     f"a near tie")
    return flips, int(near.sum())


def _gates_loss(layer, task, x, kind, plain=False):
    """CE of the head over the layer's output plus aux; the routes."""
    gi = task["ids"] if kind == "hash" else None
    if plain:
        out, aux = _plain_gather_moe(layer, x, gate_input=gi)
    else:
        out, aux = layer(x, gate_input=gi)
    logits = out.float() @ task["head"]
    return torch.nn.functional.cross_entropy(logits, task["y"]) + aux


def _gates_pass(layer, task, kind, plain=False):
    """The loss, the routes, the Sinkhorn iterate (balance) and the
    gradients of every parameter and of the input (the layer's input
    needs its gradient inside a model, so both scatter-adds run)."""
    from hetu_tpu_torch import ops
    x = task["x"].clone().requires_grad_()
    seen = []
    hook = layer.gate.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0].detach(), out[1].detach())))
    try:
        loss = _gates_loss(layer, task, x, kind, plain)
    finally:
        hook.remove()
    params = dict(layer.named_parameters())
    grads = torch.autograd.grad(loss, [*params.values(), x])
    lp = None
    if kind == "balance":
        lp = ops.balance_log_plan(ops.linear(seen[0][0].float(),
                                             layer.gate.gate_w),
                                  iters=GATES_ITERS)
    return (float(loss.detach()), seen[0][1], lp,
            dict(zip([*params, "x"], grads)))


def phase_train_moe_gates(card, seed, device="cuda"):
    """examples/moe_gates_train.py's loop at MoEConfig's widths for the
    hash, ktop1, balance and sam gates: on one batch the kernel path (the
    gather dispatch and combine, their scatter-adds) against the plain
    path (the gather's plain version), then 10 Adam steps with 2 gathers,
    2 scatter-adds and no top-k gate a step."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add, topk_gating,
    )
    from hetu_tpu_torch.optim import AdamOptimizer

    counters = (topk_gating, embedding_gather, embedding_scatter_add)
    task = gates_task(seed, device)
    out = {}
    for kind in GATES:
        t0 = time.perf_counter()
        layer = gates_layer(kind, seed, device)
        cap = gates_capacity(kind)
        print(f"[train_moe_gates] {kind}: MoELayer D={MOE_H} E={MOE_E} "
              f"ffn={GATES_FFN} cf={MOE_CF} (C={cap}) experts bf16, T="
              f"{MOE_T}, head {GATES_CLASSES} classes, Adam({GATES_LR:g}): "
              f"built in {time.perf_counter() - t0:.1f} s")
        loss_k, idx_k, lp_k, grads_k = _gates_pass(layer, task, kind)
        for c in counters:
            c.launches = 0
        loss_p, idx_p, lp_p, grads_p = _gates_pass(layer, task, kind,
                                                   plain=True)
        check(all(c.launches == 0 for c in counters),
              f"[{kind}] the plain path launched a kernel")
        check(np.isfinite(loss_k) and np.isfinite(loss_p),
              f"[{kind}] a loss is not finite")
        flips, near = route_flips(kind, idx_p, idx_k, lp_p)
        print(f"[train_moe_gates] {kind}: kernel path vs plain path: loss "
              f"{loss_k:.6f} vs {loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} "
              f"(tol {TOL_TRAIN_LOSS:g}); tokens routed otherwise {flips} "
              f"(rows at a near tie: {near})")
        check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
              f"[{kind}] kernel path loss disagrees with the plain path")
        grad_ratio = _check_grads(f"train_moe_gates] [{kind}", grads_k,
                                  grads_p) if flips == 0 else None
        del grads_k, grads_p

        opt = AdamOptimizer(GATES_LR)
        params = dict(layer.named_parameters())
        state = opt.init_state(params)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for c in counters:  # count the main path's launches only
            c.launches = 0
        losses, times = [], []
        for _ in range(GATES_STEPS):
            _sync(device)
            t1 = time.perf_counter()
            x = task["x"].clone().requires_grad_()
            loss = _gates_loss(layer, task, x, kind)
            grads = torch.autograd.grad(loss, [*params.values(), x])
            params, state = opt.update(dict(zip(params, grads)), state,
                                       params)
            losses.append(float(loss.detach()))
            _sync(device)
            times.append(time.perf_counter() - t1)
        launches = [c.launches for c in counters]
        with torch.no_grad():
            _, _, met = layer(task["x"], gate_input=task["ids"]
                              if kind == "hash" else None,
                              return_metrics=True)
        dropped = float(met["dropped_frac"])
        k = GATES_KTOP1_K if kind == "ktop1" else 1
        routed = min(round(MOE_T * k * (1 - dropped)), cap * MOE_E)
        step_s = statistics.median(times[1:])
        flops = _gates_flops(kind, routed)
        peak = _peak_gib(device)
        print(f"[train_moe_gates] {kind}: losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}; launches in "
              f"{GATES_STEPS} steps: topk_gating {launches[0]}, "
              f"embedding_gather {launches[1]}, embedding_scatter_add "
              f"{launches[2]} (expected 0, {2 * GATES_STEPS}, "
              f"{2 * GATES_STEPS})")
        check(all(np.isfinite(losses)), f"[{kind}] a loss is not finite")
        check(losses[-1] < losses[0], f"[{kind}] the loss did not fall")
        check(launches == [0, 2 * GATES_STEPS, 2 * GATES_STEPS],
              f"[{kind}] the step did not launch 2 gathers, 2 scatter-adds "
              f"and no top-k gate a step")
        print(f"[train_moe_gates] {kind}: step median {step_s * 1e3:.3f} ms "
              f"(steps 2-{GATES_STEPS}; first {times[0] * 1e3:.3f} ms), "
              f"{MOE_T / step_s:.1f} tokens/s, {flops / step_s / 1e12:.2f} "
              f"TFLOP/s ({flops / 1e9:.3f} GFLOP a step), dropped_frac "
              f"{dropped:.4f} ({routed} of {MOE_T * k} routes kept), peak "
              f"{peak:.2f} GiB allocated [{card}]")
        out[kind] = dict(launches=launches, step_ms=step_s * 1e3,
                         tokens_per_s=MOE_T / step_s, dropped_frac=dropped,
                         peak_gib=peak, losses=losses, flips=flips,
                         near_ties=near, grad_ratio=grad_ratio,
                         loss_gap=abs(loss_k - loss_p))
        del layer, state, params
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ Llama and BERT

def _set_attention_impl(model, impl):
    """Point every attention layer of ``model`` at ``impl`` ("flash" or
    the plain "xla"): the same weights through the other path."""
    for m in model.modules():
        if hasattr(m, "attention_impl"):
            m.attention_impl = impl


def _flash_counters():
    from hetu_tpu_torch.ops.cuda_kernels import (
        flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    )
    return flash_attention, flash_attention_bwd_dkdv, flash_attention_bwd_dq


def _step_stats(times):
    """Median and spread (min, max) of steps 2 onwards, in ms."""
    rest = [t * 1e3 for t in times[1:]]
    return statistics.median(rest), min(rest), max(rest)


def _llama_flops_per_token(model, seq):
    """bench.py's count adapted to the untied head: 6 x the parameters
    that multiply (all but the ``tok_emb`` gather; ``lm_head`` is one) + 12
    L H S for attention."""
    c = model.c
    n_params = sum(p.numel() for p in model.parameters())
    return (6 * (n_params - c.vocab_size * c.hidden_size)
            + 12 * c.num_layers * c.hidden_size * seq), n_params


def _bert_flops_per_token(model, seq):
    """bench.py's count for the encoder: 6 x the non-embedding parameters
    + 6 V H for the MLM head tied to ``tok_emb`` (logits at every
    position, as the reference forms them) + 12 L H S for attention."""
    c = model.c
    n_params = sum(p.numel() for p in model.parameters())
    n_emb = (c.vocab_size + c.max_position + c.type_vocab_size) \
        * c.hidden_size
    return (6 * (n_params - n_emb) + 6 * c.vocab_size * c.hidden_size
            + 12 * c.num_layers * c.hidden_size * seq), n_params


def _peak_gib(device):
    return torch.cuda.max_memory_allocated() / 2 ** 30 \
        if device == "cuda" else 0.0


def phase_llama_serve(card, seed, device="cuda"):
    """Llama-2-7B served through ServeEngine + ContinuousBatchingScheduler:
    one closed burst, the launches of the path, the kernel path against
    the plain path on the same weights."""
    from hetu_tpu_torch.models import LlamaConfig, LlamaModel
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeEngine, ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    cfg = LlamaConfig(vocab_size=LLAMA_V, hidden_size=LLAMA_H,
                      num_layers=LLAMA_L, num_heads=LLAMA_NH,
                      ffn_size=LLAMA_FFN, max_position=LLAMA_P,
                      dtype=torch.bfloat16, attention_impl="flash")
    t0 = time.perf_counter()
    # drawn on the card: 3.5 B f32 parameters would take 14 GB of host RAM
    model = LlamaModel(cfg, generator=torch.Generator(
        device=device).manual_seed(seed), device=device)
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServeEngine(model, num_slots=LLAMA_SLOTS,
                         max_len=LLAMA_MAX_LEN, device=device)
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    _sync(device)
    serving_gib = sum(p.numel() * p.element_size()
                      for p in engine.model.parameters()) / 2 ** 30
    print(f"[llama_serve] Llama-2-7B V={LLAMA_V} H={LLAMA_H} L={LLAMA_L} "
          f"(of {LLAMA_DEPTH}) "
          f"heads={LLAMA_NH} head_dim={LLAMA_HEAD_DIM} ffn={LLAMA_FFN} "
          f"({n_params / 1e9:.3f} B params) bf16 flash, {LLAMA_SLOTS} slots "
          f"x {LLAMA_MAX_LEN}: built in {time.perf_counter() - t0:.1f} s, "
          f"serving copy {serving_gib:.2f} GiB"
          + (f", {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
             f"card" if device == "cuda" else ""))

    # warm the prompt buckets the burst reaches and the decode step
    ContinuousBatchingScheduler(engine).run(
        [Request(prompt=[1] * n, max_tokens=2)
         for n in (10, 20, 40, 100, 200, 400)])

    g = np.random.default_rng(seed + 3)
    requests = [Request(prompt=p, max_tokens=m) for p, m in burst(
        g, LLAMA_V, LLAMA_REQUESTS, LLAMA_PROMPT, LLAMA_GEN)]
    metrics = ServeMetrics()
    sched = ContinuousBatchingScheduler(engine, metrics=metrics)
    tracer = trace.enable()
    counters = _flash_counters()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:  # count this path's launches only
        c.launches = 0
    _sync(device)
    t0 = time.perf_counter()
    sched.run(requests)
    _sync(device)
    wall = time.perf_counter() - t0
    launches, bwd_dkdv, bwd_dq = (c.launches for c in counters)
    trace.disable()

    prefills = [e for e in tracer.events if e["name"] == "serve.prefill"]
    decodes = [e for e in tracer.events if e["name"] == "serve.decode"]
    statuses = [r.status for r in requests]
    print(f"[llama_serve] statuses: {statuses}")
    check(all(s == "ok" for s in statuses), "a request did not finish ok")
    check(all(len(r.tokens) == r.max_tokens for r in requests),
          "a request generated the wrong number of tokens")
    check(all(0 <= t < LLAMA_V for r in requests for t in r.tokens),
          "a generated token is outside the vocabulary")
    print(f"[llama_serve] flash_attention.launches = {launches}, prefills "
          f"= {len(prefills)}, layers = {LLAMA_L}")
    check(len(prefills) == LLAMA_REQUESTS, "one prefill per request "
                                           "expected")
    check(launches == LLAMA_L * len(prefills) > 0,
          "flash_attention launches != layers x prefills")
    check(bwd_dkdv == bwd_dq == 0, "serving launched a backward kernel")

    n_tok = sum(len(r.tokens) for r in requests)
    snap = metrics.snapshot()
    step_ms = statistics.median(e["dur"] for e in decodes) / 1e3
    print(f"[llama_serve] generated {n_tok} tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tokens/s; prompts "
          f"{sum(len(r.prompt) for r in requests)} tokens [{card}]")
    print(f"[llama_serve] TTFT p50 {snap['ttft_p50_s'] * 1e3:.2f} ms, p90 "
          f"{snap['ttft_p90_s'] * 1e3:.2f} ms [{card}]")
    print(f"[llama_serve] decode step median {step_ms:.3f} ms over "
          f"{len(decodes)} steps ({LLAMA_SLOTS} slots); peak "
          f"{_peak_gib(device):.2f} GiB allocated [{card}]")
    per_bucket = {}
    for e in prefills:
        per_bucket.setdefault(e["args"]["bucket"], []).append(e["dur"] / 1e3)
    for b in sorted(per_bucket):
        print(f"[llama_serve] prefill bucket {b}: median "
              f"{statistics.median(per_bucket[b]):.3f} ms over "
              f"{len(per_bucket[b])} prompts [{card}]")

    # the kernel path against the plain path: the same serving copy with
    # its attention layers flipped to "xla" (no second 7B model)
    worst = 0.0
    with torch.inference_mode():
        for n in (7, 100, 300, LLAMA_PROMPT[1]):
            ids = torch.tensor(g.integers(0, LLAMA_V, (1, n)), device=device)
            lk, _, _ = engine.model.prefill_with_cache(ids, last_index=n - 1)
            _set_attention_impl(engine.model, "xla")
            lp, _, _ = engine.model.prefill_with_cache(ids, last_index=n - 1)
            _set_attention_impl(engine.model, "flash")
            lk, lp = lk.float(), lp.float()
            check(lk.shape == (1, LLAMA_V) and bool(torch.isfinite(lk).all()),
                  "prefill logits are not finite [1, V]")
            share = ((lk - lp).abs().max() / lp.abs().max()).item()
            worst = max(worst, share)
            top2 = lp[0].topk(2).values
            same = int(lk[0].argmax()) == int(lp[0].argmax())
            print(f"[llama_serve] prompt {n}: kernel vs plain path logits "
                  f"max|d| / max|logit| = {share:.3e} (tol "
                  f"{TOL_LLAMA_LOGITS:g}; max|logit| "
                  f"{lp.abs().max().item():.3f}), top-2 margin "
                  f"{(top2[0] - top2[1]).item():.3e}, first token equal: "
                  f"{same}")
            check(share <= TOL_LLAMA_LOGITS, "kernel path logits disagree "
                                             "with the plain path")
    phase_profile(engine, card, steps=10, vocab=LLAMA_V, tag="llama_serve ")
    return dict(launches=launches, ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
                ttft_p90_ms=snap["ttft_p90_s"] * 1e3, decode_ms=step_ms,
                tokens_per_s=n_tok / wall, logits_share=worst,
                peak_gib=_peak_gib(device),
                tokens=[r.tokens for r in requests]), engine


# ------------------------------------------------------------ paged serving

def near_tie_divergence(ref, got, logits_after, tau):
    """The near-tie rule for the two greedy streams of one request: ``ref``
    the reference path's tokens (the slot engine's, or a paged engine's
    without prefix sharing), ``got`` those of the path under test.

    While the tokens agree, go on.  At the first position ``i`` where
    ``ref`` chose s and ``got`` chose p, the plain path's logits z after
    the prompt and the agreed tokens (``logits_after(ref[:i])``, 1-D) must
    give z[s] - z[p] <= 4 tau M, M = max|z|: each engine's logits lie
    within tau M of the plain ones, so s won on one path and p on the
    other only if the slot path's gap is at most 2 tau M, and the
    recomputed z adds tau M at each of its two entries.  Later tokens are
    not compared (the histories differ).  Returns None for streams equal
    to the end, else ``(i, s, p, (z[s] - z[p]) / M)``; raises past the
    bound."""
    check(len(ref) == len(got),
          f"streams of {len(ref)} and {len(got)} tokens")
    for i, (s, p) in enumerate(zip(ref, got)):
        if s == p:
            continue
        z = torch.as_tensor(logits_after(list(ref[:i]))).double()
        share = ((z[s] - z[p]) / z.abs().max()).item()
        check(share <= 4 * tau,
              f"token {i} differs ({s} -> {p}) away from a near tie: "
              f"z[s] - z[p] = {share:.3e} of max|z|, above 4 tau = "
              f"{4 * tau:g}")
        return i, int(s), int(p), share
    return None


def shared_prompt_requests(seed, vocab):
    """A chat service's traffic: one system prompt of ``SYS_PROMPT``
    tokens, then a distinct user turn of ``SYS_SUFFIX`` tokens for each of
    ``SYS_REQUESTS`` requests, ``SYS_GEN`` generated each.  Returns the
    warm request (the system prompt and a turn of its own) and the
    burst, as (prompt, max_tokens) pairs."""
    g = np.random.default_rng(seed + 5)
    system = [int(t) for t in g.integers(0, vocab, SYS_PROMPT)]
    turns = burst(g, vocab, SYS_REQUESTS + 1, SYS_SUFFIX, SYS_GEN)
    pairs = [(system + turn, m) for turn, m in turns]
    return pairs[0], pairs[1:]


class _Served:
    """A serving copy handed to a further engine as it is: the engine's
    ``inference_copy()`` returns it, so two engines share one copy of the
    weights."""

    def __init__(self, model):
        self.c = model.c
        self._model = model

    def inference_copy(self):
        return self._model


def _serve_burst(engine, pairs, device):
    """Run (prompt, max_tokens) pairs through a fresh scheduler (and fresh
    metrics) on ``engine``.  Hard: every request ok, with max_tokens
    tokens, all in the vocabulary.  Returns the requests, wall seconds,
    trace events, the peak of pages in use (paged engines) and the
    metrics snapshot."""
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    engine.metrics = ServeMetrics()
    sched = ContinuousBatchingScheduler(engine)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    paged = hasattr(engine, "begin_prefill")
    peak = 0
    tracer = trace.enable()
    _sync(device)
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.step()
        if paged:
            peak = max(peak, engine.cache.pages_in_use)
    _sync(device)
    wall = time.perf_counter() - t0
    trace.disable()
    vocab = engine.model.c.vocab_size
    check(all(r.status == "ok" for r in reqs),
          f"a request did not finish ok: {[r.status for r in reqs]}")
    check(all(len(r.tokens) == r.max_tokens for r in reqs),
          "a request generated the wrong number of tokens")
    check(all(0 <= t < vocab for r in reqs for t in r.tokens),
          "a generated token is outside the vocabulary")
    return dict(requests=reqs, wall=wall, events=tracer.events,
                peak_pages=peak, snap=engine.metrics.snapshot())


def _burst_line(tag, name, run, card):
    """Print a burst's throughput, TTFT, decode step and (paged) chunk
    times by bucket, pages and prefix counts; returns the numbers."""
    snap, ev = run["snap"], run["events"]
    n_tok = sum(len(r.tokens) for r in run["requests"])
    decodes = [e["dur"] / 1e3 for e in ev if e["name"] == "serve.decode"]
    out = dict(tokens_per_s=n_tok / run["wall"],
               ttft_p50_ms=snap["ttft_p50_s"] * 1e3,
               ttft_p90_ms=snap["ttft_p90_s"] * 1e3,
               decode_ms=statistics.median(decodes),
               peak_pages=run["peak_pages"],
               prefix_hit_tokens=snap.get("prefix_hit_tokens", 0),
               cow_copies=snap.get("cow_copies", 0))
    print(f"[paged_serve] {tag} {name}: {n_tok} tokens in "
          f"{run['wall']:.3f} s, {out['tokens_per_s']:.1f} tokens/s; TTFT "
          f"p50 {out['ttft_p50_ms']:.2f} ms, p90 {out['ttft_p90_ms']:.2f} "
          f"ms; decode step median {out['decode_ms']:.3f} ms over "
          f"{len(decodes)} steps [{card}]")
    chunks = {}
    for e in ev:
        if e["name"] == "serve.prefill_chunk":
            chunks.setdefault(e["args"]["bucket"], []).append(e["dur"] / 1e3)
    for b in sorted(chunks):
        print(f"[paged_serve] {tag} {name}: serve.prefill_chunk bucket {b}: "
              f"median {statistics.median(chunks[b]):.3f} ms over "
              f"{len(chunks[b])} chunks [{card}]")
    if chunks:
        print(f"[paged_serve] {tag} {name}: peak pages in use "
              f"{out['peak_pages']}, prefix hits "
              f"{snap.get('prefix_hits', 0)} ({out['prefix_hit_tokens']} "
              f"tokens), COW copies {out['cow_copies']} [{card}]")
    out["chunks"] = sum(len(v) for v in chunks.values())
    out["prefills"] = sum(e["name"] == "serve.prefill" for e in ev)
    return out


def _hold_streams(tag, ref_run, got_run, logits_after, tau,
                  phase="paged_serve"):
    """The near-tie rule over every request of two runs of one burst;
    prints the counts.  Returns the diverged requests' shares."""
    shares = []
    for i, (r, q) in enumerate(zip(ref_run["requests"],
                                   got_run["requests"])):
        d = near_tie_divergence(r.tokens, q.tokens,
                                lambda agreed, r=r: logits_after(
                                    r.prompt + agreed), tau)
        if d is not None:
            print(f"[{phase}] {tag}: request {i} diverged at a near "
                  f"tie: token {d[0]} {d[1]} -> {d[2]}, (z[s] - z[p]) / M "
                  f"= {d[3]:.3e} (bound 4 tau = {4 * tau:g})")
            shares.append(d[3])
    n = len(ref_run["requests"])
    print(f"[{phase}] {tag}: {n - len(shares)} of {n} requests "
          f"token-exact to the end, {len(shares)} diverged at a near tie")
    return shares


def _warm_pairs(lengths, max_len):
    """Prompts of 1s that reach each prefill bucket a burst will, two
    tokens each (the lengths that fit ``max_len``)."""
    return [([1] * n, 2) for n in lengths if n + 2 < max_len]


def _drained(cache, tag):
    """Hard, once a burst drains: no slot holds a page, and evicting the
    prefix index returns every page to the free list with both refcounts
    at 0."""
    check(cache.num_free == cache.num_slots, f"{tag}: a slot is still held")
    check(not cache.ref_table.any(), f"{tag}: a page table ref is left")
    check(cache.pages_in_use == cache.reclaimable_pages,
          f"{tag}: a page is held by something other than the index")
    while cache._evict_one_entry():
        pass
    check(not cache.ref_index.any()
          and sorted(cache._free_pages) == list(range(1, cache.num_pages)),
          f"{tag}: the free list is not whole after the index is evicted")


def _no_flash(tag, counters):
    launches = [c.launches for c in counters]
    check(launches == [0, 0, 0],
          f"{tag}: the paged path launched flash kernels {launches}")


def _plain_logits(model, device):
    """The plain path's last-position logits after a token list."""
    def logits_after(tokens):
        ids = torch.tensor([tokens], device=device)
        with torch.inference_mode():
            lg, _, _ = model.prefill_with_cache(ids,
                                                last_index=len(tokens) - 1)
        return lg[0].float().cpu()
    return logits_after


def phase_paged_serve(card, seed, llama_engine, device="cuda"):
    """Paged serving (PagedServeEngine + the scheduler's page-budget
    admission and chunked prefill) against the slot engine: (a) GPT-2-small
    in f32, (b) Llama-2-7B in bf16 on ``llama_engine``'s serving copy, with
    a model-level check of the chunked prefill, (c) a shared system prompt
    on the same copy.  Every request ok with its tokens; streams held to
    the near-tie rule; no flash launch on the paged path; every page back
    on the free list once a burst drains."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.serve import PagedServeEngine, ServeEngine

    counters = _flash_counters()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {}

    # (a) GPT-2-small, f32, the plain attention path
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN)
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, MAX_LEN), cfg))
    slot = ServeEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                       device=device)
    paged = PagedServeEngine(_Served(slot.model), num_slots=SLOTS,
                             max_len=MAX_LEN, page_size=PAGE_SIZE,
                             device=device)
    del model
    print(f"[paged_serve] gpt: GPT-2-small f32 xla, {SLOTS} slots x "
          f"{MAX_LEN}, page {PAGE_SIZE}, chunk {paged.prefill_chunk}, "
          f"{paged.cache.num_pages} pages")
    warm = _warm_pairs((10, 20, 40, 100), MAX_LEN)
    pairs = burst(np.random.default_rng(seed), V, N_REQUESTS, GPT_PROMPT,
                  GPT_GEN)
    for e in (slot, paged):
        _serve_burst(e, warm, device)
    ref = _serve_burst(slot, pairs, device)
    for c in counters:
        c.launches = 0
    got = _serve_burst(paged, pairs, device)
    _no_flash("gpt", counters)
    _drained(paged.cache, "gpt")
    out["gpt"] = {"slot": _burst_line("gpt", "slot", ref, card),
                  "paged": _burst_line("gpt", "paged", got, card),
                  "near_ties": _hold_streams(
                      "gpt", ref, got, _plain_logits(slot.model, device),
                      TOL_F32_LOGITS)}
    del slot, paged
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) Llama-2-7B, bf16: the slot engine's plain path against the paged
    # engine on the same serving copy
    model = llama_engine.model
    paged = PagedServeEngine(_Served(model), num_slots=LLAMA_SLOTS,
                             max_len=LLAMA_MAX_LEN, page_size=PAGE_SIZE,
                             device=device)
    pool_gib = 2 * paged.cache.k.numel() * paged.cache.k.element_size() \
        / 2 ** 30
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters() if n != "tok_emb")
    print(f"[paged_serve] llama: Llama-2-7B bf16, one serving copy for "
          f"both engines, {LLAMA_SLOTS} slots x {LLAMA_MAX_LEN}, page "
          f"{PAGE_SIZE}, chunk {paged.prefill_chunk}, "
          f"{paged.cache.num_pages} pages ({pool_gib:.2f} GiB of K and V)")
    warm = _warm_pairs((10, 20, 40, 100, 200, 400), LLAMA_MAX_LEN)
    pairs = burst(np.random.default_rng(seed + 3), LLAMA_V, LLAMA_REQUESTS,
                  LLAMA_PROMPT, LLAMA_GEN)
    _set_attention_impl(model, "xla")
    _serve_burst(llama_engine, warm, device)
    ref = _serve_burst(llama_engine, pairs, device)
    _set_attention_impl(model, "flash")
    _serve_burst(paged, warm, device)
    for c in counters:
        c.launches = 0
    got = _serve_burst(paged, pairs, device)
    _no_flash("llama", counters)
    _drained(paged.cache, "llama")
    plain = _plain_logits(model, device)
    _set_attention_impl(model, "xla")
    llama = {"slot": _burst_line("llama", "slot (xla)", ref, card),
             "paged": _burst_line("llama", "paged", got, card),
             "near_ties": _hold_streams("llama", ref, got, plain,
                                        TOL_LLAMA_LOGITS)}
    ms = weight_bytes / H100_BYTES_PER_S * 1e3
    print(f"[paged_serve] llama: reckoning: each chunk reads the "
          f"{weight_bytes / 1e9:.2f} GB of matmul weights, at least "
          f"{ms:.2f} ms at 3.35 TB/s; the burst's {llama['paged']['chunks']}"
          f" chunks at least {ms * llama['paged']['chunks']:.1f} ms against "
          f"the slot engine's {llama['slot']['prefills']} prefills at least "
          f"{ms * llama['slot']['prefills']:.1f} ms: paged TTFT is "
          f"expected above the slot engine's")

    # the chunked prefill against the one-pass prefill, model level
    g = np.random.default_rng(seed + 4)
    worst = 0.0
    with torch.inference_mode():
        for n in CHUNK_CHECK_PROMPTS:
            ids = torch.tensor(g.integers(0, LLAMA_V, (1, n)), device=device)
            want, _, _ = model.prefill_with_cache(ids, last_index=n - 1)
            want = want.float()
            m = want.abs().max()
            for chunk in CHUNK_CHECK_SIZES:
                t = -(-n // chunk) * chunk
                spec = paged.cache.spec
                kc = torch.zeros(spec.num_layers, 1, t, spec.num_kv_heads,
                                 spec.head_dim, dtype=spec.dtype,
                                 device=device)
                vc = torch.zeros_like(kc)
                padded = torch.zeros(1, t, dtype=ids.dtype, device=device)
                padded[:, :n] = ids
                for start in range(0, n, chunk):
                    lg, _, _ = model.prefill_chunk_with_cache(
                        padded[:, start:start + chunk], kc, vc, start,
                        last_index=min(chunk, n - start) - 1)
                lg = lg.float()
                check(bool(torch.isfinite(lg).all()),
                      "chunked prefill logits are not finite")
                share = ((lg - want).abs().max() / m).item()
                worst = max(worst, share)
                print(f"[paged_serve] llama: prompt {n}, chunks of {chunk}: "
                      f"chunked vs one-pass prefill logits max|d| / "
                      f"max|logit| = {share:.3e} (tol {TOL_LLAMA_LOGITS:g})")
                check(share <= TOL_LLAMA_LOGITS, "chunked prefill logits "
                                                 "disagree with the prefill")
    llama["chunk_logits_share"] = worst
    out["llama"] = llama
    del paged
    if device == "cuda":
        torch.cuda.empty_cache()

    # (c) the shared system prompt: prefix sharing on against off, both
    # on the same serving copy
    warm, pairs = shared_prompt_requests(seed, LLAMA_V)
    _set_attention_impl(model, "flash")
    runs = {}
    for sharing in (False, True):
        e = PagedServeEngine(_Served(model), num_slots=LLAMA_SLOTS,
                             max_len=LLAMA_MAX_LEN, page_size=PAGE_SIZE,
                             prefix_sharing=sharing, device=device)
        _serve_burst(e, [warm], device)
        for c in counters:
            c.launches = 0
        runs[sharing] = _serve_burst(e, pairs, device)
        _no_flash("shared prompt", counters)
        _drained(e.cache, "shared prompt")
        if sharing:
            shared_engine = e
        else:
            del e
    _set_attention_impl(model, "xla")
    snap = runs[True]["snap"]
    print(f"[paged_serve] shared prompt: {SYS_PROMPT}-token system prompt, "
          f"{SYS_REQUESTS} requests: prefix hits "
          f"{snap.get('prefix_hits', 0)}, hit tokens "
          f"{snap.get('prefix_hit_tokens', 0)} (want {SYS_REQUESTS} and "
          f"{SYS_REQUESTS * SYS_PROMPT})")
    check(snap.get("prefix_hits", 0) == SYS_REQUESTS
          and snap.get("prefix_hit_tokens", 0) == SYS_REQUESTS * SYS_PROMPT,
          "the shared system prompt was not hit by every request")
    shared = {"unshared": _burst_line("shared prompt", "sharing off",
                                      runs[False], card),
              "shared": _burst_line("shared prompt", "sharing on",
                                    runs[True], card),
              "near_ties": _hold_streams("shared prompt", runs[False],
                                         runs[True], plain,
                                         TOL_LLAMA_LOGITS)}
    check(runs[True]["peak_pages"] < runs[False]["peak_pages"],
          "prefix sharing did not lower the peak of pages in use")
    _set_attention_impl(model, "flash")
    out["shared"] = shared
    out["peak_gib"] = _peak_gib(device)
    print(f"[paged_serve] peak {out['peak_gib']:.2f} GiB allocated [{card}]")
    if device == "cuda":
        phase_profile(shared_engine, card, steps=5, vocab=LLAMA_V,
                      tag="paged_serve ")
    return out


# ----------------------------------------------------------------- migration

def _span_ms(events, name):
    """Total duration (ms) and bytes of the trace spans called ``name``."""
    spans = [e for e in events if e["name"] == name]
    return (sum(e["dur"] for e in spans) / 1e3,
            sum(e.get("args", {}).get("bytes", 0) for e in spans))


def _released(engine, tag):
    """Hard, once a burst has left ``engine``: every slot free (and, on a
    paged engine, every page back on the free list once the prefix index
    is evicted, so the next route starts on an empty index)."""
    if hasattr(engine, "begin_prefill"):
        _drained(engine.cache, tag)
    check(engine.cache.num_free == engine.cache.num_slots,
          f"{tag}: a slot is still held")


def _mid_decode(sched, reqs, tag):
    """Step ``sched`` MIGRATE_STEPS times, and on until no chunked prefill
    is in flight: then every slot must hold a request mid-decode and none
    may have finished.  Returns the mid-decode requests and the queued
    ones."""
    for r in reqs:
        sched.submit(r)
    for _ in range(MIGRATE_STEPS):
        sched.step()
    while sched._prefilling and not any(r.done.is_set() for r in reqs):
        sched.step()
    running = list(sched._running.values())
    queued = [r for r in reqs if r not in running]
    check(len(running) == sched.engine.cache.num_slots
          and all(r.tokens for r in running)
          and not any(r.done.is_set() for r in reqs),
          f"{tag}: {len(running)} of {len(reqs)} requests are mid-decode "
          f"({sum(r.done.is_set() for r in reqs)} finished) once no "
          f"prefill is in flight")
    return running, queued


def _expected_adopter_launches(engine, queued, device):
    """Flash forwards the adopter launches: one a layer for each queued
    prompt it prefills, on a slot engine whose attention is flash and on
    the card; the paged prefill launches none."""
    flash = any(getattr(m, "attention_impl", None) == "flash"
                for m in engine.model.modules())
    if device != "cuda" or not flash or hasattr(engine, "begin_prefill"):
        return 0
    return engine.model.c.num_layers * len(queued)


def _finish_route(tag, dst, s2, reqs, queued, slot_map, n_running, device,
                  counters):
    """Drain the adopter and hold what it did: every request ok, one
    adopted slot for each mid-decode request, no prefill but the queued
    prompts', their flash forwards only, every slot and page freed.
    Returns the adopter's flash launches."""
    while s2.has_work():
        s2.step()
    _sync(device)
    launches = counters[0].launches
    vocab = dst.model.c.vocab_size
    check(all(r.status == "ok" and len(r.tokens) == r.max_tokens
              for r in reqs), f"{tag}: a request did not finish ok: "
                              f"{[r.status for r in reqs]}")
    check(all(0 <= t < vocab for r in reqs for t in r.tokens),
          f"{tag}: a generated token is outside the vocabulary")
    adopted = dst.metrics.count("slots_adopted")
    prefilled = dst.metrics.count("prefill_tokens")
    want = sum(len(r.prompt) for r in queued)
    check(len(slot_map) == adopted == n_running,
          f"{tag}: {adopted} slots adopted for {n_running} mid-decode "
          f"requests")
    check(prefilled == want,
          f"{tag}: the adopter prefilled {prefilled} tokens; the queued "
          f"prompts hold {want} (a migrated request was prefilled again)")
    expect = _expected_adopter_launches(dst, queued, device)
    check(launches == expect, f"{tag}: the adopter launched {launches} "
                              f"flash forwards, not {expect}")
    _released(dst, tag)
    return launches


def _migrate_route(tag, route, src, dst, pairs, card, device, hold):
    """One burst on a scheduler over ``src``, stepped until every slot is
    mid-decode, then moved whole to a scheduler over ``dst`` by
    ``migrate_inflight`` and drained there.  ``hold(requests)`` holds the
    streams to the unmigrated burst's and returns (token-exact count,
    note); returns the route's numbers."""
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics, migrate,
    )
    from hetu_tpu_torch.telemetry import trace

    counters = _flash_counters()
    src.metrics, dst.metrics = ServeMetrics(), ServeMetrics()
    s1 = ContinuousBatchingScheduler(src,
                                     prefill_chunks_per_step=MIGRATE_CHUNKS)
    s2 = ContinuousBatchingScheduler(dst)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    for c in counters:
        c.launches = 0
    running, queued = _mid_decode(s1, reqs, f"{tag} {route}")
    src_launches = counters[0].launches
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    _sync(device)
    t0 = time.perf_counter()
    slot_map = migrate.migrate_inflight(s1, s2)
    _sync(device)
    total_ms = (time.perf_counter() - t0) * 1e3
    trace.disable()
    check(not s1.has_work(), f"{tag} {route}: the source kept work")
    _released(src, f"{tag} {route} source")
    launches = _finish_route(f"{tag} {route}", dst, s2, reqs, queued,
                             slot_map, len(running), device, counters)
    export_ms, nbytes = _span_ms(tracer.events, "serve.export_slots")
    import_ms, _ = _span_ms(tracer.events, "serve.adopt_slots")
    exact, near = hold(reqs)
    gb = nbytes / 1e9
    print(f"[migrate] {tag} {route}: {exact} of {len(reqs)} streams "
          f"token-exact{near}; {len(running)} mid-decode slots adopted "
          f"({nbytes / 1e6:.3f} MB of K/V: export {export_ms:.3f} ms "
          f"({export_ms / gb:.1f} ms/GB), import {import_ms:.3f} ms "
          f"({import_ms / gb:.1f} ms/GB), migrate_inflight "
          f"{total_ms:.3f} ms), {len(queued)} queued re-prefilled "
          f"({sum(len(r.prompt) for r in queued)} prompt tokens), adopter "
          f"flash launches {launches} [{card}]")
    return dict(exact=exact, bytes=nbytes, export_ms=export_ms,
                import_ms=import_ms, migrate_ms=total_ms,
                tokens=sum(len(r.prompt) + len(r.tokens) - 1
                           for r in running),
                launches=src_launches + launches)


def _int8_rows_ok(got, rows):
    """The int8 codec's gate on one slot's imported rows ``got`` against
    the exported ``rows`` (the same device): its f32 decode within the
    reference's bound, blockmax / 254 (+1e-7) an element, for each
    (layer, head) block, and the imported rows bitwise that decode
    rounded to the cache's type.  Returns the largest error as a share of
    the bound."""
    from hetu_tpu_torch.quantwire import q8_decode_axes, q8_encode_axes

    a = rows.float()
    dec = q8_decode_axes(*q8_encode_axes(rows, (1, 3)))
    bound = a.abs().amax(dim=(1, 3), keepdim=True) / 254 + 1e-7
    err = (dec - a).abs()
    check(bool((err <= bound).all()),
          "int8 codec: an element is off by more than blockmax / 254")
    check(torch.equal(dec.to(rows.dtype), got),
          "int8 codec: the imported rows are not the decode rounded to "
          "the cache's type")
    return (err / bound).max().item()


def _drain_codec(codec, src, dst, pairs, card, device):
    """llama_serve's burst drained from the slot engine ``src`` to the
    slot engine ``dst`` through one payload (export_payload ->
    adopt_payload -> release_exported) with ``codec``; the imported rows
    held to the exported ones before the source lets them go."""
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics, migrate,
    )
    from hetu_tpu_torch.telemetry import trace

    tag = f"llama drain {codec}"
    counters = _flash_counters()
    src.metrics, dst.metrics = ServeMetrics(), ServeMetrics()
    s1 = ContinuousBatchingScheduler(src)
    s2 = ContinuousBatchingScheduler(dst)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    for c in counters:
        c.launches = 0
    running, queued = _mid_decode(s1, reqs, tag)
    src_launches = counters[0].launches
    contexts = [list(r.prompt) + list(r.tokens) for r in running]
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    _sync(device)
    t0 = time.perf_counter()
    payload, exported = migrate.export_payload(s1, codec=codec)
    _sync(device)
    t1 = time.perf_counter()
    adopted, slot_map = migrate.adopt_payload(s2, payload)
    _sync(device)
    t2 = time.perf_counter()
    trace.disable()
    worst = 0.0
    for s_slot, d_slot in slot_map.items():
        n = int(dst.cache.lengths[d_slot])
        for got, rows in ((dst.cache.k[:, d_slot, :n],
                           src.cache.k[:, s_slot, :n]),
                          (dst.cache.v[:, d_slot, :n],
                           src.cache.v[:, s_slot, :n])):
            if codec == "int8":
                worst = max(worst, _int8_rows_ok(got, rows))
            else:
                check(torch.equal(got, rows), f"{tag}: the imported rows "
                                              f"are not the exported rows")
    migrate.release_exported(s1, exported)
    _released(src, f"{tag} source")
    by_rid = {r.rid: i for i, r in enumerate(reqs)}
    order = [by_rid[r.rid] for r in adopted]
    queued_rids = {r.rid for r in queued}
    launches = _finish_route(
        tag, dst, s2, adopted, [r for r in adopted if r.rid in queued_rids],
        slot_map, len(running), device, counters)
    # the streams in submission order; tokens only, since a request
    # keeps its scheduler (and so the engine) alive through ``owner``
    streams = [None] * len(reqs)
    for i, r in zip(order, adopted):
        streams[i] = r.tokens
    reg = s1.metrics.registry.metrics()
    out = dict(payload=len(payload),
               logical=reg["serve.migrate.bytes_logical"].value,
               wire=reg["serve.migrate.bytes_wire"].value,
               export_ms=_span_ms(tracer.events, "serve.export_slots")[0],
               pack_ms=_span_ms(tracer.events, "serve.migrate.pack")[0],
               unpack_ms=_span_ms(tracer.events, "serve.migrate.unpack")[0],
               import_ms=_span_ms(tracer.events, "serve.adopt_slots")[0],
               export_payload_ms=(t1 - t0) * 1e3,
               adopt_payload_ms=(t2 - t1) * 1e3, int8_share=worst,
               mid_decode=len(running), contexts=contexts,
               launches=src_launches + launches, tokens=streams)
    gb, n = out["logical"] / 1e9, len(running)
    print(f"[migrate] {tag}: payload {out['payload'] / 1e6:.3f} MB "
          f"({out['logical'] / 1e6:.3f} MB of K/V logical, "
          f"{out['wire'] / 1e6:.3f} MB on the wire) for {n} mid-decode "
          f"slots and {len(queued)} queued records [{card}]")
    print(f"[migrate] {tag}: "
          + ", ".join(f"{stage} {out[stage + '_ms']:.3f} ms "
                      f"({out[stage + '_ms'] / gb:.1f} ms/GB, "
                      f"{out[stage + '_ms'] / n:.3f} ms a request)"
                      for stage in ("export", "pack", "unpack", "import"))
          + f"; export_payload {out['export_payload_ms']:.3f} ms, "
          f"adopt_payload {out['adopt_payload_ms']:.3f} ms"
          + (f"; int8 error up to {worst:.3f} of blockmax / 254"
             if codec == "int8" else "; imported rows bitwise the exported")
          + f" [{card}]")
    return out


def _reprefill_ms(engine, contexts, device):
    """The other arm of bench_migrate: each migrated context prefilled
    again on ``engine`` (the second of two runs), in ms."""
    out = []
    for ctx in contexts:
        slot = engine.alloc_slot()
        for _ in range(2):
            _sync(device)
            t0 = time.perf_counter()
            engine.prefill(slot, ctx)
            _sync(device)
            dt = (time.perf_counter() - t0) * 1e3
        engine.release(slot)
        out.append((len(ctx), dt))
    return out


def phase_migrate(card, seed, llama_engine, llama_ref, device="cuda"):
    """Live KV-slot migration (serve/migrate.py) between engines in this
    process, through ``migrate_inflight`` on three routes (slot -> slot,
    slot -> paged, paged -> paged): (a) GPT-2-small in f32, every stream
    token-exact against the unmigrated burst; (b) Llama-2-7B in bf16 on
    ``llama_engine``'s serving copy, streams held to ``llama_ref``
    (llama_serve's burst) by the near-tie rule; then llama_serve's burst
    drained slot -> slot through one payload with each codec, the
    imported rows bitwise (none, bf16) or within the int8 bound, and the
    re-prefill of the same contexts timed beside it.  The adopter prefills
    only the queued prompts."""
    from types import SimpleNamespace

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.serve import PagedServeEngine, ServeEngine

    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": 0}

    def engines(model, slots, max_len):
        a = ServeEngine(model, num_slots=slots, max_len=max_len,
                        device=device)
        served = _Served(a.model)
        return (a, ServeEngine(served, num_slots=slots, max_len=max_len,
                               device=device),
                *(PagedServeEngine(served, num_slots=slots, max_len=max_len,
                                   page_size=PAGE_SIZE, device=device)
                  for _ in range(2)))

    # (a) GPT-2-small, f32, the plain attention path
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN)
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, MAX_LEN), cfg))
    slot_a, slot_b, paged_a, paged_b = engines(model, SLOTS, MAX_LEN)
    del model
    pairs = burst(np.random.default_rng(seed), V, N_REQUESTS, GPT_PROMPT,
                  GPT_GEN)
    ref = [r.tokens for r in _serve_burst(slot_a, pairs, device)["requests"]]

    def exact(reqs):
        got = [r.tokens for r in reqs]
        check(got == ref, "gpt: a migrated stream differs from the "
                          "unmigrated burst")
        return len(got), ""

    out["gpt"] = {}
    for route, src, dst in (("slot->slot", slot_a, slot_b),
                            ("slot->paged", slot_a, paged_a),
                            ("paged->paged", paged_a, paged_b)):
        r = _migrate_route("gpt", route, src, dst, pairs, card, device,
                           exact)
        out["gpt"][route] = r
        out["launches"] += r["launches"]
    del slot_a, slot_b, paged_a, paged_b
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) Llama-2-7B, bf16, on llama_serve's serving copy
    model = llama_engine.model
    served = _Served(model)
    slot_b = ServeEngine(served, num_slots=LLAMA_SLOTS,
                         max_len=LLAMA_MAX_LEN, device=device)
    paged_a, paged_b = (PagedServeEngine(
        served, num_slots=LLAMA_SLOTS, max_len=LLAMA_MAX_LEN,
        page_size=PAGE_SIZE, device=device) for _ in range(2))
    pairs = burst(np.random.default_rng(seed + 3), LLAMA_V, LLAMA_REQUESTS,
                  LLAMA_PROMPT, LLAMA_GEN)
    ref_run = {"requests": [SimpleNamespace(prompt=list(p), tokens=t)
                            for (p, _), t in zip(pairs, llama_ref)]}
    plain = _plain_logits(model, device)

    def near_tie(tag):
        def hold(reqs):
            _set_attention_impl(model, "xla")
            try:
                shares = _hold_streams(tag, ref_run, {"requests": reqs},
                                       plain, TOL_LLAMA_LOGITS,
                                       phase="migrate")
            finally:
                _set_attention_impl(model, "flash")
            return len(reqs) - len(shares), \
                f" ({len(shares)} parted at a near tie)"
        return hold

    llama = out["llama"] = {}
    for route, src, dst in (("slot->slot", llama_engine, slot_b),
                            ("slot->paged", llama_engine, paged_a),
                            ("paged->paged", paged_a, paged_b)):
        r = _migrate_route("llama", route, src, dst, pairs, card, device,
                           near_tie(f"llama {route}"))
        llama[route] = r
        out["launches"] += r["launches"]
    del paged_a, paged_b

    drains = llama["drain"] = {}
    for codec in MIGRATE_CODECS:
        d = drains[codec] = _drain_codec(codec, llama_engine, slot_b, pairs,
                                         card, device)
        out["launches"] += d["launches"]
        if codec == "int8":
            n_exact = sum(a == b for a, b in zip(d["tokens"], llama_ref))
            print(f"[migrate] llama drain int8: {n_exact} of "
                  f"{len(llama_ref)} streams token-exact (no gate: the "
                  f"codec is lossy)")
        else:
            near_tie(f"llama drain {codec}")(
                [SimpleNamespace(tokens=t) for t in d["tokens"]])
    for codec in MIGRATE_CODECS:
        d = drains[codec]
        d["ratio"] = drains["none"]["wire"] / d["wire"]
        print(f"[migrate] llama drain {codec}: {d['ratio']:.3f}x fewer bytes "
              f"on the wire than none")
    check(drains["int8"]["ratio"] >= 1.9,
          "int8 codec: the payload is not 1.9x smaller than none on the "
          "bf16 cache")

    # the other arm: the migrated contexts prefilled again on the adopter
    re = _reprefill_ms(slot_b, drains["none"]["contexts"], device)
    n_tok = np.array([n for n, _ in re], float)
    ms = np.array([t for _, t in re])
    slope, icpt = np.polyfit(n_tok, ms, 1)
    llama["reprefill"] = dict(tokens=n_tok.tolist(), ms=ms.tolist(),
                              ms_per_token=slope, fixed_ms=icpt)
    print(f"[migrate] llama re-prefill of the {len(re)} migrated contexts "
          f"({int(n_tok.min())}-{int(n_tok.max())} tokens) on the adopter: "
          f"{ms.sum():.3f} ms in all, fit {icpt:.3f} ms + {slope:.5f} ms a "
          f"token [{card}]")
    tok = sum(len(c) - 1 for c in drains["none"]["contexts"])
    for name, mig in (
            ("in-process (export + import)",
             llama["slot->slot"]["export_ms"]
             + llama["slot->slot"]["import_ms"]),
            *((f"payload {c} (export + pack + unpack + import)",
               drains[c]["export_ms"] + drains[c]["pack_ms"]
               + drains[c]["unpack_ms"] + drains[c]["import_ms"])
              for c in MIGRATE_CODECS)):
        per_tok = mig / tok
        cross = icpt / (per_tok - slope) if per_tok > slope else None
        print(f"[migrate] llama migration {name}: {mig:.3f} ms for {tok} "
              f"cached tokens, {per_tok:.5f} ms a token against "
              f"re-prefill's {slope:.5f} + {icpt:.3f} ms fixed: "
              + (f"migration wins below {cross:.0f} tokens of context"
                 if cross is not None else
                 "migration wins at every context length")
              + f" [{card}]")
    out["peak_gib"] = _peak_gib(device)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[migrate] peak {out['peak_gib']:.2f} GiB allocated; phase "
          f"{out['seconds']:.1f} s; flash forwards launched on the routes "
          f"and drains {out['launches']} [{card}]")
    return out


# ------------------------------------------------------------- front end

class _CrashingEngine:
    """A slot engine that crashes once it has run ``crash_at`` decode
    rounds and stays dead, every call raising (``tests/test_serve_server.py``'s
    ``_FlakyEngine``, triggered by a count instead of a timer).  The crash
    is marked by a ``serve.engine_crash`` trace instant."""

    def __init__(self, inner, crash_at):
        self.inner, self.crash_at = inner, crash_at
        self.rounds, self.dead = 0, False
        self.cache, self.metrics, self.model = (inner.cache, inner.metrics,
                                                inner.model)

    def _check(self):
        if self.dead:
            raise RuntimeError("engine crashed (injected)")

    def alloc_slot(self):
        self._check()
        return self.inner.alloc_slot()

    def release(self, slot):
        self._check()
        self.inner.release(slot)

    def prefill(self, slot, prompt):
        self._check()
        return self.inner.prefill(slot, prompt)

    def decode(self):
        from hetu_tpu_torch.telemetry import trace
        self._check()
        if self.rounds == self.crash_at:
            self.dead = True
            trace.instant("serve.engine_crash")
            self._check()
        out = self.inner.decode()
        self.rounds += 1
        return out


def _serve_over_van(tag, engine, pairs, device, restart=None):
    """``pairs`` sent by one ``InferenceClient`` thread each, released
    together, to an ``InferenceServer`` over ``engine`` on this process's
    van (loopback).  With ``restart`` (a callable making a fresh engine),
    the server's engine loop is expected to die (``engine`` crashes) and
    ``restart_engine(restart())`` runs as soon as it has.  Hard: every
    response ok with its tokens, all in the vocabulary; one prefill a
    request and one more for each requeued one; the flash forwards one a
    layer for each prefill (on the card, flash attention).  Returns the
    streams (prompt, tokens), wall seconds, client latencies, server TTFTs,
    the server's counters, launches and the trace events."""
    import threading
    from types import SimpleNamespace

    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, InferenceClient, InferenceServer,
        ServeMetrics,
    )
    from hetu_tpu_torch.telemetry import trace

    n = len(pairs)
    counters = _flash_counters()
    sched = ContinuousBatchingScheduler(engine, metrics=ServeMetrics())
    srv = InferenceServer(sched, max_clients=n,
                          request_timeout_s=SERVER_TIMEOUT_S,
                          max_loop_errors=2,
                          failover_grace_s=FAILOVER_GRACE_S)
    clients = [InferenceClient("127.0.0.1", srv.port, i) for i in range(n)]
    start = threading.Barrier(n + 1)
    resps, lat, errors = [None] * n, [None] * n, []

    def client(i):
        try:
            start.wait(60)
            t0 = time.perf_counter()
            resps[i] = clients[i].generate(pairs[i][0],
                                           max_tokens=pairs[i][1],
                                           timeout_s=SERVER_TIMEOUT_S)
            lat[i] = time.perf_counter() - t0
        except Exception as e:  # reported after the join
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(n)]
    restarted = None
    try:
        for t in threads:
            t.start()
        for c in counters:  # count this run's launches only
            c.launches = 0
        tracer = trace.enable()
        start.wait(60)
        t0 = time.perf_counter()
        if restart is not None:
            srv._loop.join(120)
            check(not srv.healthy, f"{tag}: the engine loop did not die "
                                   f"at the injected crash")
            srv.restart_engine(restart())
            restarted = srv.healthy
        for t in threads:
            t.join(SERVER_TIMEOUT_S)
        wall = time.perf_counter() - t0
        _sync(device)
        launches = counters[0].launches
        check(not any(t.is_alive() for t in threads),
              f"{tag}: a client did not get its response")
    finally:
        trace.disable()
        for c in clients:
            c.close()
        srv.close()
    check(not errors, f"{tag}: client errors {errors}")
    vocab = engine.model.c.vocab_size
    check(all(r["status"] == "ok" for r in resps),
          f"{tag}: a response is not ok: {[r['status'] for r in resps]}")
    check(all(len(r["tokens"]) == m for r, (_, m) in zip(resps, pairs)),
          f"{tag}: a response has the wrong number of tokens")
    check(all(0 <= t < vocab for r in resps for t in r["tokens"]),
          f"{tag}: a generated token is outside the vocabulary")
    counts = {k: sched.metrics.count(k) for k in (
        "requests_requeued", "engine_restarts", "engine_loop_errors")}
    prefills = sum(e["name"] == "serve.prefill" for e in tracer.events)
    check(prefills == n + counts["requests_requeued"],
          f"{tag}: {prefills} prefills for {n} requests and "
          f"{counts['requests_requeued']} requeued")
    flash = any(getattr(m, "attention_impl", None) == "flash"
                for m in engine.model.modules())
    expect = engine.model.c.num_layers * prefills \
        if device == "cuda" and flash else 0
    check(launches == expect, f"{tag}: {launches} flash forwards, not "
                              f"{expect} (one a layer a prefill)")
    return dict(requests=[SimpleNamespace(prompt=list(p), tokens=r["tokens"])
                          for (p, _), r in zip(pairs, resps)],
                wall=wall, latency=lat, ttft=[r["ttft_s"] for r in resps],
                counts=counts, launches=launches, prefills=prefills,
                restarted=restarted, events=tracer.events)


def _front_end_line(tag, served, direct_wall, direct_ttft_p50_ms,
                    direct_tps, card):
    """Print what the server's wire and threads cost against the same
    burst run straight through the scheduler; returns the numbers."""
    n_tok = sum(len(r.tokens) for r in served["requests"])
    lat = sorted(served["latency"])
    ttft = sorted(served["ttft"])
    out = dict(tokens_per_s=n_tok / served["wall"],
               latency_p50_ms=lat[len(lat) // 2] * 1e3,
               latency_max_ms=lat[-1] * 1e3,
               ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
               direct_ttft_p50_ms=direct_ttft_p50_ms,
               direct_tokens_per_s=direct_tps, wall_s=served["wall"],
               direct_wall_s=direct_wall, launches=served["launches"])
    print(f"[server] {tag}: {len(lat)} clients, {n_tok} tokens in "
          f"{served['wall']:.3f} s through InferenceServer: "
          f"{out['tokens_per_s']:.1f} tokens/s against {direct_tps:.1f} "
          f"direct ({direct_wall:.3f} s); client latency p50 "
          f"{out['latency_p50_ms']:.2f} ms, max {out['latency_max_ms']:.2f} "
          f"ms; TTFT p50 {out['ttft_p50_ms']:.2f} ms (server side) against "
          f"{direct_ttft_p50_ms:.2f} ms direct; flash forwards "
          f"{served['launches']} for {served['prefills']} prefills [{card}]")
    return out


def _wire_drain(tag, codec, src, dst, pairs, port, channel, card, device,
                hold):
    """One burst on a scheduler over ``src``, stepped until every slot is
    mid-decode, moved whole to a scheduler over ``dst`` by
    ``migrate_inflight`` over two ``BlobChannel`` s of this process's van
    (``channel``) with ``codec``, in ``WIRE_CHUNK`` chunks, then drained
    there.  Hard: the imported rows bitwise the exported ones (none,
    bf16) or within blockmax / 254 (int8); one slot adopted a mid-decode
    request, the queued prompts the only prefill, every slot freed.
    ``hold(requests)`` holds the streams.  Returns the numbers."""
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, Request, ServeMetrics, migrate,
    )
    from hetu_tpu_torch.telemetry import default_registry, trace

    counters = _flash_counters()
    src.metrics, dst.metrics = ServeMetrics(), ServeMetrics()
    s1 = ContinuousBatchingScheduler(src)
    s2 = ContinuousBatchingScheduler(dst)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    for c in counters:
        c.launches = 0
    running, queued = _mid_decode(s1, reqs, tag)
    src_launches = counters[0].launches
    cached = sum(len(r.prompt) + len(r.tokens) - 1 for r in running)
    put_bytes = default_registry.counter("van.blob_put.bytes")
    put_calls = default_registry.counter("van.blob_put.calls")
    tx = van.BlobChannel("127.0.0.1", port, channel)
    rx = van.BlobChannel("127.0.0.1", port, channel)
    b0, c0 = put_bytes.value, put_calls.value
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    try:
        _sync(device)
        t0 = time.perf_counter()
        slot_map = migrate.migrate_inflight(s1, s2, wire=(tx, rx),
                                            codec=codec,
                                            chunk_bytes=WIRE_CHUNK,
                                            timeout_s=SERVER_TIMEOUT_S)
        _sync(device)
        total_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trace.disable()
        tx.close()
        rx.close()
    wire, chunks = put_bytes.value - b0, put_calls.value - c0
    worst = 0.0
    for s_slot, d_slot in slot_map.items():
        n = int(dst.cache.lengths[d_slot])
        for got, rows in ((dst.cache.k[:, d_slot, :n],
                           src.cache.k[:, s_slot, :n]),
                          (dst.cache.v[:, d_slot, :n],
                           src.cache.v[:, s_slot, :n])):
            if codec == "int8":
                worst = max(worst, _int8_rows_ok(got, rows))
            else:
                check(torch.equal(got, rows), f"{tag}: the imported rows "
                                              f"are not the exported rows")
    check(not s1.has_work(), f"{tag}: the source kept work")
    _released(src, f"{tag} source")
    launches = _finish_route(tag, dst, s2, reqs, queued, slot_map,
                             len(running), device, counters)
    exact, near = hold(reqs)
    ev = tracer.events
    out = dict(wire_bytes=wire, chunks=chunks, cached_tokens=cached,
               migrate_ms=total_ms, exact=exact, int8_share=worst,
               mbps_last=default_registry.gauge(
                   "migrate.wire.mbps_last").value,
               launches=src_launches + launches,
               tokens=[r.tokens for r in reqs],
               **{f"{k}_ms": _span_ms(ev, f"serve.{k}")[0] for k in (
                   "migrate.send", "migrate.recv", "export_slots",
                   "migrate.pack", "migrate.unpack", "adopt_slots")})
    gb = wire / 1e9
    print(f"[server] {tag}: {len(running)} mid-decode slots "
          f"({cached} cached tokens) over the van, {wire / 1e6:.3f} MB in "
          f"{chunks} chunks of {WIRE_CHUNK} B: send "
          f"{out['migrate.send_ms']:.3f} ms "
          f"({out['migrate.send_ms'] / gb:.1f} ms/GB), receive "
          f"{out['migrate.recv_ms']:.3f} ms "
          f"({out['migrate.recv_ms'] / gb:.1f} ms/GB); export "
          f"{out['export_slots_ms']:.3f}, pack {out['migrate.pack_ms']:.3f}, "
          f"unpack {out['migrate.unpack_ms']:.3f}, import "
          f"{out['adopt_slots_ms']:.3f} ms; migrate_inflight "
          f"{total_ms:.3f} ms; migrate.wire.mbps_last "
          f"{out['mbps_last']:.1f}; {exact} of {len(reqs)} streams "
          f"token-exact{near}; {len(queued)} queued re-prefilled"
          + (f"; int8 error up to {worst:.3f} of blockmax / 254"
             if codec == "int8" else "; imported rows bitwise the exported")
          + f" [{card}]")
    return out


def phase_server(card, seed, llama_engine, llama_run, migrated,
                 device="cuda"):
    """The front end over the van (serve/server.py, ps/van.py) and the
    chunked migration wire (serve/migrate.py) on the card: (a)
    GPT-2-small at the slice's configuration and (b) Llama-2-7B on
    ``llama_engine``'s serving copy, each burst sent by one client thread
    a request to ``InferenceServer`` and held to the burst run straight
    through the scheduler (``llama_run``: llama_serve's) by the near-tie
    rule; (c) a GPT-2-small engine that crashes mid-decode, restarted by
    ``restart_engine`` with zero loss; (d) llama_serve's burst drained
    slot -> slot by ``migrate_inflight`` over two blob channels with each
    codec, and GPT-2-small f32 token-exact over the wire, beside the
    in-process hand-off and the re-prefill of ``migrated`` (the migrate
    phase's numbers)."""
    from types import SimpleNamespace

    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": 0}

    def near_tie(model, tag, ref_run, tau):
        plain = _plain_logits(model, device)

        def hold(reqs):
            _set_attention_impl(model, "xla")
            try:
                shares = _hold_streams(tag, ref_run, {"requests": reqs},
                                       plain, tau, phase="server")
            finally:
                _set_attention_impl(model, "flash")
            return len(reqs) - len(shares), \
                f" ({len(shares)} parted at a near tie)"
        return hold

    # (a) GPT-2-small, the slice's configuration, straight and served
    cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L, num_heads=NH,
                    ffn_size=FFN, max_position=MAX_LEN, dtype=torch.bfloat16,
                    attention_impl="flash")
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, MAX_LEN), cfg))
    gpt = ServeEngine(model, num_slots=SLOTS, max_len=MAX_LEN, device=device)
    del model
    _serve_burst(gpt, _warm_pairs((10, 20, 40, 100), MAX_LEN), device)
    pairs = burst(np.random.default_rng(seed), V, N_REQUESTS, GPT_PROMPT,
                  GPT_GEN)
    direct = _serve_burst(gpt, pairs, device)
    served = _serve_over_van("gpt", gpt, pairs, device)
    out["launches"] += served["launches"]
    exact, _ = near_tie(gpt.model, "gpt served", direct,
                        TOL_LOGITS)(served["requests"])
    out["gpt"] = _front_end_line(
        "gpt", served, direct["wall"], direct["snap"]["ttft_p50_s"] * 1e3,
        sum(len(r.tokens) for r in direct["requests"]) / direct["wall"], card)
    out["gpt"]["exact"] = exact

    # (c) failover: the engine crashes mid-decode, a fresh one on the same
    # weights takes the queue inside the grace window
    shared = _Served(gpt.model)

    def fresh():
        return ServeEngine(shared, num_slots=SLOTS, max_len=MAX_LEN,
                           device=device)

    crashing = _CrashingEngine(fresh(), FAILOVER_CRASH_AT)
    failed = _serve_over_van("failover", crashing, pairs, device,
                             restart=fresh)
    out["launches"] += failed["launches"]
    counts = failed["counts"]
    check(failed["restarted"], "failover: healthy is not true again after "
                               "restart_engine")
    check(counts["requests_requeued"] >= 1 and
          counts["engine_restarts"] == 1,
          f"failover: {counts} (at least one requeued, one restart)")
    crash_us = [e["ts"] for e in failed["events"]
                if e["name"] == "serve.engine_crash"]
    check(len(crash_us) == 1, "failover: the engine crashed "
                              f"{len(crash_us)} times")
    after = [e["ts"] + e["dur"] for e in failed["events"]
             if e["name"] == "serve.prefill" and e["ts"] > crash_us[0]]
    recovery_ms = (min(after) - crash_us[0]) / 1e3
    f_exact, _ = near_tie(gpt.model, "failover", served,
                          TOL_LOGITS)(failed["requests"])
    print(f"[server] failover: the engine crashed after decode round "
          f"{FAILOVER_CRASH_AT}; {counts['engine_loop_errors']} loop errors, "
          f"{counts['requests_requeued']} requests requeued, "
          f"{counts['engine_restarts']} restart; every response ok, "
          f"{f_exact} of {len(pairs)} streams token-exact to the served "
          f"burst; crash to the first token after the restart "
          f"{recovery_ms:.3f} ms; wall {failed['wall']:.3f} s [{card}]")
    out["failover"] = dict(recovery_ms=recovery_ms, exact=f_exact, **counts)
    del gpt, shared, crashing, direct, served, failed
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) Llama-2-7B, served, against llama_serve's straight run
    lpairs = burst(np.random.default_rng(seed + 3), LLAMA_V, LLAMA_REQUESTS,
                   LLAMA_PROMPT, LLAMA_GEN)
    ref_run = {"requests": [SimpleNamespace(prompt=list(p), tokens=t)
                            for (p, _), t in zip(lpairs,
                                                 llama_run["tokens"])]}
    served = _serve_over_van("llama", llama_engine, lpairs, device)
    out["launches"] += served["launches"]
    exact, _ = near_tie(llama_engine.model, "llama served", ref_run,
                        TOL_LLAMA_LOGITS)(served["requests"])
    n_tok = sum(len(t) for t in llama_run["tokens"])
    out["llama"] = _front_end_line(
        "llama", served, n_tok / llama_run["tokens_per_s"],
        llama_run["ttft_p50_ms"], llama_run["tokens_per_s"], card)
    out["llama"]["exact"] = exact
    del served

    # (d) migration over the wire: two blob channels on this process's van
    port = van.serve(0)
    try:
        # GPT-2-small f32, plain attention: token-exact over the wire
        cfg = GPTConfig(vocab_size=V, hidden_size=H, num_layers=L,
                        num_heads=NH, ffn_size=FFN, max_position=MAX_LEN)
        model = GPTModel(cfg, device=device)
        model.load_state_dict(interop.params_from_jax(
            jax_layout_weights(seed, MAX_LEN), cfg))
        a = ServeEngine(model, num_slots=SLOTS, max_len=MAX_LEN,
                        device=device)
        b = ServeEngine(_Served(a.model), num_slots=SLOTS, max_len=MAX_LEN,
                        device=device)
        del model
        ref = [r.tokens for r in _serve_burst(a, pairs, device)["requests"]]

        def exact_hold(reqs):
            check([r.tokens for r in reqs] == ref,
                  "gpt f32 wire: a migrated stream differs from the "
                  "unmigrated burst")
            return len(reqs), ""

        out["gpt_wire"] = _wire_drain("gpt f32 wire none", "none", a, b,
                                      pairs, port, 0x57495245, card,
                                      device, exact_hold)
        out["launches"] += out["gpt_wire"]["launches"]
        del a, b
        if device == "cuda":
            torch.cuda.empty_cache()

        # Llama-2-7B, bf16: llama_serve's burst, each codec
        dst = ServeEngine(_Served(llama_engine.model), num_slots=LLAMA_SLOTS,
                          max_len=LLAMA_MAX_LEN, device=device)
        wires = out["llama_wire"] = {}
        for i, codec in enumerate(MIGRATE_CODECS):
            tag = f"llama wire {codec}"
            if codec == "int8":
                def hold(reqs):
                    n = sum(r.tokens == t for r, t in
                            zip(reqs, llama_run["tokens"]))
                    return n, " (no gate: the codec is lossy)"
            else:
                hold = near_tie(llama_engine.model, tag, ref_run,
                                TOL_LLAMA_LOGITS)
            w = wires[codec] = _wire_drain(tag, codec, llama_engine, dst,
                                           lpairs, port, 0x57495246 + i,
                                           card, device, hold)
            out["launches"] += w["launches"]
        del dst
    finally:
        van.stop()
    for codec in MIGRATE_CODECS:
        wires[codec]["ratio"] = wires["none"]["wire_bytes"] \
            / wires[codec]["wire_bytes"]
    check(wires["int8"]["ratio"] >= 1.9,
          "int8 codec: the wire bytes are not 1.9x fewer than none on the "
          "bf16 cache")
    re = migrated["llama"]["reprefill"]
    slope, icpt = re["ms_per_token"], re["fixed_ms"]
    # the migrate phase's slot -> slot hand-off moved the same burst after
    # the same steps: the same cached tokens
    inproc = migrated["llama"]["slot->slot"]
    rows = [("in process (export + import, the migrate phase)",
             inproc["export_ms"] + inproc["import_ms"],
             wires["none"]["cached_tokens"], "")]
    rows += [(f"over the wire, {c} (migrate_inflight)",
              wires[c]["migrate_ms"], wires[c]["cached_tokens"],
              f"; {wires[c]['ratio']:.3f}x fewer wire bytes than none")
             for c in MIGRATE_CODECS]
    for name, ms, tok, note in rows:
        per_tok = ms / tok
        cross = icpt / (per_tok - slope) if per_tok > slope else None
        print(f"[server] llama migration {name}: {ms:.3f} ms for {tok} "
              f"cached tokens, {per_tok:.5f} ms a token against "
              f"re-prefill's {slope:.5f} + {icpt:.3f} ms fixed: "
              + (f"migration wins below {cross:.0f} tokens of context"
                 if cross is not None else
                 "migration wins at every context length")
              + f"{note} [{card}]")
    out["peak_gib"] = _peak_gib(device)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[server] peak {out['peak_gib']:.2f} GiB allocated; phase "
          f"{out['seconds']:.1f} s; flash forwards launched "
          f"{out['launches']} [{card}]")
    return out


# ------------------------------------------------------------ serving pool

class _PoolProbe:
    """A member engine of the pool phase: a proxy over a ServeEngine that
    counts its decode rounds (also into ``rounds``, a shared ``[count,
    Condition]`` the chaos loop waits on), records every prompt it
    prefills, and with ``hold_at`` sets ``reached`` and waits on
    ``release`` at the start of that decode round (0-based): the count of
    decode rounds at which a drain or a kill lands, never a timer.  Once
    ``park`` is set, the next decode round sets ``parked`` and waits on
    ``unpark`` before it runs."""

    def __init__(self, inner, *, hold_at=None, rounds=None):
        self.inner, self.hold_at, self.rounds = inner, hold_at, rounds
        self.reached, self.release_evt = threading.Event(), threading.Event()
        self.park, self.parked, self.unpark = (threading.Event(),
                                               threading.Event(),
                                               threading.Event())
        self.decodes, self.prefilled = 0, []
        self.cache, self.metrics = inner.cache, inner.metrics

    def alloc_slot(self):
        return self.inner.alloc_slot()

    def release(self, slot):
        self.inner.release(slot)

    def prefill(self, slot, prompt):
        self.prefilled.append([int(t) for t in prompt])
        return self.inner.prefill(slot, prompt)

    def decode(self):
        if self.decodes == self.hold_at:
            self.reached.set()
            check(self.release_evt.wait(POOL_TIMEOUT_S),
                  "pool: a held member was never released")
        if self.park.is_set():
            self.park.clear()
            self.parked.set()
            check(self.unpark.wait(POOL_TIMEOUT_S),
                  "pool: a parked member was never released")
            self.unpark.clear()
        out = self.inner.decode()
        self.decodes += 1
        if self.rounds is not None:
            with self.rounds[1]:
                self.rounds[0] += 1
                self.rounds[1].notify_all()
        return out

    def export_slots(self, slot_ids):
        return self.inner.export_slots(slot_ids)

    def adopt_slots(self, snapshots):
        return self.inner.adopt_slots(snapshots)

    def resume_slots(self, slot_ids):
        self.inner.resume_slots(slot_ids)


def _pool_engine(seed, dtype, device):
    """GPT-2-small at its published widths (``POOL_V``, ``POOL_P``), the
    JAX package's layout and initialisers from ``seed``, loaded through
    ``interop``; flash attention (f32: the scalar kernel, bf16: wgmma)."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.serve import ServeEngine

    cfg = GPTConfig(vocab_size=POOL_V, hidden_size=H, num_layers=L,
                    num_heads=NH, ffn_size=FFN, max_position=POOL_P,
                    dtype=dtype, attention_impl="flash")
    model = GPTModel(cfg, device=device)
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(seed, POOL_P, POOL_V), cfg))
    return ServeEngine(model, num_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                       device=device)


def _until(cond, what, timeout=POOL_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, what)
        time.sleep(0.002)


def _wait_in_threads(threads, what):
    for t in threads:
        t.join(POOL_TIMEOUT_S)
    check(not any(t.is_alive() for t in threads), what)


def _pool_of(make, probes, **kw):
    """A ``ServingPool`` of ``POOL_MEMBERS`` members whose engines are
    ``_PoolProbe`` s over ``make()``; each probe made is appended to
    ``probes`` (a revive makes one more)."""
    from hetu_tpu_torch.serve import ServingPool

    probe_kw = {k: kw.pop(k) for k in ("hold_at", "rounds") if k in kw}

    def factory():
        p = _PoolProbe(make(), **probe_kw)
        probes.append(p)
        return p

    return ServingPool({f"m{i}": factory for i in range(POOL_MEMBERS)},
                       health_poll_s=0.05, max_loop_errors=2,
                       request_timeout_s=POOL_TIMEOUT_S, **kw)


def _pool_flash(tag, probes, events, launches, device):
    """Hard: one ``serve.prefill`` span for each prefill the members ran
    (re-prefills included), and one flash forward a layer for each on the
    card.  Returns the count of prefills."""
    prefills = sum(len(p.prefilled) for p in probes)
    spans = sum(e["name"] == "serve.prefill" for e in events)
    check(spans == prefills, f"{tag}: {spans} prefill spans for "
                             f"{prefills} prefills")
    expect = L * prefills if device == "cuda" else 0
    check(launches == expect, f"{tag}: {launches} flash forwards, not "
                              f"{expect} (one a layer a prefill)")
    return prefills


def _pool_burst(tag, make, pairs, ref_tokens, device, fault, card):
    """``pairs`` sent through ``pool.generate``, one thread a request, to
    a pool of three members, each held at the start of its decode round
    ``POOL_HOLD_AT``; then ``fault(pool, victim, probes, held)`` drains or
    kills the busiest member (``victim``) and releases the members.  Hard:
    every response ok with its tokens equal to ``ref_tokens`` (the burst
    straight through one scheduler), the flash launches one a layer a
    prefill.  Returns the pool (open), its probes, the fault's record and
    the numbers."""
    from hetu_tpu_torch.telemetry import trace

    counters = _flash_counters()
    probes = []
    pool = _pool_of(make, probes, hold_at=POOL_HOLD_AT)
    n = len(pairs)
    resps = [None] * n

    def worker(i):
        resps[i] = pool.generate(pairs[i][0], max_tokens=pairs[i][1],
                                 timeout_s=POOL_TIMEOUT_S)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    try:
        _sync(device)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for p in probes:
            check(p.reached.wait(POOL_TIMEOUT_S),
                  f"{tag}: a member never reached decode round "
                  f"{POOL_HOLD_AT}")
        victim = max(pool.members.values(), key=lambda m: m.scheduler.load)
        held = dict(name=victim.name, load=victim.scheduler.load,
                    running=list(victim.scheduler._running.values()))
        fault_out = fault(pool, victim, probes, held)
        _wait_in_threads(threads, f"{tag}: a generate did not return")
        _sync(device)
        wall = time.perf_counter() - t0
        launches = counters[0].launches
    finally:
        for p in probes:
            p.release_evt.set()
        trace.disable()
    check(all(r["status"] == "ok" for r in resps),
          f"{tag}: a response is not ok: {[r['status'] for r in resps]}")
    got = [r["tokens"] for r in resps]
    check(got == ref_tokens, f"{tag}: a stream differs from the burst run "
                             f"straight through one scheduler")
    prefills = _pool_flash(tag, probes, tracer.events, launches, device)
    n_tok = sum(len(t) for t in got)
    ttft = sorted(r["ttft_s"] for r in resps)
    out = dict(wall_s=wall, tokens_per_s=n_tok / wall, launches=launches,
               prefills=prefills, exact=n, victim=victim.name,
               ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
               migrate_ms=_span_ms(tracer.events, "serve.migrate")[0],
               failover_ms=_span_ms(tracer.events, "serve.failover")[0],
               **{f"{k}_ms": _span_ms(tracer.events, f"serve.{k}")[0]
                  for k in ("export_slots", "migrate.pack", "migrate.send",
                            "migrate.recv", "migrate.unpack",
                            "adopt_slots")},
               **fault_out)
    print(f"[pool] {tag}: {n} requests over {POOL_MEMBERS} members, "
          f"{victim.name} held at decode round {POOL_HOLD_AT} with "
          f"{held['load']} requests ({len(held['running'])} running); "
          f"every response ok, {n} of {n} streams token-exact to the "
          f"straight run; {prefills} prefills, {launches} flash forwards; "
          f"{n_tok} tokens in {wall:.3f} s, {out['tokens_per_s']:.1f} "
          f"tokens/s, TTFT p50 {out['ttft_p50_ms']:.2f} ms [{card}]")
    return pool, probes, out


def _held_probe(pool, name):
    return pool.members[name].engine.inner


def _pool_drain(wire):
    """The fault of a drain run: ``drain_member`` of the busiest member
    (over the van with codec none, or in process).  Its peers are
    released first and serve on until each has room for every request
    running on it (one peer adopts them all, slot for slot); then the
    drain starts, and the member is released once the drain waits for its
    scheduler lock (the engine loop hands the lock over before its next
    step), so the drain lands right after that decode round."""

    def fault(pool, victim, probes, held):
        need = len(held["running"])
        peers = [m for m in pool.members.values() if m is not victim]
        for m in peers:
            _held_probe(pool, m.name).release_evt.set()
        _until(lambda: all(m.scheduler.load <= POOL_SLOTS - need
                           for m in peers),
               "pool: no peer made room for the drained member's slots")
        box = {}

        def drain():
            try:
                box["map"] = pool.drain_member(victim.name, wire=wire,
                                               codec="none")
            except Exception as e:  # reported below
                box["error"] = repr(e)

        t = threading.Thread(target=drain, daemon=True)
        t.start()
        _until(lambda: victim.scheduler.control_waiting > 0
               or not t.is_alive(), "pool: the drain never reached the "
                                    "member's scheduler lock")
        _held_probe(pool, victim.name).release_evt.set()
        _wait_in_threads([t], "pool: the drain did not return")
        check("error" not in box, f"pool: the drain failed: "
                                  f"{box.get('error')}")
        return dict(slot_map=box["map"], held=held)
    return fault


def _pool_kill(pool, victim, probes, held):
    """The fault of a kill run: the busiest member's kill switch flips
    while every member is held, then all are released."""
    pool.kill_member(victim.name)
    for p in probes:
        p.release_evt.set()
    return dict(held=held)


def _drain_gates(tag, pool, probes, out):
    """Hard, for a drain run: one slot moved for each request running on
    the member at the drain, ``slots_migrated`` equal to it, and no
    prefill token on any member for a migrated request after the drain
    (a prompt that starts with a migrated request's)."""
    held, slot_map = out["held"], out["slot_map"]
    running = held["running"]
    check(len(slot_map) == len(running) > 0,
          f"{tag}: {len(slot_map)} slots moved for {len(running)} running "
          f"requests")
    moved = pool.metrics.count("slots_migrated")
    check(moved == len(running), f"{tag}: slots_migrated {moved}, not "
                                 f"{len(running)}")
    victim = _held_probe(pool, held["name"])
    extra = sum(len(q) for p in probes if p is not victim
                for q in p.prefilled
                for r in running if q[:len(r.prompt)] == list(r.prompt))
    check(extra == 0, f"{tag}: the survivors prefilled {extra} tokens for "
                      f"the migrated requests")
    reg = pool.members[held["name"]].scheduler.metrics.registry
    out.update(slots=len(slot_map), reprefill_tokens=extra,
               wire_bytes=reg.counter("serve.migrate.bytes_wire").value,
               swept=pool.metrics.count("requests_swept_on_drain"))
    return out


def _chaos_schedule():
    """The first seed whose two victims differ, as the reference's chaos
    test draws it (``tests/test_serve_pool.py``); the schedule's bytes
    checked stable."""
    from hetu_tpu_torch.resilience import FaultSchedule

    def victims(sched):
        return {e.kind: int(e.arg) for e in sched.events}

    kw = dict(steps=6, serve_preempts=1, serve_engine_kills=1,
              n_members=POOL_MEMBERS)
    seed, sched = next(
        (s, sc) for s, sc in ((s, FaultSchedule.generate(seed=s, **kw))
                              for s in range(64))
        if len(sc) == 2 and
        victims(sc)["serve_preempt"] != victims(sc)["serve_engine_kill"])
    again = FaultSchedule.generate(seed=seed, **kw).to_json()
    check(sched.to_json() == again ==
          FaultSchedule.from_json(again).to_json(),
          "pool chaos: the schedule's bytes are not stable")
    return seed, sched


def _park_busy(probe, sched):
    """Park ``probe``'s member at the start of a decode round after which
    a request of its scheduler ``sched`` is still running, so that a
    preemption fired now has live KV slots to move.  Returns how many
    requests will be running after that round."""
    for _ in range(1000):
        probe.park.set()
        check(probe.parked.wait(POOL_TIMEOUT_S),
              "pool chaos: the preempted member never decoded")
        probe.parked.clear()
        # the member's engine loop holds its scheduler lock while parked,
        # so the running requests stand still
        live = sum(len(r.tokens) + 1 < r.max_tokens
                   for r in sched._running.values())
        if live:
            return live
        probe.unpark.set()
    raise SmokeFailure("pool chaos: the preempted member never had a "
                       "request that outlives a decode round")


def _pool_chaos(engine, pairs, ref_run, device, card):
    """The seeded chaos run in bf16: a preemption and an engine kill from
    one ``FaultSchedule``, fired through ``FaultInjector.on_step`` every
    ``POOL_ROUNDS_PER_STEP`` decode rounds of the pool and applied by
    ``run_fault_events``, under continuous traffic from
    ``POOL_WORKERS`` threads looping over the burst.  Hard: every
    response ok, each stream held to the straight run by the near-tie
    rule, the preemption landing on a member with a running request
    (parked at a decode round, see ``_park_busy``, once an earlier kill
    has failed over) and moving its live KV slots (one
    ``pool_migrations``, ``slots_migrated`` the requests still running
    after that round, at least one), every
    ``fault.serve_*`` instant paired with its recovery span, ``diagnose``
    ranking each fault first for an alert that names it, the flash
    launches one a layer a prefill."""
    from types import SimpleNamespace

    from hetu_tpu_torch.resilience import FaultInjector
    from hetu_tpu_torch.serve import ServeEngine, migrate
    from hetu_tpu_torch.telemetry import AlertRule, diagnose, timeline, trace

    seed, sched = _chaos_schedule()
    print(f"[pool] chaos: schedule seed {seed}, id {sched.schedule_id}: "
          f"{sched.to_json()}")
    counters = _flash_counters()
    rounds = [0, threading.Condition()]
    probes = []
    shared = _Served(engine.model)
    pool = _pool_of(lambda: ServeEngine(shared, num_slots=POOL_SLOTS,
                                        max_len=POOL_MAX_LEN, device=device),
                    probes, rounds=rounds, migrate_codec="auto")
    inj = FaultInjector(sched)
    served, errors = [], []
    stop = threading.Event()

    def traffic(w):
        k = 0
        while not stop.is_set():
            i = (w + POOL_WORKERS * k) % len(pairs)
            try:
                served.append((i, pool.generate(
                    pairs[i][0], max_tokens=pairs[i][1],
                    timeout_s=POOL_TIMEOUT_S)))
            except Exception as e:  # reported after the join
                errors.append(repr(e))
            k += 1

    workers = [threading.Thread(target=traffic, args=(w,), daemon=True)
               for w in range(POOL_WORKERS)]
    codecs, live = [], []
    for c in counters:
        c.launches = 0
    tracer = trace.enable()
    try:
        _sync(device)
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        names = list(pool.members)
        for step in range(1, 6):
            with rounds[1]:
                check(rounds[1].wait_for(
                    lambda: rounds[0] >= POOL_ROUNDS_PER_STEP * step,
                    POOL_TIMEOUT_S), "pool chaos: the traffic stalled")
            parked = None
            for e in sched.at(step):
                if e.kind == "serve_preempt":
                    # an earlier kill fails over first: its re-homing
                    # must not be what the drain below is taken for
                    _until(lambda: pool.metrics.count("pool_failovers") >=
                           pool.metrics.count("members_killed"),
                           "pool chaos: a killed member never failed over")
                    m = pool.members[names[int(e.arg) % len(names)]]
                    parked = m, _held_probe(pool, m.name)
                    live.append(_park_busy(parked[1], m.scheduler))
                    codecs.append(migrate.resolve_codec("auto",
                                                        m.scheduler.engine))
            inj.on_step(step)
            events = inj.pop_serve_events()
            if parked is None:
                pool.run_fault_events(events)
                continue
            # the drain waits for the parked member's scheduler lock; the
            # member is let go once it does, and the drain lands right
            # after that decode round
            t = threading.Thread(target=pool.run_fault_events,
                                 args=(events,), daemon=True)
            t.start()
            _until(lambda: parked[0].scheduler.control_waiting > 0
                   or not t.is_alive(), "pool chaos: the preemption never "
                                        "reached the member's scheduler lock")
            parked[1].unpark.set()
            _wait_in_threads([t], "pool chaos: the preemption did not return")
        _until(lambda: pool.metrics.count("pool_failovers") >= 1,
               "pool chaos: the killed member never failed over")
        # traffic goes on until the burst's count of requests is served
        _until(lambda: len(served) >= len(pairs),
               "pool chaos: the survivors stopped serving")
        stop.set()
        _wait_in_threads(workers, "pool chaos: a worker did not stop")
        _sync(device)
        wall = time.perf_counter() - t0
        launches = counters[0].launches
    finally:
        stop.set()
        for p in probes:
            p.park.clear()
            p.unpark.set()
        pool.close()
        trace.disable()
    check(not errors, f"pool chaos: worker errors {errors}")
    migrations = pool.metrics.count("pool_migrations")
    slots = pool.metrics.count("slots_migrated")
    check(migrations == 1 and slots == sum(live) >= 1,
          f"pool chaos: the preemption made {migrations} migrations of "
          f"{slots} slots, not one of the {live} requests running after "
          f"the parked round")
    check(all(r["status"] == "ok" for _, r in served),
          f"pool chaos: a response is not ok: "
          f"{sorted({r['status'] for _, r in served})}")
    ev = tracer.events
    prefills = _pool_flash("pool chaos", probes, ev, launches, device)
    # every stream against the straight run, by the near-tie rule
    model = engine.model
    _set_attention_impl(model, "xla")
    try:
        shares = _hold_streams(
            "chaos", {"requests": [ref_run["requests"][i]
                                   for i, _ in served]},
            {"requests": [SimpleNamespace(prompt=pairs[i][0],
                                          tokens=r["tokens"])
                          for i, r in served]},
            _plain_logits(model, device), TOL_LOGITS, phase="pool")
    finally:
        _set_attention_impl(model, "flash")
    pairs_t = timeline.correlate(ev)
    serve_pairs = [p for p in pairs_t if p.kind.startswith("serve_")]
    check(sorted(p.kind for p in serve_pairs) ==
          ["serve_engine_kill", "serve_preempt"],
          f"pool chaos: fault instants {[p.kind for p in serve_pairs]}")
    for p in serve_pairs:
        check(p.paired and p.recovery_name in timeline.RECOVERY_FOR[p.kind],
              f"pool chaos: fault.{p.kind} has no recovery span")
        upto = [e for e in ev if e["ts"] <= p.recovery_end_us]
        d = diagnose(upto, alert=AlertRule(f"serve_recovery.{p.kind}",
                                           fault_kinds=(p.kind,)),
                     now_us=p.recovery_end_us)
        check(d is not None and d["top"]["kind"] == p.kind,
              f"pool chaos: the doctor blames "
              f"{d and d['top']['kind']} for fault.{p.kind}")
        print(f"[pool] chaos: fault.{p.kind} at step {p.step} -> "
              f"{p.recovery_name}: detection {p.detect_s * 1e3:.3f} ms, "
              f"recovery {p.recover_s * 1e3:.3f} ms; doctor: "
              f"{d['top']['text']}")
    rep = timeline.report(pairs_t)
    ttft = sorted(r["ttft_s"] for _, r in served)
    n_tok = sum(len(r["tokens"]) for _, r in served)
    migrate_ms, _ = _span_ms(ev, "serve.migrate")
    out = dict(requests=len(served), exact=len(served) - len(shares),
               near_ties=len(shares), launches=launches, prefills=prefills, wall_s=wall,
               tokens_per_s=n_tok / wall, migrate_ms=migrate_ms,
               ttft_p50_ms=ttft[len(ttft) // 2] * 1e3,
               ttft_p99_ms=ttft[min(len(ttft) - 1,
                                    int(0.99 * len(ttft)))] * 1e3,
               failovers=pool.metrics.count("pool_failovers"),
               requests_failed_over=pool.metrics.count(
                   "requests_failed_over"),
               slots_migrated=slots, live_at_preempt=live, codec=codecs, report=rep, seed=seed,
               schedule_id=sched.schedule_id)
    print(f"[pool] chaos: {len(served)} requests, every response ok, "
          f"{out['exact']} token-exact ({len(shares)} parted at a near "
          f"tie); {out['slots_migrated']} slots migrated (codec auto -> "
          f"{codecs}, drain {migrate_ms:.3f} ms), {out['failovers']} "
          f"failover ({out['requests_failed_over']} requests "
          f"re-prefilled); {prefills} prefills, {launches} flash forwards; "
          f"{n_tok} tokens in {wall:.3f} s, {out['tokens_per_s']:.1f} "
          f"tokens/s; TTFT p50 {out['ttft_p50_ms']:.2f} ms, p99 "
          f"{out['ttft_p99_ms']:.2f} ms [{card}]")
    for kind, row in rep.items():
        if kind.startswith("serve_"):
            print(f"[pool] chaos: report {kind}: " + json.dumps(row))
    return out


def phase_pool(card, seed, device="cuda"):
    """The serving pool (serve/pool.py) over GPT-2-small at its published
    widths, three members of ``POOL_SLOTS`` x ``POOL_MAX_LEN`` sharing one
    copy of the weights: (a) f32, the slice's 16-request burst through
    ``pool.generate``, token-exact against the burst straight through one
    scheduler, through a planned drain of the busiest member over the
    van (codec none) and in process, and through an unplanned kill, then
    ``revive_member``; (b) bf16, the seeded chaos run."""
    import gc

    from hetu_tpu_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pairs = burst(np.random.default_rng(seed), POOL_V, N_REQUESTS,
                  GPT_PROMPT, GPT_GEN)
    out = {"launches": 0}

    # (a) f32: the scalar flash forward, token-exact
    base = _pool_engine(seed, torch.float32, device)
    _serve_burst(base, _warm_pairs((10, 20, 40, 100), POOL_MAX_LEN), device)
    straight = _serve_burst(base, pairs, device)
    ref_tokens = [r.tokens for r in straight["requests"]]
    shared = _Served(base.model)

    def make():
        return ServeEngine(shared, num_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                           device=device)

    for tag, wire in (("f32 drain over the van", True),
                      ("f32 drain in process", False)):
        pool, probes, run = _pool_burst(tag, make, pairs, ref_tokens, device,
                                        _pool_drain(wire), card)
        try:
            run = _drain_gates(tag, pool, probes, run)
        finally:
            pool.close()
        out["launches"] += run["launches"]
        out[tag] = {k: v for k, v in run.items()
                    if k not in ("held", "slot_map")}
        print(f"[pool] {tag}: {run['victim']} drained mid-decode, "
              f"{run['slots']} slots moved (slots_migrated {run['slots']}), "
              f"{run['reprefill_tokens']} prefill tokens on the survivors "
              f"for them, {run['swept']} swept on close; serve.migrate "
              f"{run['migrate_ms']:.3f} ms (export "
              f"{run['export_slots_ms']:.3f}, pack "
              f"{run['migrate.pack_ms']:.3f}, send "
              f"{run['migrate.send_ms']:.3f}, receive "
              f"{run['migrate.recv_ms']:.3f}, unpack "
              f"{run['migrate.unpack_ms']:.3f}, import "
              f"{run['adopt_slots_ms']:.3f} ms), {run['wire_bytes']} "
              f"payload bytes [{card}]")
        del pool, probes
        gc.collect()

    tag = "f32 kill"
    pool, probes, run = _pool_burst(tag, make, pairs, ref_tokens, device,
                                    _pool_kill, card)
    try:
        name = run["victim"]
        failovers = pool.metrics.count("pool_failovers")
        check(failovers >= 1, f"{tag}: pool_failovers {failovers}")
        check(pool.members[name].dead, f"{tag}: {name} is not dead")
        moved = pool.metrics.count("requests_failed_over")
        gc.collect()
        before_gib = (torch.cuda.memory_allocated() / 2 ** 30
                      if device == "cuda" else 0.0)
        # the dead engine: its prefill record stays for the launch gate,
        # the engine itself goes with the pool's last reference to it
        dead = _held_probe(pool, name)
        pool.revive_member(name)
        dead.inner = dead.cache = dead.metrics = None
        check(pool.members[name].available, f"{tag}: {name} is not back")
        fresh = _held_probe(pool, name)
        fresh.release_evt.set()  # the revived engine holds no round
        # three submits in a row on the idle pool: one a member
        reqs = [Request(prompt=list(pairs[i][0]), max_tokens=pairs[i][1],
                        timeout_s=POOL_TIMEOUT_S) for i in range(3)]
        for r in reqs:
            pool.submit(r)
        for r in reqs:
            check(r.done.wait(POOL_TIMEOUT_S) and r.status == "ok",
                  f"{tag}: a request after the revive is not ok")
        check([r.tokens for r in reqs] == ref_tokens[:3],
              f"{tag}: a stream after the revive differs")
        check(len(fresh.prefilled) >= 1,
              f"{tag}: the revived member took no request")
        gc.collect()
        after_gib = (torch.cuda.memory_allocated() / 2 ** 30
                     if device == "cuda" else 0.0)
        revive_peak_gib = _peak_gib(device)
        revived = pool.metrics.count("members_revived")
    finally:
        pool.close()
    out["launches"] += run["launches"]
    run.update(failovers=failovers, requests_failed_over=moved,
               revived=revived, gib_before_revive=before_gib,
               gib_after_revive=after_gib,
               peak_gib_after_revive=revive_peak_gib)
    out[tag] = {k: v for k, v in run.items() if k != "held"}
    print(f"[pool] {tag}: {name} killed while held, {failovers} failover "
          f"({moved} requests re-prefilled on its peers, serve.failover "
          f"{run['failover_ms']:.3f} ms); revive_member: back in routing, "
          f"took {len(fresh.prefilled)} of 3 new requests token-exact; "
          f"{before_gib:.3f} GiB allocated before the revive, "
          f"{after_gib:.3f} GiB after, peak so far "
          f"{revive_peak_gib:.3f} GiB [{card}]")
    del pool, probes, base, shared
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # (b) bf16: the wgmma flash forward, the seeded chaos run
    engine = _pool_engine(seed, torch.bfloat16, device)
    _serve_burst(engine, _warm_pairs((10, 20, 40, 100), POOL_MAX_LEN),
                 device)
    ref_run = _serve_burst(engine, pairs, device)
    chaos = _pool_chaos(engine, pairs, ref_run, device, card)
    out["launches"] += chaos["launches"]
    out["chaos"] = chaos
    del engine
    out["peak_gib"] = _peak_gib(device)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[pool] peak {out['peak_gib']:.2f} GiB allocated; phase "
          f"{out['seconds']:.1f} s; flash forwards launched "
          f"{out['launches']} [{card}]")
    return out


_CROSS_T0 = [0.0]


def _cross_t():
    """Seconds since the crosshost phase began, printed on its lines:
    where its budget goes."""
    return time.perf_counter() - _CROSS_T0[0]


def _cross_spec(seed, dtype, device):
    """The member processes' model spec: GPT-2-small at the serving pool's
    widths and slots, its weights drawn by ``build_engine`` from
    ``seed``."""
    return {"vocab_size": POOL_V, "hidden_size": H, "num_layers": L,
            "num_heads": NH, "ffn_size": FFN, "max_position": POOL_P,
            "num_slots": POOL_SLOTS, "max_len": POOL_MAX_LEN,
            "min_bucket": 16, "seed": int(seed), "device": device,
            "dtype": dtype, "attention_impl": "flash"}


def _cross_start(workdir, spec, n=None, **pool_kw):
    """Start a ``CrossProcessServingPool`` of ``n`` members
    (``CROSS_MEMBERS``) in a thread (the members come up while the caller
    runs its straight reference); ``_cross_join`` waits for it.
    ``pool_kw`` overrides the pool's other settings."""
    from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool

    box = {}
    kw = {"lease_s": CROSS_LEASE_S, "suspect_grace_s": CROSS_GRACE_S,
          "request_timeout_s": POOL_TIMEOUT_S, "scrape_s": 0.0,
          "spawn_timeout_s": POOL_TIMEOUT_S,
          # CPU members (a rehearsal) share the host's cores
          "member_env": {"OMP_NUM_THREADS": "1"}
          if spec["device"] == "cpu" else None, **pool_kw}

    def make():
        try:
            box["pool"] = CrossProcessServingPool(
                n or CROSS_MEMBERS, workdir=workdir, model=spec, **kw)
        except Exception as e:  # reported by _cross_join
            box["error"] = repr(e)

    t = threading.Thread(target=make, daemon=True)
    t.start()
    return t, box


def _cross_join(started, tag, card, phase="crosshost", clock=None):
    t, box = started
    t.join(POOL_TIMEOUT_S)
    check("pool" in box, f"{phase} {tag}: the pool did not start: "
                         f"{box.get('error')}")
    pool = box["pool"]
    ready = [round(p.ready_s, 3) for p in pool.procs]
    print(f"[{phase}] {tag}: {len(pool.procs)} member processes "
          f"(pids {[p.pid for p in pool.procs]}) READY after {ready} s "
          f"from their spawn [{card}] "
          f"t+{(clock or _cross_t)():.1f} s")
    return pool


def _cross_straight(spec, pairs, device):
    """The burst straight through one scheduler here, on an engine of the
    members' spec (this process's tracer untouched: it streams the
    controller's spans).  Returns the engine and the requests."""
    from hetu_tpu_torch.serve import ContinuousBatchingScheduler, Request
    from hetu_tpu_torch.serve.crosshost import build_engine

    _, _, engine = build_engine(spec, device=device)
    sched = ContinuousBatchingScheduler(engine)
    reqs = [Request(prompt=list(p), max_tokens=m) for p, m in pairs]
    for r in reqs:
        sched.submit(r)
    while sched.has_work():
        sched.step()
    check(all(r.status == "ok" and len(r.tokens) == r.max_tokens
              for r in reqs), "crosshost: the straight run did not finish")
    return engine, reqs


def _cross_held_wave(pool, pairs, idx, slots, tag):
    """Hold each member of ``slots`` at its next decode round, submit
    ``pairs[i]`` for ``i`` in ``idx``, then move each hold one round on:
    every request submitted is admitted by the round the member parks at
    last, and no member ran ahead meanwhile.  Returns the requests once
    every member of ``slots`` that took one has parked there."""
    for s in slots:
        pool.hold_member(s)
    reqs = _cross_submit(pool, pairs, idx)
    for s in slots:
        pool.hold_member(s, after=1)
    for s in sorted({r.member for r in reqs} & set(slots)):
        check(pool.wait_held([s], timeout_s=POOL_TIMEOUT_S),
              f"crosshost {tag}: member {s} never parked")
    return reqs


def _cross_fault(pool, kind, slot, arg2=0.0):
    """A ``FaultInjector`` over the pool's member processes whose one
    event (step 1) hits member ``slot``: the injector indexes the live
    processes, so the event names the slot's place among them."""
    from hetu_tpu_torch.resilience import (
        FaultEvent, FaultInjector, FaultSchedule,
    )

    live = [p for p in pool.procs if p is not None and p.poll() is None]
    idx = live.index(pool.procs[slot])
    return FaultInjector(FaultSchedule([FaultEvent(1, kind, idx, arg2)]),
                         member_procs=pool.procs)


def _cross_submit(pool, pairs, idx):
    return [pool.submit(pairs[i][0], max_tokens=pairs[i][1],
                        timeout_s=POOL_TIMEOUT_S) for i in idx]


def _cross_done(reqs, tag):
    for r in reqs:
        check(r.done.wait(POOL_TIMEOUT_S), f"crosshost {tag}: request "
                                           f"{r.rid} never resolved")
    check(all(r.status == "ok" for r in reqs),
          f"crosshost {tag}: a response is not ok: "
          f"{[r.status for r in reqs]}")
    return [list(r.tokens) for r in reqs]


def _cross_exact(tag, got, ref):
    check(got == ref, f"crosshost {tag}: a stream differs from the burst "
                      f"straight through one scheduler")
    return len(got)


def _cross_value(dump, name):
    return (dump.get(name) or {}).get("value", 0)


def _cross_flash(tag, pool, device):
    """Hard: the flash forwards the members launched (their counters,
    scraped; a dead or drained member's last dump, retired incarnations
    folded in) are one a layer a prefill, and more than 0 on the card.
    Returns (launches, prefills)."""
    fleet = pool.fleet_metrics(timeout_s=POOL_TIMEOUT_S).dump()
    launches = int(_cross_value(fleet, "kernels.flash_fwd.launches"))
    prefills = int(_cross_value(fleet, "prefills"))
    expect = L * prefills if device == "cuda" else 0
    check(launches == expect and (launches > 0 or device != "cuda"),
          f"crosshost {tag}: {launches} flash forwards in the members, "
          f"not {expect} (one a layer for each of {prefills} prefills)")
    return launches, prefills


def _cross_no_jax(workdir, pool, tag):
    """Hard: every member process this pool ever spawned says ``jax=0`` on
    its READY line, and every dump says ``member.jax_loaded`` 0."""
    from pathlib import Path

    logs = sorted(Path(workdir).glob("member_*.log"))
    lines = [ln for p in logs for ln in p.read_text().splitlines()
             if ln.startswith("READY")]
    check(len(lines) == len(logs) > 0 and all("jax=0" in ln
                                               for ln in lines),
          f"crosshost {tag}: a member process loaded jax: {lines}")
    dumps = pool.member_metric_dumps
    check(all(_cross_value(d, "member.jax_loaded") == 0
              for d in dumps.values()),
          f"crosshost {tag}: a member reports jax loaded")
    return len(logs)


def _cross_peaks(pool):
    return {s: round(float(_cross_value(d, "member.peak_gib")), 3)
            for s, d in sorted(pool.member_metric_dumps.items())}


def _cross_final_dump(workdir, pid):
    """The last metrics black box a member process wrote to its stream
    (a clean exit writes one on close)."""
    from pathlib import Path

    from hetu_tpu_torch.telemetry import trace

    for path in Path(workdir).glob(f"member_s*_p{pid}.trace.jsonl"):
        dumps = [e["args"]["metrics"] for e in trace.load_jsonl(path)
                 if e.get("name") == "hetu_metrics"]
        if dumps:
            return dumps[-1]
    return {}


def _cross_pair(tag, merged, kind, card):
    """The fault instant of ``kind`` paired with its recovery span on the
    merged fleet timeline; prints and returns (detect ms, recover ms)."""
    from hetu_tpu_torch.telemetry import timeline

    pairs = [p for p in timeline.correlate(merged) if p.kind == kind]
    check(len(pairs) == 1 and pairs[0].paired and pairs[0].recovery_name
          in timeline.RECOVERY_FOR[kind],
          f"crosshost {tag}: fault.{kind} is not paired with a recovery "
          f"span: {pairs}")
    p = pairs[0]
    print(f"[crosshost] {tag}: fault.{kind} -> {p.recovery_name}: "
          f"detection {p.detect_s * 1e3:.3f} ms, recovery "
          f"{p.recover_s * 1e3:.3f} ms [{card}] "
          f"t+{_cross_t():.1f} s")
    return p.detect_s * 1e3, p.recover_s * 1e3


def _cross_f32(card, seed, device, workdir):
    """(a): the burst, the held drain, the held kill with failover and
    revive, the suspend; returns the numbers."""
    from hetu_tpu_torch.telemetry import fleet, trace

    out = {}
    spec = _cross_spec(seed, "float32", device)
    tracer = trace.open_process_stream(workdir, "controller")
    started = _cross_start(workdir, spec)
    pairs = burst(np.random.default_rng(seed), POOL_V, N_REQUESTS,
                  GPT_PROMPT, GPT_GEN)
    base, straight = _cross_straight(spec, pairs, device)
    ref = [r.tokens for r in straight]
    del base
    pool = _cross_join(started, "f32", card)
    try:
        out["ready_s"] = [p.ready_s for p in pool.procs]
        # the burst, one thread a request
        resps = [None] * len(pairs)

        def worker(i):
            resps[i] = pool.generate(pairs[i][0], max_tokens=pairs[i][1],
                                     timeout_s=POOL_TIMEOUT_S)

        ts = [threading.Thread(target=worker, args=(i,), daemon=True)
              for i in range(len(pairs))]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        _wait_in_threads(ts, "crosshost f32: a generate did not return")
        wall = time.perf_counter() - t0
        check(all(r["status"] == "ok" for r in resps),
              f"crosshost f32: a response is not ok: "
              f"{[r['status'] for r in resps]}")
        out["burst_exact"] = _cross_exact("f32 burst",
                                          [r["tokens"] for r in resps], ref)
        n_tok = sum(len(r["tokens"]) for r in resps)
        print(f"[crosshost] f32 burst: {len(pairs)} requests over "
              f"{CROSS_MEMBERS} member processes, every response ok, "
              f"{out['burst_exact']} of {len(pairs)} streams token-exact to "
              f"the straight run; {n_tok} tokens in {wall:.3f} s, "
              f"{n_tok / wall:.1f} tokens/s [{card}] "
              f"t+{_cross_t():.1f} s")
        out["burst_tokens_per_s"] = n_tok / wall

        # the drain: two requests a member, every member parked
        wave = list(range(CROSS_WAVE * CROSS_MEMBERS))
        reqs = _cross_held_wave(pool, pairs, wave, range(CROSS_MEMBERS),
                                "f32 drain")
        before = pool.scrape(timeout_s=POOL_TIMEOUT_S)
        src = max(range(CROSS_MEMBERS),
                  key=lambda s: pool._inflight.get(s, 0))
        src_pid = pool.procs[src].pid
        t0 = time.perf_counter()
        n = pool.drain_member(src, codec="none", close=True,
                              timeout_s=POOL_TIMEOUT_S)
        drain_wall = time.perf_counter() - t0
        d = pool.last_drain
        dst = d["target"]
        for s in range(CROSS_MEMBERS):
            if s not in (src, dst):
                pool.release_member(s)
        got = _cross_done(reqs, "f32 drain")
        _cross_exact("f32 drain", got, [ref[i] for i in wave])
        rc = pool.procs[src].wait(POOL_TIMEOUT_S)
        after = pool.scrape(timeout_s=POOL_TIMEOUT_S)
        # the target's prefill tokens: only those of a record that moved
        # without a slot (a submit still queued at the source), none for
        # a moved slot
        extra = int(_cross_value(after[dst], "prefill_tokens") -
                    _cross_value(before[dst], "prefill_tokens")) - sum(
            len(r.msg["prompt"]) for r in reqs if r.rid in d["queued"])
        check(n == d["requests"] == d["slots"] + len(d["queued"]) and
              d["slots"] >= 1, f"crosshost f32 drain: {d}")
        check(extra == 0, f"crosshost f32 drain: the target prefilled "
                          f"{extra} tokens for the moved slots")
        check(rc == 0, f"crosshost f32 drain: the drained process exited "
                       f"{rc}")
        check(pool.metrics.count("pool_failovers") == 0,
              "crosshost f32 drain: the lease grieved the drained member")
        wire = int(_cross_value(_cross_final_dump(workdir, src_pid),
                                "serve.migrate.bytes_wire"))
        mig_ms, _ = _span_ms(tracer.events, "serve.migrate")
        out.update(drain_slots=d["slots"], drain_wire_bytes=wire,
                   drain_ms=mig_ms, drain_wall_s=drain_wall,
                   drain_reprefill_tokens=extra, drained_rc=rc)
        print(f"[crosshost] f32 drain: member {src} drained into {dst} "
              f"while parked: {d['slots']} live slots moved ({n} "
              f"requests, {len(d['queued'])} of them queued), 0 prefill "
              f"tokens for the slots on the target; the "
              f"drained process exited {rc}; pool_failovers 0; "
              f"{len(reqs)} of {len(reqs)} streams token-exact; wire "
              f"{wire / 1e6:.3f} MB; serve.migrate {mig_ms:.3f} ms "
              f"[{card}] t+{_cross_t():.1f} s")

        # the kill: the two members left, parked with two requests each
        live = [s for s in range(CROSS_MEMBERS) if s != src]
        wave = list(range(len(wave), len(wave) + CROSS_WAVE * len(live)))
        reqs = _cross_held_wave(pool, pairs, wave, live, "f32 kill")
        pool.scrape(timeout_s=POOL_TIMEOUT_S)  # the victim's last dump
        victim = max(live, key=lambda s: pool._inflight.get(s, 0))
        inj = _cross_fault(pool, "member_kill", victim)
        inj.on_step(1)
        check(pool.procs[victim].poll() is not None,
              f"crosshost f32 kill: member {victim} was not killed")
        for s in live:
            if s != victim:
                pool.release_member(s)
        _until(lambda: pool.metrics.count("pool_failovers") >= 1,
               "crosshost f32 kill: the killed member never failed over",
               CROSS_WAIT_S)
        check(pool.svc.state_of(victim).state == "lost",
              f"crosshost f32 kill: member {victim} is "
              f"{pool.svc.state_of(victim).state}, not lost")
        # a fresh process comes up on the killed member's slot while the
        # failed-over streams finish and the survivor is suspended
        revive = threading.Thread(target=pool.revive_member, args=(victim,),
                                  daemon=True)
        revive.start()
        got = _cross_done(reqs, "f32 kill")
        _cross_exact("f32 kill", got, [ref[i] for i in wave])
        moved = pool.metrics.count("requests_failed_over")
        out.update(failovers=pool.metrics.count("pool_failovers"),
                   requests_failed_over=moved)
        print(f"[crosshost] f32 kill: member {victim} SIGKILLed while "
              f"parked, suspect -> lost, 1 failover ({moved} requests "
              f"re-prefilled on the survivor), {len(reqs)} of {len(reqs)} "
              f"streams token-exact [{card}] "
              f"t+{_cross_t():.1f} s")

        # the suspend of the survivor (shorter than lease + grace)
        survivor = next(s for s in live if s != victim)
        inc = pool.svc.state_of(survivor).incarnation
        pool.svc.lease_s, pool.svc.suspect_grace_s, sus_s = CROSS_SUSPEND
        counts = {k: pool.metrics.count(k) for k in (
            "members_suspected", "members_suspect_cleared",
            "pool_failovers")}
        wave = list(range(2, 2 + CROSS_WAVE * len(live)))
        reqs = _cross_held_wave(pool, pairs, wave, [survivor],
                                "f32 suspend")
        _cross_fault(pool, "member_suspend", survivor, sus_s).on_step(1)
        _until(lambda: pool.metrics.count("members_suspect_cleared") >
               counts["members_suspect_cleared"],
               "crosshost f32 suspend: the member was never suspected "
               "and cleared", CROSS_WAIT_S)
        pool.release_member(survivor)
        got = _cross_done(reqs, "f32 suspend")
        _cross_exact("f32 suspend", got, [ref[i] for i in wave])
        delta = {k: pool.metrics.count(k) - v for k, v in counts.items()}
        # the same process throughout: suspected and cleared, never lost
        # and rejoined under a new incarnation
        delta["same_incarnation"] = \
            pool.svc.state_of(survivor).incarnation == inc
        check(delta == {"members_suspected": 1, "members_suspect_cleared": 1,
                        "pool_failovers": 0, "same_incarnation": True},
              f"crosshost f32 suspend: {delta}")
        print(f"[crosshost] f32 suspend: member {survivor} SIGSTOPped "
              f"{sus_s} s (lease {CROSS_SUSPEND[0]} s + grace "
              f"{CROSS_SUSPEND[1]} s): suspected 1, cleared 1, failovers "
              f"0, the same incarnation; {len(reqs)} of {len(reqs)} "
              f"streams token-exact [{card}] "
              f"t+{_cross_t():.1f} s")
        revive.join(POOL_TIMEOUT_S)
        check(not revive.is_alive() and pool.procs[victim].poll() is None
              and pool.svc.state_of(victim).state == "alive",
              f"crosshost f32 revive: member {victim} did not come back")
        pool.svc.lease_s, pool.svc.suspect_grace_s = (CROSS_LEASE_S,
                                                      CROSS_GRACE_S)
        # two submits in a row: the fresh process (least loaded, its
        # link unpriced) takes at least the first
        fresh = _cross_submit(pool, pairs, [0, 1])
        check(victim in {r.member for r in fresh},
              f"crosshost f32 revive: the revived member took no request "
              f"({[r.member for r in fresh]})")
        _cross_exact("f32 revive", _cross_done(fresh, "f32 revive"),
                     [ref[0], ref[1]])
        out["revive_ready_s"] = pool.procs[victim].ready_s
        print(f"[crosshost] f32 revive: a fresh process on member "
              f"{victim}'s slot READY after {out['revive_ready_s']:.3f} s "
              f"took a new request token-exact [{card}] "
              f"t+{_cross_t():.1f} s")
        out["suspend"] = delta
        out["launches"], out["prefills"] = _cross_flash("f32", pool, device)
        out["peak_gib"] = _cross_peaks(pool)
        out["members_spawned"] = _cross_no_jax(workdir, pool, "f32")
    finally:
        pool.close()
        trace.disable()
    merged, _ = fleet.merge_streams(workdir)
    out["kill_ms"] = _cross_pair("f32 kill", merged, "member_kill", card)
    out["suspend_ms"] = _cross_pair("f32 suspend", merged, "member_suspend",
                                    card)
    return out


def _cross_chaos_schedule():
    """The seeded schedule of the reference's member chaos test at three
    members: the first seed whose suspend comes before its kill, on
    another member; its bytes checked stable."""
    from hetu_tpu_torch.resilience import FaultSchedule

    kw = dict(steps=6, member_suspends=1, member_kills=1,
              member_suspend_s=CROSS_SUSPEND[2], n_members=CROSS_MEMBERS)

    def ok(sc):
        ev = {e.kind: e for e in sc.events}
        return (len(sc) == 2 and ev["member_suspend"].step <
                ev["member_kill"].step and
                int(ev["member_suspend"].arg) % CROSS_MEMBERS !=
                int(ev["member_kill"].arg) % CROSS_MEMBERS)

    seed, sched = next((s, sc) for s, sc in (
        (s, FaultSchedule.generate(seed=s, **kw)) for s in range(1, 256))
        if ok(sc))
    again = FaultSchedule.generate(seed=seed, **kw).to_json()
    check(sched.to_json() == again == FaultSchedule.from_json(
        again).to_json(), "crosshost chaos: the schedule's bytes are not "
                          "stable")
    return seed, sched


def _cross_bf16(card, seed, device, workdir):
    """(b): the seeded member suspend and kill under the burst, in bf16;
    returns the numbers."""
    from types import SimpleNamespace

    from hetu_tpu_torch.resilience import FaultInjector
    from hetu_tpu_torch.telemetry import fleet, trace

    out = {}
    spec = _cross_spec(seed, "bfloat16", device)
    c_seed, sched = _cross_chaos_schedule()
    ev = {e.kind: e for e in sched.events}
    print(f"[crosshost] bf16 chaos: schedule seed {c_seed}, id "
          f"{sched.schedule_id}: {sched.to_json()}")
    trace.open_process_stream(workdir, "controller")
    started = _cross_start(workdir, spec)
    pairs = burst(np.random.default_rng(seed), POOL_V, N_REQUESTS,
                  GPT_PROMPT, GPT_GEN)
    engine, straight = _cross_straight(spec, pairs, device)
    ref_run = {"requests": straight}
    pool = _cross_join(started, "bf16", card)
    try:
        out["ready_s"] = [p.ready_s for p in pool.procs]
        inj = FaultInjector(sched, member_procs=pool.procs)
        half = len(pairs) // 2
        # the suspend, at a parked round of its member
        pool.svc.lease_s, pool.svc.suspect_grace_s, _ = CROSS_SUSPEND
        s_victim = int(ev["member_suspend"].arg) % CROSS_MEMBERS
        cleared = pool.metrics.count("members_suspect_cleared")
        first = _cross_held_wave(pool, pairs, range(half), [s_victim],
                                 "bf16 suspend")
        inj.on_step(ev["member_suspend"].step)
        _until(lambda: pool.metrics.count("members_suspect_cleared") >
               cleared, "crosshost bf16: the suspended member was never "
                        "suspected and cleared", CROSS_WAIT_S)
        pool.release_member(s_victim)
        got = _cross_done(first, "bf16 suspend")
        # the kill, at a parked round of its member
        pool.svc.lease_s, pool.svc.suspect_grace_s = (CROSS_LEASE_S,
                                                      CROSS_GRACE_S)
        k_victim = int(ev["member_kill"].arg) % CROSS_MEMBERS
        second = _cross_held_wave(pool, pairs, range(half, len(pairs)),
                                  [k_victim], "bf16 kill")
        pool.scrape(timeout_s=POOL_TIMEOUT_S)  # the victim's last dump
        inj.on_step(ev["member_kill"].step)
        check(inj.counters["member_procs_killed"] == 1,
              "crosshost bf16: the kill did not land")
        _until(lambda: pool.metrics.count("pool_failovers") >= 1,
               "crosshost bf16: the killed member never failed over",
               CROSS_WAIT_S)
        got += _cross_done(second, "bf16 kill")
        check(pool.metrics.count("members_suspect_cleared") == 1 and
              pool.metrics.count("pool_failovers") == 1 and
              pool.metrics.count("members_rejoined") == 0,
              "crosshost bf16: the suspend was grieved or the kill not "
              "failed over once")
        out["requests_failed_over"] = pool.metrics.count(
            "requests_failed_over")
        out["launches"], out["prefills"] = _cross_flash("bf16", pool,
                                                        device)
        out["peak_gib"] = _cross_peaks(pool)
        out["members_spawned"] = _cross_no_jax(workdir, pool, "bf16")
    finally:
        pool.close()
        trace.disable()
    model = engine.model
    _set_attention_impl(model, "xla")
    try:
        shares = _hold_streams(
            "bf16 chaos", ref_run,
            {"requests": [SimpleNamespace(prompt=pairs[i][0], tokens=t)
                          for i, t in enumerate(got)]},
            _plain_logits(model, device), TOL_LOGITS, phase="crosshost")
    finally:
        _set_attention_impl(model, "flash")
    del engine, model
    out.update(exact=len(got) - len(shares), near_ties=len(shares),
               seed=c_seed, schedule_id=sched.schedule_id)
    merged, procs = fleet.merge_streams(workdir)
    out["streams"] = len(procs)
    out["suspend_ms"] = _cross_pair("bf16 chaos", merged, "member_suspend",
                                    card)
    out["kill_ms"] = _cross_pair("bf16 chaos", merged, "member_kill", card)
    print(f"[crosshost] bf16 chaos: {len(got)} requests over "
          f"{CROSS_MEMBERS} member processes, every response ok, "
          f"{out['exact']} token-exact ({len(shares)} parted at a near "
          f"tie); suspend cleared, kill failed over "
          f"({out['requests_failed_over']} requests re-prefilled); "
          f"{len(procs)} process streams merged [{card}] "
          f"t+{_cross_t():.1f} s")
    return out


def _cross_evidence(workdir):
    """On a failure: the controller's membership and routing instants and
    the tail of each member's log, before the workdir goes."""
    from pathlib import Path

    from hetu_tpu_torch.telemetry import trace

    for path in sorted(Path(workdir).glob("controller.trace.jsonl")):
        for e in trace.load_jsonl(path):
            if e.get("name", "").startswith(("membership.", "route.",
                                             "fault.")):
                print(f"[crosshost] evidence: {e['name']} "
                      f"{json.dumps(e.get('args', {}))[:300]}")
    for path in sorted(Path(workdir).glob("member_*.log")):
        tail = path.read_text(errors="replace").splitlines()[-12:]
        print(f"[crosshost] evidence: {path.name}: " + " | ".join(tail))


def phase_crosshost(card, seed, device="cuda"):
    """The cross-process serving pool (serve/crosshost.py) over GPT-2-small
    member processes at its published widths: (a) f32, the burst, the
    held drain, the held kill with failover and revive, the suspend; (b)
    bf16, the seeded member chaos run.  Returns the numbers; ``launches``
    sums the members' flash forwards over both."""
    import tempfile

    t_phase = _CROSS_T0[0] = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="crosshost_") as root:
        for tag, fn in (("f32", _cross_f32), ("bf16", _cross_bf16)):
            workdir = os.path.join(root, tag)
            os.makedirs(workdir)
            try:
                out[tag] = fn(card, seed, device, workdir)
            except Exception:
                _cross_evidence(workdir)
                raise
            print(f"[crosshost] {tag}: pool closed, streams merged "
                  f"t+{_cross_t():.1f} s")
    out["launches"] = out["f32"]["launches"] + out["bf16"]["launches"]
    out["prefills"] = out["f32"]["prefills"] + out["bf16"]["prefills"]
    out["seconds"] = time.perf_counter() - t_phase
    for tag in ("f32", "bf16"):
        print(f"[crosshost] {tag}: peak GiB by member {out[tag]['peak_gib']}"
              f" [{card}]")
    print(f"[crosshost] phase {out['seconds']:.1f} s; {out['prefills']} "
          f"prefills in the members, flash forwards launched "
          f"{out['launches']} [{card}]")
    return out


_VAN_T0 = [0.0]


def _van_t():
    """Seconds since the vanchaos phase began, printed on its lines."""
    return time.perf_counter() - _VAN_T0[0]


def _van_pair(workdir, tag, **extra):
    """Two van server processes and the ``ReplicaSpec`` dict over them;
    returns (processes, spec, each one's spawn -> READY seconds).  Hard:
    neither loads jax (nor torch: the van's import path is torch-free)."""
    from hetu_tpu_torch.ps.membership import fresh_table_id
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )

    procs, ready = [], []
    for i in range(2):
        t0 = time.perf_counter()
        procs.append(spawn_shard_server(workdir, free_port(), f"{tag}{i}"))
        ready.append(time.perf_counter() - t0)
        check(procs[-1].ready[1:] == ["jax=0", "torch=0"],
              f"vanchaos: a van process loaded {procs[-1].ready[1:]}")
    spec = {"endpoints": [["127.0.0.1", int(p.ready[0])] for p in procs],
            "epoch_table": fresh_table_id(), **VAN_SPEC, **extra}
    return procs, spec, ready


def _van_reap(procs):
    for p in procs:
        if p is not None and p.poll() is None:
            try:
                p.send_signal(signal.SIGCONT)
            except OSError:
                pass
            p.kill()
            p.wait()


def _van_member_dumps(workdir):
    """The last metrics black box of every member process whose stream is
    in ``workdir`` (a clean exit writes one on close)."""
    from pathlib import Path

    from hetu_tpu_torch.telemetry import trace

    out = {}
    for path in sorted(Path(workdir).glob("member_s*_p*.trace.jsonl")):
        dumps = [e["args"]["metrics"] for e in trace.load_jsonl(path)
                 if e.get("name") == "hetu_metrics"]
        if dumps:
            out[path.name.split(".")[0]] = dumps[-1]
    return out


def _van_members(tag, workdir, n, device):
    """Hard: every member process of ``workdir`` said ``jax=0`` at READY
    and in its last dump, and their flash forwards are one a layer a
    prefill (more than 0 on the card).  Returns (launches, prefills,
    peak GiB by member)."""
    from pathlib import Path

    dumps = _van_member_dumps(workdir)
    logs = sorted(Path(workdir).glob("member_*.log"))
    ready = [ln for p in logs for ln in p.read_text().splitlines()
             if ln.startswith("READY")]
    check(len(dumps) == len(logs) == len(ready) == n and
          all("jax=0" in ln for ln in ready) and
          all(_cross_value(d, "member.jax_loaded") == 0
              for d in dumps.values()),
          f"vanchaos {tag}: {len(dumps)} member dumps, {len(logs)} logs, "
          f"READY lines {ready}")
    launches = sum(int(_cross_value(d, "kernels.flash_fwd.launches"))
                   for d in dumps.values())
    prefills = sum(int(_cross_value(d, "prefills")) for d in dumps.values())
    expect = L * prefills if device == "cuda" else 0
    check(launches == expect and (launches > 0 or device != "cuda"),
          f"vanchaos {tag}: {launches} flash forwards in the members, "
          f"not {expect} (one a layer for each of {prefills} prefills)")
    peaks = {k: round(float(_cross_value(d, "member.peak_gib")), 3)
             for k, d in dumps.items()}
    return launches, prefills, peaks


def _van_pair_equal(replica, tag, names=None, evidence=None):
    """Hard: every table this process opened over the pair holds bitwise
    equal rows and optimizer slots on the primary and the backup.  Beats
    land every few tens of ms, now and then between the two reads: each
    table is read again until both vans agree, within VAN_EQUAL_WAIT_S.  On a
    failure the message names the table (``names``: id -> role), the rows
    that differ and their two values, and ``evidence()``'s text.  Returns
    (tables, reads)."""
    from hetu_tpu_torch.ps.van import RemotePSTable

    def snapshot(t, idx):
        h = RemotePSTable(*replica.endpoints[idx], t.rows, t.dim,
                          table_id=t.id, create=False)
        try:
            return (h.dense_pull(), *h.slots_get(np.arange(t.rows)))
        finally:
            h.close()

    tables = [t for t in list(replica._tables) if t.replicate]
    reads = 0
    for t in tables:
        deadline = time.monotonic() + VAN_EQUAL_WAIT_S
        while True:
            reads += 1
            b = snapshot(t, replica.backup_idx)
            p = snapshot(t, replica.primary_idx)
            if all(x.tobytes() == y.tobytes() for x, y in zip(b, p)):
                break
            if time.monotonic() >= deadline:
                rows = np.where(~np.all(b[0] == p[0], axis=1))[0]
                slots = [k for k in range(1, 4)
                         if b[k].tobytes() != p[k].tobytes()]
                check(False, f"vanchaos {tag}: table {t.id:#x} "
                             f"({(names or {}).get(t.id, '?')}) differs "
                             f"between the promoted primary "
                             f"{replica.primary} and the new backup "
                             f"{replica.endpoints[replica.backup_idx]}: "
                             f"rows {rows.tolist()[:16]} (backup "
                             f"{b[0][rows[:2]].tolist()}, primary "
                             f"{p[0][rows[:2]].tolist()}), slots {slots}; "
                             f"{evidence() if evidence else ''}")
            time.sleep(0.005)
    return len(tables), reads


def _thread_states(pid):
    """The state letter of each thread of process ``pid`` (none when it is
    gone)."""
    import glob

    try:
        return [open(path).read().rsplit(")", 1)[1].split()[0]
                for path in glob.glob(f"/proc/{int(pid)}/task/*/stat")]
    except OSError:
        return []


def _stopped(pid):
    """Whether every thread of process ``pid`` is stopped (state T): a
    SIGSTOP is delivered asynchronously, and a van thread can still answer
    a request after ``kill`` returns."""
    states = _thread_states(pid)
    return bool(states) and all(st == "T" for st in states)


def _van_standby_start(workdir, seed, device):
    """(c)'s fleet, started first so that its member processes come up
    while (a) and (b) run: a van pair and a controller process of
    VAN_MEMBERS bf16 members streaming seeded requests."""
    from hetu_tpu_torch.resilience.shardproc import spawn_module

    vans, spec, ready = _van_pair(workdir, "c")
    cfg = {"workdir": workdir, "port": int(vans[0].ready[0]),
           "n_members": VAN_MEMBERS,
           "model": _cross_spec(seed, "bfloat16", device),
           "n_requests": VAN_CTRL_REQUESTS, "prompt_seed": seed,
           "max_tokens": VAN_CTRL_TOKENS, "submit_gap_s": VAN_CTRL_GAP_S,
           "hold_s": 600.0, "lease_s": CROSS_LEASE_S,
           "suspect_grace_s": CROSS_GRACE_S,
           "request_timeout_s": POOL_TIMEOUT_S, "van": spec,
           "member_env": {"OMP_NUM_THREADS": "1"} if device == "cpu"
           else None}
    path = os.path.join(workdir, "controller.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    ctrl = spawn_module(workdir, "controller",
                        "hetu_tpu_torch.serve.crosshost",
                        ["--controller", path], timeout_s=POOL_TIMEOUT_S,
                        wait=False)
    return {"vans": vans, "ctrl": ctrl, "van_ready_s": ready}


def _van_round(pool, r, pairs, ref, fire, rnd, tracer, card):
    """One held round of (a): both members parked at a decode round with
    the burst in flight, ``fire()`` SIGKILLs the primary van, the backup
    is promoted, the pool rebinds and re-sends, then the members go on.
    Hard: incarnation ``rnd + 1``, every response ok and token-exact.
    Returns the round's numbers."""
    for s in range(VAN_MEMBERS):
        pool.hold_member(s)
    reqs = _cross_submit(pool, pairs, range(len(pairs)))
    for s in range(VAN_MEMBERS):
        pool.hold_member(s, after=1)
    for s in sorted({q.member for q in reqs}):
        check(pool.wait_held([s], timeout_s=POOL_TIMEOUT_S),
              f"vanchaos f32 round {rnd}: member {s} never parked")
    resent0 = pool.metrics.count("van_rebind_resent")
    victim = r.primary[1]
    t0 = time.perf_counter()
    fire()
    _until(lambda: r.incarnation == rnd + 1,
           f"vanchaos f32 round {rnd}: the backup was never promoted",
           CROSS_WAIT_S)
    promoted_s = time.perf_counter() - t0
    _until(lambda: pool.metrics.count("van_rebinds") >= rnd,
           f"vanchaos f32 round {rnd}: the pool never rebound",
           CROSS_WAIT_S)
    for s in range(VAN_MEMBERS):
        pool.release_member(s)
    got = _cross_done(reqs, f"vanchaos f32 round {rnd}")
    _cross_exact(f"vanchaos f32 round {rnd}", got, ref)
    check(r.primary_idx == rnd % 2 and r.primary[1] != victim,
          f"vanchaos f32 round {rnd}: primary {r.primary} after killing "
          f"port {victim}")
    rebinds = [e for e in tracer.events if e.get("name") ==
               "ctrl.van_rebind" and e.get("ph") == "X"]
    out = {"incarnation": r.incarnation, "exact": len(got),
           "promoted_host_ms": promoted_s * 1e3,
           "rebind_ms": rebinds[-1]["dur"] / 1e3 if rebinds else None,
           "resent": pool.metrics.count("van_rebind_resent") - resent0}
    # the automatic resilver: a fresh backup, the pair redundant again.
    # The resilver clears `degraded` before it records its span, so wait
    # for both: reading the spans at once races the span's write
    def resilvers():
        return [e for e in tracer.events if e.get("name") == "van.resilver"
                and e.get("ph") == "X" and e.get("args", {}).get("ok")]

    _until(lambda: not r.degraded and len(resilvers()) >= rnd,
           f"vanchaos f32 round {rnd}: the pair was never re-silvered",
           CROSS_WAIT_S)
    check(r.export_lag() == 0, f"vanchaos f32 round {rnd}: replication "
                               f"lag after the resilver")
    spans = resilvers()
    check(len(spans) >= rnd, f"vanchaos f32 round {rnd}: no resilver "
                             f"returned True")
    tables = [t for t in list(r._tables) if t.replicate]
    out["resilver_s"] = spans[-1]["dur"] / 1e6
    out["resilver_rows"] = int(spans[-1]["args"]["rows_copied"])
    # rows, both optimizer slots and the step counter of every row
    out["resilver_bytes"] = sum(t.rows * (3 * t.dim * 4 + 8)
                                for t in tables)
    names = {pool._bb.id: "blackboard", pool._ledger._table.id: "ledger"}

    def evidence():
        dump = pool.fleet_metrics(timeout_s=CROSS_WAIT_S).dump()
        return json.dumps({k: v.get("value") for k, v in sorted(
            dump.items()) if "van.replica" in k or "van.resilver" in k})
    out["tables_equal"], out["reads"] = _van_pair_equal(
        r, f"f32 round {rnd}", names, evidence)
    print(f"[vanchaos] f32 round {rnd}: {len(pairs)} requests over "
          f"{VAN_MEMBERS} member processes parked mid-decode, van {victim} "
          f"SIGKILLed; backup promoted to incarnation {r.incarnation} "
          f"(seen here {out['promoted_host_ms']:.3f} ms after the kill); "
          f"rebind {out['rebind_ms']:.3f} ms, {out['resent']} submits "
          f"re-sent; every response ok, {len(got)} of {len(got)} streams "
          f"token-exact; resilver {out['resilver_s']:.3f} s, "
          f"{out['resilver_rows']} rows, {out['resilver_bytes']} bytes; "
          f"{out['tables_equal']} tables bitwise equal on both vans "
          f"({out['reads']} reads) [{card}] t+{_van_t():.1f} s")
    return out


def _van_f32(card, seed, device, workdir):
    """(a): the pool over a replicated pair with an automatic resilver,
    two held van kills; returns the numbers."""
    from hetu_tpu_torch.resilience import (
        FaultEvent, FaultInjector, FaultSchedule,
    )
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )
    from hetu_tpu_torch.serve.crosshost import CrossProcessServingPool
    from hetu_tpu_torch.telemetry import fleet, timeline, trace

    out = {}
    vans, spec, out["van_ready_s"] = _van_pair(workdir, "a")
    procs = list(vans)
    by_port = {int(v.ready[0]): v for v in vans}
    out["resilver_van_ready_s"] = []

    def fresh_backup(_replica):
        port = free_port()
        t0 = time.perf_counter()
        proc = spawn_shard_server(workdir, port, f"r{port}")
        out["resilver_van_ready_s"].append(time.perf_counter() - t0)
        procs.append(proc)
        by_port[port] = proc
        return ("127.0.0.1", port)

    model = _cross_spec(seed, "float32", device)
    tracer = trace.open_process_stream(workdir, "controller")
    box = {}

    def make():
        try:
            box["pool"] = CrossProcessServingPool(
                VAN_MEMBERS, workdir=workdir, model=model, own_van=False,
                port=int(vans[0].ready[0]), van_spec=spec,
                van_backup_factory=fresh_backup, lease_s=CROSS_LEASE_S,
                suspect_grace_s=CROSS_GRACE_S,
                request_timeout_s=POOL_TIMEOUT_S, scrape_s=0.0,
                spawn_timeout_s=POOL_TIMEOUT_S,
                member_env={"OMP_NUM_THREADS": "1"}
                if device == "cpu" else None)
        except Exception as e:  # reported below
            box["error"] = repr(e)

    maker = threading.Thread(target=make, daemon=True)
    maker.start()
    pairs = burst(np.random.default_rng(seed), POOL_V, N_REQUESTS,
                  GPT_PROMPT, GPT_GEN)
    base, straight = _cross_straight(model, pairs, device)
    ref = [q.tokens for q in straight]
    del base
    maker.join(POOL_TIMEOUT_S)
    check("pool" in box, f"vanchaos f32: the pool did not start: "
                         f"{box.get('error')}")
    pool = box["pool"]
    try:
        out["member_ready_s"] = [p.ready_s for p in pool.procs]
        r = pool._replica
        check((r.incarnation, r.primary_idx) == (1, 0),
              f"vanchaos f32: bootstrap at {r.incarnation}, {r.primary_idx}")
        print(f"[vanchaos] f32: van pair READY after "
              f"{[round(x, 3) for x in out['van_ready_s']]} s (jax=0, "
              f"torch=0), {VAN_MEMBERS} member processes READY after "
              f"{[round(x, 3) for x in out['member_ready_s']]} s [{card}] "
              f"t+{_van_t():.1f} s")
        # the seeded van kill of the reference's chaos test, fired at its
        # step while the members are parked
        sched = FaultSchedule.generate(steps=len(pairs), seed=5,
                                       van_kills=1, n_vans=1)
        check([e.kind for e in sched.events] == ["van_kill"],
              f"vanchaos f32: schedule {sched.to_json()}")

        def fire(schedule):
            def go():
                victim = by_port[r.primary[1]]
                inj = FaultInjector(schedule, van_procs=[victim])
                for step in range(1, schedule.events[0].step + 1):
                    inj.on_step(step)
                check(inj.counters["van_procs_killed"] == 1 and
                      victim.poll() is not None,
                      "vanchaos f32: the van kill did not land")
            return go

        out["rounds"] = [
            _van_round(pool, r, pairs, ref, fire(sched), 1, tracer, card),
            _van_round(pool, r, pairs, ref, fire(FaultSchedule(
                [FaultEvent(1, "van_kill", 0.0)])), 2, tracer, card)]
    finally:
        pool.close()
        trace.disable()
        _van_reap(procs)
    out["launches"], out["prefills"], out["peak_gib"] = _van_members(
        "f32", workdir, VAN_MEMBERS, device)
    merged, _ = fleet.merge_streams(workdir)
    kills = [p for p in timeline.correlate(merged) if p.kind == "van_kill"]
    check(len(kills) == 2 and all(p.paired and p.recovery_name ==
                                  "van.promote" for p in kills),
          f"vanchaos f32: fault.van_kill not paired with van.promote: "
          f"{kills}")
    out["kill_ms"] = [(p.detect_s * 1e3, p.recover_s * 1e3) for p in kills]
    for i, (det, rec) in enumerate(out["kill_ms"]):
        print(f"[vanchaos] f32 round {i + 1}: fault.van_kill -> "
              f"van.promote: detection {det:.3f} ms, recovery {rec:.3f} ms "
              f"on the merged fleet timeline [{card}] t+{_van_t():.1f} s")
    return out


def _van_fence(card, workdir):
    """(b): a SIGSTOPped primary at the table layer: a write promotes the
    backup; after SIGCONT a stale handle idle through the outage raises
    ``VanFenced``, and its retry lands on the backup."""
    from hetu_tpu_torch.ps import membership as mb
    from hetu_tpu_torch.ps import replica as rep
    from hetu_tpu_torch.ps.van import RemotePSTable
    from hetu_tpu_torch.resilience import (
        FaultEvent, FaultInjector, FaultSchedule,
    )
    from hetu_tpu_torch.telemetry import timeline, trace

    out = {}
    vans, spec, _ = _van_pair(workdir, "b", rcv_timeout_s=VAN_FENCE_RCV_S)
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        rspec = rep.ReplicaSpec.from_dict(spec)
        r1 = rep.VanReplica(rspec)
        r1.bootstrap()
        tid = mb.fresh_table_id()
        t = r1.table(4, 8, table_id=tid, create=True, sync=True,
                     init="zeros", optimizer="sgd", lr=0.0)
        row = np.arange(8, dtype=np.float32).reshape(1, -1)
        t.sparse_set([0], row)
        # an independent view bound to the old primary, idle throughout
        r2 = rep.VanReplica(rspec)
        r2.incarnation, r2.primary_idx = 1, 0
        t2 = r2.table(4, 8, table_id=tid, create=False, sync=True)
        # stopped "for good": the phase resumes it once promoted
        FaultInjector(FaultSchedule([FaultEvent(1, "van_suspend", 0.0,
                                                3600.0)]),
                      van_procs=[vans[0]]).on_step(1)
        t0 = time.perf_counter()
        try:
            _until(lambda: _stopped(vans[0].pid),
                   "vanchaos fence: the primary never stopped", CROSS_WAIT_S)
        except SmokeFailure as e:  # name what the process was doing
            raise SmokeFailure(f"{e}: thread states "
                               f"{_thread_states(vans[0].pid)}, exit code "
                               f"{vans[0].poll()}") from e
        deadline = time.monotonic() + CROSS_WAIT_S
        while True:
            try:
                t.sparse_set([1], row * 3)
                break
            except (ConnectionError, TimeoutError, RuntimeError):
                check(time.monotonic() < deadline,
                      "vanchaos fence: a write never promoted the backup")
                time.sleep(0.01)
        out["promoted_host_ms"] = (time.perf_counter() - t0) * 1e3
        check((r1.incarnation, r1.primary_idx) == (2, 1),
              f"vanchaos fence: incarnation {r1.incarnation}")
        vans[0].send_signal(signal.SIGCONT)
        print(f"[vanchaos] fence: promoted past the stopped primary, "
              f"resumed it [{card}] t+{_van_t():.1f} s", flush=True)

        seen = []

        def fenced():
            # the resumed van may take a while to answer (its backlog of
            # the stop): a read that times out is "not yet"
            try:
                h = RemotePSTable("127.0.0.1", int(vans[0].ready[0]), 1,
                                  rep.EPOCH_DIM, table_id=rspec.epoch_table,
                                  create=False, connect_timeout_s=1.0,
                                  rcv_timeout_s=1.0, reconnect=False)
            except ConnectionError as e:
                seen.append(repr(e))
                return False
            try:
                got = h.sparse_pull([0])[0]
                seen.append(got[:4].tolist())
                return int(got[rep.E_INC]) >= 2
            except RuntimeError as e:
                seen.append(repr(e))
                return False
            finally:
                h.close()

        def evidence():
            pid = vans[0].pid
            try:
                with open(f"/proc/{pid}/status") as f:
                    state = [ln.strip() for ln in f
                             if ln.startswith(("State", "Threads"))]
                fds = len(os.listdir(f"/proc/{pid}/fd"))
            except OSError as e:
                state, fds = repr(e), -1
            return (f"the old primary: rc {vans[0].poll()}, {state}, {fds} "
                    f"fds; reads {seen[:3]} ... {seen[-3:]} ({len(seen)}); "
                    f"r1 incarnation {r1.incarnation}, endpoints "
                    f"{r1.endpoints}; this process {len(os.listdir('/proc/self/fd'))}"
                    f" fds, {threading.active_count()} threads")
        deadline = time.monotonic() + CROSS_WAIT_S
        while not fenced():
            check(time.monotonic() < deadline, "vanchaos fence: the resumed "
                  f"primary was never fenced: {evidence()}")
            time.sleep(0.05)
        try:
            t2.sparse_set([2], row * 9)
            check(False, "vanchaos fence: a stale handle wrote to the "
                         "resumed old primary")
        except rep.VanFenced:
            pass
        check(r2.primary_idx == 1, "vanchaos fence: the stale view was "
                                   "not re-targeted")
        t2.sparse_set([2], row * 9)
        check(t.sparse_pull([2])[0].tobytes() == (row[0] * 9).tobytes(),
              "vanchaos fence: the retried write is not on the backup")
        for h in (t, t2):
            h.close()
    finally:
        trace.disable()
        _van_reap(vans)
    stops = [p for p in timeline.correlate(tracer.events)
             if p.kind == "van_suspend"]
    check(len(stops) == 1 and stops[0].paired and
          stops[0].recovery_name == "van.promote",
          f"vanchaos fence: fault.van_suspend not paired: {stops}")
    out["stop_ms"] = (stops[0].detect_s * 1e3, stops[0].recover_s * 1e3)
    print(f"[vanchaos] fence: primary SIGSTOPped, a write promoted the "
          f"backup ({out['promoted_host_ms']:.3f} ms on the host clock; "
          f"fault.van_suspend -> van.promote: detection "
          f"{out['stop_ms'][0]:.3f} ms, recovery {out['stop_ms'][1]:.3f} "
          f"ms); after SIGCONT the stale handle raised VanFenced and its "
          f"retry landed on the backup [{card}] t+{_van_t():.1f} s")
    return out


def _van_logs(workdir, tag):
    """On a failure: the tail of every log in the part's workdir but the
    members' (``_cross_evidence`` prints those): the controller's, the
    standby's, the vans'."""
    from pathlib import Path

    for path in sorted(p for p in Path(workdir).glob("*.log")
                       if not p.name.startswith("member_")):
        tail = path.read_text(errors="replace").splitlines()[-15:]
        print(f"[vanchaos] {tag} evidence: {path.name}: " + " | ".join(tail))


def _van_standby(card, device, workdir, fleet_c):
    """(c): SIGKILL the controller process after VAN_ACCEPTS accepts, a
    standby process watching; returns the numbers."""
    from pathlib import Path

    from hetu_tpu_torch.resilience.shardproc import spawn_module, wait_ready

    out = {"van_ready_s": fleet_c["van_ready_s"]}
    ctrl = fleet_c["ctrl"]
    wait_ready(ctrl, "controller", POOL_TIMEOUT_S)
    log_of = lambda p: Path(p.log_path).read_text(errors="replace")  # noqa
    _until(lambda: log_of(ctrl).count("ACCEPTED") >= VAN_ACCEPTS,
           "vanchaos standby: the controller accepted too few requests",
           CROSS_WAIT_S)
    path = os.path.join(workdir, "standby.json")
    with open(path, "w") as f:
        json.dump({"workdir": workdir, "port": int(
            fleet_c["vans"][0].ready[0]), "plane": "serving",
            "lease_bound_s": VAN_LEASE_BOUND_S, "poll_s": 0.05,
            "hold_s": 0.0, "resolve_timeout_s": CROSS_WAIT_S,
            "watch_timeout_s": CROSS_WAIT_S,
            "takeover_kwargs": {"lease_s": CROSS_LEASE_S,
                                "suspect_grace_s": CROSS_GRACE_S,
                                "request_timeout_s": POOL_TIMEOUT_S,
                                "spawn_timeout_s": POOL_TIMEOUT_S}}, f)
    sb = spawn_module(workdir, "standby", "hetu_tpu_torch.resilience.standby",
                      [path], timeout_s=CROSS_WAIT_S)
    _until(lambda: "WATCHING" in log_of(sb),
           "vanchaos standby: the standby never watched", CROSS_WAIT_S)
    print(f"[vanchaos] bf16 standby: controller READY after "
          f"{ctrl.ready_s:.3f} s (its members spawned meanwhile), "
          f"{log_of(ctrl).count('ACCEPTED')} accepted; the standby READY "
          f"after {sb.ready_s:.3f} s, WATCHING [{card}] t+{_van_t():.1f} s",
          flush=True)
    ctrl.kill()
    ctrl.wait(CROSS_WAIT_S)
    accepted = log_of(ctrl).count("ACCEPTED")
    try:
        rc = sb.wait(2 * CROSS_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    log = log_of(sb)
    lines = {ln.split(" ", 1)[0]: ln for ln in log.splitlines() if ln}
    check(rc == 0 and "PROMOTED" in lines and "ALLDONE" in lines and
          "RESOLVED" in lines and "READY jax=0" in log,
          f"vanchaos standby: rc {rc}, log tail {log[-1500:]!r}")
    statuses = json.loads(lines["RESOLVED"].split(" ", 1)[1])
    bad = {rid: statuses.get(str(rid)) for rid in range(1, accepted + 1)
           if statuses.get(str(rid)) != "ok"}
    check(not bad, f"vanchaos standby: accepted requests not ok: {bad}")
    out.update(accepted=accepted, resolved=len(statuses),
               controller_ready_s=ctrl.ready_s, standby_ready_s=sb.ready_s,
               detect_to_promoted_s=float(lines["PROMOTED"].split()[1]),
               promoted_to_alldone_s=float(lines["ALLDONE"].split()[1]))
    out["launches"], out["prefills"], out["peak_gib"] = _van_members(
        "bf16 standby", workdir, VAN_MEMBERS, device)
    print(f"[vanchaos] bf16 standby: controller SIGKILLed after {accepted} "
          f"accepts; the standby PROMOTED {out['detect_to_promoted_s']:.3f}"
          f" s after it detected the silence (lease bound "
          f"{VAN_LEASE_BOUND_S} s), ALLDONE "
          f"{out['promoted_to_alldone_s']:.3f} s later; every accepted "
          f"rid ok ({len(statuses)} resolved); READY jax=0 [{card}] "
          f"t+{_van_t():.1f} s")
    return out


def phase_vanchaos(card, seed, device="cuda"):
    """The replicated durable tier (ps/replica.py) and the standby
    controller (resilience/standby.py) under GPT-2-small member processes
    at its published widths, 8 slots x 512 each: (a) f32, a pool over a
    replicated van pair whose primary is SIGKILLed twice while the members
    are parked mid-decode, re-silvered in between; (b) the fence of a
    SIGSTOPped primary; (c) bf16, a controller process SIGKILLed with a
    standby process watching.  Returns the numbers; ``launches`` sums the
    members' flash forwards over (a) and (c)."""
    import tempfile

    t_phase = _VAN_T0[0] = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="vanchaos_") as root:
        dirs = {k: os.path.join(root, k) for k in ("f32", "fence", "bf16")}
        for d in dirs.values():
            os.makedirs(d)
        fleet_c = _van_standby_start(dirs["bf16"], seed, device)
        try:
            for tag, fn in (("f32", lambda: _van_f32(card, seed, device,
                                                     dirs["f32"])),
                            ("fence", lambda: _van_fence(card,
                                                         dirs["fence"])),
                            ("bf16", lambda: _van_standby(
                                card, device, dirs["bf16"], fleet_c))):
                try:
                    out[tag] = fn()
                except Exception:
                    _cross_evidence(dirs[tag])
                    _van_logs(dirs[tag], tag)
                    raise
        finally:
            _van_reap([fleet_c["ctrl"], *fleet_c["vans"]])
            subprocess.run(["pkill", "-9", "-f", root], capture_output=True,
                           timeout=30)
    out["launches"] = out["f32"]["launches"] + out["bf16"]["launches"]
    out["prefills"] = out["f32"]["prefills"] + out["bf16"]["prefills"]
    out["seconds"] = time.perf_counter() - t_phase
    for tag in ("f32", "bf16"):
        print(f"[vanchaos] {tag}: peak GiB by member "
              f"{out[tag]['peak_gib']} [{card}]")
    print(f"[vanchaos] phase {out['seconds']:.1f} s (budget "
          f"{VAN_BUDGET_S:.0f} s); {out['prefills']} prefills in the "
          f"members, flash forwards launched {out['launches']} [{card}]")
    return out


_TRAFFIC_T0 = [0.0]


def _traffic_t():
    """Seconds since the traffic phase began, printed on its lines."""
    return time.perf_counter() - _TRAFFIC_T0[0]


def traffic_base_qps(r1):
    """The trace's base rate from ``r1``, the ok requests a second one
    member sustains: the TRAFFIC_PEAK_X peak of the diurnal curve then
    asks TRAFFIC_PEAK_X * TRAFFIC_BASE_SHARE members' worth (3)."""
    return TRAFFIC_BASE_SHARE * float(r1)


def traffic_spec(seed, base_qps):
    """The phase's trace: one diurnal period over TRAFFIC_DURATION_S, two
    tenants (the reference bench's gold and bursting bronze), prompts from
    a 64-entry Zipf catalog over the members' vocabulary, 16 tokens
    generated a request."""
    from hetu_tpu_torch.traffic import TenantSpec, TraceSpec

    return TraceSpec(
        seed=int(seed), duration_s=TRAFFIC_DURATION_S,
        base_qps=float(base_qps), diurnal_peak_x=TRAFFIC_PEAK_X,
        vocab=POOL_V, n_prompts=TRAFFIC_PROMPTS,
        max_prompt_len=TRAFFIC_PROMPT_LEN, zipf_s=1.1,
        tenants=[TenantSpec(name="gold", share=0.3, slo="gold",
                            deadline_lo_s=8.0, deadline_hi_s=12.0,
                            max_tokens=TRAFFIC_GEN),
                 TenantSpec(name="bronze", share=0.7, slo="bronze",
                            deadline_lo_s=1.0, deadline_hi_s=2.5,
                            burst_x=3.0, burst_on_s=1.5, burst_off_s=2.0,
                            max_tokens=TRAFFIC_GEN)])


def _quantile(xs, q):
    """The reference bench's quantile: the sorted sample at int(q n)."""
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)] if xs else None


class _ScaleProbe:
    """The pool as the autoscaler drives it, each actuation and each
    scrape timed; everything else passes through."""

    def __init__(self, pool):
        self._pool = pool
        self.actions, self.scrape_s = [], []

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def fleet_metrics(self, **kw):
        t0 = time.perf_counter()
        try:
            return self._pool.fleet_metrics(**kw)
        finally:
            self.scrape_s.append(time.perf_counter() - t0)

    def revive_member(self, slot):
        from hetu_tpu_torch.telemetry import trace

        t0 = time.monotonic()
        self._pool.revive_member(slot)
        # READY here: the fresh process joined and is routable
        trace.instant("traffic.member_ready", {"slot": int(slot)},
                      cat="traffic")
        self.actions.append({"action": "up", "slot": int(slot), "t0": t0,
                             "t1": time.monotonic(), "spawn_ready_s":
                             self._pool.procs[slot].ready_s})

    def drain_member(self, slot, close=True):
        t0 = time.monotonic()
        n = self._pool.drain_member(slot, close=close,
                                    timeout_s=POOL_TIMEOUT_S)
        rc = self._pool.procs[slot].poll() if close else None
        self.actions.append({"action": "down", "slot": int(slot), "t0": t0,
                             "t1": time.monotonic(), "n": n, "rc": rc,
                             "drain": dict(self._pool.last_drain)})
        return n


def _traffic_ledger_counts():
    """This process's delta-ledger counters (the controller's journal)."""
    from hetu_tpu_torch.telemetry import default_registry

    out = {k: default_registry.counter(f"ledger.{k}").value
           for k in ("delta_appends", "compactions", "compaction_bytes")}
    # the control sends (blob puts): a timed-out attempt is an error
    out.update({f"blob_put_{k}": default_registry.counter(
        f"van.blob_put.{k}").value for k in ("calls", "errors")})
    return out


def _traffic_closed_loop(pool, pairs, inflight, tag):
    """``pairs`` through ``pool.generate`` by ``inflight`` client threads,
    each taking the next pair as its last one returns; returns the
    responses and the wall seconds."""
    resps = [None] * len(pairs)
    nxt = itertools.count()

    def worker():
        for i in iter(lambda: next(nxt), None):
            if i >= len(pairs):
                return
            resps[i] = pool.generate(pairs[i][0], max_tokens=pairs[i][1],
                                     timeout_s=POOL_TIMEOUT_S)

    ts = [threading.Thread(target=worker, daemon=True)
          for _ in range(inflight)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    _wait_in_threads(ts, f"traffic {tag}: a generate did not return")
    wall = time.perf_counter() - t0
    check(all(r["status"] == "ok" for r in resps),
          f"traffic {tag}: a response is not ok: "
          f"{[r['status'] for r in resps]}")
    return resps, wall


def _traffic_moved(merged, handles, actions):
    """The requests each drain moved, from the controller's routes on the
    merged timeline: a rid last routed to the drained slot whose request
    ended owned by the drain's target.  Returns [(rids, drain record)]."""
    last = {}
    for e in merged:
        if e.get("name") == "serve.route":
            last[int(e["args"]["rid"])] = int(e["args"]["member"])
    out = []
    for a in actions:
        if a["action"] != "down":
            continue
        d = a["drain"]
        rids = sorted(rid for rid, h in handles.items()
                      if last.get(rid) == d["source"] and
                      h.member == d["target"])
        out.append((rids, d))
    return out


def _traffic_exact(merged, handles, events, moved, ref, seed):
    """Hard: every ok request a drain moved, and TRAFFIC_SAMPLE other ok
    requests drawn with the seed, token-exact to the straight run; a
    request moved with its slot prefilled nothing on the adopter (its
    member-side ``serve.request`` span there has no queue wait: it was
    never admitted, so never prefilled).  Returns (moved, sampled)."""
    spans = {}
    for e in merged:
        if e.get("name") == "serve.request" and e.get("ph") == "X":
            spans.setdefault(int(e["args"]["rid"]), []).append(e["args"])
    moved_ok = 0
    for rids, d in moved:
        for rid in rids:
            h = handles[rid]
            if h.status != "ok":
                continue
            check(list(h.tokens) == ref[tuple(events[rid]["prompt"])],
                  f"traffic: request {rid}, moved by the drain of member "
                  f"{d['source']}, differs from the straight run")
            if rid not in d["queued"]:
                at = [a for a in spans.get(rid, ())
                      if a.get("slot") == d["target"]]
                check(len(at) == 1 and "queue_s" not in at[0],
                      f"traffic: request {rid} moved with its slot into "
                      f"member {d['target']}, which admitted it again: "
                      f"{at}")
            moved_ok += 1
    skip = {rid for rids, _ in moved for rid in rids}
    pool_ok = sorted(rid for rid, h in handles.items()
                     if h.status == "ok" and rid not in skip)
    g = np.random.default_rng(seed)
    pick = sorted(g.choice(pool_ok, size=min(TRAFFIC_SAMPLE, len(pool_ok)),
                           replace=False).tolist()) if pool_ok else []
    for rid in pick:
        check(list(handles[rid].tokens) ==
              ref[tuple(events[rid]["prompt"])],
              f"traffic: request {rid} differs from the straight run")
    return moved_ok, len(pick)


def _traffic_fleet_sizes(actions, t_start, t_stop):
    """Seconds the fleet spent at each size between the autoscaler's start
    and stop (an up counts from its member's READY, a down from the
    drain's end), and the peak size."""
    size, at, spent, peak = TRAFFIC_MINM, t_start, {}, TRAFFIC_MINM
    for a in sorted(actions, key=lambda a: a["t1"]):
        spent[size] = spent.get(size, 0.0) + a["t1"] - at
        size += 1 if a["action"] == "up" else -1
        at, peak = a["t1"], max(peak, size)
    spent[size] = spent.get(size, 0.0) + t_stop - at
    return peak, {k: round(v, 3) for k, v in sorted(spent.items())}


def _traffic_tenants(issued, skip):
    """Per tenant: ok, shed and timeout counts, shed rate, TTFT p50/p99 of
    its ok requests (a request moved with its slot reports the adopter's
    TTFT of 0: left out)."""
    out = {}
    for ev, h in issued:
        t = out.setdefault(ev["tenant"], {"ok": 0, "shed": 0, "timeout": 0,
                                          "other": 0, "ttft": []})
        st = h.status if h.status in ("ok", "shed", "timeout") else "other"
        t[st] += 1
        if st == "ok" and h.ttft_s is not None and h.rid not in skip:
            t["ttft"].append(float(h.ttft_s))
    for t in out.values():
        tt = t.pop("ttft")
        n = t["ok"] + t["shed"] + t["timeout"] + t["other"]
        t.update(n=n, shed_rate=t["shed"] / n if n else 0.0,
                 ttft_p50_s=_quantile(tt, 0.5), ttft_p99_s=_quantile(tt, 0.99))
    return out


def traffic_lines(out, card):
    """The phase's printed lines, from its numbers."""
    f = out
    lines = [
        f"[traffic] r1 {f['r1']:.3f} ok requests/s ({TRAFFIC_R1_N} "
        f"closed-loop requests, {TRAFFIC_R1_INFLIGHT} in flight, "
        f"{f['r1_wall_s']:.3f} s, token-exact) on 1 member; base_qps "
        f"{f['base_qps']:.3f}, peak {TRAFFIC_PEAK_X:g}x [{card}]",
        f"[traffic] trace: {f['events']} events over "
        f"{TRAFFIC_DURATION_S:g} s, {f['trace_bytes']} bytes, sha256 "
        f"{f['trace_sha256'][:16]}, synthesized again byte-identical "
        f"[{card}]",
        f"[traffic] replay: {f['issued']} issued open-loop "
        f"({f['submit_errors']} refused), {f['ok']} ok in "
        f"{f['wall_s']:.3f} s, ok-QPS {f['ok_qps']:.3f} [{card}]",
        f"[traffic] submit path: issue behind the trace p50 "
        f"{f['issue_lag_s']['p50']:.3f} s, p99 "
        f"{f['issue_lag_s']['p99']:.3f} s, max "
        f"{f['issue_lag_s']['max']:.3f} s; a submit call p50 "
        f"{f['submit_ms']['p50']:.3f} ms, p99 {f['submit_ms']['p99']:.3f} "
        f"ms, max {f['submit_ms']['max']:.3f} ms; ledger "
        f"{f['ledger']['delta_appends']} delta appends, "
        f"{f['ledger']['compactions']} compactions "
        f"({f['ledger']['compaction_bytes']} bytes); control blob puts "
        f"{f['ledger']['blob_put_calls']} ("
        f"{f['ledger']['blob_put_errors']} attempts failed) [{card}]"]
    for name, t in sorted(f["tenants"].items()):
        p50, p99 = t["ttft_p50_s"], t["ttft_p99_s"]
        budget = ""
        if name == "gold":
            budget = (f"; p99 {'met' if f['gold_p99_met'] else 'missed'} "
                      f"its {TRAFFIC_GOLD_SLO_S:g} s budget")
        lines.append(
            f"[traffic] tenant {name}: ok {t['ok']}, shed {t['shed']}, "
            f"timeout {t['timeout']} of {t['n']}, shed rate "
            f"{t['shed_rate']:.4f}; TTFT p50 "
            f"{'-' if p50 is None else f'{p50:.4f}'} s, p99 "
            f"{'-' if p99 is None else f'{p99:.4f}'} s{budget} [{card}]")
    for i, a in enumerate(f["actions"], 1):
        if a["action"] == "up":
            route = "none before it was drained" \
                if a["ready_to_route_ms"] is None \
                else f"{a['ready_to_route_ms']:.3f} ms"
            lines.append(
                f"[traffic] scale {i}: up slot {a['slot']} "
                f"({a['reason']}): decision -> READY "
                f"{a['decision_to_ready_s']:.3f} s (spawn -> READY line "
                f"{a['spawn_ready_s']:.3f} s), READY -> first routed "
                f"request {route} [{card}]")
        else:
            lines.append(
                f"[traffic] scale {i}: down slot {a['slot']} "
                f"({a['reason']}) into member {a['target']}: decision -> "
                f"drained {a['decision_to_drained_s']:.3f} s, "
                f"{a['moved']} requests moved ({a['slots']} live slots, "
                f"{a['queued']} queued), exit {a['rc']} [{card}]")
    lines += [
        f"[traffic] fleet: peak {f['peak_members']} members; seconds at "
        f"each size {f['time_at_size']}; requests routed by member "
        f"{f['routed']} [{card}]",
        f"[traffic] scrape: {f['scrape']['n']} ticks, p50 "
        f"{f['scrape']['p50_ms']:.3f} ms, max {f['scrape']['max_ms']:.3f} "
        f"ms a tick's fleet_metrics [{card}]",
        f"[traffic] gates: {f['ups']} up, {f['downs']} down, each a "
        f"traffic.scale span with its reason; every accepted request ok, "
        f"shed or timeout; {f['exact_moved']} moved + {f['exact_sampled']} "
        f"sampled ok streams token-exact, moved slots prefilled nothing; "
        f"flash forwards {f['launches']} = {L} x {f['prefills']} prefills; "
        f"{f['members_spawned']} member processes, none with jax [{card}]",
        f"[traffic] phase {f['seconds']:.1f} s (budget "
        f"{TRAFFIC_BUDGET_S:.0f} s); peak GiB by member {f['peak_gib']} "
        f"[{card}]"]
    return lines


def _traffic_run(card, seed, device, workdir):
    import hashlib

    from hetu_tpu_torch.telemetry import fleet, trace
    from hetu_tpu_torch.traffic import (
        AutoscalePolicy, Autoscaler, dumps_trace, llm_submitter, load_trace,
        replay, save_trace, synthesize,
    )
    from hetu_tpu_torch.traffic.loadgen import prompt_catalog

    out = {}
    spec = _cross_spec(seed, "float32", device)
    tracer = trace.open_process_stream(workdir, "controller")
    started = _cross_start(workdir, spec, n=TRAFFIC_MAXM, shed=True,
                           slo_classes=TRAFFIC_SLO_CLASSES,
                           scrape_s=TRAFFIC_SCRAPE_S,
                           ledger_rows=TRAFFIC_LEDGER_ROWS)
    # the catalog depends on the seed alone, not on the rate: its 64
    # prompts straight through one scheduler while the members come up
    catalog = prompt_catalog(traffic_spec(seed, 1.0))
    base, straight = _cross_straight(
        spec, [(p, TRAFFIC_GEN) for p in catalog], device)
    del base
    ref = {tuple(p): list(r.tokens) for p, r in zip(catalog, straight)}
    pool = _cross_join(started, "start", card, "traffic", _traffic_t)
    scaler = None
    try:
        for s in range(TRAFFIC_MINM, TRAFFIC_MAXM):
            pool.drain_member(s, close=True, timeout_s=POOL_TIMEOUT_S)
            check(pool.procs[s].wait(POOL_TIMEOUT_S) == 0,
                  f"traffic: parked member {s} did not exit 0")
        # r1: closed loop on the one member, requests of the trace's shape
        shape = [(ev["prompt"], ev["max_tokens"]) for ev in synthesize(
            traffic_spec(seed, 2.0 * TRAFFIC_R1_N))["events"]]
        warm = shape[:TRAFFIC_R1_WARM]
        timed = shape[TRAFFIC_R1_WARM:TRAFFIC_R1_WARM + TRAFFIC_R1_N]
        check(len(timed) == TRAFFIC_R1_N, "traffic: too few r1 requests")
        _traffic_closed_loop(pool, warm, TRAFFIC_R1_INFLIGHT, "r1 warm-up")
        resps, wall = _traffic_closed_loop(pool, timed, TRAFFIC_R1_INFLIGHT,
                                           "r1")
        check([r["tokens"] for r in resps] ==
              [ref[tuple(p)] for p, _ in timed],
              "traffic r1: a stream differs from the straight run")
        out.update(r1=TRAFFIC_R1_N / wall, r1_wall_s=wall)
        out["base_qps"] = traffic_base_qps(out["r1"])
        # the trace, twice and through a file: the same bytes
        tr = synthesize(traffic_spec(seed, out["base_qps"]))
        text = dumps_trace(tr)
        path = os.path.join(workdir, "trace.json")
        save_trace(tr, path)
        again = dumps_trace(synthesize(traffic_spec(seed,
                                                    out["base_qps"])))
        check(text == again == dumps_trace(load_trace(path)),
              "traffic: the trace's bytes differ from the spec's "
              "synthesized again")
        events = tr["events"]
        check(all(tuple(ev["prompt"]) in ref and
                  ev["max_tokens"] == TRAFFIC_GEN for ev in events),
              "traffic: an event's prompt is not in the catalog")
        out.update(events=len(events), trace_bytes=len(text.encode()),
                   trace_sha256=hashlib.sha256(text.encode()).hexdigest())
        print(f"[traffic] r1 {out['r1']:.3f} ok requests/s, base_qps "
              f"{out['base_qps']:.3f}; {len(events)} events to replay "
              f"[{card}] t+{_traffic_t():.1f} s")

        probe = _ScaleProbe(pool)
        scaler = Autoscaler(probe, AutoscalePolicy(**TRAFFIC_POLICY),
                            ttft_slos={"gold": TRAFFIC_GOLD_SLO_S},
                            active=set(range(TRAFFIC_MINM)))
        t_start = time.monotonic()
        scaler.start()
        ledger0 = _traffic_ledger_counts()
        lag, calls = [], []
        sub = llm_submitter(pool)

        def submit(ev):
            # each event's issue behind its arrival time, and its submit
            # call: what the open loop costs the controller
            t = time.perf_counter()
            lag.append(t - t0 - ev["t"])
            try:
                return sub(ev)
            finally:
                calls.append(time.perf_counter() - t)

        t0 = time.perf_counter()
        issued = replay(tr, submit)
        out["ledger"] = {k: v - ledger0[k]
                         for k, v in _traffic_ledger_counts().items()}
        out["issue_lag_s"] = {"p50": _quantile(lag, 0.5),
                              "p99": _quantile(lag, 0.99),
                              "max": max(lag)}
        out["submit_ms"] = {"p50": _quantile(calls, 0.5) * 1e3,
                            "p99": _quantile(calls, 0.99) * 1e3,
                            "max": max(calls) * 1e3}
        accepted = [(ev, h) for ev, h in issued if hasattr(h, "done")]
        out.update(issued=len(issued),
                   submit_errors=len(issued) - len(accepted))
        print(f"[traffic] replayed {len(issued)} events in "
              f"{time.perf_counter() - t0:.3f} s; fleet "
              f"{sorted(scaler.active)} [{card}] t+{_traffic_t():.1f} s")
        grace = max(ev["deadline_s"] for ev, _ in accepted) + 60.0
        deadline = time.monotonic() + grace
        for _, h in accepted:
            h.done.wait(max(deadline - time.monotonic(), 0.0))
        out["wall_s"] = time.perf_counter() - t0
        # the calm tail: the fleet shrinks back once load is gone
        tail = time.monotonic() + TRAFFIC_TAIL_S
        while len(scaler.active) > TRAFFIC_MINM and \
                time.monotonic() < tail:
            time.sleep(0.1)
        scaler.stop()
        t_stop = time.monotonic()
        print(f"[traffic] tail over: fleet {sorted(scaler.active)} "
              f"[{card}] t+{_traffic_t():.1f} s")
        unresolved = [h.rid for _, h in accepted if not h.done.is_set()]
        bad = sorted({h.status for _, h in accepted if h.done.is_set()} -
                     {"ok", "shed", "timeout"})
        check(not unresolved and not bad,
              f"traffic: accepted requests unresolved {unresolved[:20]} "
              f"or in another state {bad}")
        decided = [d for d in scaler.decisions
                   if d["action"] in ("up", "down")]
        out["ups"] = sum(d["action"] == "up" for d in decided)
        out["downs"] = sum(d["action"] == "down" for d in decided)
        check(out["ups"] >= 1 and out["downs"] >= 1,
              f"traffic: {out['ups']} scale ups and {out['downs']} downs, "
              f"not at least one each: "
              f"{[d['action'] for d in scaler.decisions]}")
        out["launches"], out["prefills"] = _cross_flash("traffic", pool,
                                                        device)
        out["peak_gib"] = _cross_peaks(pool)
        out["members_spawned"] = _cross_no_jax(workdir, pool, "traffic")
    finally:
        if scaler is not None:
            scaler.stop()
        pool.close()
        trace.disable()
    merged, _ = fleet.merge_streams(workdir)
    spans = [(e["args"]["action"], int(e["args"]["slot"]),
              e["args"].get("reason")) for e in merged
             if e.get("name") == "traffic.scale" and e.get("ph") == "X"]
    # a failed actuation keeps its span (and its reason): every decision
    # that acted, failed or not, is on the timeline
    acted = [(d["action"].split("_")[0], d["slot"], d["reason"])
             for d in scaler.decisions if d["action"] != "hold"]
    check(sorted(spans) == sorted(acted) and
          all(r for _, _, r in spans),
          f"traffic: the traffic.scale spans {spans} are not the "
          f"decisions' actions with their reasons {acted}")
    out["failed_actions"] = sum(d["action"].endswith("_failed")
                                for d in scaler.decisions)
    handles = {h.rid: h for _, h in accepted}
    by_rid = {h.rid: ev for ev, h in accepted}
    moved = _traffic_moved(merged, handles, probe.actions)
    out["exact_moved"], out["exact_sampled"] = _traffic_exact(
        merged, handles, by_rid, moved, ref, seed)
    skip = {rid for rids, _ in moved for rid in rids}
    out["tenants"] = _traffic_tenants(accepted, skip)
    out["ok"] = sum(t["ok"] for t in out["tenants"].values())
    out["ok_qps"] = out["ok"] / out["wall_s"]
    gold = out["tenants"].get("gold", {}).get("ttft_p99_s")
    out["gold_p99_met"] = gold is not None and gold <= TRAFFIC_GOLD_SLO_S
    # each action beside its decision: READY and the first route after it
    routes = [(e["ts"], int(e["args"]["member"])) for e in tracer.events
              if e.get("name") == "serve.route"]
    out["routed"] = {m: sum(1 for _, x in routes if x == m)
                     for m in sorted({m for _, m in routes})}
    readies = [e["ts"] for e in tracer.events
               if e.get("name") == "traffic.member_ready"]
    moved_by = iter(moved)
    out["actions"] = []
    for d, a in zip(decided, probe.actions):
        rec = {"action": a["action"], "slot": a["slot"],
               "reason": d["reason"]}
        if a["action"] == "up":
            ready = readies.pop(0)
            first = min((ts for ts, m in routes
                         if m == a["slot"] and ts >= ready), default=None)
            rec.update(decision_to_ready_s=a["t1"] - d["t"],
                       spawn_ready_s=a["spawn_ready_s"],
                       ready_to_route_ms=None if first is None
                       else (first - ready) / 1e3)
        else:
            rids, dr = next(moved_by)
            rec.update(decision_to_drained_s=a["t1"] - d["t"],
                       target=dr["target"], moved=len(rids),
                       slots=dr["slots"], queued=len(dr["queued"]),
                       rc=a["rc"])
        out["actions"].append(rec)
    out["peak_members"], out["time_at_size"] = _traffic_fleet_sizes(
        probe.actions, t_start, t_stop)
    ms = [x * 1e3 for x in probe.scrape_s]
    out["scrape"] = {"n": len(ms), "p50_ms": statistics.median(ms),
                     "max_ms": max(ms)}
    return out


def phase_traffic(card, seed, device="cuda"):
    """The traffic plane (traffic/loadgen.py, traffic/autoscale.py) over
    GPT-2-small member processes at its published widths, f32, 8 slots x
    512 each: r1 measured on one member, a seeded open-loop trace with a
    10x diurnal spike replayed while the autoscaler scales the fleet up
    and back down.  Returns the numbers; ``launches`` are the members'
    flash forwards."""
    import tempfile

    t_phase = _TRAFFIC_T0[0] = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="traffic_") as workdir:
        try:
            out = _traffic_run(card, seed, device, workdir)
        except Exception:
            _cross_evidence(workdir)
            raise
        finally:
            subprocess.run(["pkill", "-9", "-f", workdir],
                           capture_output=True, timeout=30)
    out["seconds"] = time.perf_counter() - t_phase
    for line in traffic_lines(out, card):
        print(line)
    return out


def phase_train_llama(card, seed, device="cuda"):
    """Llama-2-7B's widths at 4 layers: the kernel-vs-plain gate, then 10
    Executor steps at B 4 x S 4096."""

    from hetu_tpu_torch.models import LlamaConfig, LlamaModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = LlamaConfig(vocab_size=LLAMA_V, hidden_size=LLAMA_H,
                      num_layers=LLAMA_TRAIN_L, num_heads=LLAMA_NH,
                      ffn_size=LLAMA_FFN, max_position=LLAMA_P,
                      dtype=torch.bfloat16, attention_impl="flash",
                      remat=True, fused_ce=True, ce_row_chunk=2048)
    t0 = time.perf_counter()
    model = LlamaModel(cfg, generator=torch.Generator(
        device=device).manual_seed(seed + 1), device=device)
    g = np.random.default_rng(seed + 5)
    batch = (torch.tensor(g.integers(0, LLAMA_V, (LLAMA_TRAIN_B,
                                                  LLAMA_TRAIN_S)),
                          device=device),)
    _sync(device)
    print(f"[train_llama] Llama-2-7B widths, {LLAMA_TRAIN_L} layers (cut "
          f"from {LLAMA_DEPTH}) B={LLAMA_TRAIN_B} S={LLAMA_TRAIN_S} bf16 flash "
          f"remat fused-CE AdamW({LLAMA_LR:g}): built in "
          f"{time.perf_counter() - t0:.1f} s")

    # the kernel path against the plain path, one batch, same weights:
    # the attention layers flipped to "xla" in place
    loss_k, grads_k = _loss_and_grads(model, batch)
    _set_attention_impl(model, "xla")
    loss_p, grads_p = _loss_and_grads(model, batch)
    _set_attention_impl(model, "flash")
    check(np.isfinite(loss_k) and np.isfinite(loss_p), "a loss is not finite")
    print(f"[train_llama] kernel path vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} (tol "
          f"{TOL_TRAIN_LOSS:g}); peak "
          f"{_peak_gib(device):.2f} GiB allocated through the plain "
          f"path's [{LLAMA_TRAIN_B}, {LLAMA_NH}, {LLAMA_TRAIN_S}, "
          f"{LLAMA_TRAIN_S}] f32 scores")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          "kernel path loss disagrees with the plain path")
    grad_ratio = _check_grads("train_llama", grads_k, grads_p)
    del grads_k, grads_p
    if device == "cuda":
        torch.cuda.empty_cache()

    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(LLAMA_LR), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = _flash_counters()
    for c in counters:  # count this path's launches only
        c.launches = 0
    losses, times = [], []
    for _ in range(LLAMA_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    n = LLAMA_TRAIN_L
    print(f"[train_llama] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train_llama] launches in {LLAMA_STEPS} steps: flash_attention "
          f"{launches[0]}, bwd_dkdv {launches[1]}, bwd_dq {launches[2]} "
          f"(a step: {[k / LLAMA_STEPS for k in launches]}, expected "
          f"[{2 * n}, {n}, {n}])")
    check(launches == [2 * n * LLAMA_STEPS, n * LLAMA_STEPS,
                       n * LLAMA_STEPS],
          "the Llama step did not launch 2L forward and L of each backward "
          "kernel a step")

    med, lo, hi = _step_stats(times)
    fpt, n_params = _llama_flops_per_token(model, LLAMA_TRAIN_S)
    tokens = LLAMA_TRAIN_B * LLAMA_TRAIN_S
    mfu = fpt * tokens / (med / 1e3) / H100_BF16_FLOP_S
    peak = _peak_gib(device)
    print(f"[train_llama] step median {med:.3f} ms (steps 2-{LLAMA_STEPS}: "
          f"{lo:.3f}-{hi:.3f}; first {times[0] * 1e3:.3f} ms), "
          f"{tokens / med * 1e3:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"({fpt * tokens / 1e12:.2f} TFLOP a step: 6 (N - V H) + 12 L H S "
          f"a token, {n_params / 1e6:.1f} M params, over 989 TFLOP/s), "
          f"peak {peak:.2f} GiB allocated [{card}]")

    _, busy = _profiled_step(ex, state, batch, device, "train_llama step",
                             card, med)
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                tokens_per_s=tokens / med * 1e3, mfu=mfu, peak_gib=peak,
                busy_share=busy, losses=losses, grad_ratio=grad_ratio)


def bert_synthetic_batch(g, b, s, vocab):
    """``examples/bert_pretrain.py``'s ``synthetic_batch`` (its lines
    31-67): a sticky-Markov stream over per-sequence 16-token topic
    vocabularies, NSP negatives switching topic at the segment boundary,
    15 % of positions masked (id 4) for MLM.  Returns (ids, token types,
    attention mask of ones, MLM labels with -1 unmasked, NSP labels)."""
    half = s // 2
    topic_a = g.integers(5, vocab, (b, 16))
    topic_b = g.integers(5, vocab, (b, 16))
    nsp = g.integers(0, 2, (b,)).astype(np.int32)
    pick = g.integers(0, 16, (b, s))
    stay = g.random((b, s)) < 0.9
    redraw = ~stay
    redraw[:, 0] = True
    redraw[nsp == 0, half] = True
    seg_vocab = np.where((np.arange(s)[None, :] < half)
                         | (nsp[:, None] == 1),
                         np.take_along_axis(topic_a, pick, 1),
                         np.take_along_axis(topic_b, pick, 1))
    last_redraw = np.maximum.accumulate(
        np.where(redraw, np.arange(s)[None, :], 0), axis=1)
    ids = np.take_along_axis(seg_vocab, last_redraw, 1).astype(np.int32)
    tok_type = (np.arange(s)[None] >= half).astype(np.int32) * np.ones(
        (b, 1), np.int32)
    attn = np.ones((b, s), np.int32)
    mlm = np.where(g.random((b, s)) < 0.15, ids, -1).astype(np.int32)
    masked_ids = np.where(mlm != -1, 4, ids)
    return masked_ids, tok_type, attn, mlm, nsp


def phase_train_bert(card, seed, device="cuda"):
    """BERT-base pretraining at B 16 x S 512 without a mask: the masked
    forward's plain path, the kernel-vs-plain gate, then 10 Executor
    steps."""
    import warnings


    from hetu_tpu_torch.models import BertConfig, BertModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = BertConfig(vocab_size=BERT_V, hidden_size=BERT_H,
                     num_layers=BERT_L, num_heads=BERT_NH, ffn_size=BERT_FFN,
                     max_position=BERT_P, dropout_rate=BERT_DROPOUT,
                     dtype=torch.bfloat16, attention_impl="flash")
    t0 = time.perf_counter()
    model = BertModel(cfg, generator=torch.Generator(
        device=device).manual_seed(seed + 2), device=device)
    ids, tok, attn, mlm, nsp = (
        torch.tensor(a, device=device) for a in bert_synthetic_batch(
            np.random.default_rng(seed + 6), BERT_B, BERT_S, BERT_V))
    batch = (ids, tok, None, mlm, nsp)  # no mask: the non-causal kernels
    _sync(device)
    print(f"[train_bert] BERT-base V={BERT_V} H={BERT_H} L={BERT_L} "
          f"heads={BERT_NH} ffn={BERT_FFN} B={BERT_B} S={BERT_S} bf16 flash "
          f"dropout {BERT_DROPOUT:g} AdamW({BERT_LR:g}, wd {BERT_WD:g}), "
          f"{int((mlm != -1).sum())} MLM targets: built in "
          f"{time.perf_counter() - t0:.1f} s")
    counters = _flash_counters()

    # a masked forward (the example's all-ones mask) takes the plain path
    # in every block, as the reference does: it warns, launches nothing,
    # and equals the plain layers' output bit for bit
    for c in counters:
        c.launches = 0
    with torch.no_grad(), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seq_k = model.encode(ids, tok, attn)
        _set_attention_impl(model, "xla")
        seq_p = model.encode(ids, tok, attn)
        _set_attention_impl(model, "flash")
    masked_launches = sum(c.launches for c in counters)
    warned = sum("ignores explicit masks" in str(w.message) for w in caught)
    same = torch.equal(seq_k, seq_p)
    print(f"[train_bert] masked forward: {masked_launches} flash launches, "
          f"{warned} warnings (one a block), equal to the plain path: "
          f"{same}")
    check(masked_launches == 0, "a masked forward launched a flash kernel")
    check(warned == BERT_L, "a masked flash block did not warn")
    check(same, "the masked forward differs from the plain path")
    del seq_k, seq_p

    # the kernel path against the plain path, one batch, same weights,
    # both drawing dropout from generators of one seed
    def dropout_gen():
        return torch.Generator(device=device).manual_seed(seed + 7)

    loss_k, grads_k = _loss_and_grads(model, batch, model.pretrain_loss_fn(),
                                      dropout_gen())
    _set_attention_impl(model, "xla")
    loss_p, grads_p = _loss_and_grads(model, batch, model.pretrain_loss_fn(),
                                      dropout_gen())
    _set_attention_impl(model, "flash")
    check(np.isfinite(loss_k) and np.isfinite(loss_p), "a loss is not finite")
    print(f"[train_bert] kernel path vs plain path: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, |d|={abs(loss_k - loss_p):.3e} (tol "
          f"{TOL_TRAIN_LOSS:g})")
    check(abs(loss_k - loss_p) <= TOL_TRAIN_LOSS,
          "kernel path loss disagrees with the plain path")
    grad_ratio = _check_grads("train_bert", grads_k, grads_p)
    del grads_k, grads_p

    ex = Executor(model.pretrain_loss_fn(),
                  AdamWOptimizer(BERT_LR, weight_decay=BERT_WD), seed=seed)
    state = ex.init_state(model)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:  # count this path's launches only
        c.launches = 0
    losses, times = [], []
    for _ in range(BERT_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    print(f"[train_bert] losses: {' '.join(f'{x:.4f}' for x in losses)} "
          f"(last: mlm {float(met['mlm_loss']):.4f}, nsp "
          f"{float(met['nsp_loss']):.4f})")
    check(all(np.isfinite(losses)), "a training loss is not finite")
    check(losses[-1] < losses[0], "the loss did not fall")
    print(f"[train_bert] launches in {BERT_STEPS} steps: flash_attention "
          f"{launches[0]}, bwd_dkdv {launches[1]}, bwd_dq {launches[2]} "
          f"(a step: {[k / BERT_STEPS for k in launches]}, expected "
          f"[{BERT_L}, {BERT_L}, {BERT_L}])")
    check(launches == [BERT_L * BERT_STEPS] * 3,
          "the BERT step did not launch L of each flash kernel a step")

    med, lo, hi = _step_stats(times)
    fpt, n_params = _bert_flops_per_token(model, BERT_S)
    tokens = BERT_B * BERT_S
    mfu = fpt * tokens / (med / 1e3) / H100_BF16_FLOP_S
    peak = _peak_gib(device)
    print(f"[train_bert] step median {med:.3f} ms (steps 2-{BERT_STEPS}: "
          f"{lo:.3f}-{hi:.3f}; first {times[0] * 1e3:.3f} ms), "
          f"{BERT_B / med * 1e3:.1f} samples/s, {tokens / med * 1e3:.1f} "
          f"tokens/s, MFU {100 * mfu:.2f} % ({fpt * tokens / 1e12:.2f} TFLOP "
          f"a step: 6 N_nonemb + 6 V H + 12 L H S a token, "
          f"{n_params / 1e6:.1f} M params, over 989 TFLOP/s), peak "
          f"{peak:.2f} GiB allocated [{card}]")

    _, busy = _profiled_step(ex, state, batch, device, "train_bert step",
                             card, med)
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                samples_per_s=BERT_B / med * 1e3, mfu=mfu, peak_gib=peak,
                busy_share=busy, losses=losses, grad_ratio=grad_ratio)


# ------------------------------------------------------------------- CNN

def _all_counters():
    """The launch counters of the port's six kernels, in the kernels
    line's order."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add, topk_gating,
    )
    return (*_flash_counters(), topk_gating, embedding_gather,
            embedding_scatter_add)


def conv_fc_macs(model, x):
    """Multiply-adds of the convolutions and matmuls of ``model``'s
    forward on ``x`` (an evaluation forward, which leaves the batch norms'
    state alone): N·Cout·Hout·Wout·Cin·kh·kw a convolution, N·in·out a
    Linear."""
    from hetu_tpu_torch.layers import Conv2d, Linear
    macs = []

    def hook(m, inp, out):
        w = m.weight
        macs.append(out.numel() * (w[0].numel() if isinstance(m, Conv2d)
                                   else w.shape[1]))
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv2d, Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


def _epochs(loader):
    while True:
        yield from loader


def _as_f64(model):
    """A float64 copy of ``model``: parameters, buffers and each layer's
    compute type."""
    other = copy.deepcopy(model).double()
    for m in other.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return other


def _cnn_one_step(model, batch):
    """Loss, every gradient and the new statistics of one training step's
    forward and backward (no update), on ``model``'s own tensors."""
    from hetu_tpu_torch.layers import state_buffers
    from hetu_tpu_torch.models import classifier_loss_fn
    params = dict(model.named_parameters())
    state = state_buffers(model)
    loss, _ = classifier_loss_fn(model)(params, state, batch, None, True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads)), state


@contextlib.contextmanager
def _relu_pattern(masks, flips=None):
    """Route every ``ops.relu`` of the block through a kept pattern: with
    ``flips`` None each call appends its ``x > 0`` to ``masks`` and
    computes the plain ReLU; otherwise each call takes the next recorded
    mask (``where(mask, x, 0)``) and adds to ``flips[0]`` the elements
    whose own sign disagrees with it.  A ReLU input within rounding of 0
    lands on either side in f32 and float64, and keeps or drops that
    element's gradient: holding both passes to one pattern leaves only
    the rounding to compare."""
    from hetu_tpu_torch import ops
    plain = ops.relu
    replay = iter(masks)

    def relu(x):
        if flips is None:
            masks.append(x.detach() > 0)
            return plain(x)
        m = next(replay)
        flips[0] += int((m != (x.detach() > 0)).sum())
        return torch.where(m, x, x.new_zeros(()))
    ops.relu = relu
    try:
        yield
    finally:
        ops.relu = plain


def _gaps(got, ref):
    return {n: float((got[n].double() - r).abs().max() / r.abs().max())
            for n, r in ref.items()}


def _cnn_f32_vs_f64(model, batch, device, tag):
    """One step of ``model``'s weights on ``batch`` in f32 and in float64,
    the float64 pass through the f32 pass's ReLU pattern: the gaps, held
    to the tolerances, the ReLU inputs on the other side of
    0 in float64 and the gradient gap with float64's own pattern, and
    whether two f32 steps are bitwise equal."""
    x, y = (torch.as_tensor(a).to(device) for a in batch)
    masks, flips, runs = [], [0], []
    for i in range(2):
        m32 = copy.deepcopy(model)
        with _relu_pattern(masks) if i == 0 else contextlib.nullcontext():
            runs.append(_cnn_one_step(m32, (x, y)))
        del m32
    _, own64, _ = _cnn_one_step(_as_f64(model), (x.double(), y))
    with _relu_pattern(masks, flips):
        loss64, grads64, state64 = _cnn_one_step(_as_f64(model),
                                                 (x.double(), y))
    n_relu = sum(m.numel() for m in masks)
    del masks
    loss32, grads32, state32 = runs[0]
    loss_gap = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    grad_gap = _gaps(grads32, grads64)
    stat_gap = _gaps(state32, state64)
    own_gap = max(_gaps(grads32, own64).items(), key=lambda kv: kv[1])
    bitwise = bool(torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(runs[0][1][n], runs[1][1][n]) for n in grads32))
    worst_g = max(grad_gap.items(), key=lambda kv: kv[1])
    worst_s = max(stat_gap.items(), key=lambda kv: kv[1])
    print(f"[train_cnn] f32 (TF32 off) vs float64, one step of the {tag} "
          f"on one batch, float64 through f32's ReLU pattern: loss "
          f"{float(loss32):.7f} vs {float(loss64):.7f} (gap "
          f"{loss_gap:.3e}, tol {TOL_CNN_LOSS:g}); gradients of "
          f"{len(grad_gap)} parameters max|dG| / max|G| <= "
          f"{worst_g[1]:.3e} ({worst_g[0]}, tol {TOL_CNN_GRAD:g}); new "
          f"statistics of {len(stat_gap)} buffers max|ds| / max|s| <= "
          f"{worst_s[1]:.3e} ({worst_s[0]}, tol {TOL_CNN_STATS:g}); "
          f"{flips[0]} of {n_relu} ReLU inputs on the other side of 0 in "
          f"float64, whose own pattern gives gradients within "
          f"{own_gap[1]:.3e} ({own_gap[0]}); two f32 steps bitwise equal "
          f"(loss and every gradient): {bitwise}")
    check(loss_gap <= TOL_CNN_LOSS, f"{tag}: the f32 loss disagrees with "
                                    f"float64")
    check(worst_g[1] <= TOL_CNN_GRAD,
          f"{tag}: the f32 gradient of {worst_g[0]} disagrees with float64")
    check(worst_s[1] <= TOL_CNN_STATS,
          f"{tag}: the f32 statistics {worst_s[0]} disagree with float64")
    return dict(loss_gap=loss_gap, grad_gap=worst_g[1],
                stats_gap=worst_s[1], relu_flips=flips[0],
                own_pattern_grad_gap=own_gap[1], bitwise_f32=bitwise)


def _train_steps(tag, model, loader, steps, optimizer, device, loss_fn=None,
                 phase="train_cnn"):
    """``steps`` Executor train steps over ``loader``'s epochs (any
    iterable of batches): finite, falling loss; returns the executor,
    state, losses, host times and the last batch."""
    from hetu_tpu_torch.models import classifier_loss_fn
    from hetu_tpu_torch.train import Executor
    ex = Executor(loss_fn or classifier_loss_fn(model), optimizer)
    state = ex.init_state(model)
    losses, times = [], []
    batches = _epochs(loader)
    for _ in range(steps):
        batch = next(batches)
        _sync(device)
        t0 = time.perf_counter()
        state, met = ex.run("train", state, batch)
        losses.append(float(met["loss"]))
        _sync(device)
        times.append(time.perf_counter() - t0)
    print(f"[{phase}] {tag} losses: "
          f"{' '.join(f'{x:.4f}' for x in losses)} (acc of the last batch "
          f"{float(met['acc']):.3f})")
    check(all(np.isfinite(losses)), f"{tag}: a training loss is not finite")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall")
    return ex, state, losses, times, batch


def phase_train_cnn(card, seed, device="cuda"):
    """ResNet-18 / CIFAR-10 (examples/cnn_resnet.py) through the Executor
    with its BatchNorm state, f32 against float64, the checkpoint round
    trip; then VGG-16, LeNet and MLP."""
    import tempfile


    from hetu_tpu_torch.data import Dataloader, datasets
    from hetu_tpu_torch.layers import state_buffers
    from hetu_tpu_torch.lr import CosineScheduler
    from hetu_tpu_torch.models import MLP, VGG, LeNet, ResNet18
    from hetu_tpu_torch.optim import MomentumOptimizer
    from hetu_tpu_torch.train import Executor, checkpoint

    t_phase = time.perf_counter()
    counters = _all_counters()
    train_x, train_y, test_x, test_y = datasets.cifar10()
    loader = Dataloader((train_x[:CNN_SUBSET], train_y[:CNN_SUBSET]), CNN_B,
                        shuffle=True)
    spe = loader.num_batches
    sched = CosineScheduler(CNN_LR, t_max=CNN_STEPS, warmup=spe // 10)
    model = ResNet18(generator=torch.Generator(device=device).manual_seed(
        seed + 30), device=device)
    initial = copy.deepcopy(model)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train_cnn] ResNet-18 ({n_params / 1e6:.2f} M params, "
          f"{len(state_buffers(model))} state buffers) f32, B {CNN_B} of "
          f"[3, 32, 32], synthetic CIFAR-10 subset {CNN_SUBSET} ({spe} "
          f"batches an epoch), Momentum(0.9) under CosineScheduler("
          f"{CNN_LR:g}, t_max {CNN_STEPS}, warmup {spe // 10}), "
          f"{CNN_STEPS} steps")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    ex, state, losses, times, batch = _train_steps(
        "resnet18", model, loader, CNN_STEPS, MomentumOptimizer(sched, 0.9),
        device, model.loss_fn())
    launches = [c.launches for c in counters]
    peak = _peak_gib(device)
    own = state_buffers(model)
    check(state.model_state.keys() == own.keys() and all(
        state.model_state[k] is t for k, t in own.items()),
        "the Executor's model state is not the model's buffers")
    moved = sum(not torch.equal(t, torch.ones_like(t))
                for k, t in own.items() if k.endswith(".var"))
    print(f"[train_cnn] state: {len(own)} buffers are the model's own, "
          f"{moved} of {len(own) // 2} running variances moved; launches of "
          f"the six kernels in {CNN_STEPS} steps: {launches}")
    check(moved == len(own) // 2, "a running variance did not move")
    check(launches == [0] * 6, "the CNN path launched a port kernel")
    valid = ex.run("validate", state, (test_x[:CNN_VALID],
                                       test_y[:CNN_VALID]))
    print(f"[train_cnn] validate on {CNN_VALID} test samples: loss "
          f"{float(valid['loss']):.4f}, acc {float(valid['acc']):.4f} "
          f"(random labels: chance is 0.1)")
    check(np.isfinite(float(valid["loss"])), "the validation loss is not "
                                             "finite")

    # the checkpoint round trip: a fresh model and Executor take the saved
    # state, then one more step on each from the same batch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet18.npz")
        ex.save(path, state, model)
        fresh = ResNet18(generator=torch.Generator(device=device)
                         .manual_seed(seed + 31), device=device)
        ex2 = Executor(fresh.loss_fn(), MomentumOptimizer(sched, 0.9))
        state2 = ex2.load(path, ex2.init_state(fresh), fresh)
    same = all(np.array_equal(a, b) for a, b in zip(
        checkpoint.state_dict(state, model).values(),
        checkpoint.state_dict(state2, fresh).values()))
    state, m1 = ex.run("train", state, batch)
    state2, m2 = ex2.run("train", state2, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    params_equal = all(torch.equal(a, b) for a, b in zip(
        state.params.values(), state2.params.values()))
    print(f"[train_cnn] checkpoint: loaded state equal to the saved one: "
          f"{same}; next step's loss {l1!r} vs {l2!r} (bitwise: "
          f"{l1 == l2}); parameters after it bitwise equal: {params_equal}")
    check(same, "the loaded checkpoint differs from the saved state")
    check(l1 == l2, "the step after the checkpoint differs")
    del fresh, ex2, state2

    gaps = _cnn_f32_vs_f64(initial, batch, device, "initial weights")
    trained = _cnn_f32_vs_f64(model, batch, device, "trained weights")
    del initial

    med, lo, hi = _step_stats(times)
    x_dev = torch.as_tensor(batch[0]).to(device)
    macs = conv_fc_macs(model, x_dev)
    flops = 2 * 3 * macs
    share = flops / (med / 1e3) / H100_F32_FLOP_S
    print(f"[train_cnn] step median {med:.3f} ms (steps 2-{CNN_STEPS}: "
          f"{lo:.3f}-{hi:.3f}; first {times[0] * 1e3:.3f} ms), "
          f"{CNN_B / med * 1e3:.1f} samples/s, {flops / 1e9:.2f} GFLOP a "
          f"step (2 x 3 x {macs} conv and fc multiply-adds), "
          f"{flops / (med / 1e3) / 1e12:.2f} TFLOP/s = "
          f"{100 * share:.2f} % of 67 TFLOP/s (f32 outside the tensor "
          f"cores, H100 SXM data sheet), peak {peak:.2f} GiB allocated "
          f"[{card}]")
    _, busy = _profiled_step(ex, state, batch, device, "train_cnn step",
                             card, med)
    del model, ex, state
    if device == "cuda":
        torch.cuda.empty_cache()

    # VGG-16 (BN) on CIFAR shapes, LeNet on MNIST padded to 32 x 32, the
    # MLP on MNIST's 784 features
    mx, my, _, _ = datasets.mnist()
    mx, my = mx[:CNN_SUBSET], my[:CNN_SUBSET]
    padded = np.pad(mx.reshape(-1, 1, 28, 28), ((0, 0), (0, 0), (2, 2),
                                                (2, 2)))
    zoo = {}
    for name, build, data in (
            ("vgg16", lambda g: VGG(16, generator=g, device=device),
             (train_x[:CNN_SUBSET], train_y[:CNN_SUBSET])),
            ("lenet", lambda g: LeNet(generator=g, device=device),
             (padded, my)),
            ("mlp", lambda g: MLP(generator=g, device=device), (mx, my))):
        for c in counters:
            c.launches = 0
        m = build(torch.Generator(device=device).manual_seed(seed + 32))
        _, _, zl, zt, _ = _train_steps(
            name, m, Dataloader(data, CNN_B, shuffle=True), CNN_ZOO_STEPS,
            MomentumOptimizer(CNN_ZOO_LR, 0.9), device)
        zmed = _step_stats(zt)[0]
        zoo[name] = dict(losses=zl, step_ms=zmed,
                         launches=[c.launches for c in counters])
        print(f"[train_cnn] {name}: step median {zmed:.3f} ms, "
              f"{CNN_B / zmed * 1e3:.1f} samples/s, launches "
              f"{zoo[name]['launches']} [{card}]")
        check(zoo[name]["launches"] == [0] * 6,
              f"{name}: the CNN path launched a port kernel")
        del m
    took = time.perf_counter() - t_phase
    print(f"[train_cnn] phase took {took:.1f} s")
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                samples_per_s=CNN_B / med * 1e3, flops=flops,
                f32_share=share, peak_gib=peak, busy_share=busy,
                losses=losses, valid_acc=float(valid["acc"]), zoo=zoo,
                trained=trained, **gaps)


# ------------------------------------------------------- RNN, GCN, op zoo

def _grads_of(model, loss_fn, batch):
    """Loss and every gradient of one evaluation-mode pass (no dropout, no
    update) of ``loss_fn`` over ``model``'s own parameters."""
    params = dict(model.named_parameters())
    loss, _ = loss_fn(params, {}, batch, None, False)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _f32_vs_f64(phase, tag, model, make_loss, batch32, batch64, tol_loss,
                tol_grad, relu=False):
    """One pass of ``model``'s weights in f32 and in float64 (the float64
    pass through the f32 pass's ReLU pattern when ``relu``): the loss's
    relative gap and each gradient's max gap over its max |G|, held to
    ``tol_loss`` and ``tol_grad``; returns the gaps and the flips."""
    masks, flips = [], [0]
    with _relu_pattern(masks) if relu else contextlib.nullcontext():
        loss32, grads32 = _grads_of(model, make_loss(model), batch32)
    m64 = _as_f64(model)
    with _relu_pattern(masks, flips) if relu else contextlib.nullcontext():
        loss64, grads64 = _grads_of(m64, make_loss(m64), batch64)
    n_relu = sum(m.numel() for m in masks)
    del masks, m64
    loss_gap = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    worst = max(_gaps(grads32, grads64).items(), key=lambda kv: kv[1])
    pattern = (f", float64 through f32's ReLU pattern ({flips[0]} of "
               f"{n_relu} ReLU inputs on the other side of 0 in float64)"
               if relu else "")
    print(f"[{phase}] {tag}: f32 (TF32 off) vs float64, one pass of the "
          f"same weights and batch{pattern}: loss {float(loss32):.7f} vs "
          f"{float(loss64):.7f} (gap {loss_gap:.3e}, tol {tol_loss:g}); "
          f"gradients of {len(grads32)} parameters max|dG| / max|G| <= "
          f"{worst[1]:.3e} ({worst[0]}, tol {tol_grad:g})")
    check(loss_gap <= tol_loss, f"{tag}: the f32 loss disagrees with "
                                f"float64")
    check(worst[1] <= tol_grad,
          f"{tag}: the f32 gradient of {worst[0]} disagrees with float64")
    return dict(loss_gap=loss_gap, grad_gap=worst[1], relu_flips=flips[0])


def phase_train_rnn(card, seed, device="cuda"):
    """examples/rnn_mnist.py's recurrent classifiers (rnn, lstm, gru) on
    the synthetic MNIST through the Executor: 20 steps each (finite,
    falling loss; no kernel of the six launches), one pass in f32 against
    float64, step time, samples/s, busy share, peak memory."""
    from hetu_tpu_torch.data import Dataloader, datasets
    from hetu_tpu_torch.models import RNNClassifier
    from hetu_tpu_torch.optim import AdamOptimizer

    t_phase = time.perf_counter()
    counters = _all_counters()
    mx, my, _, _ = datasets.mnist()
    data = (mx[:RNN_SUBSET], my[:RNN_SUBSET])
    print(f"[train_rnn] T 28 x D 28, hidden {RNN_HIDDEN}, Linear("
          f"{RNN_HIDDEN}, 10) on the last step, f32, B {RNN_B}, Adam("
          f"{RNN_LR:g}), {RNN_STEPS} steps a cell on a {RNN_SUBSET}-sample "
          f"subset of the synthetic MNIST")
    cells, launches = {}, [0] * 6
    for i, cell in enumerate(RNN_CELLS):
        model = RNNClassifier(cell, RNN_HIDDEN, generator=torch.Generator(
            device=device).manual_seed(seed + 40 + i), device=device)
        initial = copy.deepcopy(model)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        ex, state, losses, times, batch = _train_steps(
            cell, model, Dataloader(data, RNN_B, shuffle=True), RNN_STEPS,
            AdamOptimizer(RNN_LR), device, model.loss_fn(),
            phase="train_rnn")
        got = [c.launches for c in counters]
        launches = [a + b for a, b in zip(launches, got)]
        peak = _peak_gib(device)
        check(got == [0] * 6, f"{cell}: the RNN path launched a port kernel")
        x, y = (torch.as_tensor(a).to(device) for a in batch)
        gaps = _f32_vs_f64("train_rnn", f"{cell}, initial weights", initial,
                           lambda m: m.loss_fn(), (x, y), (x.double(), y),
                           TOL_RNN_LOSS, TOL_RNN_GRAD)
        med, lo, hi = _step_stats(times)
        print(f"[train_rnn] {cell}: step median {med:.3f} ms (steps "
              f"2-{RNN_STEPS}: {lo:.3f}-{hi:.3f}; first "
              f"{times[0] * 1e3:.3f} ms), {RNN_B / med * 1e3:.1f} samples/s, "
              f"peak {peak:.3f} GiB allocated, launches of the six kernels "
              f"{got} [{card}]")
        _, busy = _profiled_step(ex, state, batch, device,
                                 f"train_rnn {cell} step", card, med)
        cells[cell] = dict(step_ms=med, step_spread_ms=(lo, hi),
                           samples_per_s=RNN_B / med * 1e3, peak_gib=peak,
                           busy_share=busy, losses=losses, **gaps)
        del model, initial, ex, state
    print(f"[train_rnn] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, cells=cells)


def arxiv_like_graph(seed):
    """A seeded graph at ogbn-arxiv's sizes (``GCN_N`` nodes, ``GCN_F``
    features, ``GCN_CLASSES`` classes, ``GCN_EDGES`` directed edges, then
    both directions as examples/gnn_gcn.py adds them): one community a
    class, ``GCN_INTRA`` of the edges inside a community, features the
    class's mean plus normal noise of ``GCN_NOISE``, a ``GCN_TRAIN_SHARE``
    label mask.  Returns numpy ``(x, labels, src, dst, mask)``, made once
    for train_gcn and gcn_sampled."""
    return _graph(seed, GCN_N, GCN_F, GCN_CLASSES, GCN_EDGES, GCN_INTRA,
                  GCN_NOISE, GCN_TRAIN_SHARE)


@functools.lru_cache(maxsize=1)
def _graph(seed, n, f, classes, edges, intra, noise, train_share):
    g = np.random.default_rng(seed + 50)
    labels = g.integers(0, classes, n)
    members = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=classes)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src = g.integers(0, n, edges)
    c = labels[src]
    mate = members[starts[c] + (g.random(edges) * counts[c]).astype(
        np.int64)]
    dst = np.where(g.random(edges) < intra, mate, g.integers(0, n, edges))
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    means = g.standard_normal((classes, f)).astype(np.float32)
    x = means[labels] + np.float32(noise) * g.standard_normal(
        (n, f), np.float32)
    mask = (g.random(n) < train_share).astype(np.float32)
    return x, labels, src, dst, mask


def phase_train_gcn(card, seed, device="cuda"):
    """The reference's 2-layer GCN on the whole arxiv-sized graph through
    the Executor: 20 steps (finite, falling loss; no kernel of the six
    launches), gcn_norm's degrees exact, one pass in f32 against float64
    through f32's ReLU pattern, step time, nodes/s, busy share, peak."""
    from hetu_tpu_torch.models import GCN
    from hetu_tpu_torch.ops.graph_ops import gcn_norm, in_degree
    from hetu_tpu_torch.optim import AdamOptimizer

    t_phase = time.perf_counter()
    counters = _all_counters()
    x, labels, src, dst, mask = arxiv_like_graph(seed)
    n = x.shape[0]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    es, ed, ew = gcn_norm(torch.as_tensor(src, device=device),
                          torch.as_tensor(dst, device=device), n)
    deg = in_degree(ed, n)
    exact = bool(torch.equal(deg, torch.bincount(ed, minlength=n).float()))
    print(f"[train_gcn] graph: {n} nodes, {x.shape[1]} features, "
          f"{int(labels.max()) + 1} classes, {src.size} edges ({src.size // 2}"
          f" drawn, both directions) + {n} self loops = {es.numel()}; "
          f"degrees {int(deg.min())}-{int(deg.max())}, exact integers: "
          f"{exact}; {int(mask.sum())} labelled nodes "
          f"({100 * mask.mean():.1f} %)")
    check(exact and float(deg.max()) < 2 ** 24,
          "gcn_norm's degrees are not exact integers")
    batch = (torch.as_tensor(x, device=device),
             torch.as_tensor(labels, device=device),
             torch.as_tensor(mask, device=device))
    model = GCN(x.shape[1], GCN_HIDDEN, GCN_CLASSES,
                dropout_rate=GCN_DROPOUT, generator=torch.Generator(
                    device=device).manual_seed(seed + 51), device=device)
    initial = copy.deepcopy(model)
    print(f"[train_gcn] GCN({x.shape[1]}, {GCN_HIDDEN}, {GCN_CLASSES}), "
          f"dropout {GCN_DROPOUT}, f32, Adam({GCN_LR:g}), {GCN_STEPS} "
          f"full-graph steps")
    ex, state, losses, times, _ = _train_steps(
        "gcn", model, [batch], GCN_STEPS, AdamOptimizer(GCN_LR), device,
        model.loss_fn(es, ed, ew), phase="train_gcn")
    launches = [c.launches for c in counters]
    peak = _peak_gib(device)
    check(launches == [0] * 6, "the GCN path launched a port kernel")
    med, lo, hi = _step_stats(times)
    print(f"[train_gcn] step median {med:.3f} ms (steps 2-{GCN_STEPS}: "
          f"{lo:.3f}-{hi:.3f}; first {times[0] * 1e3:.3f} ms), "
          f"{n / med * 1e3:.0f} nodes/s, peak {peak:.3f} GiB allocated, "
          f"launches of the six kernels {launches} [{card}]")
    _, busy = _profiled_step(ex, state, batch, device, "train_gcn step",
                             card, med)
    del ex, state, model
    if device == "cuda":
        torch.cuda.empty_cache()
    gaps = _f32_vs_f64(
        "train_gcn", "initial weights", initial,
        lambda m: m.loss_fn(es, ed, ew if m.w1.dtype == torch.float32
                            else ew.double()),
        batch, (batch[0].double(), batch[1], batch[2].double()),
        TOL_GCN_LOSS, TOL_GCN_GRAD, relu=True)
    print(f"[train_gcn] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                nodes_per_s=n / med * 1e3, peak_gib=peak, busy_share=busy,
                losses=losses, **gaps)


class _TimedGraph:
    """A DistGraph's pulls, each timed into ``pull_s``."""

    def __init__(self, graph):
        self.g = graph
        self.pull_s = 0.0

    def _timed(self, fn, nodes):
        t0 = time.perf_counter()
        try:
            return fn(nodes)
        finally:
            self.pull_s += time.perf_counter() - t0

    def neighbors(self, nodes):
        return self._timed(self.g.neighbors, nodes)

    def features(self, nodes):
        return self._timed(self.g.features, nodes)

    def labels(self, nodes):
        return self._timed(self.g.labels, nodes)


def edge_keys(src, dst, n):
    """The sorted keys ``src · n + dst`` of a graph's edges."""
    return np.unique(np.asarray(src, np.int64) * n + dst)


def sampled_edges_real(batch, keys, n):
    """Whether every sampled edge ``u -> v`` (compact ids) is an edge ``(v,
    u)`` of the graph of ``keys`` (:func:`edge_keys`) on ``n`` nodes: v
    pulled u as a neighbour."""
    want = batch.nodes[batch.edge_dst] * n + batch.nodes[batch.edge_src]
    at = np.minimum(np.searchsorted(keys, want), keys.size - 1)
    return bool((keys[at] == want).all())


def fan_in_bounded(batch, fanouts):
    """Whether a seed takes at most the first hop's fanout plus the later
    ones', and any other node at most the later hops'."""
    indeg = np.bincount(batch.edge_dst, minlength=len(batch.nodes))
    n_seed = int(batch.seed_mask.sum())
    return bool(indeg[:n_seed].max(initial=0) <= sum(fanouts)
                and indeg[n_seed:].max(initial=0) <= sum(fanouts[1:]))


def phase_gcn_sampled(card, seed, device="cuda"):
    """GraphSAGE-style sampled training of the same GCN: the graph
    published to in-process PS tables, 8 batches of 512 seeds sampled
    (25, 10) on the host, padded to static shapes, normalised on the card
    and trained through the Executor; every sampled edge real, fan-in
    bounded, a finite loss whose last 3 batches' mean is below the first
    3's; sample, pull, copy and step times."""
    from hetu_tpu_torch.data.graph_sampler import DistGraph, NeighborSampler
    from hetu_tpu_torch.models import GCN
    from hetu_tpu_torch.ops.graph_ops import gcn_norm
    from hetu_tpu_torch.optim import AdamOptimizer
    from hetu_tpu_torch.ps import PSTable
    from hetu_tpu_torch.train import Executor

    t_phase = time.perf_counter()
    counters = _all_counters()
    x, labels, src, dst, mask = arxiv_like_graph(seed)
    n = x.shape[0]
    t0 = time.perf_counter()
    graph = DistGraph.publish(
        src, dst, x, labels, max_degree=SAGE_MAX_DEGREE, seed=seed,
        table_factory=lambda rows, dim, tag: PSTable(rows, dim,
                                                     init="zeros"))
    publish_s = time.perf_counter() - t0
    keys = edge_keys(src, dst, n)
    timed = _TimedGraph(graph)
    sampler = NeighborSampler(timed, seed=seed)
    print(f"[gcn_sampled] published {n} nodes to in-process PS tables "
          f"(adjacency [{n}, {SAGE_MAX_DEGREE + 1}], features [{n}, "
          f"{x.shape[1]}], labels [{n}, 1] f32) in {publish_s:.2f} s; "
          f"{SAGE_BATCHES} batches of {SAGE_SEEDS} seeds, fanouts "
          f"{SAGE_FANOUTS}, padded to {SAGE_PAD_NODES} nodes and "
          f"{SAGE_PAD_EDGES} edges")
    model = GCN(x.shape[1], GCN_HIDDEN, GCN_CLASSES,
                dropout_rate=GCN_DROPOUT, generator=torch.Generator(
                    device=device).manual_seed(seed + 52), device=device)

    def loss_fn(params, model_state, batch, generator, train):
        *data, es, ed, ew = batch
        return model.loss_fn(es, ed, ew)(params, model_state, tuple(data),
                                         generator, train)
    ex = Executor(loss_fn, AdamOptimizer(GCN_LR))
    state = ex.init_state(model)
    train_nodes = np.flatnonzero(mask)
    rng = np.random.default_rng(seed + 53)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    rows, losses = [], []
    for i in range(SAGE_BATCHES):
        seeds = rng.choice(train_nodes, SAGE_SEEDS, replace=False)
        timed.pull_s = 0.0
        t0 = time.perf_counter()
        raw = sampler.sample(seeds, SAGE_FANOUTS)
        sample_s = time.perf_counter() - t0
        check(sampled_edges_real(raw, keys, n),
              f"batch {i}: a sampled edge is not an edge of the graph")
        check(fan_in_bounded(raw, SAGE_FANOUTS),
              f"batch {i}: a node's fan-in exceeds its fanout")
        b = raw.pad_to(SAGE_PAD_NODES, SAGE_PAD_EDGES)
        _sync(device)
        t0 = time.perf_counter()
        data = [torch.as_tensor(a).to(device) for a in (
            b.features, b.labels, b.seed_mask, b.edge_src, b.edge_dst)]
        _sync(device)
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        *data, es, ed = data
        es, ed, ew = gcn_norm(es, ed, SAGE_PAD_NODES)
        state, met = ex.run("train", state, (*data, es, ed, ew))
        losses.append(float(met["loss"]))
        _sync(device)
        step_s = time.perf_counter() - t0
        rows.append(dict(sample_ms=sample_s * 1e3,
                         pull_ms=timed.pull_s * 1e3, copy_ms=copy_s * 1e3,
                         step_ms=step_s * 1e3, nodes=len(raw.nodes),
                         edges=len(raw.edge_src)))
        print(f"[gcn_sampled] batch {i}: sample {sample_s * 1e3:.1f} ms "
              f"(pulls {timed.pull_s * 1e3:.1f} ms), copy to the card "
              f"{copy_s * 1e3:.3f} ms, norm and step "
              f"{step_s * 1e3:.3f} ms, {len(raw.nodes)} nodes and "
              f"{len(raw.edge_src)} edges before padding, loss "
              f"{losses[-1]:.4f}, acc {float(met['acc']):.3f} [{card}]")
    launches = [c.launches for c in counters]
    peak = _peak_gib(device)
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    print(f"[gcn_sampled] loss mean of the first 3 batches {first:.4f}, of "
          f"the last 3 {last:.4f}; peak {peak:.3f} GiB allocated; launches "
          f"of the six kernels {launches}; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    check(all(np.isfinite(losses)), "a sampled batch's loss is not finite")
    check(last < first, "the sampled training's loss did not fall")
    check(launches == [0] * 6, "the sampled GCN path launched a port kernel")
    return dict(launches=launches, batches=rows, losses=losses,
                publish_s=publish_s, peak_gib=peak)


_DEVICE = "<the device under test>"  # a zoo case's device keyword


def _zoo_cases(g):
    """``(name, args, kwargs, exact)`` for every op of the elementwise,
    matmul, shape and reduce families: numpy inputs drawn from ``g``, with
    ties where an order among equals matters."""
    def r(*shape):
        return g.standard_normal(shape).astype(np.float32)
    x, y = r(256, 333), r(256, 333)
    pos = np.abs(r(256, 333)) + 0.1
    a, b, c = r(128, 64), r(64, 96), r(128, 96)
    ba, bb, bc = r(8, 128, 64), r(8, 64, 96), r(8, 128, 96)
    ties = g.integers(0, 7, (64, 200)).astype(np.float32)
    ints = g.integers(-50, 50, (64, 200)).astype(np.int32)
    img = r(4, 3, 32, 32)
    perm = np.stack([g.permutation(333) for _ in range(256)])
    rows = g.permutation(256)[:100]
    exact = [
        ("abs_", (x,), {}), ("opposite", (x,), {}), ("floor", (3 * x,), {}),
        ("ceil", (3 * x,), {}), ("clamp", (x, -0.5, 0.5), {}),
        ("sign", (ties - 3,), {}), ("bool_", (ties,), {}),
        ("where", (x > 0, x, y), {}), ("masked_fill", (x, x > 0, -1.0), {}),
        ("mask", (x, x > 0), {}),
        ("reshape", (x, (333, 256)), {}), ("transpose", (ba, (1, 0, 2)), {}),
        ("concat", (x, y), {"axis": 1}),
        ("concatenate", ([x, y, x],), {"axis": 0}),
        ("split", (x, 4), {"axis": 0}), ("split", (x, [5, 100]), {"axis": 1}),
        ("slice_", (x, (3, 7), (100, 200)), {}),
        ("slice_assign", (x, y[:50, :60], (250, 10)), {}),
        ("slice_by_matrix", (x, g.integers(-256, 256, 500),
                             g.integers(0, 333, 500)), {}),
        ("pad", (x, ((1, 2), (3, 4))), {"constant_values": 2.0}),
        ("pad", (x, ((5, 1), (3, 9))), {"mode": "reflect"}),
        ("pad", (x, ((5, 1), (3, 9))), {"mode": "edge"}),
        ("pad", (x, ((5, 1), (3, 9))), {"mode": "symmetric"}),
        ("pad", (x, ((5, 1), (3, 9))), {"mode": "wrap"}),
        ("tile", (a, (2, 3)), {}), ("repeat", (a, 3), {"axis": 1}),
        ("repeat", (a, g.integers(0, 4, 128)), {"axis": 0}),
        ("roll", (x, 17), {"axis": 1}), ("broadcast_shape", (x[:1],
                                                             (256, 333)), {}),
        ("broadcast_to", (x[:, :1], (2, 256, 333)), {}),
        ("gather", (x, g.integers(-333, 333, (40, 5))), {"axis": 1}),
        ("gather_elements", (x, g.integers(0, 333, (256, 50))), {"axis": 1}),
        ("scatter", (x, perm[:, :200], y[:, :200]), {"axis": 1}),
        ("scatter1d", (x, rows, y[:100]), {}),
        ("indexing", (x, g.integers(-256, 256, 300)), {}),
        ("one_hot", (g.integers(-2, 12, 500), 10), {}),
        ("arange", (3, 1000, 7), {"device": _DEVICE}),
        ("arange", (0.5, 99.0), {"device": _DEVICE}),
        ("full", ((64, 5), 2.5), {"device": _DEVICE}),
        ("full_like", (x, 3.0), {}), ("ones_like", (x,), {}),
        ("zeros_like", (x,), {}), ("cumsum", (ints,), {"axis": 1}),
        ("flip", (ba, (0, 2)), {}), ("tril", (x, -3), {}),
        ("triu", (x, 5), {}), ("tril_lookup", (ba,), {"offset": 2}),
        ("interpolate", (img,), {"size": (64, 48), "mode": "nearest"}),
        ("interpolate", (img,), {"size": (13, 20), "mode": "nearest"}),
        ("reduce_min", (x, 1), {}), ("reduce_max", (x,), {}),
        ("max_", (x, 0), {"keepdims": True}), ("min_", (x,), {}),
        ("argmax", (ties, 1), {}), ("argsort", (ties, 1), {}),
        ("argsort", (ties, 0), {"descending": True}),
        ("topk", (ties, 10), {}), ("topk", (ties, 5), {"axis": 0}),
        ("topk_idx", (ties, 3), {}), ("topk_val", (ties, 3), {}),
        ("unique", (ints, 150), {"fill_value": 0}),
        ("unique", (ties, 4), {}),
    ]
    arith = [
        ("add", (x, y), {}), ("add_const", (x, 2.5), {}),
        ("minus", (x, y), {}), ("minus_const", (x, 1.5), {}),
        ("const_minus", (1.5, x), {}), ("multiply", (x, y), {}),
        ("mul_const", (x, -3.0), {}), ("divide", (x, pos), {}),
        ("div_const", (x, 7.0), {}), ("const_div", (2.0, pos), {}),
        ("exp", (x,), {}), ("log", (pos,), {}), ("pow_", (pos, y), {}),
        ("const_pow", (2.0, x), {}), ("power", (pos, 3.0), {}),
        ("sqrt", (pos,), {}), ("rsqrt", (pos,), {}), ("sin", (x,), {}),
        ("cos", (x,), {}),
        ("matmul", (a, b), {}), ("matmul", (a.T.copy(), b),
                                 {"trans_a": True}),
        ("linear", (a, b.T.copy(), c[0]), {"trans_w": True}),
        ("batch_matmul", (ba, bb), {}),
        ("addmm", (c, a, b), {"alpha": 2.0, "beta": 0.5}),
        ("baddbmm", (bc, ba, bb), {"alpha": -1.0, "beta": 3.0}),
        ("matrix_dot", (x, y), {}), ("cumsum", (x,), {"axis": 0}),
        ("interpolate", (img,), {"size": (64, 48)}),
        ("interpolate", (img,), {"size": (13, 20)}),
        ("reduce_sum", (x, 1), {}), ("reduce_sum", (x,), {}),
        ("reduce_mean", (x, (0, 1)), {"keepdims": True}),
        ("reduce_mul", (1 + 0.1 * x[:, :8], 1), {}),
        ("reduce_norm1", (x, 0), {}), ("reduce_norm2", (x, 1), {}),
        ("reduce_sum_axis_zero", (x,), {}), ("norm", (x,), {}),
        ("norm", (x, 3), {}),
    ]
    return [(n, a_, k, True) for n, a_, k in exact] + \
        [(n, a_, k, False) for n, a_, k in arith]


def _zoo_args(args, device):
    def one(a):
        if isinstance(a, list):
            return [one(b) for b in a]
        return torch.as_tensor(a, device=device) \
            if isinstance(a, np.ndarray) else a
    return [one(a) for a in args]


def _zoo_leaves(out):
    return [t for o in out for t in _zoo_leaves(o)] \
        if isinstance(out, (list, tuple)) else [out]


def phase_ops_zoo(card, device="cuda"):
    """Every op of the elementwise, shape, reduce and matmul families on
    the card against the same op on the CPU, on the same inputs: exact
    where the op rounds nothing (index, shape, order ops), within
    ``TOL_ZOO`` of the output's largest magnitude otherwise; an id out of
    range raises on the card too."""
    from hetu_tpu_torch import ops

    t_phase = time.perf_counter()
    cases = _zoo_cases(np.random.default_rng(60))
    worst = ("", 0.0)
    for name, args, kw, exact in cases:
        outs = []
        for dev in ("cpu", device):
            kw_dev = {k: dev if v is _DEVICE else v for k, v in kw.items()}
            outs.append(_zoo_leaves(getattr(ops, name)(
                *_zoo_args(args, dev), **kw_dev)))
        ref, got = outs
        check(len(got) == len(ref), f"ops_zoo {name}: {len(got)} outputs")
        for gt, rt in zip(got, ref):
            gt = gt.cpu()
            check(gt.shape == rt.shape and gt.dtype == rt.dtype,
                  f"ops_zoo {name}: {gt.shape} {gt.dtype} vs {rt.shape} "
                  f"{rt.dtype}")
            if exact or not rt.is_floating_point():
                check(torch.equal(gt, rt), f"ops_zoo {name}: not exact")
                continue
            scale = float(rt.abs().max())
            gap = float((gt - rt).abs().max()) / scale if scale else 0.0
            worst = max(worst, (name, gap), key=lambda w: w[1])
            check(gap <= TOL_ZOO, f"ops_zoo {name}: {gap:.3e} of max|y| "
                                  f"> {TOL_ZOO:g}")
    x = torch.zeros(4, 3, device=device)
    for name, args in (("gather", (x, torch.tensor([0, 4], device=device))),
                       ("scatter1d", (x, torch.tensor([-5], device=device),
                                      torch.ones(1, 3, device=device)))):
        try:
            getattr(ops, name)(*args)
        except IndexError:
            continue
        check(False, f"ops_zoo {name}: an id out of range did not raise")
    n_exact = sum(c[3] for c in cases)
    print(f"[ops_zoo] {len(cases)} cases ({n_exact} exact, "
          f"{len(cases) - n_exact} within {TOL_ZOO:g} of max|y|) on "
          f"{device} against the CPU: all agree; worst arithmetic gap "
          f"{worst[1]:.3e} ({worst[0]}); ids out of range raise; "
          f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(cases=len(cases), exact=n_exact, worst=worst)


# ----------------------------------------------------- embedding compression

def compress_table(method, vocab, dim, generator):
    """examples/rec_compressed.py's ``make_table`` in the port, with the
    example's constructor arguments where it has them, the module's
    defaults for the other methods of ALL_METHODS; ``"full"`` is the
    dense ``Embedding`` (``impl="xla"``: no kernel)."""
    from hetu_tpu_torch import embedding_compress as ec
    from hetu_tpu_torch.layers import Embedding
    kw = dict(generator=generator)
    tables = {
        "full": lambda: Embedding(vocab, dim, **kw),
        "hash": lambda: ec.HashEmbedding(vocab, dim, 0.1, **kw),
        "compo": lambda: ec.CompositionalEmbedding(vocab, dim, **kw),
        "dpq": lambda: ec.DPQEmbedding(vocab, dim, **kw),
        "mgqe": lambda: ec.MGQEEmbedding(vocab, dim, **kw),
        "tt": lambda: ec.TensorTrainEmbedding(vocab, dim, **kw),
        "dhe": lambda: ec.DHEEmbedding(vocab, dim, **kw),
        "robe": lambda: ec.ROBEEmbedding(vocab, dim, 0.1, **kw),
        "alpt": lambda: ec.ALPTEmbedding(vocab, dim, **kw),
        "prune": lambda: ec.PrunedEmbedding(vocab, dim, rate=0.7, **kw),
        "pep": lambda: ec.PEPEmbedding(vocab, dim, **kw),
        "optembed": lambda: ec.OptEmbedEmbedding(vocab, dim, **kw),
        "autosrh": lambda: ec.AutoSRHEmbedding(vocab, dim, **kw),
        "mde": lambda: ec.MixedDimEmbedding(vocab, dim, **kw),
        "autodim": lambda: ec.AutoDimEmbedding(vocab, dim, **kw),
        "dedup": lambda: ec.DedupEmbedding(vocab, dim, 0.2, **kw),
        "adapt": lambda: ec.AdaptiveEmbedding(vocab, dim, **kw),
    }
    return tables[method]()


def compressed_model(method, vocab, dim, fields, generator):
    """The example's model: the table (drawn first) and its head,
    ``mlp_tower(fields * dim, (32,), out_dim=1)``."""
    from hetu_tpu_torch.models.ctr_common import mlp_tower
    return torch.nn.ModuleDict({
        "emb": compress_table(method, vocab, dim, generator),
        "head": mlp_tower(fields * dim, (CMP_HIDDEN,), out_dim=1,
                          generator=generator)})


def compressed_loss(model, ids, y):
    """The example's loss, mean BCE with logits of the head over the
    flattened rows; returns the loss and the rows."""
    from hetu_tpu_torch import ops
    rows = model["emb"](ids)
    logit = model["head"](rows.reshape(rows.shape[0], -1))
    return ops.binary_cross_entropy_with_logits(logit[:, 0], y).mean(), rows


def compressed_step_fn(model, optimizer):
    """The example's train step over every parameter of ``model``, in
    place: ``step(ids, labels) -> loss``; its optimizer state is
    ``step.opt_state``."""
    params = dict(model.named_parameters())
    state = optimizer.init_state(params)

    def step(ids, y):
        loss, _ = compressed_loss(model, ids, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        state.update(optimizer.update(dict(zip(params, grads)), state,
                                      params)[1])
        return loss.detach()

    step.opt_state = state
    return step


def compressed_batches(g, vocab, n=None, b=None, fields=None):
    """``n`` batches of ``(ids [b, fields] int32, labels [b] f32)``: Zipf
    ids (``zipf_ids``) labelled by examples/rec_compressed.py's rule,
    ``(ids % 5 - 2) @ w * 0.3 + noise > 0`` with ``w`` one draw for all."""
    n, b, fields = n or CMP_BATCHES, b or CTR_B, fields or CTR_F
    w = g.standard_normal(fields)
    out = []
    for _ in range(n):
        ids = zipf_ids(g, (b, fields), vocab)
        logit = (ids % 5 - 2) @ w * 0.3
        out.append((ids, (logit + g.standard_normal(b) > 0).astype(
            np.float32)))
    return out


@contextlib.contextmanager
def _choice_pattern(records, flips=None):
    """Route each discrete choice of the compression layers (their
    ``DISCRETE_CHOICES``: codes, rounding, binary steps, pruning masks)
    through a kept pattern, as :func:`_relu_pattern` does for the ReLU:
    with ``flips`` None each call appends its choice to ``records[name]``;
    otherwise each call takes the next recorded choice and adds to
    ``flips[0]`` the elements where its own choice differs."""
    from hetu_tpu_torch.embedding_compress import layers
    saved = {n: getattr(layers, n) for n in layers.DISCRETE_CHOICES}
    replay = {n: iter(records.get(n, ())) for n in saved}

    def wrap(name, fn):
        def choice(*args):
            own = fn(*args)
            if flips is None:
                records.setdefault(name, []).append(own.detach())
                return own
            kept = next(replay[name])
            flips[0] += int((kept != own).sum())
            return kept.to(own.dtype)
        return choice
    for n, fn in saved.items():
        setattr(layers, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(layers, n, fn)


def _compressed_pass(model, ids, y):
    """Loss, every parameter's gradient, and ``sum |dL/dy · y|`` over the
    rows ``y`` (the size of the terms that cancel in a gradient that is
    zero in exact arithmetic, ALPT's ``log_scale``)."""
    params = dict(model.named_parameters())
    loss, rows = compressed_loss(model, ids, y)
    *grads, g_rows = torch.autograd.grad(loss, [*params.values(), rows])
    return loss.detach(), dict(zip(params, grads)), \
        float((g_rows * rows.detach()).abs().sum())


def compressed_f32_vs_f64(name, model, ids, y, replay=True):
    """One pass of ``model`` in f32 and in float64 on the same batch, the
    float64 pass (with ``replay``) through the f32 pass's discrete choices
    and head ReLUs: the loss's relative gap and each gradient's max gap
    over its max |G| (ALPT's ``log_scale``: over ``sum |dL/dy · y|``),
    held to train_rnn's limits; returns the gaps and the flips."""
    records, masks, flips = {}, [], [0]
    with _choice_pattern(records), _relu_pattern(masks):
        loss32, g32, _ = _compressed_pass(model, ids, y)
    m64 = _as_f64(model)
    with (_choice_pattern(records, flips) if replay
          else contextlib.nullcontext()), \
            (_relu_pattern(masks, flips) if replay
             else contextlib.nullcontext()):
        loss64, g64, terms = _compressed_pass(m64, ids, y.double())
    n_choices = sum(t.numel() for r in records.values() for t in r) \
        + sum(m.numel() for m in masks)
    del m64, records, masks
    loss_gap = abs(float(loss32) - float(loss64)) / abs(float(loss64))
    gaps = {}
    for n, r in g64.items():
        scale = terms if (name == "alpt" and n == "emb.log_scale") \
            else float(r.abs().max())
        gap = float((g32[n].double() - r).abs().max())
        gaps[n] = gap / scale if scale else (0.0 if gap == 0 else np.inf)
    worst = max(gaps.items(), key=lambda kv: kv[1])
    print(f"[train_compressed] {name}: f32 vs float64 at V {CMP_F64_V}, "
          f"float64 {'through' if replay else 'without'} f32's "
          f"{n_choices} discrete choices and ReLUs ({flips[0]} flip in "
          f"float64): loss gap {loss_gap:.3e} (tol {TOL_RNN_LOSS:g}), "
          f"gradients of {len(gaps)} parameters max|dG| / max|G| <= "
          f"{worst[1]:.3e} ({worst[0]}, tol {TOL_RNN_GRAD:g})")
    check(loss_gap <= TOL_RNN_LOSS, f"{name}: the f32 loss disagrees with "
                                    f"float64")
    check(worst[1] <= TOL_RNN_GRAD,
          f"{name}: the f32 gradient of {worst[0]} disagrees with float64")
    return dict(loss_gap=loss_gap, grad_gap=worst[1], flips=flips[0],
                choices=n_choices)


def _serve_full(ctx, model):
    """The trained full table in int8 form: ``from_table``'s q and scale
    and ``quantize_embedding_lookup`` bitwise on the card and the CPU."""
    from hetu_tpu_torch import embedding_compress as ec
    from hetu_tpu_torch import ops
    table = model["emb"].weight.detach()
    ids = ctx["batches"][0][0]
    q, scale = ec.QuantizedEmbedding.from_table(table)
    rows = ops.quantize_embedding_lookup(q, scale, ids)
    cq, cscale = ec.QuantizedEmbedding.from_table(table.cpu())
    crows = ops.quantize_embedding_lookup(cq, cscale, ids.cpu())
    same = [torch.equal(_bits(a.cpu()), _bits(b))
            for a, b in ((q, cq), (scale, cscale), (rows, crows))]
    nbytes = q.numel() + scale.numel() * 4
    print(f"[train_compressed] full -> QuantizedEmbedding.from_table: "
          f"{nbytes / 1e9:.3f} GB against {table.numel() * 4 / 1e9:.3f} "
          f"GB; q, scale and quantize_embedding_lookup of a batch bitwise "
          f"on {ctx['device']} and the CPU: {same}")
    check(all(same), "from_table or quantize_embedding_lookup differs "
                     "from the CPU's")
    return dict(int8_bytes=nbytes, bitwise=all(same))


def _serve_dpq(ctx, model):
    """DPQ's serving form: its lookups within the reference test's limits
    of the hard path."""
    emb, ids = model["emb"], ctx["batches"][0][0]
    serving = emb.to_serving()
    with torch.no_grad():
        got, hard = emb.serving_lookup(serving, ids), emb(ids)
    ok = bool(torch.allclose(got, hard, rtol=1e-5, atol=1e-6))
    gap = float((got - hard).abs().max())
    nbytes = sum(t.numel() * t.element_size() for t in serving.values())
    print(f"[train_compressed] dpq -> to_serving: codes {tuple(serving['codes'].shape)} "
          f"{serving['codes'].dtype} + codebooks, {nbytes / 1e6:.3f} MB "
          f"against logits {emb.logits.numel() * 4 / 1e9:.3f} GB; "
          f"serving_lookup vs the hard path max gap {gap:.3e} (rtol 1e-5, "
          f"atol 1e-6): {ok}")
    check(ok, "DPQ's serving lookup disagrees with its hard path")
    return dict(serving_bytes=nbytes, gap=gap)


def _serve_prune(ctx, model):
    """The pruned table (the module's forward over every id) in ELL form,
    its lookups bitwise the pruned rows; then a DeepLight schedule on the
    module: warmup, prune at 0.9 (``prune_rate_setter``), int8 serving
    (``switch_to_quantized``)."""
    from hetu_tpu_torch import embedding_compress as ec
    from hetu_tpu_torch.embedding_compress.scheduler import (
        Stage, prune_rate_setter, switch_to_quantized,
    )
    from hetu_tpu_torch.optim import AdamOptimizer
    emb, ids = model["emb"], ctx["batches"][0][0]
    with torch.no_grad():
        table = emb(torch.arange(emb.n, device=ctx["device"]))
    nnz = (table != 0).sum(1)
    max_nnz = int(nnz.max())
    sparse = ec.SparseEmbedding.from_dense(table, max_nnz)
    same = torch.equal(_bits(sparse(ids)), _bits(table[ids.long()]))
    ell = sparse.values.numel() * 8
    print(f"[train_compressed] prune (rate {float(emb.rate):g}) -> "
          f"SparseEmbedding.from_dense: max_nnz {max_nnz}, density "
          f"{float(nnz.double().mean()) / emb.dim:.4f}, ELL "
          f"{ell / 1e9:.3f} GB against {table.numel() * 4 / 1e9:.3f} GB; "
          f"lookups bitwise the pruned rows: {same}")
    check(same, "the ELL lookups differ from the pruned dense rows")
    del table, nnz, sparse
    sched = ec.CompressionScheduler([
        Stage("warmup", 2), Stage("prune", 4, on_enter=prune_rate_setter(0.9)),
        Stage("serve", 6, on_enter=switch_to_quantized(emb))])
    step = compressed_step_fn(model, AdamOptimizer(CMP_LR))
    losses, stages = [], []
    for s in range(6):
        model["emb"] = sched.maybe_transition(s, model["emb"])
        stages.append(sched.current.name)
        ids, y = ctx["batches"][s % CMP_BATCHES]
        if sched.current.name != "serve":
            losses.append(float(step(ids, y)))
            continue
        with torch.no_grad():
            losses.append(float(compressed_loss(model, ids, y)[0]))
    q = model["emb"]
    check(isinstance(q, ec.QuantizedEmbedding) and float(emb.rate) == float(
        np.float32(0.9)), "the DeepLight schedule did not prune and switch")
    err = float(((q(ids) - emb.w.detach()[ids.long()]).abs()
                 / q.scale[ids.long()][..., None]).max())
    print(f"[train_compressed] DeepLight schedule {stages}: losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; int8 rows within "
          f"{err:.4f} of a step of the dense rows (<= 0.5)")
    check(all(np.isfinite(losses)) and err <= 0.5 + 1e-6,
          "the switched int8 rows are not the dense rows rounded")
    return dict(max_nnz=max_nnz, ell_bytes=ell, schedule_losses=losses)


def _retrain_pep(ctx, model):
    """``pep_to_retrain`` -> MaskedEmbedding, a few steps of a fresh Adam:
    finite losses, the frozen mask kept."""
    from hetu_tpu_torch import embedding_compress as ec
    from hetu_tpu_torch.optim import AdamOptimizer
    model["emb"] = ec.pep_to_retrain(model["emb"])
    step = compressed_step_fn(model, AdamOptimizer(CMP_LR))
    losses = [float(step(*ctx["batches"][s % CMP_BATCHES]))
              for s in range(CMP_RETRAIN_STEPS)]
    me = model["emb"]
    leaked = bool(((me.w != 0) & (me.mask == 0)).any())
    kept = float(me.mask.mean())
    print(f"[train_compressed] pep -> pep_to_retrain: {kept:.4f} of the "
          f"elements kept; {CMP_RETRAIN_STEPS} retrain steps, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; a masked weight moved: "
          f"{leaked}")
    check(all(np.isfinite(losses)) and not leaked,
          "the PEP retrain moved a masked weight")
    return dict(kept=kept, retrain_losses=losses)


def _flow_autodim(ctx, model):
    """AutoDim's bi-level trainer on the trained model (weights on train
    batches, arch on a validation batch), then its retrain form."""
    from hetu_tpu_torch import embedding_compress as ec
    from hetu_tpu_torch.optim import AdamOptimizer
    emb, batches = model["emb"], ctx["batches"]
    trainer = ec.AutoDimBiLevelTrainer(
        emb, lambda p, b: compressed_loss(model, *b)[0], embed_key="emb",
        weight_opt=AdamOptimizer(CMP_LR), alpha_lr=5e-2)
    arch0 = emb.arch.detach().clone()
    _, tl, vl = trainer.fit(dict(model.named_parameters()),
                            batches[:CMP_FLOW_STEPS], batches[CMP_FLOW_STEPS:])
    r = trainer.finalize()
    print(f"[train_compressed] AutoDimBiLevelTrainer: {len(tl)} weight and "
          f"{len(vl)} arch steps, train {' '.join(f'{x:.4f}' for x in tl)}, "
          f"val {' '.join(f'{x:.4f}' for x in vl)}; arch "
          f"{[round(float(a), 5) for a in emb.arch.detach()]}; finalize: dim "
          f"{int(r.dim)}, t {tuple(r.t.shape)}")
    check(all(np.isfinite(tl + vl)) and not torch.equal(emb.arch, arch0)
          and r.t.shape[1] == int(r.dim), "the AutoDim flow failed")
    return dict(dim=int(r.dim), losses=tl, val_losses=vl)


def _flow_optembed(ctx, model):
    """OptEmbed's flow on the trained model: supernet steps, a short
    evolutionary search over the fields' dims (fitness: a batch's loss of
    the masked rows + 1e-3 per kept dim), the retrain form."""
    from hetu_tpu_torch import embedding_compress as ec
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.optim import AdamOptimizer
    emb, batches = model["emb"], ctx["batches"]
    flow = ec.OptEmbedFlow(emb, lambda p, b: compressed_loss(model, *b)[0],
                           embed_key="emb", weight_opt=AdamOptimizer(CMP_LR))
    _, losses = flow.train_supernet(dict(model.named_parameters()),
                                    batches[:CMP_FLOW_STEPS])
    ids, y = batches[-1]

    @torch.no_grad()
    def fitness(cand):
        rows = emb(ids) * ec.OptEmbedFlow.field_mask(
            cand, emb.dim, device=ids.device)
        logit = model["head"](rows.reshape(rows.shape[0], -1))[:, 0]
        return float(ops.binary_cross_entropy_with_logits(logit, y).mean()) \
            + 1e-3 * float(np.sum(cand))
    best, fit = ec.OptEmbedFlow.evolutionary_search(
        fitness, n_fields=CTR_F, dim=emb.dim, generations=CMP_GENERATIONS,
        seed=ctx["seed"])
    r = flow.finalize(best)
    kept = float(r.row_mask.mean())
    print(f"[train_compressed] OptEmbedFlow: supernet losses "
          f"{' '.join(f'{x:.1f}' for x in losses)} (with the threshold "
          f"regulariser); {CMP_GENERATIONS}-generation search: best fitness "
          f"{fit:.4f}, field dims {best.tolist()}; finalize: {kept:.4f} of "
          f"the rows kept")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0]
          and np.isfinite(fit), "the OptEmbed flow failed")
    return dict(supernet_losses=losses, best=best.tolist(), rows_kept=kept)


# what follows a method's timed steps, on its trained model
_CMP_AFTER = {"full": _serve_full, "dpq": _serve_dpq, "prune": _serve_prune,
              "pep": _retrain_pep, "autodim": _flow_autodim,
              "optembed": _flow_optembed}


def phase_train_compressed(card, seed, device="cuda"):
    """examples/rec_compressed.py's loop for every trainable method of the
    compression zoo and the full table, at the Criteo-Kaggle table (DPQ
    and MGQE cut to 2^22 rows): finite, falling loss, step time, peak
    memory, parameter bytes; the eight storage-compressing methods under
    the full table; one profiled step each; each method in f32 against
    float64; the serving forms, PEP's retrain, a DeepLight schedule, the
    AutoDim and OptEmbed flows.  No kernel of the six launches."""
    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch.optim import AdamOptimizer

    t_phase = time.perf_counter()
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    g = np.random.default_rng(seed + 70)
    sets = {v: [tuple(torch.tensor(a, device=device) for a in b)
                for b in compressed_batches(g, v)]
            for v in (CTR_V, CMP_V_CUT, CMP_F64_V)}
    print(f"[train_compressed] examples/rec_compressed.py's loop: V "
          f"{CTR_V} (dpq, mgqe {CMP_V_CUT}), D {CTR_DIM}, {CTR_F} fields, "
          f"head mlp_tower({CTR_F * CTR_DIM}, ({CMP_HIDDEN},), 1), B "
          f"{CTR_B}, Adam({CMP_LR:g}), {CMP_STEPS} steps over "
          f"{CMP_BATCHES} Zipf(a={CTR_ZIPF_A}) batches, on {device}")
    methods, after = {}, {}
    for i, name in enumerate(CMP_METHODS):
        v = CMP_V_CUT if name in CMP_CUT else CTR_V
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = compressed_model(name, v, CTR_DIM, CTR_F, torch.Generator(
            device=device).manual_seed(seed + 80 + i))
        step = compressed_step_fn(model, AdamOptimizer(CMP_LR))
        _sync(device)
        build_s = time.perf_counter() - t0
        losses, host, dev = [], [], []
        for s in range(CMP_STEPS):
            ids, y = sets[v][s % CMP_BATCHES]
            _sync(device)
            t1 = time.perf_counter()
            if device == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            loss = step(ids, y)
            if device == "cuda":
                ev[1].record()
            _sync(device)
            host.append(time.perf_counter() - t1)
            if device == "cuda":
                dev.append(ev[0].elapsed_time(ev[1]) / 1e3)
            losses.append(float(loss))
        peak = _peak_gib(device)
        nbytes = sum(p.numel() * p.element_size()
                     for p in model["emb"].parameters())
        full_bytes = v * CTR_DIM * 4
        med, lo, hi = _step_stats(host)
        dev_ms = _step_stats(dev)[0] if dev else None
        print(f"[train_compressed] {name}: losses "
              f"{' '.join(f'{x:.4f}' for x in losses)}; step median "
              f"{med:.3f} ms on the host clock (steps 2-{CMP_STEPS}: "
              f"{lo:.3f}-{hi:.3f}), "
              + (f"{dev_ms:.3f} ms by CUDA events" if dev_ms is not None
                 else "CUDA events not measured")
              + f", {CTR_B / med * 1e3:.1f} samples/s; parameters "
              f"{nbytes / 1e9:.4f} GB = {nbytes / full_bytes:.4f} of the "
              f"full table's at V {v}; peak {peak:.3f} GiB; built in "
              f"{build_s:.1f} s [{card}]")
        check(all(np.isfinite(losses)), f"{name}: a loss is not finite")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall")
        busy = None
        if device == "cuda":  # one more step, profiled
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(*sets[v][0])
                _sync(device)
            busy = _profile_table(prof, f"train_compressed {name} step",
                                  card, med * 1e3)
        methods[name] = dict(vocab=v, losses=losses, step_ms=med,
                             step_spread_ms=(lo, hi), device_step_ms=dev_ms,
                             samples_per_s=CTR_B / med * 1e3, peak_gib=peak,
                             param_bytes=nbytes, full_bytes=full_bytes,
                             busy_share=busy)
        del step
        if name in _CMP_AFTER:
            after[name] = _CMP_AFTER[name](dict(
                device=device, seed=seed, batches=sets[v]), model)
        del model
        if device == "cuda":
            torch.cuda.empty_cache()
    for name in CMP_STORAGE:
        check(methods[name]["param_bytes"] < CTR_V * CTR_DIM * 4,
              f"{name} holds no fewer parameter bytes than the full table")
    print(f"[train_compressed] parameter bytes under the full table's "
          f"{CTR_V * CTR_DIM * 4 / 1e9:.3f} GB: "
          + ", ".join(f"{n} {methods[n]['param_bytes'] / 1e9:.4f}"
                      for n in CMP_STORAGE))
    f64 = {}
    for i, name in enumerate(CMP_METHODS):
        model = compressed_model(name, CMP_F64_V, CTR_DIM, CTR_F,
                                 torch.Generator(device=device).manual_seed(
                                     seed + 80 + i))
        ids, y = sets[CMP_F64_V][0]
        f64[name] = compressed_f32_vs_f64(name, model, ids, y)
        del model
    launches = [c.launches for c in counters]
    print(f"[train_compressed] launches of the six kernels {launches}; "
          f"phase took {time.perf_counter() - t_phase:.1f} s")
    check(launches == [0] * 6,
          "the compression path launched a port kernel")
    return dict(launches=launches, methods=methods, f64=f64, after=after)


# ------------------------------------------------------------------- CTR

def ctr_batch(g, b, vocab):
    """``(dense_x [b, 13] f32, ids [b, 26] int32, labels [b] f32)`` drawn as
    bench.py bench_ctr draws them: ids, then dense features, then labels."""
    ids = g.integers(0, vocab, (b, CTR_F)).astype(np.int32)
    dx = g.standard_normal((b, CTR_DENSE)).astype(np.float32)
    y = g.integers(0, 2, b).astype(np.float32)
    return dx, ids, y


def zipf_ids(g, shape, vocab, a=CTR_ZIPF_A):
    """Zipf-skewed ids in [0, vocab): numpy's Zipf(a) draws, clipped to
    vocab, minus one, so id 0 is the most frequent."""
    return (np.minimum(g.zipf(a, shape), vocab) - 1).astype(np.int32)


def sgd_row_tolerance(grads, ids, touched, rows, lr):
    """The bound the kernel-vs-plain gate holds the touched table rows to
    after one sparse SGD step, ``[len(touched), D]`` f64, computed over the
    touched rows only (never ``[V, D]``).

    ``touched`` (ascending) are the distinct ids of ``ids``; ``grads [N,
    D]`` the step's row gradients; ``rows`` the touched rows before the
    step.  A row with at most two sources sums bitwise alike on both paths
    (a + b is the same in either order), so its bound is 0.  A row of n > 2
    sources with magnitudes S = sum |g| sums within (n - 1) 2^-24 S of the
    exact sum on each path, 2 (n - 1) 2^-24 S apart (the bound of a
    sequential f32 sum, as ``TOL_GATES``' note states); the update ``p +
    ((p - lr g) - p)`` carries lr times that into the row and adds four
    roundings of at most 2^-24 of |p| + 2 lr S each."""
    flat = ids.reshape(-1).to(touched.dtype)
    pos = torch.searchsorted(touched, flat)
    u, d = touched.numel(), grads.shape[-1]
    n = torch.bincount(pos, minlength=u).double()[:, None]
    s = torch.zeros(u, d, dtype=torch.float64, device=grads.device) \
        .index_add_(0, pos, grads.reshape(-1, d).double().abs())
    tol = lr * 2 * (n - 1) * 2 ** -24 * s \
        + 2 ** -22 * (rows.double().abs() + 2 * lr * s)
    return torch.where(n > 2, tol, 0.0)


def ctr_roofline(b):
    """bench.py bench_ctr's roofline (bench.py:391-395) with H100 figures:
    (bytes, flops, seconds) of three row passes of B · 26 · 16 f32 (gather
    read, sparse update read and write) over the HBM rate, plus the MLP's
    forward and backward FLOPs over the dense bf16 peak, as bench_ctr
    counts them."""
    row_bytes = 3.0 * b * CTR_F * CTR_DIM * 4
    in_dim = CTR_F * CTR_DIM + CTR_DENSE
    mlp_flops = 2.0 * b * (in_dim * CTR_HIDDEN[0] + CTR_HIDDEN[0]
                           * CTR_HIDDEN[1] + CTR_HIDDEN[1]) * 3
    return row_bytes, mlp_flops, \
        row_bytes / H100_BYTES_PER_S + mlp_flops / H100_BF16_FLOP_S


def _recording_sgd(lr):
    """SGD(lr) whose sparse path keeps the last IndexedSlices it was given
    (the step's row gradients, before deduplication)."""
    from hetu_tpu_torch.optim import SGDOptimizer

    class RecordingSGD(SGDOptimizer):
        slices = None

        def apply_indexed(self, p, slices, slots, lr, step):
            self.slices = slices
            return super().apply_indexed(p, slices, slots, lr, step)
    return RecordingSGD(lr)


def _ctr_step_once(model, batch, plain):
    """One sparse SGD step from the model's state: the kernel path, or the
    plain path (``emb_impl="xla"`` and deduplicate's segment sum by the
    scatter-add's plain version, ``index_add_``).  Returns ``(loss tensor,
    row gradients, their ids)``."""
    import hetu_tpu_torch.ops.cuda_kernels as ck
    opt = _recording_sgd(CTR_LR)
    step = model.sparse_step_fn(opt)
    if not plain:
        loss, _ = step(*batch)
    else:
        saved = model.emb.impl, ck.embedding_scatter_add
        model.emb.impl = "xla"
        ck.embedding_scatter_add = ck.embedding_scatter_add_plain
        try:
            loss, _ = step(*batch)
        finally:
            model.emb.impl, ck.embedding_scatter_add = saved
    return loss, opt.slices.values, opt.slices.indices


def _ctr_kernel_vs_plain(model, batch, tag, gen):
    """The kernel path against the plain path, one step each from the same
    state, restored after each (only the touched rows and the dense
    parameters are kept: never a second table).  Returns the gate's
    readings."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add,
    )
    table = model.emb.weight
    dev = table.device
    ids = batch[1]
    touched = torch.unique(ids.reshape(-1))
    net = dict(model.net.named_parameters())
    cand = torch.randint(0, table.shape[0], (2 * CTR_UNTOUCHED_SAMPLE,),
                         generator=gen, device=dev)
    touched_rows = touched.long()
    untouched = cand[~torch.isin(cand, touched_rows)][:CTR_UNTOUCHED_SAMPLE]
    with torch.no_grad():
        rows0, others0 = table[touched_rows].clone(), table[untouched].clone()
        net0 = {n: p.detach().clone() for n, p in net.items()}

    def restore():
        with torch.no_grad():
            table[touched_rows] = rows0
            for n, p in net.items():
                p.copy_(net0[n])

    out, launches = {}, {}
    for path in ("kernel", "plain"):
        embedding_gather.launches = embedding_scatter_add.launches = 0
        loss, grads, gids = _ctr_step_once(model, batch, path == "plain")
        _sync(dev.type)
        launches[path] = (embedding_gather.launches,
                          embedding_scatter_add.launches)
        with torch.no_grad():
            out[path] = (loss, table[touched_rows].clone(),
                         {n: p.detach().clone() for n, p in net.items()})
            if path == "kernel":
                kept = tolerance_share(table[untouched], others0)
                tol = sgd_row_tolerance(grads, gids, touched, rows0, CTR_LR)
        restore()
    (loss_k, rows_k, net_k), (loss_p, rows_p, net_p) = out["kernel"], \
        out["plain"]
    runs = torch.bincount(torch.searchsorted(touched, ids.reshape(-1)))
    loss_share = tolerance_share(loss_k, loss_p)
    net_share = max(tolerance_share(net_k[n], net_p[n]) for n in net)
    row_share = tolerance_share(rows_k, rows_p, tol)
    bitwise_rows = tolerance_share(rows_k, rows_p) == 0.0
    print(f"[train_ctr] kernel path vs plain path, one step ({tag}: "
          f"{ids.numel()} ids, {touched.numel()} distinct, longest run "
          f"{int(runs.max())}, {int((runs > 2).sum())} rows of more than two "
          f"sources): loss {float(loss_k):.7f} vs {float(loss_p):.7f} "
          f"({'bitwise' if loss_share == 0 else 'DIFFERS'}); dense "
          f"parameters {'bitwise' if net_share == 0 else 'DIFFER'}; touched "
          f"rows share of the sum bound used {row_share:.3g} "
          f"({'bitwise' if bitwise_rows else 'not bitwise'}); "
          f"{untouched.numel()} untouched rows "
          f"{'unchanged' if kept == 0 else 'CHANGED'}; launches (gather, "
          f"scatter-add) kernel path {launches['kernel']}, plain path "
          f"{launches['plain']}")
    check(np.isfinite(float(loss_k)), f"the CTR loss is not finite ({tag})")
    check(loss_share == 0.0, f"kernel path loss differs from the plain "
                             f"path's ({tag})")
    check(net_share == 0.0, f"kernel path dense parameters differ from the "
                            f"plain path's ({tag})")
    check(row_share <= 1.0, f"kernel path table rows outside the bound of "
                            f"a sequential f32 sum ({tag})")
    check(kept == 0.0, f"the kernel path changed an untouched row ({tag})")
    check(launches["plain"] == (0, 0), "the plain CTR path launched a kernel")
    check(launches["kernel"] == (1, 1),
          f"the CTR step did not launch 1 gather and 1 scatter-add "
          f"({tag}: {launches['kernel']})")
    return dict(row_share=row_share, bitwise_rows=bitwise_rows,
                longest_run=int(runs.max()), distinct=touched.numel())


def _ctr_kernel_timings(card, table, grads, ids, zipf, gen):
    """The gather and the deduplicate sum at the CTR step's shapes: each
    kernel against its plain version (the deduplicate sum bitwise against
    the CPU's sequential sum, which adds in the kernel's order), then timed
    beside its plain version, the PyTorch call and the bound.  The gather
    cycles through CTR_GATHER_SETS batches of ids, so that its rows come
    cold from HBM, as a new batch finds them (its hot reading, the same ids
    every call, is printed too)."""
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_gather_plain, embedding_scatter_add,
        embedding_scatter_add_plain,
    )
    from hetu_tpu_torch.ops.embedding import IndexedSlices
    v, d = table.shape
    n = ids.numel()
    flat = ids.reshape(-1)
    for tag, id_set in (("uniform", flat), ("zipf", zipf.reshape(-1))):
        got = embedding_gather(table, id_set)
        check(tolerance_share(got, embedding_gather_plain(table, id_set))
              == 0.0, f"embedding_gather disagrees with its plain version "
                      f"at the CTR shape ({tag})")
        sl = IndexedSlices(id_set, grads, (v, d))
        dd = sl.deduplicate()
        ref = IndexedSlices(id_set.cpu(), grads.cpu(), (v, d)).deduplicate()
        ok = tolerance_share(dd.values.cpu(), ref.values) == 0.0 \
            and tolerance_share(dd.indices.cpu(), ref.indices) == 0.0
        print(f"[train_ctr] at the CTR shape ({tag} ids): gather bitwise its "
              f"plain version; deduplicate {'bitwise' if ok else 'DIFFERS'} "
              f"against the CPU's sequential sum")
        check(ok, f"deduplicate's scatter-add disagrees with the sequential "
                  f"sum at the CTR shape ({tag})")
    sets = [flat] + [torch.randint(0, v, (n,), generator=gen,
                                   device=table.device, dtype=torch.int32)
                     for _ in range(CTR_GATHER_SETS - 1)]
    cycle = itertools.cycle(sets)
    gather = dict(
        ms=device_ms(lambda: embedding_gather(table, next(cycle)), 64),
        plain_ms=device_ms(lambda: embedding_gather_plain(table,
                                                          next(cycle)), 32),
        library_ms=device_ms(lambda: torch.index_select(table, 0,
                                                        next(cycle)), 64),
        hot_ms=device_ms(lambda: embedding_gather(table, flat), 64),
        hot_library_ms=device_ms(lambda: torch.index_select(table, 0, flat),
                                 64),
        bound_ms=gather_bound(table, flat), bound_by="bytes",
        max_abs_err=0.0)
    print(f"[train_ctr] embedding_gather table [{v}, {d}] f32, {n} ids "
          f"(cold rows): kernel {gather['ms']:.4f} ms, plain "
          f"{gather['plain_ms']:.4f} ms, index_select (yardstick only) "
          f"{gather['library_ms']:.4f} ms, bound {gather['bound_ms']:.5f} ms "
          f"(bytes); the same ids every call: kernel {gather['hot_ms']:.4f} "
          f"ms, index_select {gather['hot_library_ms']:.4f} ms [{card}]")
    scatter = {}
    for tag, id_set in (("uniform", flat), ("zipf", zipf.reshape(-1))):
        sidx, order = torch.sort(id_set, stable=True)
        svals = grads[order]
        first = torch.ones(n, dtype=torch.bool, device=table.device)
        first[1:] = sidx[1:] != sidx[:-1]
        seg = torch.cumsum(first, 0, dtype=torch.int32) - 1
        sl = IndexedSlices(id_set, grads, (v, d))
        m = dict(
            ms=device_ms(lambda: embedding_scatter_add(svals, seg, n), 40),
            plain_ms=device_ms(lambda: embedding_scatter_add_plain(
                svals, seg, n), 40),
            library_ms=device_ms(lambda: torch.zeros(
                n, d, device=table.device).index_add_(0, seg, svals), 40),
            bound_ms=scatter_bound(svals, seg, n), bound_by="bytes",
            deduplicate_ms=device_ms(sl.deduplicate, 20),
            longest_run=int(torch.bincount(seg).max()), max_abs_err=0.0)
        m["split"] = _scatter_split(card, {f"deduplicate ({tag} ids)":
                                           (svals, seg, n)}, "train_ctr")
        scatter[tag] = m
        print(f"[train_ctr] deduplicate's scatter-add ({tag} ids, {n} rows "
              f"of {d} f32, longest run {m['longest_run']}): kernel "
              f"{m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, index_add_ "
              f"(yardstick only) {m['library_ms']:.4f} ms, bound "
              f"{m['bound_ms']:.5f} ms (bytes); the whole deduplicate "
              f"{m['deduplicate_ms']:.4f} ms [{card}]")
    return gather, scatter


def phase_train_ctr(card, seed, device="cuda"):
    """Device-resident Wide & Deep at bench_ctr's widths (a [33M, 16] f32
    table on the card, B 2048, SGD): the kernel path against the plain path
    on a uniform and a Zipf batch, 10 sparse steps on one batch, the masked
    step over BucketedLoader's buckets, the kernels at the step's shapes."""
    from torch.profiler import ProfilerActivity, profile

    from hetu_tpu_torch.data.bucketing import BucketedLoader
    from hetu_tpu_torch.models import WideDeepDevice
    from hetu_tpu_torch.ops.cuda_kernels import (
        embedding_gather, embedding_scatter_add,
    )
    from hetu_tpu_torch.optim import SGDOptimizer

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = WideDeepDevice(CTR_V, CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN,
                           emb_impl="auto", generator=gen, device=device)
    g = np.random.default_rng(seed)
    batch = tuple(torch.tensor(a, device=device)
                  for a in ctr_batch(g, CTR_B, CTR_V))
    zipf = torch.tensor(zipf_ids(g, (CTR_B, CTR_F), CTR_V), device=device)
    _sync(device)
    table_gb = model.emb.weight.numel() * 4 / 1e9
    print(f"[train_ctr] WideDeepDevice V={CTR_V} fields={CTR_F} "
          f"dim={CTR_DIM} dense={CTR_DENSE} hidden={CTR_HIDDEN} f32, table "
          f"{table_gb:.3f} GB drawn on the {device}, B={CTR_B}, "
          f"SGD({CTR_LR:g}): built in {time.perf_counter() - t0:.1f} s")

    gates = {"uniform": _ctr_kernel_vs_plain(model, batch, "uniform ids",
                                             gen),
             "zipf": _ctr_kernel_vs_plain(model, (batch[0], zipf, batch[2]),
                                          f"Zipf a={CTR_ZIPF_A} ids", gen)}

    step = model.sparse_step_fn(SGDOptimizer(CTR_LR))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    embedding_gather.launches = embedding_scatter_add.launches = 0
    losses, times = [], []
    for _ in range(CTR_STEPS):
        _sync(device)
        t1 = time.perf_counter()
        loss, _ = step(*batch)
        losses.append(float(loss))
        _sync(device)
        times.append(time.perf_counter() - t1)
    launches = [embedding_gather.launches, embedding_scatter_add.launches]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    print(f"[train_ctr] losses: {' '.join(f'{x:.5f}' for x in losses)}")
    check(all(np.isfinite(losses)), "a CTR training loss is not finite")
    check(losses[-1] < losses[0], "the CTR loss did not fall")
    print(f"[train_ctr] launches in {CTR_STEPS} steps: embedding_gather "
          f"{launches[0]}, embedding_scatter_add {launches[1]} (expected "
          f"{CTR_STEPS} each)")
    check(launches == [CTR_STEPS, CTR_STEPS], "the CTR step did not launch "
                                              "1 gather and 1 scatter-add")
    limit = model.emb.weight.numel() * 4 + 1e9
    print(f"[train_ctr] peak allocated over the timed steps "
          f"{peak / 1e9:.3f} GB (table {table_gb:.3f} GB; limit "
          f"{limit / 1e9:.3f} GB) [{card}]")
    check(peak < limit, "the CTR step allocated a table-sized tensor")
    med, lo, hi = _step_stats(times)
    row_bytes, mlp_flops, roof_s = ctr_roofline(CTR_B)
    print(f"[train_ctr] step median {med:.3f} ms (steps 2-{CTR_STEPS}: "
          f"{lo:.3f}-{hi:.3f} ms; first {times[0] * 1e3:.3f} ms), "
          f"{CTR_B / med * 1e3:.1f} samples/s; bench_ctr's roofline "
          f"({row_bytes / 1e6:.2f} MB of rows at 3.35 TB/s + "
          f"{mlp_flops / 1e9:.3f} GFLOP at 989 TFLOP/s = "
          f"{roof_s * 1e3:.5f} ms, {CTR_B / roof_s:.4g} samples/s): "
          f"{100 * roof_s * 1e3 / med:.3f} % reached [{card}]")

    masked = model.masked_step_fn(SGDOptimizer(CTR_LR))
    loader = BucketedLoader((ctr_batch(g, n, CTR_V)
                             for n in CTR_MASKED_SIZES), CTR_B)
    embedding_gather.launches = embedding_scatter_add.launches = 0
    masked_losses, buckets = [], []
    for dx, ids, y, n_valid in loader:
        loss, _ = masked(dx, ids, y, n_valid)
        masked_losses.append(float(loss))
        buckets.append((n_valid, dx.shape[0]))
    masked_launches = (embedding_gather.launches,
                       embedding_scatter_add.launches)
    print(f"[train_ctr] masked steps (n_valid, bucket) {buckets}: losses "
          f"{' '.join(f'{x:.5f}' for x in masked_losses)}; launches "
          f"{masked_launches}")
    check(all(np.isfinite(masked_losses)), "a masked CTR loss is not finite")
    check(masked_launches == (len(buckets),) * 2,
          "the masked CTR step did not launch 1 gather and 1 scatter-add")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, _ = step(*batch)
        float(loss)
        _sync(device)
    busy = _profile_table(prof, "train_ctr step", card, med * 1e3)

    opt = _recording_sgd(CTR_LR)
    model.sparse_step_fn(opt)(*batch)
    gather, scatter = _ctr_kernel_timings(
        card, model.emb.weight.detach(), opt.slices.values,
        batch[1], zipf, gen)
    return dict(launches=launches, step_ms=med, step_spread_ms=(lo, hi),
                samples_per_s=CTR_B / med * 1e3, peak_gb=peak / 1e9,
                busy_share=busy, losses=losses, gates=gates,
                roofline_share=roof_s * 1e3 / med, gather=gather,
                scatter=scatter)


def synthetic_ctr(n, fields, dense, vocab, seed):
    """examples/ctr_wdl.py's Criteo-shaped synthetic clickstream: clicks
    correlate with a few hidden field weights and the dense features."""
    g = np.random.default_rng(seed)
    sparse = g.integers(0, vocab, (n, fields)).astype(np.int64)
    dense_x = g.standard_normal((n, dense)).astype(np.float32)
    w_hidden = g.standard_normal(fields)
    logit = (sparse % 7 - 3) @ w_hidden * 0.2 + dense_x[:, :3].sum(-1) * 0.5
    y = (logit + g.standard_normal(n) > 0).astype(np.float32)
    return sparse, dense_x, y


@contextlib.contextmanager
def van_servers(n, ready_s=VAN_READY_S):
    """``n`` van servers, each in a process of its own (a process runs one
    van server), importing the port's ``ps.van`` and nothing of JAX; yields
    their ``[(host, port), ...]`` once each has printed READY, within
    ``ready_s`` in all.  A server lives until its standard input closes:
    killed on the way out, and gone with this process if it dies."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _VAN_SERVER_SRC, root],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        deadline = time.monotonic() + ready_s
        ports = []
        for proc in procs:
            left = deadline - time.monotonic()
            ready = select.select([proc.stdout], [], [], max(left, 0))[0]
            check(bool(ready), f"a van server did not start within "
                               f"{ready_s:g} s")
            line = proc.stdout.readline()
            check(line.startswith("READY"), f"a van server failed to start "
                                            f"(exit {proc.poll()}): {line!r}")
            ports.append(int(line.split()[1]))
        yield [("127.0.0.1", port) for port in ports]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=30)


def _server_bytes(eps):
    """Bytes the van servers at ``eps`` received and sent so far."""
    from hetu_tpu_torch.ps import van
    stats = [van.stats(host, port) for host, port in eps]
    return (sum(st["bytes_rx"] for st in stats),
            sum(st["bytes_tx"] for st in stats))


def _client_van_bytes():
    """``{op: bytes}`` of the van client ops recorded so far."""
    from hetu_tpu_torch.ps import van
    return {op: d.get("bytes", 0) for op, d in van.op_stats().items()
            if "bytes" in d}


def _ps_ctr_arm(name, emb, kw, batch_at, card, device, seed, record=None,
                probe=None):
    """``examples/ctr_wdl.py``'s pipeline (prefetch, pull, step, push) for
    CTR_PS_STEPS steps on ``emb``; with ``record`` (a list), each push's
    (ids, row gradients) is appended to it; ``probe()`` is read just
    before the steps and just after them (``probes`` in the result)."""
    from hetu_tpu_torch.models import WideDeep
    from hetu_tpu_torch.optim import AdamOptimizer

    t0 = time.perf_counter()
    model = WideDeep(CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN,
                     generator=torch.Generator(device=device).manual_seed(
                         seed), device=device)
    step = model.hybrid_step_fn(AdamOptimizer(CTR_PS_LR))
    built = time.perf_counter() - t0
    losses, pulls, steps, pushes = [], [], [], []
    probes = [probe()] if probe else []
    emb.prefetch(batch_at(0)[0])
    for it in range(CTR_PS_STEPS):
        ids, dx, yy = batch_at(it)
        t1 = time.perf_counter()
        rows = emb.pull_prefetched()
        t2 = time.perf_counter()
        loss, _, g_rows = step(dx, rows, yy)
        losses.append(float(loss))
        t3 = time.perf_counter()
        emb.push(ids, g_rows)
        t4 = time.perf_counter()
        if record is not None:
            record.append((ids.copy(),
                           g_rows.detach().float().cpu().numpy()))
        if it + 1 < CTR_PS_STEPS:
            emb.prefetch(batch_at(it + 1)[0])
        pulls.append(t2 - t1)
        steps.append(t3 - t2)
        pushes.append(t4 - t3)
    probes += [probe()] if probe else []
    emb.flush()
    t5 = time.perf_counter()
    emb.pull(batch_at(0)[0])
    raw_pull = time.perf_counter() - t5
    hit = emb.cache.hit_rate if emb.cache is not None else None
    ms = {k: statistics.median(v[1:]) * 1e3 for k, v in
          (("pull", pulls), ("step", steps), ("push", pushes))}
    total = ms["pull"] + ms["step"] + ms["push"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    cache = (f", cache {kw['cache_capacity']} {kw['cache_policy']}"
             if hit is not None else "")
    print(f"[ps_ctr] {name}: PSEmbedding({CTR_PS_V}, {CTR_DIM}, "
          f"{kw['optimizer']}, lr {kw['lr']:g}{cache}) + WideDeep hidden "
          f"{CTR_HIDDEN} Adam({CTR_PS_LR:g}), B {CTR_B}, built in "
          f"{built:.1f} s; losses {' '.join(f'{x:.4f}' for x in losses)}")
    print(f"[ps_ctr] {name}: medians of steps 2-{CTR_PS_STEPS}: pull "
          f"(waited on the prefetch) {ms['pull']:.3f} ms, step (copy in, "
          f"forward, backward, Adam) {ms['step']:.3f} ms, push "
          f"{ms['push']:.3f} ms; {CTR_B / total * 1e3:.1f} samples/s; a "
          f"pull not overlapped {raw_pull * 1e3:.3f} ms"
          f"{'; hit rate %.4f' % hit if hit is not None else ''} [{card}]")
    check(all(np.isfinite(losses)), f"a ps_ctr loss is not finite ({name})")
    check(last < first, f"the ps_ctr loss did not fall ({name}: mean of "
                        f"the first five {first:.4f}, of the last five "
                        f"{last:.4f})")
    if hit is not None:
        check(hit > 0, f"the HET cache never hit ({name})")
    run = dict(ms, samples_per_s=CTR_B / total * 1e3,
               raw_pull_ms=raw_pull * 1e3, hit_rate=hit, losses=losses)
    if probe:
        run["probes"] = probes
    return run


def _ps_replay(eps, initial, pushes, final):
    """The replay gate of the remote tier: a table partitioned over the
    servers at ``eps`` takes the in-process arm's initial rows
    (``sparse_set``) and its recorded pushes (sgd, the arm's lr), and must
    then equal the in-process table within rtol 1e-6
    (``tests/test_ps_multiserver.py``'s bound)."""
    from hetu_tpu_torch.ps import PartitionedPSTable
    t0 = time.perf_counter()
    table = PartitionedPSTable(eps, CTR_PS_V, CTR_DIM, init="zeros",
                               optimizer="sgd", lr=CTR_PS_SGD_LR)
    try:
        chunk = 1 << 17
        for lo in range(0, CTR_PS_V, chunk):
            ids = np.arange(lo, min(lo + chunk, CTR_PS_V))
            table.sparse_set(ids, initial[ids])
        for ids, grads in pushes:
            table.sparse_push(ids, grads)
        got = np.concatenate([
            table.sparse_pull(np.arange(lo, min(lo + chunk, CTR_PS_V)))
            for lo in range(0, CTR_PS_V, chunk)])
        starts = table.shard_starts
    finally:
        table.close()
    bitwise = int((got.view(np.int32) == final.view(np.int32)).all(-1).sum())
    err = np.abs(got - final) / np.maximum(np.abs(final), 1e-30)
    worst = float(err.max())
    print(f"[ps_ctr] replay: {len(pushes)} pushes of the in-process sgd arm "
          f"replayed on a table partitioned over {len(eps)} servers (shards "
          f"start at {starts}) after sparse_set of its initial rows: "
          f"{bitwise} of {CTR_PS_V} rows bitwise equal to the in-process "
          f"table, max relative difference {worst:.3e} (rtol 1e-6); "
          f"{time.perf_counter() - t0:.1f} s")
    check(bool(np.all(np.abs(got - final) <= 1e-6 * np.abs(final))),
          "the partitioned table's replay disagrees with the in-process "
          "table")
    return dict(bitwise_rows=bitwise, max_rel=worst)


def phase_ps_ctr(card, seed, device="cuda"):
    """Wide & Deep on PSEmbedding rows through examples/ctr_wdl.py's
    pipeline (prefetch, pull, step, push) at B 2048: in process, once on
    bench_ctr's PS leg (1M rows, sgd, no cache) and once behind the HET
    cache (adagrad, lfuopt, 131072 rows); then on a table key-range-
    partitioned over two van servers in two other processes, without and
    with the remote HET cache; and the in-process sgd arm's pushes
    replayed on the partitioned table, which must then equal it."""
    from hetu_tpu_torch.ps import PSEmbedding

    sparse, dense_x, y = synthetic_ctr(CTR_B * 64, CTR_F, CTR_DENSE,
                                       CTR_PS_V, seed)
    n = sparse.shape[0]

    def batch_at(it):
        lo = (it * CTR_B) % (n - CTR_B)
        return sparse[lo:lo + CTR_B], dense_x[lo:lo + CTR_B], \
            y[lo:lo + CTR_B]

    sgd = dict(optimizer="sgd", lr=CTR_PS_SGD_LR)
    het = dict(optimizer="adagrad", lr=0.05, cache_capacity=CTR_PS_CACHE,
               cache_policy="lfuopt", pull_bound=0)
    out = {}
    pushes = []
    for name, kw in (("no cache", sgd), ("HET cache", het)):
        emb = PSEmbedding(CTR_PS_V, CTR_DIM, seed=seed,
                          pin_memory=device == "cuda", **kw)
        record = pushes if name == "no cache" else None
        if record is not None:
            initial = emb.table.dense_pull()
        try:
            out[name] = _ps_ctr_arm(name, emb, kw, batch_at, card, device,
                                    seed, record)
            if record is not None:
                final = emb.table.dense_pull()
        finally:
            emb.close()
    with van_servers(VAN_SERVERS) as eps:
        for name, kw in (("remote: 2 servers", sgd),
                         ("remote: HET cache", het)):
            t0 = time.perf_counter()
            emb = PSEmbedding(CTR_PS_V, CTR_DIM, seed=seed, endpoints=eps,
                              pin_memory=device == "cuda", **kw)
            made = time.perf_counter() - t0
            check(emb.table.n_servers == VAN_SERVERS,
                  f"the table is not partitioned over {VAN_SERVERS} servers")
            try:
                run = _ps_ctr_arm(
                    name, emb, kw, batch_at, card, device, seed,
                    probe=lambda: (_server_bytes(eps), _client_van_bytes()))
            finally:
                emb.close()
            ((rx0, tx0), ops0), ((rx1, tx1), ops1) = run.pop("probes")
            ops = {op: (b - ops0.get(op, 0)) / CTR_PS_STEPS
                   for op, b in ops1.items()
                   if op.startswith("group_") and b > ops0.get(op, 0)}
            run.update(table_ms=made * 1e3,
                       server_rx_per_step=(rx1 - rx0) / CTR_PS_STEPS,
                       server_tx_per_step=(tx1 - tx0) / CTR_PS_STEPS,
                       van_bytes_per_step=ops)
            print(f"[ps_ctr] {name}: the partitioned table ({CTR_PS_V} x "
                  f"{CTR_DIM} f32 over {VAN_SERVERS} servers) made in "
                  f"{made * 1e3:.1f} ms; a step moved "
                  f"{run['server_rx_per_step'] / 1e6:.3f} MB to the servers "
                  f"and {run['server_tx_per_step'] / 1e6:.3f} MB back "
                  f"(their transport counters); client van ops a step: "
                  + (", ".join(f"van.{op}.bytes {b / 1e6:.3f} MB"
                               for op, b in sorted(ops.items()))
                     or "none (the remote HET cache's native calls)")
                  + f" [{card}]")
            out[name] = run
        out["replay"] = _ps_replay(eps, initial, pushes, final)
    return out


# ---------------------------------------------------------------- recsys

def recsys_jax_layout_weights(seed, model) -> dict:
    """``model``'s parameters as the JAX package's tree (a Linear's weight
    ``[in, out]``), drawn with numpy from ``seed`` leaf by leaf in the
    tree's sorted order: Xavier-uniform weights, normal(0, 0.01) biases."""
    from hetu_tpu_torch import interop

    g = np.random.default_rng([seed, 24])

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        shape = np.shape(node)
        if len(shape) == 2:
            lim = np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
            return (g.random(shape, dtype=np.float32) * 2 - 1) * lim
        return 0.01 * g.standard_normal(shape, dtype=np.float32)
    return draw(interop.params_to_jax(model.state_dict(), model))


def recsys_model(seed, device):
    """train_ctr's Wide & Deep tower (26 fields, emb dim 16, 13 dense,
    hidden (256, 256)), f32 on ``device``, its weights
    :func:`recsys_jax_layout_weights` loaded through ``interop``."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import WideDeep

    model = WideDeep(CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN,
                     generator=torch.Generator(device=device).manual_seed(
                         seed), device=device)
    model.load_state_dict(interop.params_from_jax(
        recsys_jax_layout_weights(seed, model), model))
    return model


def _recsys_f64(model64, dense, rows):
    """CTR probabilities of a float64 CPU forward."""
    with torch.no_grad():
        logit = model64(torch.from_numpy(dense).double(),
                        torch.from_numpy(rows).double())
    return torch.sigmoid(logit).numpy()


def _recsys_cache(table, capacity, cls=None):
    from hetu_tpu_torch.serve.recsys import ServingEmbeddingCache
    from hetu_tpu_torch.telemetry.registry import MetricsRegistry
    return (cls or ServingEmbeddingCache)(
        table, capacity, pull_bound=RECSYS_PULL_BOUND, policy="lru",
        registry=MetricsRegistry())


def _recsys_engine(model, cache, device):
    from hetu_tpu_torch.serve.recsys import RecsysEngine
    return RecsysEngine(model, cache, max_batch=RECSYS_MAX_BATCH,
                        min_bucket=RECSYS_MIN_BUCKET, device=device)


def _recsys_requests(g, n):
    """``n`` requests' (dense [n, 13] f32, ids [n, 26] int64): standard-
    normal dense features, Zipf(1.2) ids over the table's rows."""
    ids = zipf_ids(g, (n, CTR_F), RECSYS_V).astype(np.int64)
    return g.standard_normal((n, CTR_DENSE)).astype(np.float32), ids


def _span_medians(events):
    """Median ms of the engine's three spans among ``events``."""
    out = {}
    for part in ("gather", "dispatch", "device_wait"):
        d = [e["dur"] / 1e3 for e in events
             if e.get("name") == f"serve.recsys.{part}" and "dur" in e]
        out[part] = float(np.median(d)) if d else float("nan")
    return out


def _recsys_ab(card, seed, model, table, device):
    """Arm (a): bench_ctr_serve's A/B of the cached engine against the
    cache-less one on the same seeded single requests, in waves through
    ``RecsysBatcher.step``, the variants alternating round by round."""
    from hetu_tpu_torch.serve.recsys import RecsysBatcher, RecsysRequest
    from hetu_tpu_torch.telemetry import trace

    g = np.random.default_rng([seed, 24, 1])
    dense, ids = _recsys_requests(g, RECSYS_REQUESTS)
    v = {name: {"eng": _recsys_engine(model, _recsys_cache(table, cap),
                                      device),
                "cap": cap, "lats": [], "busy": 0.0, "spans": [],
                "scores": np.zeros(RECSYS_REQUESTS, np.float32),
                "status": []}
         for name, cap in (("cached", RECSYS_CACHE), ("cache-less", 0))}
    # one fixed batch of each bucket through both engines: bitwise equal
    # (it also builds every bucket's staging before the timed rounds)
    gb = np.random.default_rng([seed, 24, 2])
    cached, bare = v["cached"]["eng"], v["cache-less"]["eng"]
    for b in cached.buckets:
        bd, bi = _recsys_requests(gb, b)
        x, y = cached.score(bd, bi), bare.score(bd, bi)
        check(np.array_equal(x, y), f"recsys (a): bucket {b}: the cached "
              f"and cache-less engines differ (max |d| "
              f"{np.abs(x - y).max():.3e})")
    for x in v.values():  # measure the replayed traffic only
        x["eng"].close()
        x["eng"].caches = (_recsys_cache(table, x["cap"]),)
        x["sched"] = RecsysBatcher(x["eng"], max_delay_s=0.001)
    per = RECSYS_REQUESTS // RECSYS_ROUNDS
    tracer = trace.enable()
    try:
        for r in range(RECSYS_ROUNDS):
            order = ("cached", "cache-less") if r % 2 == 0 \
                else ("cache-less", "cached")
            for name in order:
                x, n0 = v[name], len(tracer.events)
                t0 = time.perf_counter()
                for lo in range(r * per, (r + 1) * per, RECSYS_WAVE):
                    hi = min(lo + RECSYS_WAVE, (r + 1) * per)
                    wave = [RecsysRequest(dense=dense[i], sparse=ids[i],
                                          timeout_s=60.0)
                            for i in range(lo, hi)]
                    for req in wave:
                        x["sched"].submit(req)
                    while x["sched"].has_work():
                        x["sched"].step()
                    for i, req in zip(range(lo, hi), wave):
                        x["status"].append(req.status)
                        x["scores"][i] = np.nan if req.score is None \
                            else req.score
                        x["lats"].append(req.ttfr_s)
                x["busy"] += time.perf_counter() - t0
                x["spans"] += tracer.events[n0:]
    finally:
        trace.disable()
    model64 = copy.deepcopy(model).to("cpu", torch.float64)
    rows = table.sparse_pull(ids.reshape(-1)).reshape(
        RECSYS_REQUESTS, CTR_F, CTR_DIM)
    p64 = _recsys_f64(model64, dense, rows)
    out = {}
    for name, x in v.items():
        eng, st = x["eng"], x["eng"].caches[0].stats()
        bad = [s for s in x["status"] if s != "ok"]
        check(not bad and len(x["status"]) == RECSYS_REQUESTS,
              f"recsys (a) {name}: {len(bad)} requests not ok: "
              f"{sorted(set(bad))}")
        err = float(np.abs(x["scores"].astype(np.float64) - p64).max())
        check(err <= RECSYS_TOL_F64, f"recsys (a) {name}: max |p - "
              f"p_float64| {err:.3e} > {RECSYS_TOL_F64:g}")
        check(eng.compiled_executables() <= eng.max_executables,
              f"recsys (a) {name}: {eng.compiled_executables()} shapes > "
              f"{eng.max_executables}")
        lats = np.asarray(x["lats"]) * 1e3
        out[name] = dict(
            qps=RECSYS_REQUESTS / x["busy"],
            ttfr_p50_ms=float(np.percentile(lats, 50)),
            ttfr_p99_ms=float(np.percentile(lats, 99)),
            hit_rate=st["hit_rate"], bytes_pulled=st["ps_bytes_pulled"],
            bytes_saved=st["ps_bytes_saved"], max_err=err,
            batches=eng.metrics.count("recsys_batches") - len(eng.buckets),
            shapes=eng.compiled_executables(),
            spans=_span_medians(x["spans"]))
        o = out[name]
        print(f"[recsys] (a) {name}: {RECSYS_REQUESTS} requests in waves of "
              f"{RECSYS_WAVE}, {o['batches']} batches, every response ok; "
              f"QPS {o['qps']:.1f}, TTFR p50 {o['ttfr_p50_ms']:.3f} ms, p99 "
              f"{o['ttfr_p99_ms']:.3f} ms; hit rate {o['hit_rate']:.4f}, PS "
              f"bytes pulled {o['bytes_pulled']}, saved {o['bytes_saved']}; "
              f"median span ms gather {o['spans']['gather']:.3f}, dispatch "
              f"{o['spans']['dispatch']:.3f}, device_wait "
              f"{o['spans']['device_wait']:.3f}; max |p - p_float64| "
              f"{err:.3e} (limit {RECSYS_TOL_F64:g}); {o['shapes']} of "
              f"{eng.max_executables} bucket shapes [{card}]")
        eng.close()
    check(out["cached"]["hit_rate"] > 0, "recsys (a): the cache never hit")
    print(f"[recsys] (a) one fixed batch of each bucket "
          f"{list(cached.buckets)} bitwise equal through both engines; "
          f"cache-less p99 / cached p99 "
          f"{out['cache-less']['ttfr_p99_ms'] / out['cached']['ttfr_p99_ms']:.3f}"
          f" [{card}]")
    return out


def _recsys_wait(cond, what):
    deadline = time.monotonic() + RECSYS_WAIT_S
    while not cond():
        check(time.monotonic() < deadline, f"recsys: {what} within "
                                           f"{RECSYS_WAIT_S:g} s")
        time.sleep(0.005)


def _recsys_pool_arm(card, seed, model, table, device):
    """Arm (b): a two-member RecsysPool over the table while a trainer
    thread writes a version-encoded sentinel row; a member killed, failed
    over and revived; 64 requests over the wire.  Returns the pool (for
    arms (c) and (d)) and the arm's numbers."""
    from hetu_tpu_torch.serve.recsys import (
        RecsysClient, RecsysPool, ServingEmbeddingCache,
    )

    sentinel = RECSYS_V - 1
    published, seen, closes = [0], [], {}

    class SentinelCache(ServingEmbeddingCache):
        """Records, for every lookup of the sentinel, the trainer's count
        of completed sets when the lookup began and the rows served."""

        def lookup(self, indices):
            c0 = published[0]
            rows = super().lookup(indices)
            hit = np.asarray(indices).reshape(-1) == sentinel
            if hit.any():
                seen.append((c0, rows.reshape(-1, CTR_DIM)[hit]))
            return rows

        def close(self):
            closes[id(self)] = closes.get(id(self), 0) + 1
            super().close()

    def factory():
        return _recsys_engine(model, _recsys_cache(table, RECSYS_CACHE,
                                                   SentinelCache), device)

    g = np.random.default_rng([seed, 24, 3])
    pool = RecsysPool({"a": factory, "b": factory}, failover_grace_s=30.0,
                      request_timeout_s=60.0)
    try:
        table.sparse_set([sentinel], np.zeros((1, CTR_DIM), np.float32))
        stop = threading.Event()

        def trainer():
            ver = 0
            while not stop.is_set():
                ver += 1
                table.sparse_set([sentinel],
                                 np.full((1, CTR_DIM), ver, np.float32))
                published[0] = ver  # after the set

        statuses, lock = [], threading.Lock()

        def client(k):
            gc = np.random.default_rng([seed, 24, 4, k])
            while not stop.is_set():
                d, i = _recsys_requests(gc, 1)
                i[0, 0] = sentinel
                r = pool.score(d[0], i[0], timeout_s=60.0)
                with lock:
                    statuses.append(r["status"])

        th = [threading.Thread(target=trainer, daemon=True)] + [
            threading.Thread(target=client, args=(k,), daemon=True)
            for k in range(4)]
        for t in th:
            t.start()
        time.sleep(RECSYS_SENTINEL_S)
        stop.set()
        for t in th:
            t.join(RECSYS_WAIT_S)
        check(not any(t.is_alive() for t in th),
              "recsys (b): a client or the trainer hung")
        lags = [c0 - int(r[0]) for c0, rows in seen for r in rows]
        torn = sum(int(not np.all(rows == rows[:, :1])) for _, rows in seen)
        check(statuses and all(s == "ok" for s in statuses),
              f"recsys (b): sentinel requests not ok: {set(statuses)}")
        check(published[0] > 10 and len(lags) > 10 and not torn,
              f"recsys (b): {published[0]} sentinel sets, {len(lags)} "
              f"sentinel lookups, {torn} torn")
        check(max(lags) <= RECSYS_PULL_BOUND, f"recsys (b): a served "
              f"sentinel {max(lags)} versions stale > pull_bound "
              f"{RECSYS_PULL_BOUND}")
        print(f"[recsys] (b) sentinel: {len(statuses)} requests by 4 "
              f"clients while a trainer thread made {published[0]} sets "
              f"of row {sentinel} over the van, every response ok; "
              f"{len(lags)} sentinel rows served, lag max {max(lags)} "
              f"versions (pull_bound {RECSYS_PULL_BOUND}; below 0 where a "
              f"set completed during the lookup), none torn [{card}]")

        # the kill: the victim's loop strikes out under traffic and the
        # health poll fails its queue over to the peer
        dead = pool.members["a"].engine
        t0 = time.perf_counter()
        pool.kill_member("a")
        kill_status = []
        for _ in range(16):
            d, i = _recsys_requests(g, 1)
            kill_status.append(pool.score(d[0], i[0],
                                          timeout_s=60.0)["status"])
        _recsys_wait(lambda: pool.metrics.count("pool_failovers") == 1,
                     "the killed member failed over")
        failover_s = time.perf_counter() - t0
        check(all(s == "ok" for s in kill_status) and
              not pool.members["a"].available,
              f"recsys (b): after the kill {set(kill_status)}, member a "
              f"available {pool.members['a'].available}")
        t1 = time.perf_counter()
        pool.revive_member("a")
        revive_ms = (time.perf_counter() - t1) * 1e3
        check([closes.get(id(c)) for c in dead.caches] == [1],
              f"recsys (b): the dead engine's caches closed "
              f"{[closes.get(id(c)) for c in dead.caches]} times")
        new = pool.members["a"].engine
        for _ in range(4):
            d, i = _recsys_requests(g, 1)
            check(pool.score(d[0], i[0], timeout_s=60.0)["status"] == "ok",
                  "recsys (b): a request after the revive failed")
        check(new is not dead and pool.members["a"].available and
              new.metrics.count("recsys_scored") > 0,
              "recsys (b): the revived member took no request")
        print(f"[recsys] (b) kill_member: 16 requests every one ok, "
              f"pool_failovers 1 after {failover_s * 1e3:.1f} ms "
              f"(requests_failed_over "
              f"{pool.metrics.count('requests_failed_over')}); revive_member "
              f"{revive_ms:.1f} ms, the dead engine's cache closed once, the "
              f"revived member scored {new.metrics.count('recsys_scored')} "
              f"of 4 new requests [{card}]")

        # 64 requests over the wire, each against the same in process
        front = pool.frontend(max_clients=1)
        cl = RecsysClient("127.0.0.1", pool.port, 0)
        wire_ms, gaps = [], []
        try:
            for _ in range(RECSYS_WIRE_REQUESTS):
                d, i = _recsys_requests(g, 1)
                t = time.perf_counter()
                resp = cl.score(d[0], i[0], timeout_s=60.0)
                wire_ms.append((time.perf_counter() - t) * 1e3)
                here = pool.score(d[0], i[0], timeout_s=60.0)
                check(resp["status"] == "ok" and here["status"] == "ok",
                      f"recsys (b): wire {resp['status']}, in process "
                      f"{here['status']}")
                gaps.append(abs(resp["score"] - here["score"]))
        finally:
            cl.close()
            front.close()
        check(max(gaps) <= RECSYS_TOL_WIRE, f"recsys (b): a wire score "
              f"{max(gaps):.3e} from the same request in process")
        print(f"[recsys] (b) wire: {RECSYS_WIRE_REQUESTS} requests through "
              f"pool.frontend() and a RecsysClient, every one ok, max |wire "
              f"- in process| {max(gaps):.3e} (limit {RECSYS_TOL_WIRE:g}); "
              f"round trip p50 {float(np.median(wire_ms)):.3f} ms, p99 "
              f"{float(np.percentile(wire_ms, 99)):.3f} ms [{card}]")
    except BaseException:
        pool.close()
        raise
    return pool, dict(sentinel_sets=published[0], lag_max=max(lags),
                      failover_ms=failover_s * 1e3, revive_ms=revive_ms,
                      wire_gap=max(gaps))


def _recsys_shard_kill(card, seed, pool, table, slots):
    """Arm (c): the reference chaos test's seeded shard SIGKILL under the
    pool's traffic; the shard restarts on its port and the caches
    recover."""
    from hetu_tpu_torch.resilience import FaultInjector, FaultSchedule
    from hetu_tpu_torch.telemetry import timeline, trace

    sched = FaultSchedule.generate(**RECSYS_KILL_SCHEDULE)
    (kill_ev,) = sched.events
    check(kill_ev.kind == "kill_shard", f"recsys (c): drew {kill_ev}")
    slot = slots[int(kill_ev.arg)]
    inj = FaultInjector(sched, shard_procs=slots)
    g = np.random.default_rng([seed, 24, 5])
    statuses = []

    def one():
        d, i = _recsys_requests(g, 1)
        statuses.append(pool.score(d[0], i[0], timeout_s=60.0)["status"])

    tracer = trace.enable()
    try:
        for step in range(1, RECSYS_KILL_STEPS + 1):
            inj.on_step(step)
            for _ in range(2):
                one()
        slot.thread.join(RECSYS_WAIT_S)
        _recsys_wait(lambda: all(table.alive),
                     "the restarted shard reconnected")
        # a degraded cache re-probes the PS at its first lookup past
        # probe_interval_s: serve on until the probes have run
        caches = [c for m in pool.members.values() for c in m.engine.caches]
        deadline = time.monotonic() + RECSYS_WAIT_S
        while any(c.degraded for c in caches):
            check(time.monotonic() < deadline,
                  "recsys (c): a cache never recovered")
            time.sleep(0.05)
            one()
    finally:
        trace.disable()
    events = tracer.events
    degraded = sum(c.stats()["degraded_lookups"] for c in caches)
    check(inj.counters["shards_killed"] == 1 and degraded > 0,
          f"recsys (c): {inj.counters['shards_killed']} shards killed, "
          f"{degraded} degraded lookups")
    check(all(s == "ok" for s in statuses),
          f"recsys (c): responses {sorted(set(statuses))}")
    ks = [p for p in timeline.correlate(events) if p.kind == "kill_shard"]
    check(len(ks) == 1 and ks[0].paired and
          ks[0].recovery_name == "serve.recsys_degrade",
          f"recsys (c): fault.kill_shard paired as {ks}")
    kill = next(e for e in events if e.get("name") == "fault.kill_shard")
    enter = next(e for e in events
                 if e.get("name") == "serve.recsys.degrade_enter")
    window = next(e for e in events
                  if e.get("name") == "serve.recsys_degrade")
    out = dict(
        requests=len(statuses), degraded_lookups=degraded,
        kill_to_degraded_ms=(enter["ts"] - kill["ts"]) / 1e3,
        window_ms=window["dur"] / 1e3,
        restart_to_recovered_ms=(window["ts"] + window["dur"] - kill["ts"])
        / 1e3 - slot.respawned_s * 1e3,
        detect_s=ks[0].detect_s, recover_s=ks[0].recover_s)
    print(f"[recsys] (c) shard kill: FaultSchedule.generate("
          f"{', '.join(f'{k}={x}' for k, x in RECSYS_KILL_SCHEDULE.items())})"
          f" SIGKILLed shard {int(kill_ev.arg)} at step {kill_ev.step}; "
          f"{out['requests']} requests, every one ok, {degraded} degraded "
          f"lookups; kill -> first degraded answer "
          f"{out['kill_to_degraded_ms']:.3f} ms, degraded window "
          f"{out['window_ms']:.3f} ms, restart -> recovered "
          f"{out['restart_to_recovered_ms']:.3f} ms (the heartbeat saw it "
          f"dead {slot.dead_seen_s:.3f} s after the kill, READY again "
          f"{slot.respawned_s:.3f} s); fault.kill_shard paired with "
          f"serve.recsys_degrade, no cache left degraded [{card}]")
    return out


def _recsys_trace(card, seed, pool):
    """Arm (d): an open-loop CTR trace replayed through
    ``ctr_submitter``."""
    from hetu_tpu_torch.traffic import (
        TenantSpec, TraceSpec, ctr_submitter, replay, synthesize,
    )

    spec = TraceSpec(seed=seed, tenants=[TenantSpec("ctr", kind="ctr")],
                     **RECSYS_TRACE)
    trace_d = synthesize(spec)
    lag, t0 = [], [0.0]

    def on_submit(ev, handle):
        lag.append(time.monotonic() - t0[0] - ev["t"])

    t0[0] = time.monotonic()
    out = replay(trace_d, ctr_submitter(pool), on_submit=on_submit)
    for _, h in out:
        check(not isinstance(h, Exception), f"recsys (d): a submit raised "
                                            f"{h!r}")
        check(h.done.wait(h.timeout_s + 15.0), "recsys (d): a request "
                                               "never resolved")
    counts = {}
    for _, h in out:
        counts[h.status] = counts.get(h.status, 0) + 1
    check(set(counts) <= {"ok", "shed", "timeout"} and
          counts.get("ok", 0) >= 1, f"recsys (d): statuses {counts}")
    ok = np.asarray([h.ttfr_s for _, h in out if h.status == "ok"]) * 1e3
    res = dict(events=len(out), counts=counts,
               ttfr_p50_ms=float(np.percentile(ok, 50)),
               ttfr_p99_ms=float(np.percentile(ok, 99)),
               lag_p99_ms=float(np.percentile(lag, 99)) * 1e3,
               lag_max_ms=float(np.max(lag)) * 1e3)
    print(f"[recsys] (d) open-loop trace: {res['events']} CTR events over "
          f"{spec.duration_s:g} s (base {spec.base_qps:g}/s, diurnal peak "
          f"x{spec.diurnal_peak_x:g}) through ctr_submitter: "
          + ", ".join(f"{k} {n}" for k, n in sorted(counts.items()))
          + f"; TTFR p50 {res['ttfr_p50_ms']:.3f} ms, p99 "
          f"{res['ttfr_p99_ms']:.3f} ms; the replay behind the trace p99 "
          f"{res['lag_p99_ms']:.3f} ms, max {res['lag_max_ms']:.3f} ms "
          f"[{card}]")
    return res


def phase_recsys(card, seed, device="cuda"):
    """Online CTR serving (serve/recsys.py) on the card: the Wide & Deep
    tower at train_ctr's widths behind ServingEmbeddingCaches over a van
    PartitionedPSTable of 1M x 16 f32 rows on two shard processes.  The
    table is ps_ctr's PS leg, cut from train_ctr's 33M card-resident rows
    to keep the van servers' start-up inside the script's limit.  Arms:
    (a) the cached engine against the cache-less one, (b) a RecsysPool
    under a sentinel-writing trainer, a member kill and revive and the
    wire, (c) a seeded shard SIGKILL, (d) an open-loop CTR trace.  No
    kernel of the six runs on this path (rows are gathered on the host).
    Returns the numbers for the summary and the kernels line."""
    import tempfile

    from hetu_tpu_torch.ps import PartitionedPSTable
    from hetu_tpu_torch.resilience.shardproc import free_port

    t0 = time.perf_counter()
    counters = _all_counters()
    with tempfile.TemporaryDirectory(prefix="recsys_") as root:
        slots, table, pool = [], None, None
        try:
            for i in range(2):
                slots.append(_ShardSlot(root, free_port(), f"rs{i}"))
            t1 = time.perf_counter()
            table = PartitionedPSTable(
                [("127.0.0.1", s.port) for s in slots], RECSYS_V, CTR_DIM,
                init="normal", init_b=0.01, seed=seed, optimizer="adagrad",
                lr=RECSYS_ADAGRAD_LR, heartbeat_ms=100)
            made_ms = (time.perf_counter() - t1) * 1e3
            for i, s in enumerate(slots):
                s.table, s.index = table, i
            model = recsys_model(seed, device)
            print(f"[recsys] WideDeep({CTR_F}, {CTR_DIM}, {CTR_DENSE}, "
                  f"{CTR_HIDDEN}) f32 on {device}; PartitionedPSTable("
                  f"{RECSYS_V}, {CTR_DIM}, f32, adagrad) over 2 van shard "
                  f"processes made in {made_ms:.1f} ms; caches {RECSYS_CACHE}"
                  f" rows, LRU, pull_bound {RECSYS_PULL_BOUND}; engines "
                  f"max_batch {RECSYS_MAX_BATCH} from bucket "
                  f"{RECSYS_MIN_BUCKET} [{card}]")
            for c in counters:
                c.launches = 0
            ab = _recsys_ab(card, seed, model, table, device)
            pool, pl = _recsys_pool_arm(card, seed, model, table, device)
            kill = _recsys_shard_kill(card, seed, pool, table, slots)
            tr = _recsys_trace(card, seed, pool)
            launches = [c.launches for c in counters]
        finally:
            if pool is not None:
                pool.close()
            if table is not None:
                table.close()
            for s in slots:
                s.close()
    check(launches == [0] * 6, f"recsys: the six kernels launched "
                               f"{launches} on a path that runs none")
    out = dict(ab=ab, pool=pl, kill=kill, trace=tr, table_ms=made_ms,
               launches=launches, seconds=time.perf_counter() - t0)
    print(f"[recsys] phase {out['seconds']:.1f} s (budget "
          f"{RECSYS_BUDGET_S:g} s: "
          f"{'met' if out['seconds'] <= RECSYS_BUDGET_S else 'missed'}); "
          f"launches of the six kernels {launches} [{card}]")
    return out


def recsys_summary(recsys, card) -> str:
    """The recsys phase's summary line, printed in the output's tail."""
    ra, rp = recsys["ab"], recsys["pool"]
    rk, rt = recsys["kill"], recsys["trace"]
    return (f"[recsys] summary: phase {recsys['seconds']:.1f} s (budget "
            f"{RECSYS_BUDGET_S:g} s); (a) QPS cached "
            f"{ra['cached']['qps']:.1f}, cache-less "
            f"{ra['cache-less']['qps']:.1f}, TTFR p99 cached "
            f"{ra['cached']['ttfr_p99_ms']:.3f} ms, cache-less "
            f"{ra['cache-less']['ttfr_p99_ms']:.3f} ms, hit rate "
            f"{ra['cached']['hit_rate']:.4f}; (b) sentinel lag max "
            f"{rp['lag_max']}, failover {rp['failover_ms']:.1f} ms, wire "
            f"max |d| {rp['wire_gap']:.3e}; (c) kill -> degraded "
            f"{rk['kill_to_degraded_ms']:.3f} ms, window "
            f"{rk['window_ms']:.3f} ms, restart -> recovered "
            f"{rk['restart_to_recovered_ms']:.3f} ms; (d) {rt['events']} "
            f"events, " + ", ".join(f"{k} {n}" for k, n in
                                    sorted(rt['counts'].items()))
            + f", TTFR p99 {rt['ttfr_p99_ms']:.3f} ms; launches "
            f"{recsys['launches']} [{card}]")


# ------------------------------------------------------------- supervise

def _sup_spec(seed, device):
    """Arm (a)'s configuration, passed whole to its child processes (which
    adopt these widths)."""
    return {"seed": seed, "device": device, "V": SUP_V, "H": H, "L": SUP_L,
            "NH": NH, "FFN": FFN, "B": SUP_B, "S": SUP_S,
            "steps": SUP_STEPS, "lr": SUP_LR, "every": SUP_CKPT_EVERY,
            "keep": SUP_KEEP, "data_errors": list(SUP_DATA_ERRORS),
            "hold_at": -1}


def _sup_gpt(spec):
    """GPT-2-small at the spec's widths (bf16, flash, remat, fused CE),
    its weights drawn from the seed in the JAX package's layout, an
    Executor (AdamW) over it, and the seeded batch of each step; made the
    same way in every arm.  Returns (config, executor, state, batch_fn)."""
    from hetu_tpu_torch import interop
    from hetu_tpu_torch.models import GPTConfig, GPTModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    cfg = GPTConfig(vocab_size=spec["V"], hidden_size=spec["H"],
                    num_layers=spec["L"], num_heads=spec["NH"],
                    ffn_size=spec["FFN"], max_position=spec["S"],
                    dropout_rate=0.0, dtype=torch.bfloat16,
                    attention_impl="flash", remat=True, fused_ce=True)
    model = GPTModel(cfg, device=spec["device"])
    model.load_state_dict(interop.params_from_jax(
        jax_layout_weights(spec["seed"], spec["S"], spec["V"], spec["L"]),
        cfg))
    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(spec["lr"]),
                  seed=spec["seed"])
    state = ex.init_state(model)

    def batch_fn(i):
        g = np.random.default_rng([spec["seed"], 22, int(i)])
        return (g.integers(0, spec["V"], (spec["B"], spec["S"])),)
    return cfg, ex, state, batch_fn


def _sup_supervisor(spec, ex, cfg, ckpt_dir=None):
    """The arm's Supervisor: the data faults of the spec, and with
    ``ckpt_dir`` a checkpoint every ``every`` steps, ``keep`` kept."""
    from hetu_tpu_torch.resilience import (
        FaultEvent, FaultInjector, FaultSchedule, Supervisor,
    )
    sched = FaultSchedule([FaultEvent(s, "data_error")
                           for s in spec["data_errors"]])
    kw = (dict(ckpt_dir=ckpt_dir, ckpt_every=spec["every"],
               keep=spec["keep"]) if ckpt_dir else {})
    return Supervisor(ex, injector=FaultInjector(sched), config=cfg, **kw)


def supervise_child(spec_json, ckpt_dir):
    """One GPT-2-small training process of the supervise phase's arm (a):
    ``Supervisor.run`` over ``ckpt_dir`` (resuming from it when it holds a
    checkpoint), printing ``step <i> <loss>`` after each step and, at step
    ``hold_at``, waiting for a line on its standard input; then each
    checkpoint's ``SAVE``/``RESTORE`` line, its launches, counters and
    modules, and ``PREEMPTED <step>`` or ``DONE <step>``."""
    spec = json.loads(spec_json)
    globals().update(H=spec["H"], L=spec["L"], NH=spec["NH"],
                     FFN=spec["FFN"])
    if spec["device"] == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, ex, state, batch_fn = _sup_gpt(spec)
    sup = _sup_supervisor(spec, ex, cfg, ckpt_dir)
    mgr = sup.manager
    save, restore = mgr.save, mgr.restore

    def timed_save(st, step, *, extra=None):
        t0 = time.perf_counter()
        path = save(st, step, extra=extra)
        print(f"SAVE {step} {path.stat().st_size} "
              f"{(time.perf_counter() - t0) * 1e3:.3f}", flush=True)
        return path

    def timed_restore(template, *, restore_rng=True):
        t0 = time.perf_counter()
        got = restore(template, restore_rng=restore_rng)
        size = os.path.getsize(mgr.last_restored) if got else 0
        print(f"RESTORE {got[1] if got else -1} {size} "
              f"{(time.perf_counter() - t0) * 1e3:.3f} {len(mgr.skipped)}",
              flush=True)
        return got
    mgr.save, mgr.restore = timed_save, timed_restore

    def post_step(i, st, metrics, batch):
        print(f"step {i} {float(metrics['loss']):.6f}", flush=True)
        if i == spec["hold_at"]:
            sys.stdin.readline()  # held until the parent has signalled

    counters = _all_counters()
    for c in counters:
        c.launches = 0
    rep = sup.run(state, batch_fn, spec["steps"], post_step=post_step)
    print("LAUNCHES", *(c.launches for c in counters), flush=True)
    print("COUNTERS", json.dumps(rep.counters), flush=True)
    print("MODULES jax=%d hetu_tpu=%d" % (
        "jax" in sys.modules,
        any(m == "hetu_tpu" or m.startswith("hetu_tpu.")
            for m in sys.modules)), flush=True)
    print("PREEMPTED" if rep.preempted else "DONE", rep.step, flush=True)
    return 0


_SUP_CHILD_SRC = (
    "import sys\nsys.path.insert(0, sys.argv[1])\nimport chip_smoke\n"
    "sys.exit(chip_smoke.supervise_child(sys.argv[2], sys.argv[3]))\n")


def _sup_child(spec, ckpt_dir, workdir, tag, on_line=None):
    """Run :func:`supervise_child` in a fresh interpreter; ``on_line(proc,
    line)`` sees each line of its output as it comes.  Returns its exit
    code, its lines, the seconds from its spawn to its first step and the
    ``perf_counter`` of its exit."""
    import queue

    root = os.path.dirname(os.path.abspath(__file__))
    err_path = os.path.join(workdir, f"{tag}.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", _SUP_CHILD_SRC, root, json.dumps(spec),
             ckpt_dir], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=err, text=True)
    lines, first_step = queue.Queue(), None

    def reader():
        for line in proc.stdout:
            lines.put(line.strip())
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()
    out = []
    deadline = t0 + SUP_CHILD_S
    try:
        while True:
            try:
                line = lines.get(timeout=max(deadline - time.perf_counter(),
                                             0.01))
            except queue.Empty:
                check(False, f"supervise {tag}: the child said nothing for "
                             f"{SUP_CHILD_S:g} s: {out[-5:]}")
            if line is None:
                break
            out.append(line)
            if line.startswith("step ") and first_step is None:
                first_step = time.perf_counter() - t0
            if on_line is not None:
                on_line(proc, line)
        rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        t_exit = time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        with open(err_path) as f:
            print(f.read()[-3000:], file=sys.stderr)
    check(rc == 0, f"supervise {tag}: the child exited {rc}: {out[-5:]}")
    return dict(rc=rc, lines=out, first_step_s=first_step, t_exit=t_exit)


def _sup_parse(run, steps, tag, device, n_layers):
    """The child's report: the steps it printed, saves, restore, launches
    (held to 2 L forwards and L of each backward kernel a step on the
    card, none off it), counters, no jax."""
    lines = run["lines"]
    word = {ln.split()[0]: ln.split()[1:] for ln in lines if ln}
    run["steps"] = [int(ln.split()[1]) for ln in lines
                    if ln.startswith("step ")]
    run["saves"] = [(int(s), int(b), float(ms)) for s, b, ms in
                    (ln.split()[1:] for ln in lines
                     if ln.startswith("SAVE "))]
    r = word.get("RESTORE")
    run["restore"] = (int(r[0]), int(r[1]), float(r[2]), int(r[3])) \
        if r else None
    run["launches"] = [int(x) for x in word["LAUNCHES"]]
    run["counters"] = json.loads(
        next(ln for ln in lines if ln.startswith("COUNTERS "))[9:])
    check(word["MODULES"] == ["jax=0", "hetu_tpu=0"],
          f"supervise {tag}: the child loaded {word['MODULES']}")
    n = len(steps)
    want = [2 * n_layers * n, n_layers * n, n_layers * n] \
        if device == "cuda" else [0, 0, 0]
    check(run["launches"][:3] == want,
          f"supervise {tag}: flash launches {run['launches'][:3]} over "
          f"{n} steps, expected {want}")
    check(run["steps"] == list(steps),
          f"supervise {tag}: ran steps {run['steps']}, expected "
          f"{list(steps)}")
    return run


def _sup_state(path):
    """A checkpoint's header and leaves, read with numpy alone (the port's
    loader is not what is checked here)."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(bytes(z["header"]).decode())
        return header, [z[f"leaf_{i}"] for i in range(header["n_leaves"])]


def _sup_gaps(a, b):
    """Per leaf (max |a - b|, bitwise equal)."""
    out = []
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        same = x.shape == y.shape and x.tobytes() == y.tobytes()
        gap = 0.0 if same else float(np.max(np.abs(
            x.astype(np.float64) - y.astype(np.float64))))
        out.append((gap, same))
    return out


def _sup_inproc(spec, tag, trace_on, card):
    """An uninterrupted supervised run in this process (no checkpoint
    directory): its final leaves in checkpoint order, (seed, seqnum), the
    step times (between successive post_steps; the guarded step waits for
    its finiteness check), launches and counters; with ``trace_on``, its
    ``recovery.retry`` spans."""
    from hetu_tpu_torch import rng as hrng
    from hetu_tpu_torch.telemetry import trace
    from hetu_tpu_torch.train import checkpoint

    cfg, ex, state, batch_fn = _sup_gpt(spec)
    sup = _sup_supervisor(spec, ex, cfg)
    stamps, losses = [time.perf_counter()], []

    def post_step(i, st, metrics, batch):
        stamps.append(time.perf_counter())
        losses.append(float(metrics["loss"]))

    counters = _all_counters()
    for c in counters:
        c.launches = 0
    tracer = trace.enable() if trace_on else None
    try:
        rep = sup.run(state, batch_fn, spec["steps"], post_step=post_step)
    finally:
        if trace_on:
            trace.disable()
    launches = [c.launches for c in counters]
    n, nl = spec["steps"], spec["L"]
    want = [2 * nl * n, nl * n, nl * n] if spec["device"] == "cuda" \
        else [0, 0, 0]
    check(launches[:3] == want, f"supervise {tag}: flash launches "
                                f"{launches[:3]}, expected {want}")
    check(all(np.isfinite(losses)),
          f"supervise {tag}: a loss is not finite: {losses}")
    check(rep.counters.get("retries_data") == len(spec["data_errors"]),
          f"supervise {tag}: {rep.counters.get('retries_data')} data "
          f"retries, expected {len(spec['data_errors'])}")
    out = dict(leaves=list(checkpoint.state_dict(rep.state, cfg).values()),
               seed_status=hrng.get_seed_status(), losses=losses,
               times=np.diff(stamps), launches=launches,
               counters=rep.counters, ex=ex, state=rep.state,
               batch_fn=batch_fn)
    if trace_on:
        out["retry_spans"] = [e for e in tracer.events
                              if e["name"] == "recovery.retry"]
        check(len(out["retry_spans"]) == len(spec["data_errors"]) and all(
            e["args"]["what"] == "data" for e in out["retry_spans"]),
            f"supervise {tag}: recovery.retry spans "
            f"{[e['args'] for e in out['retry_spans']]}")
    print(f"[supervise] gpt {tag}: {n} supervised steps, losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; data retries "
          f"{rep.counters['retries_data']}; flash launches {launches[:3]} "
          f"[{card}]")
    return out


def _sup_gpt_arm(card, seed, device, workdir):
    """Arm (a): GPT-2-small through the Supervisor, uninterrupted twice in
    this process, then preempted by SIGTERM in a child held at step 5,
    its newest checkpoint corrupted, and resumed in a second child."""
    spec = _sup_spec(seed, device)
    t0 = time.perf_counter()
    a1 = _sup_inproc(spec, "uninterrupted 1", True, card)
    for k in ("ex", "state", "batch_fn"):
        a1.pop(k)
    if device == "cuda":
        torch.cuda.empty_cache()
    a2 = _sup_inproc(spec, "uninterrupted 2", False, card)
    # the same guarded step with no supervisor around it
    ex, state, batch_fn = a2.pop("ex"), a2.pop("state"), a2.pop("batch_fn")
    bare = []
    for i in range(SUP_BARE_STEPS):
        t = time.perf_counter()
        state, met = ex.run("train_guarded", state, batch_fn(i))
        float(met["loss"])
        bare.append(time.perf_counter() - t)
    del ex, state, met
    if device == "cuda":
        torch.cuda.empty_cache()
    inproc_s = time.perf_counter() - t0
    twins = _sup_gaps(a1["leaves"], a2["leaves"])
    reproducible = all(same for _, same in twins) and \
        a1["seed_status"] == a2["seed_status"]
    sup_ms = float(np.median(a2["times"][1:])) * 1e3
    bare_ms = float(np.median(bare[1:])) * 1e3
    overhead = 100.0 * (sup_ms - bare_ms) / bare_ms
    print(f"[supervise] gpt: the two uninterrupted arms "
          f"{'bitwise equal' if reproducible else 'differ'} "
          f"({sum(s for _, s in twins)} of {len(twins)} leaves bitwise, "
          f"max |d| {max(g for g, _ in twins):.3e}); step median "
          f"supervised {sup_ms:.3f} ms, bare {bare_ms:.3f} ms, overhead "
          f"{overhead:.2f} % (the reference's target < 2 %, reported); "
          f"in process {inproc_s:.1f} s [{card}]")

    ckpt_dir = os.path.join(workdir, "ckpt")
    t_sig = []

    def preempt(proc, line):
        if line.startswith(f"step {SUP_HOLD_AT} "):
            t_sig.append(time.perf_counter())
            proc.send_signal(signal.SIGTERM)
            proc.stdin.write("go\n")
            proc.stdin.flush()

    pre = _sup_parse(_sup_child(dict(spec, hold_at=SUP_HOLD_AT), ckpt_dir,
                                workdir, "preempted", preempt),
                     range(SUP_HOLD_AT + 1), "preempted", device, spec["L"])
    stop = SUP_HOLD_AT + 1
    pre_files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
    check(pre["lines"][-1] == f"PREEMPTED {stop}" and
          pre["counters"].get("preempt_signals") == 1 and
          [s for s, _, _ in pre["saves"]] == [SUP_CKPT_EVERY, stop] and
          pre_files == [f"ckpt-{SUP_CKPT_EVERY:08d}.npz",
                        f"ckpt-{stop:08d}.npz"],
          f"supervise preempted: {pre['lines'][-1]}, saves "
          f"{pre['saves']}, files {pre_files}, counters {pre['counters']}")
    check(pre["counters"].get("retries_data", 0) ==
          sum(s < stop for s in SUP_DATA_ERRORS),
          f"supervise preempted: data retries {pre['counters']}")
    sigterm_exit_s = pre["t_exit"] - t_sig[0]

    # bit rot in the newest checkpoint's body: its CRC no longer matches
    newest = os.path.join(ckpt_dir, f"ckpt-{stop:08d}.npz")
    with open(newest, "r+b") as f:
        f.seek(os.path.getsize(newest) // 2)
        body = bytearray(f.read(64))
        f.seek(-len(body), 1)
        f.write(bytes(b ^ 0xFF for b in body))

    res = _sup_parse(_sup_child(spec, ckpt_dir, workdir, "resumed"),
                     range(SUP_CKPT_EVERY, SUP_STEPS), "resumed", device,
                     spec["L"])
    c = res["counters"]
    check(res["lines"][-1] == f"DONE {SUP_STEPS}" and
          c.get("corrupt_checkpoints_skipped") == 1 and
          c.get("resumed_from_step") == SUP_CKPT_EVERY and
          res["restore"] is not None and
          res["restore"][0] == SUP_CKPT_EVERY and res["restore"][3] == 1,
          f"supervise resumed: {res['lines'][-1]}, restore "
          f"{res['restore']}, counters {c}")
    check(c.get("retries_data", 0) ==
          sum(s >= SUP_CKPT_EVERY for s in SUP_DATA_ERRORS),
          f"supervise resumed: data retries {c}")
    print(f"[supervise] gpt resumed: skipped the corrupt checkpoint of "
          f"step {stop} (CRC), restored step {res['restore'][0]} "
          f"(resumed_from_step {c['resumed_from_step']}), ran steps "
          f"{res['steps'][0]}-{res['steps'][-1]}, DONE {SUP_STEPS} "
          f"[{card}]")

    header, leaves = _sup_state(os.path.join(ckpt_dir,
                                             f"ckpt-{SUP_STEPS:08d}.npz"))
    gaps = _sup_gaps(leaves, a1["leaves"])
    bitwise = all(same for _, same in gaps)
    rng_same = tuple(header["rng"]) == tuple(a1["seed_status"])
    if reproducible:
        ok = bitwise and rng_same
        rule = "bitwise, as the two uninterrupted arms are"
    else:
        ok = rng_same and all(g <= t for (g, _), (t, _) in zip(gaps, twins))
        rule = "each leaf within the uninterrupted arms' own gap"
    print(f"[supervise] gpt resume vs uninterrupted: "
          f"{sum(s for _, s in gaps)} of {len(gaps)} leaves (parameters, "
          f"AdamW slots, step, rng words) bitwise, max |d| "
          f"{max(g for g, _ in gaps):.3e}; (seed, seqnum) {header['rng']} "
          f"vs {list(a1['seed_status'])}; rule: {rule} [{card}]")
    check(ok, "supervise: the resumed run does not match the uninterrupted "
              f"one ({rule})")
    saves = pre["saves"] + res["saves"]
    for who, run in (("preempted", pre), ("resumed", res)):
        for step, size, ms in run["saves"]:
            print(f"[supervise] gpt {who}: save of step {step}: {size} "
                  f"bytes in {ms:.1f} ms ({size / ms / 1e6:.3f} GB/s) "
                  f"[{card}]")
    r_step, r_size, r_ms, _ = res["restore"]
    print(f"[supervise] gpt resumed: restore {r_ms:.1f} ms (two CRC "
          f"passes, one of them over the corrupt file, and the load of "
          f"step {r_step}'s {r_size} bytes); SIGTERM -> the child's exit "
          f"{sigterm_exit_s:.3f} s; the resumed child's start -> its first "
          f"step {res['first_step_s']:.3f} s (the preempted child's "
          f"{pre['first_step_s']:.3f} s) [{card}]")
    launches = [a + b + p + r for a, b, p, r in zip(
        a1["launches"], a2["launches"], pre["launches"], res["launches"])]
    return dict(reproducible=reproducible, bitwise=bitwise,
                max_gap=max(g for g, _ in gaps),
                twin_gap=max(g for g, _ in twins),
                step_ms=sup_ms, bare_ms=bare_ms, overhead_pct=overhead,
                saves=saves, restore=res["restore"],
                sigterm_exit_s=sigterm_exit_s,
                resume_first_step_s=res["first_step_s"],
                preempt_first_step_s=pre["first_step_s"],
                launches=launches,
                launches_by_arm={"uninterrupted_1": a1["launches"],
                                 "uninterrupted_2": a2["launches"],
                                 "preempted": pre["launches"],
                                 "resumed": res["launches"]})


class _ShardSlot:
    """A van shard process on a fixed port, as ``FaultInjector`` kills it:
    ``kill()`` SIGKILLs it and returns once the table's heartbeat has seen
    it die (the guard's poll then finds it dead, as a poll one heartbeat
    later would), and restarts it on the same port after a beat of
    downtime (the preemptible fleet's scheduler), in a thread."""

    def __init__(self, workdir, port, tag):
        from hetu_tpu_torch.resilience.shardproc import spawn_shard_server
        self._spawn = lambda t: spawn_shard_server(workdir, port, t)
        self.port, self.tag = port, tag
        self.proc = self._spawn(tag)
        self.table = self.index = self.killed = self.thread = None
        self.dead_seen_s = self.respawned_s = None

    def kill(self):
        self.killed = self.proc
        t0 = time.perf_counter()
        self.proc.kill()
        self.proc.wait()
        deadline = time.monotonic() + 30.0
        while self.table.alive[self.index]:
            check(time.monotonic() < deadline, "the table's heartbeat did "
                  "not see the killed shard die within 30 s")
            time.sleep(0.005)
        self.dead_seen_s = time.perf_counter() - t0

        def respawn():
            time.sleep(0.2)
            self.proc = self._spawn(self.tag + "r")
            self.respawned_s = time.perf_counter() - t0
        self.thread = threading.Thread(target=respawn, daemon=True)
        self.thread.start()

    def wait(self, timeout=None):
        return (self.killed or self.proc).wait(timeout)

    def poll(self):
        return self.proc.poll()

    def send_signal(self, sig):
        self.proc.send_signal(sig)

    def close(self):
        if self.thread is not None:
            self.thread.join(30)
        self.proc.kill()
        self.proc.wait()


def _sup_checked_guard(table, snapshot_path):
    """``PSShardGuard`` holding every repair to its snapshot: the repaired
    shard's rows and adagrad slots must read back bitwise equal to the
    snapshot the guard held when it first saw the shard dead (and still
    holds), and every other shard's rows as they were just before."""
    from hetu_tpu_torch.resilience import PSShardGuard

    class CheckedGuard(PSShardGuard):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.checked, self.at_death = [], {}

        def poll(self):
            t = self.table
            due = set(self._pending) | {i for i, a in enumerate(t.alive)
                                        if not a}
            for i in due - set(self.at_death):
                if i in self._have_slots:
                    r = self.shard_rows(i)
                    self.at_death[i] = [a[r].copy() for a in (
                        self._snap, self._snap_s1, self._snap_s2,
                        self._snap_step)]
            before = {j: t.sparse_pull(self.shard_rows(j))
                      for j in range(t.n_servers) if due and j not in due}
            t0 = time.perf_counter()
            done = super().poll()
            ms = (time.perf_counter() - t0) * 1e3
            for i in (due - self._pending) if done else ():
                r = self.shard_rows(i)
                got = [t.sparse_pull(r), *t.slots_get(r)]
                snap = [a[r] for a in (self._snap, self._snap_s1,
                                       self._snap_s2, self._snap_step)]
                ok = all(np.array_equal(x, y) and np.array_equal(x, z)
                         for x, y, z in zip(got, snap, self.at_death[i]))
                live = all(np.array_equal(t.sparse_pull(self.shard_rows(j)),
                                          b) for j, b in before.items())
                self.checked.append(dict(shard=i, rows=len(r), ms=ms,
                                         bitwise=ok, live_unchanged=live))
                check(ok, f"supervise ps: shard {i}'s rows or slots differ "
                          "from the snapshot after the repair")
                check(live, "supervise ps: the repair changed a live shard")
            return done

    return CheckedGuard(table, snapshot_path=snapshot_path)


def _sup_ps_arm(card, seed, device, workdir):
    """Arm (b): the Wide & Deep PS step at ps_ctr's PS-leg size through
    the Supervisor, over a table key-range-split across two van shard
    processes, under the reference chaos test's seeded schedule (a shard
    SIGKILLed and repaired from the guard's snapshot, a NaN batch, two
    van faults)."""
    from hetu_tpu_torch import ops
    from hetu_tpu_torch.models import WideDeep
    from hetu_tpu_torch.optim import AdamOptimizer
    from hetu_tpu_torch.ps import PartitionedPSTable
    from hetu_tpu_torch.resilience import (
        FaultInjector, FaultSchedule, Supervisor,
    )
    from hetu_tpu_torch.resilience.shardproc import free_port
    from hetu_tpu_torch.telemetry import timeline, trace
    from hetu_tpu_torch.train import Executor

    sched = FaultSchedule.generate(**SUP_PS_SCHEDULE)
    kinds = sorted(e.kind for e in sched.events)
    check(kinds == ["kill_shard", "nan_grad", "van_error", "van_error"],
          f"supervise ps: the seeded schedule drew {kinds}")
    sparse, dense_x, y = synthetic_ctr(CTR_B * 64, CTR_F, CTR_DENSE,
                                       CTR_PS_V, seed)
    n = sparse.shape[0]
    t0 = time.perf_counter()
    slots = [_ShardSlot(workdir, free_port(), f"sup{i}") for i in range(2)]
    table = None
    try:
        table = PartitionedPSTable(
            [("127.0.0.1", s.port) for s in slots], CTR_PS_V, CTR_DIM,
            init="normal", init_b=0.01, seed=seed, optimizer="adagrad",
            lr=SUP_PS_ADAGRAD_LR, heartbeat_ms=100)
        for i, s in enumerate(slots):
            s.table, s.index = table, i
        model = WideDeep(CTR_F, CTR_DIM, CTR_DENSE, CTR_HIDDEN,
                         generator=torch.Generator(device=device).manual_seed(
                             seed), device=device)

        def loss_fn(params, model_state, batch, gen, train):
            rows = batch["rows"].requires_grad_()
            logit = model(batch["dense"], rows)
            loss = ops.binary_cross_entropy_with_logits(
                logit, batch["y"]).mean()
            # the rows' gradient rides the metrics out to the push; the
            # Executor then takes the parameters' from the same graph
            ge, = torch.autograd.grad(loss, rows, retain_graph=True)
            return loss, ({"ge": ge}, model_state)

        def batch_fn(i):
            lo = (i * CTR_B) % (n - CTR_B)
            ids = sparse[lo:lo + CTR_B]
            rows = table.sparse_pull(ids.reshape(-1))
            return {"dense": dense_x[lo:lo + CTR_B], "ids": ids,
                    "rows": rows.reshape(CTR_B, CTR_F, CTR_DIM),
                    "y": y[lo:lo + CTR_B]}

        losses = []

        def post_step(i, st, metrics, batch):
            table.sparse_push(batch["ids"].reshape(-1),
                              metrics["ge"].detach().reshape(-1, CTR_DIM)
                              .float().cpu().numpy())
            losses.append((i, float(metrics["loss"])))

        ex = Executor(loss_fn, AdamOptimizer(CTR_PS_LR), seed=seed)
        guard = _sup_checked_guard(table, os.path.join(workdir, "snap.npz"))
        sup = Supervisor(ex, injector=FaultInjector(sched, shard_procs=slots),
                         guards=[guard], ckpt_every=SUP_PS_EVERY, retries=25,
                         backoff_base_s=0.05, backoff_max_s=0.5, seed=seed)
        built = time.perf_counter() - t0
        counters = _all_counters()
        for c in counters:
            c.launches = 0
        tracer = trace.enable()
        t1 = time.perf_counter()
        try:
            rep = sup.run(ex.init_state(model), batch_fn, SUP_PS_STEPS,
                          post_step=post_step)
        finally:
            trace.disable()
        run_s = time.perf_counter() - t1
        ps_launches = [c.launches for c in counters]
        recovered = table.recovered
    finally:
        if table is not None:
            table.close()
        for s in slots:
            s.close()
    c = rep.counters
    print(f"[supervise] ps: WideDeep hidden {CTR_HIDDEN} Adam({CTR_PS_LR:g})"
          f" on a PartitionedPSTable({CTR_PS_V}, {CTR_DIM}, adagrad, lr "
          f"{SUP_PS_ADAGRAD_LR:g}) over 2 van shard processes, B {CTR_B}, "
          f"{SUP_PS_STEPS} steps under FaultSchedule.generate("
          f"{', '.join(f'{k}={v}' for k, v in SUP_PS_SCHEDULE.items())}) = "
          f"{sched.to_json()}; built in {built:.1f} s, ran in {run_s:.1f} s "
          f"[{card}]")
    print(f"[supervise] ps counters: " + ", ".join(
        f"{k} {c.get(k, 0)}" for k in (
            "shards_killed", "van_errors_injected", "nan_injected",
            "nonfinite_steps_skipped", "retries", "retries_data",
            "retries_guard", "retries_post_step", "shard_repairs",
            "shard_snapshots", "shard_snapshot_errors"))
          + f"; table.recovered {recovered} [{card}]")
    check(c.get("shards_killed") == 1 and c.get("van_errors_injected") == 2
          and c.get("nan_injected") == 1
          and c.get("nonfinite_steps_skipped", 0) >= 1
          and c.get("retries", 0) >= 2 and c.get("shard_repairs", 0) >= 1
          and recovered >= 1, f"supervise ps: counters {dict(c)}, "
                              f"recovered {recovered}")
    check(guard.checked and all(x["bitwise"] and x["live_unchanged"]
                                for x in guard.checked),
          f"supervise ps: the repair was not checked: {guard.checked}")
    vals = [x for _, x in losses]
    check(rep.step == SUP_PS_STEPS and len(vals) == SUP_PS_STEPS - c[
        "nonfinite_steps_skipped"] and all(np.isfinite(vals)),
          f"supervise ps: step {rep.step}, {len(vals)} finite losses")
    first, last = float(np.mean(vals[:5])), float(np.mean(vals[-5:]))
    print(f"[supervise] ps losses (finite steps): "
          f"{' '.join(f'{x:.4f}' for x in vals)}; mean of the first five "
          f"{first:.4f}, of the last five {last:.4f} [{card}]")
    check(last < first, "supervise ps: the loss did not fall")
    pairs = timeline.correlate(tracer.events)
    by = {}
    for p in pairs:
        by.setdefault(p.kind, []).append(p)
    for kind, name in (("kill_shard", "recovery.shard_repair"),
                       ("nan_grad", "recovery.nonfinite_skip"),
                       ("van_error", "recovery.retry")):
        check(kind in by and all(p.paired and p.recovery_name == name
                                 for p in by[kind]),
              f"supervise ps: fault.{kind} is not paired with {name}: "
              f"{by.get(kind)}")
        for p in by[kind]:
            print(f"[supervise] ps: fault.{kind} -> {p.recovery_name}: "
                  f"detection {p.detect_s * 1e3:.3f} ms, recovery "
                  f"{p.recover_s * 1e3:.3f} ms [{card}]")
    snaps = [e["dur"] / 1e3 for e in tracer.events
             if e["name"] == "supervisor.shard_snapshot"]
    snap_mb = os.path.getsize(os.path.join(workdir, "snap.npz")) / 1e6
    wire_mb = CTR_PS_V * (3 * CTR_DIM * 4 + 8) / 1e6
    repair = guard.checked[0]
    kill_s = by["kill_shard"][0].recover_s
    slot = slots[int(next(e.arg for e in sched.events
                          if e.kind == "kill_shard"))]
    print(f"[supervise] ps: {len(snaps)} snapshots of {wire_mb:.1f} MB "
          f"pulled (rows, two slots, steps) and a {snap_mb:.1f} MB file: "
          f"ms {' '.join(f'{x:.1f}' for x in snaps)}; the repair of shard "
          f"{repair['shard']} ({repair['rows']} rows and slots bitwise the "
          f"snapshot of before its death; the live shard unchanged) "
          f"{repair['ms']:.1f} ms; the kill -> heartbeat saw it dead "
          f"{slot.dead_seen_s:.3f} s, -> respawned READY "
          f"{slot.respawned_s:.3f} s, -> repaired {kill_s:.3f} s [{card}]")
    return dict(counters=dict(c), recovered=recovered, losses=vals,
                snapshot_ms=snaps, snapshot_mb=snap_mb, wire_mb=wire_mb,
                repair_ms=repair["ms"], death_to_repaired_s=kill_s,
                respawned_s=slot.respawned_s, run_s=run_s,
                launches=ps_launches)


def phase_supervise(card, seed, device="cuda"):
    """The training supervisor (resilience/supervisor.py): (a) GPT-2-small
    preempted by a real SIGTERM and resumed step-exactly in a fresh
    process past a corrupt checkpoint; (b) a PS-hybrid Wide & Deep run
    whose van shard process is SIGKILLed and repaired from the guard's
    snapshot.  Returns the numbers for the summary and the kernels
    line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="supervise_") as root:
        gpt = _sup_gpt_arm(card, seed, device, root)
        if device == "cuda":
            torch.cuda.empty_cache()
        ps_dir = os.path.join(root, "ps")
        os.makedirs(ps_dir)
        ps = _sup_ps_arm(card, seed, device, ps_dir)
    out = dict(gpt=gpt, ps=ps, launches=gpt["launches"],
               ps_launches=ps["launches"],
               seconds=time.perf_counter() - t0)
    print(f"[supervise] phase {out['seconds']:.1f} s (budget "
          f"{SUP_BUDGET_S:g} s); launches of the six kernels: gpt "
          f"{out['launches']}, ps {out['ps_launches']} [{card}]")
    return out


_ELASTIC_T0 = [0.0]


def _elastic_t():
    """Seconds since the elastic phase began, printed on its lines."""
    return time.perf_counter() - _ELASTIC_T0[0]


@contextlib.contextmanager
def _elastic_blas_threads():
    """The BLAS threads of every process the phase spawns: the host's
    cores over the workers (at least 1), set in this process's
    environment for its children and restored after."""
    n = str(max(1, len(os.sched_getaffinity(0)) // ELASTIC_WORKERS))
    keys = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: n for k in keys})
    try:
        yield int(n)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _elastic_kw(seed, port, **kw):
    """The supervisor's arguments for the phase's problem, over the
    phase's van process."""
    return dict(steps=ELASTIC_STEPS, global_batch=ELASTIC_GB,
                features=ELASTIC_FEATURES, out_dim=ELASTIC_OUT,
                n_samples=ELASTIC_SAMPLES, data_seed=seed, lr=ELASTIC_LR,
                lease_s=ELASTIC_LEASE_S, suspect_grace_s=ELASTIC_GRACE_S,
                ordered_grads=True, own_van=False, port=port,
                spawn_timeout_s=ELASTIC_WAIT_S, **kw)


def _elastic_until(sup, cond, what):
    """Poll the supervisor until ``cond()``; fail after ELASTIC_WAIT_S
    with the fleet's state."""
    deadline = time.monotonic() + ELASTIC_WAIT_S
    while not cond():
        sup.poll()
        check(time.monotonic() < deadline,
              f"elastic: {what} within {ELASTIC_WAIT_S:g} s: "
              f"{[(m.slot, m.state, m.committed) for m in sup.svc.members]}")
        time.sleep(0.02)


def _elastic_step_mib(width):
    """The bytes one ordered-apply step moves over the van at ``width``,
    in MiB: each rank pulls the weights and stages its gradient, rank 0
    pulls the staged block and pushes it back in rank order."""
    return 4 * width * ELASTIC_FEATURES * ELASTIC_OUT * 4 / 2 ** 20


def _elastic_records(workdir):
    """step -> the committed records of the workers' consumed logs (the
    step's latest epoch)."""
    from pathlib import Path

    by_step = {}
    for path in Path(workdir).glob("worker_*_*.jsonl"):
        if path.name.endswith(".trace.jsonl"):
            continue
        for line in path.read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                by_step.setdefault(int(rec["step"]), []).append(rec)
    return {step: [r for r in recs
                   if r["epoch"] == max(x["epoch"] for x in recs)]
            for step, recs in by_step.items()}


_ELASTIC_PARTS = ("bar_sync", "pull", "grad", "push")


def _elastic_steps(records):
    """(median step ms, per-step losses): a step's ms is its slowest
    rank's sync barrier, pull, gradient and push (the commit barrier and
    the pacing sleep are not in the record); its loss the mean of its
    ranks' slice losses."""
    ms = [max(sum(r["ms"][k] for k in _ELASTIC_PARTS) for r in recs)
          for _, recs in sorted(records.items())]
    losses = [float(np.mean([r["loss"] for r in recs]))
              for _, recs in sorted(records.items())]
    return statistics.median(ms), losses


def _elastic_parts(records):
    """The median ms of each part of a step, for rank 0 (whose push
    is the ordered apply) and for the other ranks (stage and wait)."""
    def med(pick):
        return {k: round(statistics.median(
            r["ms"][k] for recs in records.values() for r in recs
            if pick(r["rank"])), 3) for k in _ELASTIC_PARTS}
    return {"rank0": med(lambda r: r == 0), "others": med(lambda r: r > 0)}


def _elastic_no_torch(workdir, tag, pattern="worker_*_*.log",
                      phase="elastic", n_min=1):
    """Hard: at least ``n_min`` member processes of ``workdir`` (their
    logs match ``pattern``) said READY, each with ``jax=0 torch=0``.
    Returns how many did."""
    from pathlib import Path

    lines = [ln for p in Path(workdir).glob(pattern)
             for ln in p.read_text(errors="replace").splitlines()
             if ln.startswith("READY")]
    check(len(lines) >= n_min and all(ln.split()[2:] == ["jax=0", "torch=0"]
                                      for ln in lines),
          f"{phase} {tag}: a member loaded jax or torch: {lines}")
    return len(lines)


def _proc_libs(pid):
    """Whether process ``pid`` has torch's or jaxlib's shared libraries
    mapped (an import of either maps them)."""
    with open(f"/proc/{int(pid)}/maps") as f:
        maps = f.read()
    return {"torch": int("libtorch" in maps or "/torch/lib/" in maps),
            "jax": int("jaxlib" in maps)}


def _elastic_van_mib(port, before):
    """MiB the van received and sent since ``before`` (its stats)."""
    from hetu_tpu_torch.ps import van

    now = van.stats("127.0.0.1", port)
    return (now["bytes_rx"] + now["bytes_tx"] - before["bytes_rx"]
            - before["bytes_tx"]) / 2 ** 20


def _elastic_replay(seed):
    """The plain numpy replay of a clean run: per step, each rank's
    gradient of the mean-squared loss on its slice of the width-invariant
    schedule from the step's weights, then ``w -= lr * g`` rank by rank
    in f32 (the van's SGD)."""
    from hetu_tpu_torch.resilience.multicontroller import (
        WorkerSpec, make_schedule,
    )

    sched = make_schedule(WorkerSpec(
        port=0, slot=-1, n_slots=ELASTIC_WORKERS, steps=ELASTIC_STEPS,
        global_batch=ELASTIC_GB, features=ELASTIC_FEATURES,
        out_dim=ELASTIC_OUT, n_samples=ELASTIC_SAMPLES, data_seed=seed,
        lr=ELASTIC_LR))
    w = np.zeros((ELASTIC_FEATURES, ELASTIC_OUT), np.float32)
    lr = np.float32(ELASTIC_LR)
    for step in range(ELASTIC_STEPS):
        grads = []
        for r in range(ELASTIC_WORKERS):
            xb, yb = sched.local_slice(step, r, ELASTIC_WORKERS)
            grads.append((2.0 / ELASTIC_GB) * (xb.T @ (xb @ w - yb)))
        for g in grads:
            w = w - lr * g
    return w


def _elastic_twins(card, seed, root, port):
    """(a): two clean in-process supervisors, the same seed.  Hard: both
    complete covers, their final weights bitwise equal and within
    ELASTIC_REPLAY_TOL of max|w| of the numpy replay, the loss of the
    last 4 steps below the first 4's, no worker with jax or torch."""
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.resilience.multicontroller import (
        MultiControllerElasticSupervisor,
    )

    runs = []
    for i in (1, 2):
        workdir = os.path.join(root, f"clean_{i}")
        os.makedirs(workdir)
        before = van.stats("127.0.0.1", port)
        t0 = time.perf_counter()
        sup = MultiControllerElasticSupervisor(
            ELASTIC_WORKERS, workdir=workdir, **_elastic_kw(seed, port))
        try:
            up_s = time.perf_counter() - t0
            rep = sup.run(deadline_s=ELASTIC_WAIT_S)
            run_s = time.perf_counter() - t0 - up_s
            sup.verify_consumed(rep["consumed"])
            repushed = int(sup.fleet_metrics().counter(
                "ps.dp_repush_duplicates").value)
        finally:
            sup.close()
        records = _elastic_records(workdir)
        step_ms, losses = _elastic_steps(records)
        runs.append(dict(w=rep["final_weights"], up_s=up_s, run_s=run_s,
                         step_ms=step_ms, losses=losses, repushed=repushed,
                         parts=_elastic_parts(records),
                         mib=_elastic_van_mib(port, before) / ELASTIC_STEPS,
                         ready=_elastic_no_torch(workdir, f"(a) run {i}")))
    w1, w2 = runs[0]["w"], runs[1]["w"]
    check(w1.shape == (ELASTIC_FEATURES, ELASTIC_OUT) and
          bool(np.isfinite(w1).all()),
          f"elastic (a): final weights {w1.shape}, finite "
          f"{bool(np.isfinite(w1).all())}")
    check(np.array_equal(w1, w2),
          f"elastic (a): the twins differ, max |d| "
          f"{float(np.abs(w1 - w2).max())}")
    t0 = time.perf_counter()
    ref = _elastic_replay(seed)
    replay_s = time.perf_counter() - t0
    gap = float(np.abs(w1 - ref).max())
    scale = float(np.abs(ref).max())
    check(gap <= ELASTIC_REPLAY_TOL * scale,
          f"elastic (a): max |d| to the numpy replay {gap:.3e} > "
          f"{ELASTIC_REPLAY_TOL:g} x {scale:.4f}")
    losses = runs[0]["losses"]
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    check(len(losses) == ELASTIC_STEPS and last < first,
          f"elastic (a): loss of the first 4 steps {first:.6f}, of the "
          f"last 4 {last:.6f} ({len(losses)} steps)")
    out = dict(max_gap=gap, scale=scale, loss_first=first, loss_last=last,
               replay_s=replay_s, repushed=[r["repushed"] for r in runs],
               **{k: [r[k] for r in runs]
                  for k in ("up_s", "run_s", "step_ms", "mib", "parts")})
    print(f"[elastic] (a) clean twins: verify_consumed passed in both; "
          f"final weights [{ELASTIC_FEATURES}, {ELASTIC_OUT}] f32 bitwise "
          f"equal; max |d| to the numpy replay {gap:.3e} (bound "
          f"{ELASTIC_REPLAY_TOL:g} x max|w| {scale:.6f}); loss of steps 0-3 "
          f"{first:.6f} -> steps {ELASTIC_STEPS - 4}-{ELASTIC_STEPS - 1} "
          f"{last:.6f}; step ms median "
          f"{[round(x, 3) for x in out['step_ms']]}; van MiB a step "
          f"{[round(x, 3) for x in out['mib']]} (the apply's "
          f"{_elastic_step_mib(ELASTIC_WORKERS):.3f}); fleet up "
          f"{[round(x, 3) for x in out['up_s']]} s, run "
          f"{[round(x, 3) for x in out['run_s']]} s; replay "
          f"{replay_s:.3f} s; re-pushed {out['repushed']}; "
          f"{sum(r['ready'] for r in runs)} workers READY jax=0 torch=0 "
          f"[{card}] t+{_elastic_t():.1f} s", flush=True)
    for i, run in enumerate(runs, 1):
        print(f"[elastic] (a) run {i}: median ms of a step's parts, rank 0 "
              f"(its push is the ordered apply) {run['parts']['rank0']}, "
              f"ranks 1-2 {run['parts']['others']} [{card}]", flush=True)
    return out, w1


def _elastic_worker_kill(card, seed, workdir, port):
    """(b): the seeded worker SIGKILL and a replacement process.  Hard:
    the shrink at width 2, 5 survivor steps, the grow back to 3 at a
    resume no earlier, a complete cover at widths exactly {2, 3}, one
    worker killed, the kill paired with ``elastic.reshard`` within 10 s,
    no worker with jax or torch."""
    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.resilience.faults import FaultInjector, FaultSchedule
    from hetu_tpu_torch.resilience.multicontroller import (
        MultiControllerElasticSupervisor,
    )
    from hetu_tpu_torch.telemetry import timeline, trace

    schedule = FaultSchedule.generate(steps=ELASTIC_STEPS, seed=77 + seed,
                                      worker_proc_kills=1,
                                      n_workers=ELASTIC_WORKERS)
    (ev,) = schedule.events
    check(ev.kind == "worker_proc_kill",
          f"elastic (b): the seeded schedule drew {ev.kind}")
    before = van.stats("127.0.0.1", port)
    tracer = trace.Tracer()
    trace.enable(tracer=tracer)
    try:
        sup = MultiControllerElasticSupervisor(
            ELASTIC_WORKERS, workdir=workdir,
            **_elastic_kw(seed, port, step_sleep_s=ELASTIC_PACE_S))
        sup.injector = FaultInjector(schedule, worker_procs=sup.procs)
        try:
            _elastic_until(sup, lambda: bool(sup.resizes), "the shrink")
            shrink = sup.resizes[0]
            check(shrink.kind == "shrink" and shrink.width == 2,
                  f"elastic (b): the first resize {shrink}")
            killed = sup.injector.counters["worker_procs_killed"]
            check(killed == 1, f"elastic (b): {killed} workers killed")
            dead = next(s for s in range(ELASTIC_WORKERS)
                        if sup.procs[s].poll() is not None)
            _elastic_until(sup, lambda: min(
                sup.svc.state_of(s).committed
                for s in range(ELASTIC_WORKERS) if s != dead)
                >= shrink.resume_step + 5, "5 steps after the shrink")
            sup.spawn_replacement(dead)  # returns at its READY
            ready_s = sup.procs[dead].ready_s
            t_ready = time.perf_counter()
            _elastic_until(sup, lambda: len(sup.resizes) >= 2, "the grow")
            ready_to_grow_s = time.perf_counter() - t_ready
            grow = sup.resizes[-1]
            check(grow.kind == "grow" and grow.width == 3 and
                  grow.resume_step >= shrink.resume_step,
                  f"elastic (b): the grow {grow} after {shrink}")
            rep = sup.run(deadline_s=ELASTIC_WAIT_S)
            sup.verify_consumed(rep["consumed"])
            widths = {r["width"] for r in rep["resizes"]}
            check(widths == {2, 3}, f"elastic (b): widths {widths}")
            repushed = int(sup.fleet_metrics().counter(
                "ps.dp_repush_duplicates").value)
        finally:
            sup.close()
    finally:
        trace.disable()
    pairs = [p for p in timeline.correlate(tracer.events)
             if p.kind == "worker_proc_kill"]
    check(len(pairs) == 1 and pairs[0].paired and
          pairs[0].recovery_name == "elastic.reshard" and
          pairs[0].detect_s < 10.0,
          f"elastic (b): the kill's pairing {pairs}")
    step_ms, _ = _elastic_steps(_elastic_records(workdir))
    out = dict(kill_step=ev.step, victim=dead, detect_s=pairs[0].detect_s,
               shrink_s=pairs[0].recover_s, ready_s=ready_s,
               ready_to_grow_s=ready_to_grow_s, repushed=repushed,
               shrink_resume=shrink.resume_step,
               grow_resume=grow.resume_step, step_ms=step_ms,
               mib=_elastic_van_mib(port, before) / ELASTIC_STEPS,
               ready=_elastic_no_torch(workdir, "(b)"))
    print(f"[elastic] (b) worker kill: worker {dead} SIGKILLed at step "
          f"{ev.step}; kill -> lease expiry {out['detect_s']:.3f} s, kill "
          f"-> shrink published (width 2, resume {shrink.resume_step}) "
          f"{out['shrink_s']:.3f} s; replacement spawn -> READY "
          f"{ready_s:.3f} s, READY -> grow published (width 3, resume "
          f"{grow.resume_step}) {ready_to_grow_s:.3f} s; widths {{2, 3}}, "
          f"verify_consumed passed; ps.dp_repush_duplicates {repushed}; "
          f"step ms median {step_ms:.3f}; van MiB a step {out['mib']:.3f} "
          f"(re-runs and the probes included); {out['ready']} workers "
          f"READY jax=0 torch=0 [{card}] t+{_elastic_t():.1f} s",
          flush=True)
    return out


def _elastic_controller_kill(card, seed, workdir, port, clean_w):
    """(c): the controller a process of its own (``--controller``) over
    the van, a standby process (``plane="elastic"``) watching; the seeded
    controller SIGKILL.  Hard: the standby PROMOTED and ALLDONE, its
    adopted supervisor at incarnation >= 2 with a ``takeover`` resize, a
    complete cover, the final weights bitwise (a)'s where no gradient was
    re-pushed (else within rtol 0.05, atol 0.01), the kill paired with
    ``ctrl.takeover``, no process of the arm with jax or torch."""
    from pathlib import Path

    from hetu_tpu_torch.ps import van
    from hetu_tpu_torch.ps.van import RemotePSTable
    from hetu_tpu_torch.resilience.faults import FaultInjector, FaultSchedule
    from hetu_tpu_torch.resilience.multicontroller import (
        WorkerSpec, check_complete_cover, make_schedule, merge_consumed_logs,
        worker_metrics,
    )
    from hetu_tpu_torch.resilience.shardproc import spawn_module
    from hetu_tpu_torch.telemetry import fleet, timeline, trace

    schedule = FaultSchedule.generate(steps=ELASTIC_STEPS, seed=11 + seed,
                                      controller_kills=1)
    (ev,) = schedule.events
    check(ev.kind == "controller_kill",
          f"elastic (c): the seeded schedule drew {ev.kind}")
    log_of = lambda p: Path(p.log_path).read_text(errors="replace")  # noqa
    path = os.path.join(workdir, "controller.json")
    with open(path, "w") as f:
        json.dump({"workdir": workdir, "port": port,
                   "n_workers": ELASTIC_WORKERS, "steps": ELASTIC_STEPS,
                   "global_batch": ELASTIC_GB, "data_seed": seed,
                   "features": ELASTIC_FEATURES, "out_dim": ELASTIC_OUT,
                   "n_samples": ELASTIC_SAMPLES, "lr": ELASTIC_LR,
                   "ordered_grads": True, "lease_s": ELASTIC_LEASE_S,
                   "suspect_grace_s": ELASTIC_GRACE_S,
                   "step_sleep_s": ELASTIC_PACE_S,
                   "ctrl_lease_s": ELASTIC_CTRL_LEASE_S,
                   "deadline_s": ELASTIC_WAIT_S}, f)
    before = van.stats("127.0.0.1", port)
    ctrl = spawn_module(workdir, "controller",
                        "hetu_tpu_torch.resilience.multicontroller",
                        ["--controller", path], timeout_s=ELASTIC_WAIT_S)
    spec = WorkerSpec.from_json(sorted(Path(workdir).glob(
        "worker_*_*.json"))[0].read_text())
    path = os.path.join(workdir, "standby.json")
    with open(path, "w") as f:
        json.dump({"workdir": workdir, "port": port, "plane": "elastic",
                   "membership_table": spec.membership_table,
                   "n_slots": spec.n_slots,
                   "lease_bound_s": ELASTIC_STANDBY_BOUND_S, "poll_s": 0.05,
                   "watch_timeout_s": ELASTIC_WAIT_S,
                   "resolve_timeout_s": ELASTIC_WAIT_S,
                   "takeover_kwargs": {"lease_s": ELASTIC_LEASE_S,
                                       "suspect_grace_s": ELASTIC_GRACE_S,
                                       "spawn_timeout_s": ELASTIC_WAIT_S}},
                  f)
    sb = spawn_module(workdir, "standby", "hetu_tpu_torch.resilience.standby",
                      [path], timeout_s=ELASTIC_WAIT_S)
    deadline = time.monotonic() + ELASTIC_WAIT_S
    while "WATCHING" not in log_of(sb):
        check(sb.poll() is None and time.monotonic() < deadline,
              f"elastic (c): the standby never watched: {log_of(sb)[-800:]}")
        time.sleep(0.02)
    libs = {"controller": _proc_libs(ctrl.pid), "standby": _proc_libs(sb.pid)}
    check(all(v == {"torch": 0, "jax": 0} for v in libs.values()),
          f"elastic (c): libraries mapped {libs}")
    tracer = trace.open_process_stream(workdir, "harness")
    try:
        inj = FaultInjector(schedule, ctrl_procs=[ctrl])
        fired = 0
        while ctrl.poll() is None:
            check(time.monotonic() < deadline,
                  f"elastic (c): the kill at step {ev.step} never fired: "
                  f"{log_of(ctrl)[-800:]}")
            cur = sum(ln.startswith("STEP")
                      for ln in log_of(ctrl).splitlines())
            for t in range(fired + 1, cur + 1):
                inj.on_step(t)
            fired = max(fired, cur)
            time.sleep(0.02)
        killed = inj.counters["controller_procs_killed"]
    finally:
        trace.disable()
        if tracer is not None:
            tracer.close()
    check(killed == 1, f"elastic (c): {killed} controllers killed")
    try:
        rc = sb.wait(2 * ELASTIC_WAIT_S)
    except subprocess.TimeoutExpired:
        rc = None
    log = log_of(sb)
    lines = {ln.split(" ", 1)[0]: ln for ln in log.splitlines() if ln}
    check(rc == 0 and {"PROMOTED", "RESOLVED", "ALLDONE"} <= set(lines) and
          "READY jax=0 torch=0" in log,
          f"elastic (c): the standby rc {rc}, log tail {log[-1500:]!r}")
    report = json.loads(lines["RESOLVED"].split(" ", 1)[1])
    inc = report["takeover"]["incarnation"]
    kinds = [r["kind"] for r in report["resizes"]]
    check(inc >= 2 and "takeover" in kinds,
          f"elastic (c): incarnation {inc}, resizes {kinds}")
    table = RemotePSTable("127.0.0.1", port, spec.features, spec.out_dim,
                          table_id=spec.weights_table, create=False)
    try:
        weights = table.dense_pull()
    finally:
        table.close()
    logs = [p for p in Path(workdir).glob("worker_*_*.jsonl")
            if not p.name.endswith(".trace.jsonl")]
    check_complete_cover(merge_consumed_logs(logs), make_schedule(spec),
                         spec.steps)
    repushed = int(worker_metrics(workdir).counter(
        "ps.dp_repush_duplicates").value)
    gap = float(np.abs(weights - clean_w).max())
    if repushed == 0:
        check(np.array_equal(weights, clean_w),
              f"elastic (c): no re-push, yet max |d| to (a) {gap:.3e}")
    else:
        check(np.allclose(weights, clean_w, rtol=0.05, atol=0.01),
              f"elastic (c): {repushed} re-pushed, max |d| to (a) {gap:.3e}")
    merged, _ = fleet.merge_streams(workdir)
    pairs = [p for p in timeline.correlate(merged)
             if p.kind == "controller_kill"]
    check(len(pairs) == 1 and pairs[0].paired and
          pairs[0].recovery_name == "ctrl.takeover",
          f"elastic (c): the kill's pairing {pairs}")
    step_ms, _ = _elastic_steps(_elastic_records(workdir))
    out = dict(kill_step=ev.step, incarnation=inc, repushed=repushed,
               gap=gap, detect_s=pairs[0].detect_s,
               handoff_s=pairs[0].recover_s,
               promoted_s=float(lines["PROMOTED"].split()[1]),
               alldone_s=float(lines["ALLDONE"].split()[1]),
               controller_ready_s=ctrl.ready_s, standby_ready_s=sb.ready_s,
               resume=report["takeover"]["resume_step"], step_ms=step_ms,
               mib=_elastic_van_mib(port, before) / ELASTIC_STEPS,
               ready=_elastic_no_torch(workdir, "(c)"))
    print(f"[elastic] (c) controller kill: controller process READY after "
          f"{ctrl.ready_s:.3f} s (its 3 workers spawned), standby READY "
          f"after {sb.ready_s:.3f} s; SIGKILLed at step {ev.step}; kill -> "
          f"ctrl.takeover start {out['detect_s']:.3f} s, kill -> hand-off "
          f"complete {out['handoff_s']:.3f} s (incarnation {inc}, resume "
          f"{out['resume']}); the standby PROMOTED {out['promoted_s']:.3f} "
          f"s after it saw the silence (bound {ELASTIC_STANDBY_BOUND_S:g} "
          f"s), ALLDONE {out['alldone_s']:.3f} s later; verify_consumed "
          f"passed; ps.dp_repush_duplicates {repushed}, final weights "
          f"{'bitwise' if gap == 0.0 else f'max |d| {gap:.3e} from'} (a)'s; "
          f"step ms median {step_ms:.3f}; van MiB a step {out['mib']:.3f}; "
          f"controller and standby map neither torch nor jax, "
          f"{out['ready']} workers READY jax=0 torch=0 [{card}] "
          f"t+{_elastic_t():.1f} s", flush=True)
    return out


def phase_elastic(card, seed):
    """The multi-controller elastic training plane
    (``resilience/multicontroller.py``, ``resilience/memberproc.py``) and
    the standby's elastic takeover, over one van process: (a) two clean
    3-worker runs, (b) a worker SIGKILL and its replacement, (c) the
    controller process SIGKILLed under a standby process.  No kernel runs
    on this path: its processes are numpy over the van.  Returns the
    numbers for the summary and the kernels line."""
    import tempfile

    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )

    t_phase = _ELASTIC_T0[0] = time.perf_counter()
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    out = {}
    with tempfile.TemporaryDirectory(prefix="elastic_") as root, \
            _elastic_blas_threads() as threads:
        out["blas_threads"] = threads
        port = free_port()
        vanp = spawn_shard_server(root, port, "elastic")
        try:
            check(vanp.ready[1:] == ["jax=0", "torch=0"],
                  f"elastic: the van process READY {vanp.ready}")
            out["a"], clean_w = _elastic_twins(card, seed, root, port)
            for tag, fn in (
                    ("b", lambda d: _elastic_worker_kill(card, seed, d,
                                                         port)),
                    ("c", lambda d: _elastic_controller_kill(
                        card, seed, d, port, clean_w))):
                workdir = os.path.join(root, tag)
                os.makedirs(workdir)
                out[tag] = fn(workdir)
        finally:
            vanp.kill()
            vanp.wait()
            subprocess.run(["pkill", "-9", "-f", root], capture_output=True,
                           timeout=30)
    out["launches"] = [c.launches for c in counters]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[elastic] phase {out['seconds']:.1f} s (budget "
          f"{ELASTIC_BUDGET_S:g} s: "
          f"{'met' if out['seconds'] <= ELASTIC_BUDGET_S else 'missed'}); "
          f"{out['blas_threads']} BLAS threads a process; launches of the "
          f"six kernels {out['launches']} [{card}]", flush=True)
    return out


def _fwd_case(card, shape, causal, gen, runs, tag):
    """The forward kernel at ``shape`` (bf16, contiguous): held against
    its plain version with the row-scaled ``TOL_F``, then timed beside it,
    SDPA and the bound.  ``TOL_O`` is absolute and was set for S <= 1024:
    along a causal sequence of 4096 the rms of output row i falls to about
    sqrt(e / i) (0.026 at the last row), so it would wave through errors
    of a tenth of the last rows' values."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_plain,
    )
    b, h, s, d = shape
    q, k, v = _qkv(shape, s, torch.bfloat16, gen)
    with torch.inference_mode():
        o = flash_attention(q, k, v, causal=causal)
        o_p, _ = flash_attention_plain(q, k, v, causal=causal)
        err = (o.float() - o_p.float()).abs().max().item()
        share = grad_tolerance_share(o, o_p, TOL_F)
        ok = share <= 1.0 and bool(torch.isfinite(o).all())
        del o, o_p
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal), runs)
        plain_ms = device_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal), max(3, runs // 10), 1)
        lib_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal), runs)
    bound_ms, bound_by = flash_bound(b, h, s, s, d, causal)
    tflops = flash_flops(b, h, s, s, d, causal) / ms / 1e9
    print(f"[kernel_shapes] flash_attention bf16 {tag} q{tuple(shape)} "
          f"causal={causal}: max|dO|={err:.3e} (share of TOL_F used "
          f"{share:.3g}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms ({tflops:.1f} "
          f"TFLOP/s, {100 * bound_ms / ms:.1f} % of the bound), plain "
          f"{plain_ms:.4f} ms, library (SDPA, yardstick only) {lib_ms:.4f} "
          f"ms, {ms / lib_ms:.2f}x SDPA, bound {bound_ms:.5f} ms "
          f"({bound_by}) [{card}]")
    check(ok, f"flash_attention disagrees with its plain version ({tag})")
    return dict(shape=list(shape), causal=causal, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=tflops, max_abs_err=err, tol_share=share)


def _bwd_case(card, shape, causal, gen, tag):
    """Both backward kernels at ``shape`` (bf16, contiguous): held against
    the plain backward with ``TOL_D``, then timed beside it, the whole
    ``flash_attention_bwd``, SDPA's backward and the bounds."""
    from hetu_tpu_torch.ops.cuda_kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
        flash_attention_bwd_dq, flash_attention_bwd_plain,
    )
    b, h, s, d = shape
    args = _bwd_inputs(shape, s, torch.bfloat16, causal, gen)
    with torch.no_grad():
        dk, dv = flash_attention_bwd_dkdv(*args, causal=causal)
        dq = flash_attention_bwd_dq(*args, causal=causal)
        want = flash_attention_bwd_plain(*args, causal=causal)
        errs, shares = {}, {}
        for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            errs[name] = (got.float() - ref.float()).abs().max().item()
            shares[name] = grad_tolerance_share(got, ref)
        ok = all(x <= 1.0 for x in shares.values())
        del dk, dv, dq, want
        ms = {"dkdv": device_ms(lambda: flash_attention_bwd_dkdv(
            *args, causal=causal), 20),
              "dq": device_ms(lambda: flash_attention_bwd_dq(
                  *args, causal=causal), 20)}
        plain_ms = device_ms(lambda: flash_attention_bwd_plain(
            *args, causal=causal), 3, 1)
        q, k, v, do = args[:4]
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        whole_ms = device_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=causal), 20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=causal)
    lib_ms = device_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 20)
    print(f"[kernel_shapes] flash_attention_bwd bf16 {tag} q{tuple(shape)} "
          f"causal={causal}: " + " ".join(
              f"max|{n}|={e:.3e}" for n, e in errs.items())
          + " (share of TOL_D used " + " ".join(
              f"{n} {x:.3g}" for n, x in shares.items())
          + f") {'ok' if ok else 'FAIL'}; whole backward {whole_ms:.4f} ms, "
          f"plain backward {plain_ms:.4f} ms, library (SDPA backward, "
          f"yardstick only) {lib_ms:.4f} ms, {whole_ms / lib_ms:.2f}x "
          f"[{card}]")
    check(ok, f"flash backward kernels disagree with the plain backward "
              f"({tag})")
    report = {}
    for name in ("dkdv", "dq"):
        bound_ms, bound_by = flash_bound(b, h, s, s, d, causal, kernel=name)
        tflops = flash_flops(b, h, s, s, d, causal, kernel=name) \
            / ms[name] / 1e9
        report[name] = dict(
            shape=list(shape), causal=causal, ms=ms[name], plain_ms=plain_ms,
            library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
            tflops=tflops, whole_bwd_ms=whole_ms,
            max_abs_err=(max(errs["dk"], errs["dv"]) if name == "dkdv"
                         else errs["dq"]))
        print(f"[kernel_shapes] flash_attention_bwd_{name} bf16 {tag} "
              f"q{tuple(shape)}: kernel {ms[name]:.4f} ms ({tflops:.1f} "
              f"TFLOP/s, {100 * bound_ms / ms[name]:.1f} % of the bound), "
              f"bound {bound_ms:.5f} ms ({bound_by}) [{card}]")
    return report


def phase_kernel_shapes(card):
    """The flash kernels at the Llama and BERT paths' shapes: the
    serving forward at (1, 32, S, 128), the Llama training step's (4, 32,
    4096, 128) causal and BERT's (16, 12, 512, 64) non-causal, forward and
    backward.  Run after the model phases, with the card's memory free:
    the plain versions at (4, 32, 4096, 128) hold [4, 32, 4096, 4096] f32
    scores (8.6 GB each)."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    fwd = {}
    for s in LLAMA_FWD_S:
        fwd[f"llama_serve_s{s}"] = _fwd_case(
            card, (1, LLAMA_NH, s, LLAMA_HEAD_DIM), True, gen, 60,
            f"llama_serve S={s}")
    train = (LLAMA_TRAIN_B, LLAMA_NH, LLAMA_TRAIN_S, LLAMA_HEAD_DIM)
    bert = (BERT_B, BERT_NH, BERT_S, BERT_H // BERT_NH)
    fwd["llama_train"] = _fwd_case(card, train, True, gen, 20,
                                   "llama_train")
    torch.cuda.empty_cache()
    fwd["bert_train"] = _fwd_case(card, bert, False, gen, 20, "bert_train")
    bwd = {"llama_train": _bwd_case(card, train, True, gen, "llama_train")}
    torch.cuda.empty_cache()
    bwd["bert_train"] = _bwd_case(card, bert, False, gen, "bert_train")
    return fwd, {k: {tag: r[k] for tag, r in bwd.items()}
                 for k in ("dkdv", "dq")}


# ---------------------------------------------------------------- mesh
# The data- and tensor-parallel plane: two rank processes on the one card
# over gloo (NCCL refuses two ranks on one GPU), then one rank over nccl.
MESH_L = 4  # of GPT-2-small's 12 layers, at full width (V, H, NH, FFN)
MESH_B, MESH_S, MESH_STEPS = 4, 256, 3
MESH_LR = 1e-4
MESH_F32_L, MESH_F32_B, MESH_F32_S, MESH_F32_STEPS = 2, 2, 128, 2
MESH_SERVE_L = 2
MESH_REQS, MESH_PROMPT, MESH_GEN = 4, 24, 32
MESH_SERVE_LEN = 64
# the gates, fixed before the first run: a bf16 arm's loss within 2^-7 of
# the single process's (relative, each step: two roundings of a bf16
# partial sum apart); the f32 arm within the reference's own rtol 2e-4
# (tests/test_sharded_gpt.py, tests/test_strategies.py); the int8 arm
# within 10 % of the exact arm; the collectives within 1e-6 of max|ref|
# (two-rank sums are exact in either order: 0 expected)
TOL_MESH_BF16 = 2 ** -7
TOL_MESH_F32 = 2e-4
MESH_INT8_REL = 0.10
TOL_MESH_COLL = 1e-6
MESH_BUDGET_S = 90.0


def mesh_config(layers, dtype, s=MESH_S):
    from hetu_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=V, hidden_size=H, num_layers=layers,
                     num_heads=NH, ffn_size=FFN, max_position=max(s, 1024),
                     dropout_rate=0.0, dtype=dtype, attention_impl="flash",
                     remat=dtype == torch.bfloat16, fused_ce=True)


def mesh_batch(seed, b, s, masked: bool):
    """Token ids ``[b, s]`` from ``seed``; ``masked`` makes the first dp
    shard hold fewer valid labels than the second (half of row 0 is -1),
    where a per-shard mean differs from the global batch's."""
    ids = np.random.default_rng(seed + 7).integers(0, V, (b, s))
    if masked:
        ids[0, s // 2:] = -1
    return torch.tensor(ids, dtype=torch.int64)


def mesh_train(seed, layers, dtype, steps, batch, device, mesh=None,
               strategy=None, grad_sync="exact"):
    """``steps`` Executor steps of GPT-2-small at ``layers`` layers:
    (losses, step seconds, launches of the three flash kernels)."""
    from hetu_tpu_torch.models import GPTModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.train import Executor

    gen = torch.Generator(device=device).manual_seed(seed)
    model = GPTModel(mesh_config(layers, dtype, batch.shape[1]),
                     generator=gen, device=device)
    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(MESH_LR), mesh=mesh,
                  dist_strategy=strategy, grad_sync=grad_sync, seed=seed)
    state = ex.init_state(model)
    counters = _flash_counters()
    for c in counters:
        c.launches = 0
    losses, times = [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        state, m = ex.run("train", state, (batch,))
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    return [losses, times, [c.launches for c in counters], state]


def mesh_requests(seed):
    g = np.random.default_rng(seed + 11)
    return [g.integers(0, V, MESH_PROMPT).tolist() for _ in range(MESH_REQS)]


def mesh_serve(seed, device, mesh=None):
    """Greedy tokens of ``MESH_REQS`` requests of ``MESH_GEN`` tokens
    through ``ServeEngine`` and ``PagedServeEngine`` (f32 GPT-2-small at
    ``MESH_SERVE_L`` layers), and the flash forwards they launched."""
    from hetu_tpu_torch.models import GPTModel
    from hetu_tpu_torch.serve import (
        ContinuousBatchingScheduler, PagedServeEngine, Request, ServeEngine,
    )
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    model = GPTModel(mesh_config(MESH_SERVE_L, torch.float32),
                     generator=gen, device=device)
    out, launches = {}, 0
    fwd = _flash_counters()[0]
    for name, make in (("slot", lambda: ServeEngine(
            model, num_slots=MESH_REQS, max_len=MESH_SERVE_LEN,
            device=device, mesh=mesh)),
            ("paged", lambda: PagedServeEngine(
                model, num_slots=MESH_REQS, max_len=MESH_SERVE_LEN,
                page_size=PAGE_SIZE, device=device, mesh=mesh))):
        engine = make()
        fwd.launches = 0
        sched = ContinuousBatchingScheduler(engine)
        reqs = [Request(prompt=p, max_tokens=MESH_GEN)
                for p in mesh_requests(seed)]
        for r in reqs:
            sched.submit(r)
        while sched.has_work():
            sched.step()
        out[name] = [list(r.tokens) for r in reqs]
        launches += fwd.launches
    return out, launches


def mesh_inputs(rank, shape=(8, 6)):
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn(*shape, generator=g)


def mesh_collectives(rank, mesh, device):
    """Every function of ``parallel.collectives`` on this rank's input."""
    from hetu_tpu_torch.parallel import collectives as C
    x = mesh_inputs(rank).to(device)
    out = {
        "psum": C.psum(x, "dp", mesh=mesh),
        "pmean": C.pmean(x, "dp", mesh=mesh),
        "all_gather": C.all_gather(x, "dp", tiled_dim=1, mesh=mesh),
        "reduce_scatter": C.reduce_scatter(x, "dp", scatter_dim=0,
                                           mesh=mesh),
        "all_to_all": C.all_to_all(x, "dp", split_dim=0, concat_dim=1,
                                   mesh=mesh),
        "hierarchical_all_to_all": C.hierarchical_all_to_all(
            x, "pp", "dp", mesh=mesh),
        "quantized_psum_int8": C.quantized_psum(x, "dp", wire="int8",
                                                block=16, mesh=mesh),
        "quantized_psum_bf16": C.quantized_psum(x, "dp", wire="bf16",
                                                mesh=mesh),
        "quantized_pmean_int8": C.quantized_pmean(x, "dp", wire="int8",
                                                  block=16, mesh=mesh),
        "ppermute_shift": C.ppermute_shift(x, "dp", 1, mesh=mesh),
        "grouped_allreduce": C.grouped_allreduce(mesh, "dp")(x),
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def mesh_expected(rank, world=2):
    """What rank ``rank`` of :func:`mesh_collectives` must hold, assembled
    in one process from every rank's input."""
    from hetu_tpu_torch.quantwire import block_decode, block_encode
    xs = [mesh_inputs(r) for r in range(world)]
    tot = xs[0] + xs[1]
    q = [block_decode(*block_encode(x, 16), x.numel(), x.shape) for x in xs]
    qsum = torch.stack(q).sum(0)
    b16 = torch.stack([x.to(torch.bfloat16).float() for x in xs]).sum(0)
    a2a = [x.chunk(world, 0)[rank] for x in xs]
    return {k: v.numpy() for k, v in {
        "psum": tot, "pmean": tot / world,
        "all_gather": torch.cat(xs, 1),
        "reduce_scatter": tot.chunk(world, 0)[rank],
        "all_to_all": torch.cat(a2a, 1),
        "hierarchical_all_to_all": torch.cat(a2a, 0),
        "quantized_psum_int8": qsum, "quantized_psum_bf16": b16,
        "quantized_pmean_int8": qsum / world,
        "ppermute_shift": xs[(rank - 1) % world],
        "grouped_allreduce": tot}.items()}


def mesh_rank(rank, world, spec):
    """One rank of the mesh phase: arms (a)-(d) on this rank's share
    (unless ``spec["mesh"]`` is False), then the sharded phase's work
    where ``spec["sharded"]`` asks for it (:func:`sharded_rank`) and the
    dppipe phase's where ``spec["dppipe"]`` does (:func:`dppipe_rank`)."""
    g = globals()
    for k, v in spec["consts"].items():
        g[k] = v
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = mesh_arms(rank, spec) if spec.get("mesh", True) else {}
    if spec.get("sharded"):
        out["sharded"] = sharded_rank(rank, world, spec)
    if spec.get("dppipe"):
        out["dppipe"] = dppipe_rank(rank, world, spec)
    return out


def mesh_arms(rank, spec):
    """The mesh phase's arms (a)-(d) in one rank."""
    device = spec["device"]
    seed = spec["seed"]
    from hetu_tpu_torch.parallel import collectives, make_mesh
    from hetu_tpu_torch.parallel.strategies import MegatronLM
    from hetu_tpu_torch.telemetry import default_registry as reg
    out = {"t_start": time.time()}
    tp = make_mesh(tp=2, device=device, backend="gloo")
    dp = make_mesh(dp=2, device=device, backend="gloo")
    # (a) Megatron tp = 2: bf16 flash remat at MESH_L layers, f32 at 2
    batch = mesh_batch(seed, MESH_B, MESH_S, masked=False)
    la, ta, na, st = mesh_train(seed, MESH_L, torch.bfloat16, MESH_STEPS,
                                batch, device, tp, MegatronLM())
    w = st.params["blocks.0.ffn_in.weight"]
    out["a"] = dict(losses=la, times=ta, launches=na,
                    placement=str(w.placements),
                    local_shape=list(w.to_local().shape))
    del st
    f32 = mesh_batch(seed, MESH_F32_B, MESH_F32_S, masked=False)
    lf, _, _, st = mesh_train(seed, MESH_F32_L, torch.float32,
                              MESH_F32_STEPS, f32, device, tp, MegatronLM())
    out["a_f32"] = dict(losses=lf)
    del st
    # (b) dp = 2 on a batch whose shards hold unequal valid counts
    masked = mesh_batch(seed, MESH_B, MESH_S, masked=True)
    lb, tb, nb, st = mesh_train(seed, MESH_L, torch.bfloat16, MESH_STEPS,
                                masked, device, dp)
    del st
    before = (reg.counter("train.grad_sync.bytes_logical").value,
              reg.counter("train.grad_sync.bytes_wire").value)
    li, ti, ni, st = mesh_train(seed, MESH_L, torch.bfloat16, MESH_STEPS,
                                masked, device, dp, grad_sync="int8")
    del st
    out["b"] = dict(
        exact=dict(losses=lb, times=tb, launches=nb),
        int8=dict(losses=li, times=ti, launches=ni,
                  logical=reg.counter("train.grad_sync.bytes_logical").value
                  - before[0],
                  wire=reg.counter("train.grad_sync.bytes_wire").value
                  - before[1]))
    # (c) tp = 2 serving with a kv-head-sharded cache
    _sync(device)
    t0 = time.perf_counter()
    tokens, sl = mesh_serve(seed, device, tp)
    out["c"] = dict(tokens=tokens, launches=sl,
                    seconds=time.perf_counter() - t0)
    # (d) the collectives
    out["d"] = mesh_collectives(rank, dp, device)
    out["staged"] = dict(collectives.STAGED)
    return out


def _mesh_gate(tag, got, ref, tol, card, what="the single process",
               phase="mesh"):
    """Each step's loss against the reference: as many steps, each with
    |d| <= tol x |ref|."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
    print(f"[{phase}] {tag}: losses {[round(x, 6) for x in got]} vs {what} "
          f"{[round(x, 6) for x in ref]}; worst relative gap {worst:.3e} "
          f"(gate {tol:.3e}) [{card}]")
    check(len(got) == len(ref), f"{phase} {tag}: {len(got)} losses, "
                                f"{len(ref)} expected")
    check(worst <= tol, f"{phase} {tag}: loss gap {worst:.3e} > {tol:.3e}")
    return worst


def phase_mesh(card, seed, device="cuda", sharded=False, dppipe=False):
    """The data- and tensor-parallel plane (parallel/, the Executor's
    mesh, dist_strategy and grad_sync, the tp serving engines): the
    single-process references first, then two rank processes on the card
    over gloo run (a)-(d), then one rank over nccl (e).  With ``sharded``
    (``dppipe``) the same two ranks then run the sharded (dppipe) phase's
    work; its results are returned under ``"sharded"`` (``"dppipe"``) and
    its time is not the mesh phase's."""
    import torch.distributed as dist

    from hetu_tpu_torch.parallel import make_mesh, ranks

    t_phase = time.perf_counter()
    print(f"[mesh] GPT-2-small V={V} H={H} NH={NH} FFN={FFN}: tp/dp arms at "
          f"{MESH_L} layers B={MESH_B} S={MESH_S} bf16 flash remat AdamW "
          f"x {MESH_STEPS} steps, f32 arm at {MESH_F32_L} layers; serving "
          f"{MESH_REQS} x {MESH_GEN} tokens at {MESH_SERVE_L} layers f32")
    batch = mesh_batch(seed, MESH_B, MESH_S, masked=False)
    masked = mesh_batch(seed, MESH_B, MESH_S, masked=True)
    ref_a = mesh_train(seed, MESH_L, torch.bfloat16, MESH_STEPS, batch,
                       device)
    ref_f32 = mesh_train(seed, MESH_F32_L, torch.float32, MESH_F32_STEPS,
                         mesh_batch(seed, MESH_F32_B, MESH_F32_S, False),
                         device)
    ref_b = mesh_train(seed, MESH_L, torch.bfloat16, MESH_STEPS, masked,
                       device)
    ref_c, _ = mesh_serve(seed, device)
    t_ref = time.perf_counter() - t_phase
    for ref in (ref_a, ref_f32, ref_b):
        ref[3] = None  # the states: free their memory for the ranks
    if device == "cuda":
        torch.cuda.empty_cache()

    spec = {"seed": seed, "device": device, "consts": rank_consts(),
            "sharded": sharded, "dppipe": dppipe}
    t0 = time.time()
    res = ranks.run(mesh_rank, 2, backend="gloo", args=(spec,),
                    timeout_s=600.0)
    t_ranks = time.time() - t0
    sharded_s = 0.0
    for later in ("sharded", "dppipe"):
        if (sharded, dppipe)[later == "dppipe"]:
            sharded_s += max(r[later]["t_end"] for r in res) - min(
                r[later]["t_start"] for r in res)
    t_ranks -= sharded_s
    start_s = max(r["t_start"] for r in res) - t0
    print(f"[mesh] two ranks over gloo on {device}: {t_ranks:.1f} s, the "
          f"ranks up after {start_s:.1f} s (reference runs {t_ref:.1f} s) "
          f"[{card}]")
    launches = [0] * 6
    for r, out in enumerate(res):
        a, b, c = out["a"], out["b"], out["c"]
        _mesh_gate(f"(a) rank {r} tp=2 bf16", a["losses"], ref_a[0],
                   TOL_MESH_BF16, card)
        _mesh_gate(f"(a) rank {r} tp=2 f32", out["a_f32"]["losses"],
                   ref_f32[0], TOL_MESH_F32, card)
        print(f"[mesh] (a) rank {r}: ffn_in.weight {a['placement']} local "
              f"{a['local_shape']}; step ms "
              f"{[round(x * 1e3, 3) for x in a['times']]}; flash launches "
              f"{a['launches']}")
        expect = [2 * MESH_L * MESH_STEPS, MESH_L * MESH_STEPS,
                  MESH_L * MESH_STEPS]
        for arm, n in (("(a)", a["launches"]), ("(b) exact",
                                                b["exact"]["launches"]),
                       ("(b) int8", b["int8"]["launches"])):
            if device == "cuda":
                check(n == expect, f"mesh {arm} rank {r}: flash launches "
                                   f"{n}, expected {expect}")
        check("Shard" in a["placement"],
              f"mesh (a): ffn_in.weight is not tp-sharded after the "
              f"updates: {a['placement']}")
        _mesh_gate(f"(b) rank {r} dp=2 exact, unequal valid counts",
                   b["exact"]["losses"], ref_b[0], TOL_MESH_BF16, card)
        _mesh_gate(f"(b) rank {r} dp=2 int8 vs the exact arm",
                   b["int8"]["losses"], b["exact"]["losses"],
                   MESH_INT8_REL, card, what="the exact arm")
        i8 = b["int8"]
        print(f"[mesh] (b) rank {r}: grad sync int8 wire {i8['wire']} B vs "
              f"logical {i8['logical']} B ({i8['wire'] / i8['logical']:.4f})"
              f"; step ms exact {[round(x * 1e3, 3) for x in b['exact']['times']]}"
              f", int8 {[round(x * 1e3, 3) for x in i8['times']]} [{card}]")
        for name in ("slot", "paged"):
            same = c["tokens"][name] == ref_c[name]
            print(f"[mesh] (c) rank {r} tp=2 {name} engine: "
                  f"{MESH_REQS} x {MESH_GEN} tokens "
                  f"{'equal' if same else 'DIFFER from'} the single "
                  f"process's ({c['seconds']:.2f} s both engines)")
            check(same, f"mesh (c) rank {r} {name}: tokens differ")
        exp = mesh_expected(r)
        worst = {k: float(np.abs(out["d"][k] - exp[k]).max()
                          / max(1e-30, np.abs(exp[k]).max()))
                 for k in exp}
        print(f"[mesh] (d) rank {r} collectives on {device}, max |d| / "
              f"max|ref|: {', '.join(f'{k} {v:.1e}' for k, v in worst.items())}"
              f"; staged through the host: {out['staged'] or 'none'}")
        check(max(worst.values()) <= TOL_MESH_COLL,
              f"mesh (d) rank {r}: {max(worst, key=worst.get)} off by "
              f"{max(worst.values()):.3e}")
        for i, arm in enumerate((a["launches"], b["exact"]["launches"],
                                 b["int8"]["launches"])):
            for k in range(3):
                launches[k] += arm[k]
        launches[0] += c["launches"]
    # (e) one rank over nccl (the default backend) in this process
    nccl = {}
    if device == "cuda":
        nccl = phase_mesh_nccl(card, seed, batch)
    seconds = time.perf_counter() - t_phase - sharded_s
    print(f"[mesh] phase {seconds:.1f} s (budget {MESH_BUDGET_S:g} s); "
          f"flash launches over both ranks {launches[:3]} [{card}]")
    return dict(launches=launches, seconds=seconds, ranks_s=t_ranks,
                start_s=start_s, staged=res[0]["staged"], nccl=nccl,
                step_ms=[x * 1e3 for x in res[0]["a"]["times"]],
                sharded=[r["sharded"] for r in res] if sharded else None,
                dppipe=[r["dppipe"] for r in res] if dppipe else None)


def rank_consts():
    """The module's sizes and gates the rank processes take over (a test
    may have set them smaller)."""
    return {k: globals()[k] for k in ("V", "H", "NH", "FFN", "PAGE_SIZE")
            + tuple(k for k in globals() if k.startswith(
                ("MESH_", "SHARDED_", "TOL_SHARDED_", "DPPIPE_",
                 "TOL_DPPIPE_")))}


def phase_mesh_nccl(card, seed, batch):
    """(e): the Executor on ``make_mesh(dp=1)`` (nccl, one rank) takes one
    step bitwise the single-device step, and ``make_mesh(tp=2)`` on one
    GPU raises."""
    import torch.distributed as dist

    from hetu_tpu_torch.parallel import make_mesh
    try:
        make_mesh(tp=2)
    except ValueError as e:
        print(f"[mesh] (e) make_mesh(tp=2) on one GPU raises: {e}")
    else:
        raise SmokeFailure("make_mesh(tp=2) on one GPU did not raise")
    mesh = make_mesh(dp=1)
    try:
        backend = dist.get_backend()
        l1, _, _, ref = mesh_train(seed, MESH_L, torch.bfloat16, 1, batch,
                                   "cuda")
        l2, _, _, got = mesh_train(seed, MESH_L, torch.bfloat16, 1, batch,
                                   "cuda", mesh)
        first = None if l1 == l2 else "the loss"
        for n, p in ref.params.items():
            if first is not None:
                break
            q = got.params[n].detach().full_tensor()
            if not torch.equal(p.detach(), q):
                first = n
        print(f"[mesh] (e) one rank over {backend}: one step "
              f"{'bitwise the single-device step' if first is None else 'differs first at ' + first}"
              f" [{card}]")
        check(first is None, f"mesh (e): nccl step differs at {first}")
    finally:
        dist.destroy_process_group()
    return dict(backend=backend, bitwise=first is None)


# ------------------------------------------------------------- sharded
# The fully sharded GPT-MoE (models/gpt_sharded.py) at MoEConfig's widths
# (V 32000, H 512, 8 heads, FFN 2048, E 8, top-2; capacity factor E/k, so
# that no route can drop), depth cut to 4 layers (2 a stage at pp = 2), B 8
# x S 1024, 2 microbatches, bf16 matmuls, Adam 1e-4, 3 steps; in the mesh
# phase's two gloo ranks on the one card, after its arms.
SHARDED_V, SHARDED_H, SHARDED_NH, SHARDED_FFN = 32000, 512, 8, 2048
SHARDED_E, SHARDED_K = 8, 2
SHARDED_CF = SHARDED_E / SHARDED_K
SHARDED_L, SHARDED_M, SHARDED_B, SHARDED_S = 4, 2, 8, 1024
SHARDED_STEPS, SHARDED_LR = 3, 1e-4
SHARDED_F32_L, SHARDED_F32_S, SHARDED_F32_STEPS = 2, 256, 2
# the ring and Ulysses checks' global [B, H, S, D] (bf16), the pipeline
# check's tanh stack: width, layers, batch, microbatches
SHARDED_RING = (2, 8, 2048, 64)
SHARDED_PIPE_D, SHARDED_PIPE_L, SHARDED_PIPE_B, SHARDED_PIPE_M = (
    512, 4, 64, 4)
SHARDED_RUNS = 10
# the gates, fixed before the first run: a bf16 arm's loss within 2^-7 of
# the single process's each step (relative), the f32 arms within the
# reference's rtol 2e-4 (tests/test_sharded_gpt.py); the kernel ring at the
# flash gates for a plain path that rounds at other points (the
# reference's einsum ring rounds neither p nor dS: O within TOL_O +
# RTOL_O |O|, dQ/dK/dV within TOL_TRAIN_GRAD of max|ref|), Ulysses at the
# same-rounding gates (TOL_F, TOL_D) of single-process flash; the
# pipeline at the reference test's rtol 1e-5 (outputs) and 1e-4
# (gradients) of max|ref|; no route dropped
TOL_SHARDED_BF16 = 2 ** -7
TOL_SHARDED_F32 = 2e-4
TOL_SHARDED_PIPE = (1e-5, 1e-4)
SHARDED_BUDGET_S = 75.0
# the arms: (name, mesh axes), the single process first (mesh None, rank
# 0 alone)
SHARDED_ARMS = (("single", None), ("pp2", {"pp": 2}), ("sp2", {"sp": 2}),
                ("tp2", {"tp": 2}), ("ep2", {"ep": 2}), ("dp2", {"dp": 2}))
SHARDED_F32_ARMS = (("single", None), ("sp2", {"sp": 2}), ("ep2", {"ep": 2}))


def sharded_config(dtype, layers):
    from hetu_tpu_torch.models.gpt_sharded import ShardedGPTConfig
    return ShardedGPTConfig(
        vocab_size=SHARDED_V, hidden_size=SHARDED_H, num_layers=layers,
        num_heads=SHARDED_NH, ffn_size=SHARDED_FFN, num_experts=SHARDED_E,
        top_k=SHARDED_K, capacity_factor=SHARDED_CF,
        max_position=max(SHARDED_S, SHARDED_F32_S),
        n_microbatches=SHARDED_M, dtype=dtype)


def sharded_batch(seed, b, s):
    """Token ids and next-token labels ``[b, s]`` (the last -1)."""
    ids = np.random.default_rng(seed + 13).integers(0, SHARDED_V, (b, s))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -1)], axis=1)
    return torch.tensor(ids), torch.tensor(labels)


def sharded_expected(axes, layers, steps, world=2):
    """Each kernel's launches over the ranks of one arm, from the code's
    structure: every rank runs M + pp - 1 pipeline ticks a step, each its
    stage's L / pp blocks (no tick is skipped, bubbles included, and
    autograd runs each one's backward); a block's ring launches one flash
    forward, dK/dV and dQ a visited key block (causal: the rank's sp index
    + 1 of them), its MoE FFN one top-k gate, two gathers (dispatch and
    combine) and their two scatter-adds."""
    axes = axes or {}
    pp, sp = axes.get("pp", 1), axes.get("sp", 1)
    ranks_n = world if axes else 1
    ticks = SHARDED_M + pp - 1
    blocks = ticks * (layers // pp) * steps  # block calls a rank
    flash = sum(blocks * (r % sp + 1) for r in range(ranks_n))
    moe = blocks * ranks_n
    return [flash, flash, flash, moe, 2 * moe, 2 * moe]


def sharded_train(seed, mesh, dtype, layers, s, steps, device):
    """``steps`` Adam steps of ``ShardedGPT`` on ``mesh`` from the seeded
    whole weights: losses, step seconds, the six kernels' launches (their
    counts set to 0 just before the steps), dropped shares, ms a step
    staged through the host by collective."""
    from hetu_tpu_torch.models.gpt_sharded import ShardedGPT
    from hetu_tpu_torch.optim import AdamOptimizer
    from hetu_tpu_torch.parallel import collectives
    model = ShardedGPT(sharded_config(dtype, layers), mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.place(model.init(gen), device)
    ids, labels = sharded_batch(seed, SHARDED_B, s)
    ids, labels = (model.local_batch(x).to(device) for x in (ids, labels))
    opt = AdamOptimizer(SHARDED_LR)
    state = opt.init_state(params)
    step = model.make_train_step(opt)
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    staged = dict(collectives.STAGED)
    losses, times, dropped = [], [], []
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        params, state, m = step(params, state, ids, labels)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        dropped.append(float(m["dropped_frac"]))
    launches = [c.launches for c in counters]
    staged = {k: v - staged.get(k, 0)
              for k, v in collectives.STAGED.items() if v - staged.get(k, 0)}
    return dict(losses=losses, times=times, launches=launches,
                dropped=dropped, staged=staged)


def _events_ms(fn, runs):
    """Mean device time of ``fn()`` from CUDA events around ``runs``
    calls after a warm-up call (the ring's host hops included)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def _qkv_global(seed, device):
    g = torch.Generator(device=device).manual_seed(seed + 17)
    return [torch.randn(*SHARDED_RING, generator=g, device=device,
                        dtype=torch.bfloat16) for _ in range(4)]


def _fwd_bwd(fn, q, k, v, w):
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    o.backward(w)
    return [o.detach(), q.grad, k.grad, v.grad]


def sharded_seq_checks(rank, world, seed, device):
    """(b) the kernel ring against the plain ring on this rank's blocks,
    causal and not; (c) Ulysses against single-process flash attention;
    both timed beside single-process flash at the global shape."""
    from hetu_tpu_torch.ops.cuda_kernels import flash_attention
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_plain,
    )
    from hetu_tpu_torch.parallel.ulysses import ulysses_attention
    import torch.distributed as dist
    mesh = make_mesh(sp=world, device=device, backend="gloo")
    q, k, v, w = _qkv_global(seed, device)
    n = SHARDED_RING[2] // world
    blk = [x[:, :, rank * n:(rank + 1) * n] for x in (q, k, v, w)]
    out = {}
    for causal in (False, True):
        ring = _fwd_bwd(lambda a, b, c: ring_attention(
            a, b, c, mesh, causal=causal), *blk)
        plain = _fwd_bwd(lambda a, b, c: ring_attention_plain(
            a, b, c, mesh, causal=causal), *blk)
        whole = _fwd_bwd(lambda a, b, c: flash_attention(
            a, b, c, causal=causal), q, k, v, w)
        whole = [x[:, :, rank * n:(rank + 1) * n] for x in whole]
        uly = _fwd_bwd(lambda a, b, c: ulysses_attention(
            a, b, c, mesh, causal=causal), *blk)
        # the kernel ring against the reference's einsum ring, which
        # rounds neither p nor dS: the gates of the flash paths that round
        # at other points (TOL_O + RTOL_O for O, TOL_TRAIN_GRAD of the
        # largest |gradient|); Ulysses against single-process flash, the
        # same kernels at the same rounding points: TOL_F and TOL_D
        shares = {"ring": [ring_o_share(ring[0], plain[0])] + [
            float((a.float() - b.float()).abs().max()
                  / (TOL_TRAIN_GRAD * b.float().abs().max()))
            for a, b in zip(ring[1:], plain[1:])],
            "ulysses": [grad_tolerance_share(uly[0], whole[0], TOL_F)] + [
                grad_tolerance_share(a, b) for a, b in zip(uly[1:],
                                                           whole[1:])]}
        out[causal] = dict(shares=shares)
        if device == "cuda":
            out[causal]["ring_ms"] = _events_ms(lambda: ring_attention(
                *blk[:3], mesh, causal=causal), SHARDED_RUNS)
            out[causal]["ulysses_ms"] = _events_ms(lambda: ulysses_attention(
                *blk[:3], mesh, causal=causal), SHARDED_RUNS)
            dist.barrier()
            if rank == 0:  # the card alone
                out[causal]["flash_ms"] = _events_ms(lambda: flash_attention(
                    q, k, v, causal=causal), SHARDED_RUNS)
            dist.barrier()
    return out


def ring_o_share(got, ref):
    """The largest share of its limit, ``TOL_O + RTOL_O * |ref|`` (bf16),
    that an element of the ring's O uses."""
    ref = ref.float()
    limit = TOL_O[torch.bfloat16] + RTOL_O[torch.bfloat16] * ref.abs()
    return float(((got.float() - ref).abs() / limit).max())


def _tanh_block(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _tanh_stack(seed, device, D, L, B):
    """A tanh stack (``[L, D, D]`` weights of 0.05 · N(0, 1), ``[L, D]``
    biases of 0.1 · N(0, 1)), an input and a cotangent ``[B, D]``, drawn
    in that order on ``device`` from ``seed``; and the sequential stack's
    output and the gradients of ``sum(y * cotangent)`` for the layers and
    the input."""
    g = torch.Generator(device=device).manual_seed(seed)
    layers = {"w": torch.randn(L, D, D, generator=g, device=device) * 0.05,
              "b": torch.randn(L, D, generator=g, device=device) * 0.1}
    h = torch.randn(B, D, generator=g, device=device)
    w = torch.randn(B, D, generator=g, device=device)
    seq = {k: v.clone().requires_grad_(True) for k, v in layers.items()}
    h_seq = h.clone().requires_grad_(True)
    y = h_seq
    for i in range(L):
        y = _tanh_block({"w": seq["w"][i], "b": seq["b"][i]}, y)
    (y * w).sum().backward()
    return layers, h, w, dict(y=y.detach(), dh=h_seq.grad,
                              dw=seq["w"].grad, db=seq["b"].grad)


def _gap(a, b):
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def sharded_pipe_check(rank, world, seed, device):
    """(d) GPipe at pp = world on the tanh stack against the sequential
    stack, forward and gradients (this rank's stage rows, the input's):
    the largest |d| over max|ref| of each."""
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.pipeline import GPipe
    mesh = make_mesh(pp=world, device=device, backend="gloo")
    L = SHARDED_PIPE_L
    layers, h, w, ref = _tanh_stack(seed + 19, device, SHARDED_PIPE_D, L,
                                    SHARDED_PIPE_B)
    pipe = GPipe(_tanh_block, mesh, n_microbatches=SHARDED_PIPE_M,
                 remat=True)
    st = {k: v.detach().requires_grad_(True)
          for k, v in pipe.stack_params(layers).items()}
    h_p = h.clone().requires_grad_(True)
    y_p = pipe(st, h_p)
    (y_p * w).sum().backward()
    lps = L // world
    rows = slice(rank * lps, (rank + 1) * lps)
    return dict(y=_gap(y_p.detach(), ref["y"]), dh=_gap(h_p.grad, ref["dh"]),
                dw=_gap(st["w"].grad[rank], ref["dw"][rows]),
                db=_gap(st["b"].grad[rank], ref["db"][rows]))


def sharded_rank(rank, world, spec):
    """The sharded phase's work in one rank of the mesh phase's world:
    (a) the model arms, (b)-(c) the sequence checks, (d) the pipeline."""
    import torch.distributed as dist

    from hetu_tpu_torch.parallel import make_mesh
    device, seed = spec["device"], spec["seed"]
    out = {"t_start": time.time(), "arms": {}, "f32": {}}
    for key, dtype, layers, s, steps, arms in (
            ("arms", torch.bfloat16, SHARDED_L, SHARDED_S, SHARDED_STEPS,
             SHARDED_ARMS),
            ("f32", torch.float32, SHARDED_F32_L, SHARDED_F32_S,
             SHARDED_F32_STEPS, SHARDED_F32_ARMS)):
        for name, axes in arms:
            if axes is None:  # one rank, every axis 1; the other waits
                if rank == 0:
                    out[key][name] = sharded_train(seed, None, dtype, layers,
                                                   s, steps, device)
                dist.barrier()
                continue
            mesh = make_mesh(device=device, backend="gloo", **axes)
            out[key][name] = sharded_train(seed, mesh, dtype, layers, s,
                                           steps, device)
            if device == "cuda":
                torch.cuda.empty_cache()
    out["seq"] = sharded_seq_checks(rank, world, seed, device)
    out["pipe"] = sharded_pipe_check(rank, world, seed, device)
    out["t_end"] = time.time()
    return out


def phase_sharded(card, res, device="cuda"):
    """The sharded phase's gates and lines, from the two ranks' results
    (:func:`sharded_rank`)."""
    t0 = time.perf_counter()
    print(f"[sharded] ShardedGPT V={SHARDED_V} H={SHARDED_H} "
          f"NH={SHARDED_NH} FFN={SHARDED_FFN} E={SHARDED_E} k={SHARDED_K} "
          f"cf={SHARDED_CF:g}: bf16 arms at {SHARDED_L} layers B={SHARDED_B} "
          f"S={SHARDED_S} M={SHARDED_M} Adam x {SHARDED_STEPS} steps, f32 "
          f"arms at {SHARDED_F32_L} layers S={SHARDED_F32_S}; two gloo ranks "
          f"on one {device}")
    launches = [0] * 6
    for key, tol, layers, steps, arms in (
            ("arms", TOL_SHARDED_BF16, SHARDED_L, SHARDED_STEPS,
             SHARDED_ARMS),
            ("f32", TOL_SHARDED_F32, SHARDED_F32_L, SHARDED_F32_STEPS,
             SHARDED_F32_ARMS)):
        ref = res[0][key]["single"]["losses"]
        for name, axes in arms:
            got = [r[key][name] for r in res if name in r[key]]
            n = [sum(g["launches"][i] for g in got) for i in range(6)]
            launches = [a + b for a, b in zip(launches, n)]
            for r, g in enumerate(got):
                worst = max(abs(a - b) / abs(b)
                            for a, b in zip(g["losses"], ref))
                drop = max(g["dropped"])
                print(f"[sharded] (a) {key} {name} rank {r}: losses "
                      f"{[round(x, 6) for x in g['losses']]}; worst relative "
                      f"gap to the single process {worst:.3e} (gate "
                      f"{tol:.3e}); dropped share {drop:g}; step ms after "
                      f"the first {[round(t * 1e3, 3) for t in g['times'][1:]]}"
                      f"; staged {g['staged'] or 'none'} [{card}]")
                check(worst <= tol, f"sharded {key} {name} rank {r}: loss "
                                    f"gap {worst:.3e} > {tol:.3e}")
                check(drop == 0.0, f"sharded {key} {name} rank {r}: routes "
                                   f"dropped ({drop:g})")
                check(all(np.isfinite(g["losses"])),
                      f"sharded {key} {name}: nonfinite loss")
            expect = sharded_expected(axes, layers, steps)
            print(f"[sharded] (e) {key} {name}: launches over the ranks "
                  f"{n} (expected {expect})")
            if device == "cuda":
                check(n == expect, f"sharded {key} {name}: launches {n}, "
                                   f"expected {expect}")
    ep = [sum(r["arms"]["ep2"]["launches"][i] for r in res)
          for i in range(3, 6)]
    if device == "cuda":
        check(min(ep) > 0, f"sharded ep arm: routing kernels launched {ep}")
    for causal in (False, True):
        for r, out in enumerate(res):
            s = out["seq"][causal]
            for tag in ("ring", "ulysses"):
                sh = s["shares"][tag]
                print(f"[sharded] ({'b' if tag == 'ring' else 'c'}) {tag} "
                      f"{'causal' if causal else 'non-causal'} rank {r} "
                      f"{list(SHARDED_RING)} bf16 sp=2: tolerance shares O, "
                      f"dQ, dK, dV {[round(x, 4) for x in sh]} against the "
                      f"{'plain ring' if tag == 'ring' else 'single-process flash'}"
                      f" [{card}]")
                check(max(sh) <= 1.0, f"sharded {tag} causal={causal} rank "
                                      f"{r}: share {max(sh):.3f} > 1")
            if "ring_ms" in s:
                print(f"[sharded] (b) {'causal' if causal else 'non-causal'}"
                      f" rank {r}: kernel ring forward {s['ring_ms']:.4f} "
                      f"ms, Ulysses {s['ulysses_ms']:.4f} ms a call (CUDA "
                      f"events, host hops included; both ranks on the card)"
                      + (f"; single-process flash_attention at "
                         f"{list(SHARDED_RING)} {s['flash_ms']:.4f} ms"
                         if "flash_ms" in s else "") + f" [{card}]")
    for r, out in enumerate(res):
        p = out["pipe"]
        print(f"[sharded] (d) GPipe pp=2 rank {r} vs the sequential stack: "
              f"max|d|/max|ref| y {p['y']:.2e}, dh {p['dh']:.2e}, dw "
              f"{p['dw']:.2e}, db {p['db']:.2e} (gates "
              f"{TOL_SHARDED_PIPE[0]:g}, {TOL_SHARDED_PIPE[1]:g})")
        check(p["y"] <= TOL_SHARDED_PIPE[0], f"sharded pipe y {p['y']:.2e}")
        check(max(p["dh"], p["dw"], p["db"]) <= TOL_SHARDED_PIPE[1],
              f"sharded pipe gradients {p}")
    ranks_s = max(r["t_end"] for r in res) - min(r["t_start"] for r in res)
    seconds = ranks_s + (time.perf_counter() - t0)
    print(f"[sharded] phase {seconds:.1f} s (budget {SHARDED_BUDGET_S:g} s: "
          f"{'met' if seconds <= SHARDED_BUDGET_S else 'missed'}); launches "
          f"over both ranks, rows 1-6 {launches} [{card}]")
    step_ms = {name: [round(t * 1e3, 3) for t in res[0]["arms"][name]
                      ["times"][1:]] for name, _ in SHARDED_ARMS}
    return dict(launches=launches, seconds=seconds, step_ms=step_ms,
                staged={name: res[-1]["arms"][name]["staged"]
                        for name, _ in SHARDED_ARMS[1:]},
                ring={c: res[0]["seq"][c] for c in (False, True)})


# -------------------------------------------------------------- dppipe
# Elastic mesh resharding (resilience/elastic.py), the partial-reduce step
# (parallel/preduce.py), the distributed GCN (ops/distgcn.py), the 1F1B
# pipeline (parallel/pipedream.py) and HetPipe (parallel/hetpipe.py), in
# the mesh phase's two gloo ranks on the one card, after the sharded
# phase.  GPT-2-small at full width and MESH_L layers, bf16 flash remat
# AdamW, B 4 x S 256 (the mesh phase's cut), f32 arms at 2 layers.
DPPIPE_STEPS = 6            # (a): worker 1 lost at step 2, back at step 4
DPPIPE_LOSS_AT, DPPIPE_JOIN_AT = 2, 4
DPPIPE_DATA_B = 24          # the schedule's sequences (one epoch)
DPPIPE_GCN = (GCN_N, GCN_F, GCN_EDGES)  # (c): ogbn-arxiv's sizes
DPPIPE_GCN_RUNS = 5
# (d) the tanh stack (width, layers, batch) and the GPT arm (B 8 x S 512,
# one sequence a microbatch); M = 8 > 2 · pp: the stash slots wrap
DPPIPE_PIPE_D, DPPIPE_PIPE_L, DPPIPE_PIPE_B, DPPIPE_M = 512, 4, 64, 8
DPPIPE_GPT_B, DPPIPE_GPT_S = 8, 512
# (e) HetPipe: the tanh stack, 4 waves synced every 2; two workers at pp 1
# over 12 waves under staleness 2, at a server rate that moves a mean
# square over 256-wide outputs (at 0.1 the summed loss fell only to 0.92
# of the first in 12 waves on an H100)
DPPIPE_HET_D, DPPIPE_HET_L, DPPIPE_HET_B, DPPIPE_HET_M = 256, 4, 32, 4
DPPIPE_HET_WAVES, DPPIPE_HET_LR = 4, 0.05
DPPIPE_TWO_WAVES, DPPIPE_TWO_LR = 12, 1.0
# the gates, fixed before the first run: (a) each step's loss within 2^-7
# of the fault-free run (bf16), the f32 arm's final parameters within the
# reference test's rtol 2e-4 / atol 1e-5 (tests/test_elastic.py); (b) the
# mesh phase's 2^-7; (c) the reference test's rtol 1e-4 / atol 1e-5
# (tests/test_preduce_distgcn.py); (d) GPipe's 1e-5 / 1e-4 of max|ref| for
# the tanh stack, the GPT arm's loss within 2^-7 and each gradient within
# TOL_TRAIN_GRAD of max|G|; (e) 1e-4 of max|ref|
TOL_DPPIPE_BF16 = 2 ** -7
TOL_DPPIPE_F32 = (2e-4, 1e-5)
TOL_DPPIPE_GCN = (1e-4, 1e-5)
TOL_DPPIPE_PIPE = (1e-5, 1e-4)
TOL_DPPIPE_HET = 1e-4
DPPIPE_BUDGET_S = 60.0
# van table and SSP ids: one worker, two workers, the staleness trip (one
# a rank: the id plus the rank)
DPPIPE_TABLE_IDS = (0x7D0_0001, 0x7D0_0002, 0x7D0_0004)
DPPIPE_SSP_IDS = (0x7D0_0010, 0x7D0_0020)


def dppipe_expected(layers=None, steps=None):
    """Each arm's flash launches over both ranks, [fwd, dK/dV, dQ], from
    the code's structure (rows 4-6 launch none): a remat bf16 train step
    launches 2·L forwards and L of each backward kernel a rank, an f32
    step (no remat) L of each; (a) ``steps`` fault-free steps on both
    ranks and the elastic run's 2·steps - (join - loss) rank-steps (the
    lost rank runs none while out), bf16 at L and f32 at 2 layers; (b) 2
    Executor steps and 5 preduce steps on both ranks, 2 one-process steps
    on rank 0; (c), (e) none; (d) the GPT arm's value_and_grad: M·L/2
    forwards a pass on each stage plus M·L/2 recomputed forwards and M·L/2
    of each backward kernel."""
    L = MESH_L if layers is None else layers
    n = DPPIPE_STEPS if steps is None else steps
    el = 2 * n - (DPPIPE_JOIN_AT - DPPIPE_LOSS_AT)
    # each rank-step: the bf16 arm's [2L, L, L] and the f32 arm's [L_f32] * 3
    a = [(el + 2 * n) * (x + MESH_F32_L) for x in (2 * L, L, L)]
    b = [(2 * 2 + 5 * 2 + 2) * x for x in (2 * L, L, L)]
    lps = L // 2
    d = [2 * (3 * DPPIPE_M * lps), 2 * DPPIPE_M * lps, 2 * DPPIPE_M * lps]
    return {"a": a + [0, 0, 0], "b": b + [0, 0, 0], "c": [0] * 6,
            "d": d + [0, 0, 0], "e": [0] * 6}


def _dppipe_counts():
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    return counters


def _state_digest(state):
    """blake2b of this rank's local parameters and optimizer slots (bytes,
    in name order), with the step and rng words."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    tensors = [state.params[n] for n in sorted(state.params)] + [
        d[n] for k in sorted(state.opt_state["slots"])
        for d in [state.opt_state["slots"][k]] for n in sorted(d)]
    for t in tensors:
        t = t.to_local() if hasattr(t, "to_local") else t
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    h.update(np.asarray([state.step, state.opt_state["step"]],
                        np.int64).tobytes())
    h.update(np.asarray(state.rng, np.uint32).tobytes())
    return h.hexdigest()


def _state_bits(params, opt_state):
    """The parameters' and the optimizer slots' bits (:func:`_bits`), in
    name order."""
    return [_bits(t.detach()) for t in [
        params[n] for n in sorted(params)] + [
        d[n] for k in sorted(opt_state["slots"])
        for d in [opt_state["slots"][k]] for n in sorted(d)]]


def dppipe_elastic(rank, seed, device, dtype, layers):
    """(a) one arm: the fault-free dp = 2 run, then the elastic run (worker
    1 lost at DPPIPE_LOSS_AT, back at DPPIPE_JOIN_AT), both supervised
    over one ElasticBatchSchedule: each trained step's loss, the resizes,
    launches by rank, the final state's digest (and, for f32, the gap of
    its parameters to the fault-free run's)."""
    from hetu_tpu_torch.data.dataloader import ElasticBatchSchedule
    from hetu_tpu_torch.models import GPTModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.parallel import MeshConfig, make_mesh
    from hetu_tpu_torch.resilience import (
        FaultEvent, FaultInjector, FaultSchedule, Supervisor,
    )
    from hetu_tpu_torch.resilience.elastic import ElasticSupervisor
    from hetu_tpu_torch.train import Executor
    s = MESH_S if dtype == torch.bfloat16 else MESH_F32_S
    b = MESH_B if dtype == torch.bfloat16 else MESH_F32_B
    data = np.random.default_rng(seed + 23).integers(
        0, V, (DPPIPE_DATA_B * b // MESH_B, s))
    sched = ElasticBatchSchedule(data, b, seed=seed)
    out = {}
    states = {}
    for name in ("fault_free", "elastic"):
        gen = torch.Generator(device=device).manual_seed(seed)
        model = GPTModel(mesh_config(layers, dtype, s), generator=gen,
                         device=device)
        mesh = make_mesh(dp=2, device=device, backend="gloo") \
            if name == "fault_free" else None
        ex = Executor(model.lm_loss_fn(), AdamWOptimizer(MESH_LR),
                      mesh=mesh, seed=seed)
        state = ex.init_state(model)
        losses = []

        def post(step, st, metrics, batch, losses=losses):
            losses.append(float(metrics["loss"]))
        if name == "fault_free":
            sup = Supervisor(ex)
        else:
            faults = FaultSchedule([
                FaultEvent(DPPIPE_LOSS_AT, "worker_loss", 1.0),
                FaultEvent(DPPIPE_JOIN_AT, "worker_join", 1.0)])
            sup = ElasticSupervisor(
                ex, config=MeshConfig(dp=2), device=device, backend="gloo",
                schedule=sched, injector=FaultInjector(faults),
                model_config=model.c)
        counters = _dppipe_counts()
        _sync(device)
        t0 = time.perf_counter()
        rep = sup.run(state, lambda i: (torch.as_tensor(
            sched.global_batch(i)),), DPPIPE_STEPS, post_step=post)
        _sync(device)
        out[name] = dict(losses=losses, seconds=time.perf_counter() - t0,
                         launches=[c.launches for c in counters],
                         step=rep.step)
        if name == "elastic":
            out[name]["resizes"] = [(e.kind, e.worker, e.width, e.step,
                                     e.downtime_s) for e in sup.resizes]
            out[name]["digest"] = _state_digest(rep.state)
        states[name] = rep.state
        del model, ex, sup
    if dtype == torch.float32:
        # the final parameters against the fault-free run's: the largest
        # |d| - atol - rtol |ref| over max |ref| (<= 0 passes)
        rtol, atol = TOL_DPPIPE_F32
        worst = -1.0
        for n, p in states["elastic"].params.items():
            a = p.to_local().detach().float()
            r = states["fault_free"].params[n].to_local().detach().float()
            worst = max(worst, float(((a - r).abs() - atol - rtol * r.abs())
                                     .max()))
        out["f32_excess"] = worst
        out["rng_equal"] = bool(np.array_equal(
            states["elastic"].rng, states["fault_free"].rng))
    return out


def dppipe_preduce(rank, seed, device):
    """(b) GPT-2-small at MESH_L layers: 2 Executor steps at exact dp = 2;
    then preduce_step_fn from the same weights with masks [1, 1], [1, 1]
    (the Executor's two losses), [1, 0] (rank 0's shard alone), [1, 1]
    (the next loss), [0, 0] (nothing moves: digests before and after);
    on rank 0 a one-process replay of the [1, 0] step and the next one
    from a copy of the state after the second step."""
    import torch.distributed as dist

    from hetu_tpu_torch.models import GPTModel
    from hetu_tpu_torch.optim import AdamWOptimizer
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.preduce import preduce_step_fn
    from hetu_tpu_torch.train import Executor
    batch = mesh_batch(seed, MESH_B, MESH_S, masked=False).to(device)
    mesh = make_mesh(dp=2, device=device, backend="gloo")
    counters = _dppipe_counts()

    def gpt():
        gen = torch.Generator(device=device).manual_seed(seed)
        return GPTModel(mesh_config(MESH_L, torch.bfloat16, MESH_S),
                        generator=gen, device=device)
    model = gpt()
    ex = Executor(model.lm_loss_fn(), AdamWOptimizer(MESH_LR), mesh=mesh,
                  seed=seed)
    state = ex.init_state(model)
    exact = []
    for _ in range(2):
        state, m = ex.run("train", state, (batch,))
        exact.append(float(m["loss"]))
    del model, ex, state
    model = gpt()
    lm = model.lm_loss_fn()
    opt = AdamWOptimizer(MESH_LR)
    params = dict(model.named_parameters())
    opt_state = opt.init_state(params)
    step, n = preduce_step_fn(lambda p, ids: lm(p, {}, ids, None, True)[0],
                              opt, mesh)
    losses, times, replay = [], [], None
    for i, mask in enumerate(([1, 1], [1, 1], [1, 0], [1, 1], [0, 0])):
        if i == 2 and rank == 0:
            # the one-process replay starts from this state
            replay = ({k: p.detach().clone() for k, p in params.items()},
                      {"step": opt_state["step"], "slots": {
                          k: {n: t.clone() for n, t in v.items()}
                          for k, v in opt_state["slots"].items()}})
        if i == 4:
            before = [t.clone() for t in _state_bits(params, opt_state)]
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, batch,
                                       np.asarray(mask, np.float32))
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    frozen = all(torch.equal(a, b) for a, b in
                 zip(before, _state_bits(params, opt_state)))
    out = dict(exact=exact, losses=losses, times=times, n=n, frozen=frozen)
    del model, params, opt_state
    if rank == 0:
        model = gpt()
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(replay[0][k])
        lm = model.lm_loss_fn()
        params = dict(model.named_parameters())
        opt_state, one = replay[1], []
        for ids in (batch[:MESH_B // 2], batch):
            loss = lm(params, {}, ids, None, True)[0]
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            params, opt_state = opt.update(grads, opt_state, params)
            one.append(float(loss.detach()))
        out["one_process"] = one
        del model
    dist.barrier()
    out["launches"] = [c.launches for c in counters]
    return out


def dppipe_gcn(rank, seed, device):
    """(c) ``dist_gcn_aggregate`` on a seeded graph at ogbn-arxiv's sizes
    plus one isolated padding node (169 343 is odd; the dst-sharded
    layout needs a multiple of 2), GCN-normalised weights, f32: this
    rank's rows and dL/dh of both routes against one process's
    ``coo_spmm`` on the whole graph; ms a call (CUDA events, both ranks
    calling) and the calls staged through the host."""
    import torch.distributed as dist

    from hetu_tpu_torch.ops.distgcn import (
        dist_gcn_aggregate, shard_edges_by_dst,
    )
    from hetu_tpu_torch.ops.graph_ops import coo_spmm, gcn_norm
    from hetu_tpu_torch.parallel import collectives, make_mesh
    n, f, edges = DPPIPE_GCN
    x, _, src, dst, _ = _graph(seed, n, f, GCN_CLASSES, edges, GCN_INTRA,
                               GCN_NOISE, GCN_TRAIN_SHARE)
    s, d, w = (t.numpy() for t in gcn_norm(torch.tensor(src),
                                           torch.tensor(dst), n))
    npad = n + n % 2
    h = np.zeros((npad, f), np.float32)
    h[:n] = x
    cot = np.random.default_rng(seed + 29).standard_normal(
        (npad, f)).astype(np.float32)
    ss, dd, ww = shard_edges_by_dst(s, d, w, npad, 2)
    mesh = make_mesh(dp=2, device=device, backend="gloo")
    e = ss.shape[0] // 2
    rows = slice(rank * npad // 2, (rank + 1) * npad // 2)
    edge = [torch.tensor(a[rank * e:(rank + 1) * e]).to(device)
            for a in (ss, dd, ww)]
    # the one-process reference: the whole graph, autograd for dL/dh
    h_all = torch.tensor(h, device=device).requires_grad_(True)
    ref = coo_spmm(torch.tensor(s, device=device),
                   torch.tensor(d, device=device),
                   torch.tensor(w, device=device), h_all, npad)
    ref.backward(torch.tensor(cot, device=device))
    ref_y, ref_dh = ref.detach()[rows], h_all.grad[rows]
    rtol, atol = TOL_DPPIPE_GCN
    counters = _dppipe_counts()
    out = {"nodes": n, "padded": npad, "edges": int(s.size),
           "per_rank": e}
    staged0 = dict(collectives.STAGED)
    for ring in (False, True):
        hl = torch.tensor(h[rows], device=device).requires_grad_(True)
        y = dist_gcn_aggregate(hl, *edge, mesh, ring=ring)
        y.backward(torch.tensor(cot[rows], device=device))
        shares = [float(((a - r).abs() / (atol + rtol * r.abs())).max())
                  for a, r in ((y.detach(), ref_y), (hl.grad, ref_dh))]
        hl = hl.detach()
        ms = None
        if device == "cuda":
            ms = _events_ms(lambda: dist_gcn_aggregate(hl, *edge, mesh,
                                                       ring=ring),
                            DPPIPE_GCN_RUNS)
        out["ring" if ring else "gather"] = dict(shares=shares, ms=ms)
    out["staged"] = {k: v - staged0.get(k, 0)
                     for k, v in collectives.STAGED.items()
                     if v - staged0.get(k, 0)}
    out["launches"] = [c.launches for c in counters]
    if device == "cuda":
        dist.barrier()
        if rank == 0:  # the card alone
            args = [torch.tensor(a, device=device) for a in (s, d, w)]
            hd = torch.tensor(h, device=device)
            out["coo_spmm_ms"] = _events_ms(
                lambda: coo_spmm(*args, hd, npad), DPPIPE_GCN_RUNS)
        dist.barrier()
    return out


def dppipe_pipe(rank, seed, device):
    """(d) PipeDream1F1B at pp = 2, M = DPPIPE_M: the tanh stack (f32)
    under a cotangent against the sequential stack (outputs, this stage's
    gradients); GPT-2-small's blocks (MESH_L, MESH_L / 2 a stage), B
    DPPIPE_GPT_B x S DPPIPE_GPT_S, bf16 flash, value_and_grad of the LM
    loss against the same stack and loss in this process: the loss's
    relative gap and each block gradient's gap over max|G|."""
    from torch.func import functional_call

    from hetu_tpu_torch import ops
    from hetu_tpu_torch.models import GPTModel
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.pipedream import PipeDream1F1B
    mesh = make_mesh(pp=2, device=device, backend="gloo")
    L = DPPIPE_PIPE_L
    layers, h, cot, ref = _tanh_stack(seed + 31, device, DPPIPE_PIPE_D, L,
                                      DPPIPE_PIPE_B)
    pipe = PipeDream1F1B(_tanh_block, mesh, n_microbatches=DPPIPE_M)
    stage = pipe.local_stage(pipe.stack_params(layers))
    y, grads = pipe.forward_and_grad(stage, h, cot)
    rows = slice(rank * L // 2, (rank + 1) * L // 2)
    out = {"tanh": dict(y=_gap(y, ref["y"]),
                        dw=_gap(grads["w"][0], ref["dw"][rows]),
                        db=_gap(grads["b"][0], ref["db"][rows]))}
    del ref
    # the GPT blocks
    gen = torch.Generator(device=device).manual_seed(seed)
    model = GPTModel(mesh_config(MESH_L, torch.bfloat16, DPPIPE_GPT_S),
                     generator=gen, device=device)
    ids = np.random.default_rng(seed + 37).integers(
        0, V, (DPPIPE_GPT_B, DPPIPE_GPT_S))
    ids = torch.tensor(ids, device=device)
    with torch.no_grad():
        h = model._embed(ids, model.pos_emb[None, :DPPIPE_GPT_S])
    names = [n for n, _ in model.blocks[0].named_parameters()]
    stacked = {n: torch.stack([dict(b.named_parameters())[n].detach()
                               for b in model.blocks]) for n in names}
    template = model.blocks[0]

    def block_fn(p, x):
        return functional_call(template, p, (x,))

    def loss_fn(o):
        return ops.lm_head_cross_entropy(model.ln_f(o)[:, :-1],
                                         model.tok_emb, ids[:, 1:])
    pipe = PipeDream1F1B(block_fn, mesh, n_microbatches=DPPIPE_M)
    stage = pipe.local_stage(pipe.stack_params(stacked))
    counters = _dppipe_counts()
    _sync(device)
    t0 = time.perf_counter()
    loss, grads = pipe.value_and_grad(stage, h, loss_fn)
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    # the same stack and loss in this process
    x = h
    for b in model.blocks:
        x = b(x)
    ref_loss = loss_fn(x)
    ref = torch.autograd.grad(ref_loss, [p for b in model.blocks
                                         for p in b.parameters()])
    ref = dict(zip([f"{i}.{n}" for i in range(MESH_L) for n in names], ref))
    lps = MESH_L // 2
    worst = 0.0
    for n in names:
        for i in range(lps):
            r = ref[f"{rank * lps + i}.{n}"]
            worst = max(worst, float((grads[n][0, i].float() - r.float())
                                     .abs().max()
                                     / (TOL_TRAIN_GRAD
                                        * r.float().abs().max())))
    out["gpt"] = dict(loss=float(loss), ref_loss=float(ref_loss.detach()),
                      grad_share=worst, seconds=seconds, launches=launches)
    return out


def _het_replay(layers, h, y, waves, sync_every, lr, local_lr):
    """The HetPipe protocol in one process on the sequential tanh stack:
    each wave's loss and the local weights after it."""
    local = {k: v.clone() for k, v in layers.items()}
    server = {k: v.clone() for k, v in layers.items()}
    accum = None
    losses, after = [], []
    for wave in range(1, waves + 1):
        p = {k: v.clone().requires_grad_(True) for k, v in local.items()}
        o = h
        for i in range(p["w"].shape[0]):
            o = _tanh_block({"w": p["w"][i], "b": p["b"][i]}, o)
        loss = ((o - y) ** 2).mean()
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        accum = g if accum is None else {k: accum[k] + g[k] for k in g}
        if wave % sync_every == 0:
            server = {k: server[k] - lr * accum[k] for k in server}
            accum = None
            local = {k: v.clone() for k, v in server.items()}
        else:
            local = {k: local[k] - local_lr * g[k] for k in local}
        losses.append(float(loss))
        after.append(local)
    return losses, after


def dppipe_hetpipe(rank, seed, device, port):
    """(e) HetPipe over a van this world's rank 0 serves: one virtual
    worker at pp = 2 syncing every 2 waves against the protocol's replay
    in this process; two workers at pp = 1 (a rank each) sharing one
    table and a RemoteSSP; a worker whose peer never clocks."""
    import torch.distributed as dist

    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.hetpipe import (
        HetPipeWorker, make_weight_table,
    )
    from hetu_tpu_torch.parallel.pipedream import PipeDream1F1B
    from hetu_tpu_torch.ps.van import RemoteSSP
    g = torch.Generator(device=device).manual_seed(seed + 41)
    D, L, B = DPPIPE_HET_D, DPPIPE_HET_L, DPPIPE_HET_B
    layers = {"w": torch.randn(L, D, D, generator=g, device=device) * 0.1,
              "b": torch.randn(L, D, generator=g, device=device) * 0.1}
    h = torch.randn(B, D, generator=g, device=device)
    y = torch.randn(B, D, generator=g, device=device) * 0.1

    def lf(o):
        return ((o - y) ** 2).mean()

    def table(stacked, tid, create, lr=DPPIPE_HET_LR):
        return make_weight_table(stacked, optimizer="sgd", lr=lr,
                                 remote=("127.0.0.1", port), table_id=tid,
                                 create=create)
    out = {}
    counters = _dppipe_counts()
    # one virtual worker at pp = 2, synced every 2 waves
    mesh = make_mesh(pp=2, device=device, backend="gloo")
    pipe = PipeDream1F1B(_tanh_block, mesh, n_microbatches=DPPIPE_HET_M)
    stacked = pipe.stack_params(layers)
    t = table(stacked, DPPIPE_TABLE_IDS[0], True) if rank == 0 else None
    dist.barrier()
    t = t or table(stacked, DPPIPE_TABLE_IDS[0], False)
    worker = HetPipeWorker(pipe, stacked, t, publish_init=True,
                           sync_every=2, local_lr=DPPIPE_HET_LR)
    t0 = time.perf_counter()
    losses, params = [], []
    for _ in range(DPPIPE_HET_WAVES):
        losses.append(worker.step(h, lf))
        params.append({k: v.clone() for k, v in worker.params.items()})
    seconds = time.perf_counter() - t0
    rl, rp = _het_replay(layers, h, y, DPPIPE_HET_WAVES, 2, DPPIPE_HET_LR,
                         DPPIPE_HET_LR)
    lps = L // 2
    rows = slice(rank * lps, (rank + 1) * lps)
    gap = max(max(_gap(p[k][0], r[k][rows]) for k in p)
              for p, r in zip(params, rp))
    lgap = max(abs(a - b) / abs(b) for a, b in zip(losses, rl))
    out["one"] = dict(gap=gap, loss_gap=lgap, losses=losses,
                      seconds=seconds)
    dist.barrier()
    t.close()
    # two workers at pp = 1, one a rank, over one table and one RemoteSSP
    mesh = make_mesh(dp=2, device=device, backend="gloo")
    pipe = PipeDream1F1B(_tanh_block, mesh, n_microbatches=DPPIPE_HET_M)
    stacked = pipe.stack_params(layers)
    t = table(stacked, DPPIPE_TABLE_IDS[1], True, DPPIPE_TWO_LR) \
        if rank == 0 else None
    dist.barrier()
    t = t or table(stacked, DPPIPE_TABLE_IDS[1], False, DPPIPE_TWO_LR)
    ssp = RemoteSSP("127.0.0.1", port, DPPIPE_SSP_IDS[0], 2, 2)
    worker = HetPipeWorker(pipe, stacked, t, publish_init=rank == 0,
                           worker_id=rank, ssp=ssp)
    dist.barrier()
    if rank == 1:
        worker.pull_weights()
    hw = torch.randn(B, D, generator=torch.Generator(device=device)
                     .manual_seed(seed + 43 + rank), device=device)
    zero = torch.zeros_like(hw)
    two = [worker.step(hw, lambda o: ((o - zero) ** 2).mean())
           for _ in range(DPPIPE_TWO_WAVES)]
    dist.barrier()
    out["two"] = dict(losses=two, clocks=[ssp.clock(0), ssp.clock(1)])
    dist.barrier()
    t.close()
    ssp.close()
    # a peer that never clocks: this rank's own worker, staleness 1
    t = table(stacked, DPPIPE_TABLE_IDS[2] + rank, True)
    ssp = RemoteSSP("127.0.0.1", port, DPPIPE_SSP_IDS[1] + rank, 2, 1)
    worker = HetPipeWorker(pipe, stacked, t, publish_init=True, ssp=ssp,
                           ssp_timeout_ms=50)
    trip = None
    waves = 0
    for _ in range(2):
        try:
            worker.step(h, lf)
            waves += 1
        except RuntimeError as e:
            trip = str(e)
    out["stale"] = dict(waves=waves, trip=trip)
    out["launches"] = [c.launches for c in counters]
    t.close()
    ssp.close()
    return out


def dppipe_rank(rank, world, spec):
    """The dppipe phase's arms (a)-(e) in one rank of the mesh phase's
    world; each arm's seconds."""
    import torch.distributed as dist

    from hetu_tpu_torch.ps import van
    device, seed = spec["device"], spec["seed"]
    out = {"t_start": time.time(), "seconds": {}}

    def arm(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        out["seconds"][name] = time.perf_counter() - t0
        if device == "cuda":
            torch.cuda.empty_cache()
    arm("a_bf16", dppipe_elastic, rank, seed, device, torch.bfloat16, MESH_L)
    arm("a_f32", dppipe_elastic, rank, seed, device, torch.float32,
        MESH_F32_L)
    arm("b", dppipe_preduce, rank, seed, device)
    arm("c", dppipe_gcn, rank, seed, device)
    arm("d", dppipe_pipe, rank, seed, device)
    port = [van.serve(0) if rank == 0 else None]
    dist.broadcast_object_list(port, src=0)
    try:
        arm("e", dppipe_hetpipe, rank, seed, device, port[0])
        dist.barrier()
    finally:
        if rank == 0:
            van.stop()
    out["t_end"] = time.time()
    return out


def phase_dppipe(card, res, device="cuda"):
    """The dppipe phase's gates and lines, from the two ranks' results
    (:func:`dppipe_rank`)."""
    t0 = time.perf_counter()
    print(f"[dppipe] GPT-2-small V={V} H={H} NH={NH} FFN={FFN} at {MESH_L} "
          f"layers B={MESH_B} S={MESH_S} bf16 flash remat AdamW, f32 at "
          f"{MESH_F32_L} layers; two gloo ranks on one {device}")
    exp = dppipe_expected()
    got = {k: [0] * 6 for k in exp}
    # (a) elastic
    for key, layers in (("a_bf16", MESH_L), ("a_f32", MESH_F32_L)):
        ff, el = (res[0][key][n] for n in ("fault_free", "elastic"))
        for r, out in enumerate(res):
            e = out[key]["elastic"]
            kinds = [(k, w) for k, _, w, _, _ in e["resizes"]]
            print(f"[dppipe] (a) {key} rank {r}: resizes {kinds} at steps "
                  f"{[s for *_, s, _ in e['resizes']]}, downtime_s "
                  f"{[round(x[4], 4) for x in e['resizes']]}; {e['step']} "
                  f"steps, {len(e['losses'])} trained here in "
                  f"{e['seconds']:.2f} s (fault-free "
                  f"{out[key]['fault_free']['seconds']:.2f} s); launches "
                  f"{e['launches'][:3]} [{card}]")
            check(kinds == [("shrink", 1), ("grow", 2)],
                  f"dppipe (a) {key} rank {r}: resizes {kinds}")
            n_trained = DPPIPE_STEPS - (r == 1) * (DPPIPE_JOIN_AT
                                                   - DPPIPE_LOSS_AT)
            check(len(e["losses"]) == n_trained,
                  f"dppipe (a) {key} rank {r}: {len(e['losses'])} steps "
                  f"trained, {n_trained} expected")
            for name in ("fault_free", "elastic"):
                got["a"] = [a + b for a, b in zip(
                    got["a"], out[key][name]["launches"])]
            if device == "cuda":
                per = [2 * layers, layers, layers] if key == "a_bf16" else \
                    [layers] * 3
                want = [n_trained * x for x in per]
                check(e["launches"][:3] == want and
                      not any(e["launches"][3:]),
                      f"dppipe (a) {key} rank {r}: launches "
                      f"{e['launches']}, expected {want}")
        tol = TOL_DPPIPE_BF16 if key == "a_bf16" else TOL_DPPIPE_F32[0]
        _mesh_gate(f"(a) {key} rank 0 elastic", el["losses"], ff["losses"],
                   tol, card, "the fault-free dp=2 run", "dppipe")
        digests = {out[key]["elastic"]["digest"] for out in res}
        same = "bitwise equal" if len(digests) == 1 else "DIFFER"
        print(f"[dppipe] (a) {key}: after the grow both ranks' parameters, "
              f"slots, step and rng {same}")
        check(len(digests) == 1, f"dppipe (a) {key}: ranks differ after "
                                 f"the grow")
    f = res[0]["a_f32"]
    print(f"[dppipe] (a) f32 final parameters vs fault-free: largest |d| - "
          f"atol - rtol|ref| {f['f32_excess']:.3e} (rtol "
          f"{TOL_DPPIPE_F32[0]:g}, atol {TOL_DPPIPE_F32[1]:g}: <= 0 "
          f"passes); rng words "
          f"{'bitwise equal' if f['rng_equal'] else 'DIFFER'}")
    check(f["f32_excess"] <= 0.0, f"dppipe (a) f32 parameters off by "
                                  f"{f['f32_excess']:.3e}")
    check(f["rng_equal"], "dppipe (a) f32 rng words differ")
    # (b) partial reduce
    for r, out in enumerate(res):
        b = out["b"]
        got["b"] = [x + y for x, y in zip(got["b"], b["launches"])]
        frozen = "left parameters and slots bitwise" if b["frozen"] \
            else "MOVED parameters or slots"
        print(f"[dppipe] (b) rank {r}: preduce group losses "
              f"{[round(x, 6) for x in b['losses']]} (masks [1,1] [1,1] "
              f"[1,0] [1,1] [0,0]); step ms "
              f"{[round(t * 1e3, 3) for t in b['times']]}; [0,0] {frozen}; "
              f"launches {b['launches'][:3]} [{card}]")
        _mesh_gate(f"(b) rank {r} [1,1] x2", b["losses"][:2], b["exact"],
                   TOL_DPPIPE_BF16, card, "the Executor's exact dp=2",
                   "dppipe")
        check(b["frozen"], f"dppipe (b) rank {r}: [0,0] moved the state")
        check(b["losses"][4] == 0.0, f"dppipe (b) rank {r}: empty group "
                                     f"loss {b['losses'][4]}")
    _mesh_gate("(b) [1,0] and the next step", res[0]["b"]["losses"][2:4],
               res[0]["b"]["one_process"], TOL_DPPIPE_BF16, card,
               "one process on rank 0's shard", "dppipe")
    # (c) distributed GCN
    for out in res:
        got["c"] = [x + y for x, y in zip(got["c"], out["c"]["launches"])]
        got["e"] = [x + y for x, y in zip(got["e"], out["e"]["launches"])]
    c0 = res[0]["c"]
    print(f"[dppipe] (c) graph: {c0['nodes']} nodes + "
          f"{c0['padded'] - c0['nodes']} isolated padding node, "
          f"{c0['edges']} edges (self loops included), {c0['per_rank']} a "
          f"rank after padding, F={DPPIPE_GCN[1]} f32 dp=2")
    for r, out in enumerate(res):
        c = out["c"]
        for route in ("gather", "ring"):
            sh = c[route]["shares"]
            ms = c[route]["ms"]
            print(f"[dppipe] (c) rank {r} {route}: tolerance shares y, dh "
                  f"{[round(x, 4) for x in sh]} against one process's "
                  f"coo_spmm (rtol {TOL_DPPIPE_GCN[0]:g}, atol "
                  f"{TOL_DPPIPE_GCN[1]:g})"
                  + (f"; {ms:.4f} ms a call" if ms is not None else "")
                  + f" [{card}]")
            check(max(sh) <= 1.0, f"dppipe (c) rank {r} {route}: share "
                                  f"{max(sh):.3f} > 1")
        print(f"[dppipe] (c) rank {r}: staged through the host "
              f"{c['staged'] or 'none'}"
              + (f"; one process's coo_spmm {c['coo_spmm_ms']:.4f} ms"
                 if "coo_spmm_ms" in c else ""))
    # (d) 1F1B
    for r, out in enumerate(res):
        t, gp = out["d"]["tanh"], out["d"]["gpt"]
        got["d"] = [x + y for x, y in zip(got["d"], gp["launches"])]
        print(f"[dppipe] (d) 1F1B pp=2 M={DPPIPE_M} rank {r} tanh "
              f"[{DPPIPE_PIPE_L}, {DPPIPE_PIPE_D}] f32 vs the sequential "
              f"stack: max|d|/max|ref| y {t['y']:.2e}, dw {t['dw']:.2e}, "
              f"db {t['db']:.2e} (gates {TOL_DPPIPE_PIPE[0]:g}, "
              f"{TOL_DPPIPE_PIPE[1]:g})")
        check(t["y"] <= TOL_DPPIPE_PIPE[0], f"dppipe (d) tanh y {t['y']}")
        check(max(t["dw"], t["db"]) <= TOL_DPPIPE_PIPE[1],
              f"dppipe (d) tanh gradients {t}")
        gap = abs(gp["loss"] - gp["ref_loss"]) / abs(gp["ref_loss"])
        print(f"[dppipe] (d) 1F1B GPT blocks rank {r} B={DPPIPE_GPT_B} "
              f"S={DPPIPE_GPT_S} bf16: loss {gp['loss']:.6f} vs the stack "
              f"in one process {gp['ref_loss']:.6f} (gap {gap:.3e}, gate "
              f"{TOL_DPPIPE_BF16:.3e}); block gradients' largest share "
              f"{gp['grad_share']:.4f} of {TOL_TRAIN_GRAD:g} max|G|; "
              f"value_and_grad {gp['seconds'] * 1e3:.1f} ms; launches "
              f"{gp['launches'][:3]} [{card}]")
        check(gap <= TOL_DPPIPE_BF16, f"dppipe (d) GPT loss gap {gap:.3e}")
        check(gp["grad_share"] <= 1.0, f"dppipe (d) GPT gradient share "
                                       f"{gp['grad_share']:.3f}")
    # (e) HetPipe
    for r, out in enumerate(res):
        e = out["e"]
        one, st = e["one"], e["stale"]
        print(f"[dppipe] (e) rank {r} one worker pp=2 sync_every 2 over "
              f"the van: {DPPIPE_HET_WAVES} waves, largest gap to the "
              f"protocol's replay {one['gap']:.2e} (weights), "
              f"{one['loss_gap']:.2e} (losses) (gate {TOL_DPPIPE_HET:g}); "
              f"{one['seconds']:.2f} s; stalled peer: {st['waves']} wave "
              f"then {'a staleness trip' if st['trip'] else 'NO TRIP'}")
        check(max(one["gap"], one["loss_gap"]) <= TOL_DPPIPE_HET,
              f"dppipe (e) rank {r}: HetPipe off its replay by "
              f"{max(one['gap'], one['loss_gap']):.2e}")
        check(st["waves"] == 1 and st["trip"] and "staleness" in st["trip"],
              f"dppipe (e) rank {r}: the staleness bound did not trip "
              f"({st})")
    two = [out["e"]["two"] for out in res]
    first = sum(t["losses"][0] for t in two)
    last = sum(t["losses"][-1] for t in two)
    clocks = two[0]["clocks"]
    print(f"[dppipe] (e) two workers pp=1 over one table and a RemoteSSP "
          f"(staleness 2, server SGD {DPPIPE_TWO_LR:g}): summed loss "
          f"{first:.6f} -> {last:.6f} over {DPPIPE_TWO_WAVES} waves; clocks "
          f"{clocks}")
    check(last < 0.8 * first, f"dppipe (e) two workers: {first} -> {last}")
    check(clocks == [DPPIPE_TWO_WAVES] * 2, f"dppipe (e) clocks {clocks}")
    # (f) launches
    launches = [0] * 6
    for k in exp:
        launches = [x + y for x, y in zip(launches, got[k])]
        print(f"[dppipe] (f) ({k}) launches over both ranks, rows 1-6 "
              f"{got[k]} (expected {exp[k]})")
        if device == "cuda":
            check(got[k] == exp[k], f"dppipe ({k}): launches {got[k]}, "
                                    f"expected {exp[k]}")
    ranks_s = max(r["t_end"] for r in res) - min(r["t_start"] for r in res)
    seconds = ranks_s + (time.perf_counter() - t0)
    arms = {k: round(max(r["seconds"][k] for r in res), 2)
            for k in res[0]["seconds"]}
    print(f"[dppipe] phase {seconds:.1f} s (budget {DPPIPE_BUDGET_S:g} s: "
          f"{'met' if seconds <= DPPIPE_BUDGET_S else 'missed'}); arms s "
          f"{arms}; launches over both ranks, rows 1-6 {launches} [{card}]")
    return dict(launches=launches, seconds=seconds, arms=arms,
                downtime=[x[4] for x in res[0]["a_bf16"]["elastic"]
                          ["resizes"]],
                gcn_ms={k: res[0]["c"][k]["ms"] for k in ("gather", "ring")},
                pipe_ms=res[0]["d"]["gpt"]["seconds"] * 1e3)


# ---------------------------------------------------------------- mpmd
# The process-level MPMD pipeline plane (parallel/mpmd.py,
# parallel/mpmd_elastic.py) and the standby's mpmd takeover, in processes
# of its own after the dppipe phase.  (a) MPMDStageRunner on the card:
# GPT-2-small's blocks at full width (bf16 flash, no remat, MESH_L blocks,
# MPMD_L / 2 a stage), stage dps [2, 1] as three stage processes over one
# van process, B 4 x S 256 in M = 4 microbatches of one sequence, two
# steps on the same inputs, every weight drawn with numpy from the seed in
# each process.  (b) The elastic pipeline's numpy stages (no kernel):
# GPipe and 1F1B, a middle-stage SIGKILL landed at a committed step.
# (c) The controller process SIGKILLed at a progress step under a standby
# process on plane="mpmd".
MPMD_DPS = (2, 1)
MPMD_L = MESH_L
MPMD_B, MPMD_S, MPMD_M, MPMD_STEPS = 4, 256, 4, 2
# (b), (c): three numpy stages, width 64, B 64 in M = 8 microbatches,
# 24 steps paced 80 ms apart, so a controller killed at step 5 leaves the
# stages more than MPMD_CTRL_LEASE_S of work (they park, and the standby
# adopts a pipeline mid-run); GPipe's stash bound; the seeded kills (the
# middle stage, the controller, both at step 5 of the schedule's draw)
MPMD_EL = dict(steps=24, n_microbatches=8, width=64, batch=64,
               step_sleep_s=0.08)
MPMD_EL_STASH = 3
MPMD_KILL = dict(steps=10, seed=1)
# the leases of (b) and (c): 1 s, as the kernel arm's three processes
# start beside them and hold the host's cores for seconds
MPMD_LEASE_S, MPMD_GRACE_S, MPMD_CTRL_LEASE_S = 1.0, 0.5, 1.0
MPMD_WAIT_S = 60.0  # a wait's own deadline
# the gates, fixed before the first run: (a) the summed loss / M within
# 2^-7 relative of one process running the same stack (bf16); each
# parameter's gradient within TOL_TRAIN_GRAD of max|G| of that process's
# autograd.grad; step 2's gradients equal step 1's at the reference
# test's rtol 1e-6 (tests/test_mpmd.py); (b), (c) bitwise
TOL_MPMD_LOSS = 2 ** -7
MPMD_STEP_RTOL = 1e-6
MPMD_BUDGET_S = 60.0

_MPMD_CHILD_SRC = (
    "import sys\nsys.path.insert(0, sys.argv[1])\nimport chip_smoke\n"
    "sys.exit(chip_smoke.mpmd_stage_child(sys.argv[2]))\n")


def mpmd_consts():
    """The module's sizes the kernel arm's stage processes take over (a
    test may have set them smaller)."""
    return {k: globals()[k] for k in ("V", "H", "NH", "FFN")
            + tuple(k for k in globals() if k.startswith("MPMD_"))}


def mpmd_expected():
    """The kernel arm's flash launches over its three stage processes,
    rows 1-6, from the schedule: each microbatch passes every block once
    a step (on stage 0's replica that owns it, then on stage 1), and with
    no remat a block launches one forward, one dK/dV and one dQ a
    microbatch; rows 4-6 launch none (the embedding runs before the
    counts are set to 0)."""
    per = MPMD_STEPS * MPMD_M * MPMD_L
    return [per, per, per, 0, 0, 0]


def mpmd_model(seed, device):
    """GPT-2-small's embeddings, MPMD_L blocks and final LayerNorm (bf16,
    flash, no remat), every parameter drawn with numpy from ``seed`` —
    the same in every process — and the token ids ``[B, S]``."""
    from hetu_tpu_torch.models import GPTModel

    cfg = dataclasses.replace(mesh_config(MPMD_L, torch.bfloat16, MPMD_S),
                              remat=False)
    model = GPTModel(cfg, device="cpu")
    rng = np.random.default_rng(seed + 43)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            w = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            w *= np.float32(0.02)
            if name.endswith(".scale"):
                w += np.float32(1.0)
            p.copy_(torch.from_numpy(w))
    ids = np.random.default_rng(seed + 47).integers(0, V, (MPMD_B, MPMD_S))
    return model.to(device), torch.tensor(ids, device=device)


def _mpmd_stage_blocks(model, stage):
    lps = MPMD_L // len(MPMD_DPS)
    return list(model.blocks)[stage * lps:(stage + 1) * lps]


def _mpmd_flat_names(blocks):
    return [f"{i}.{n}" for i, b in enumerate(blocks)
            for n, _ in b.named_parameters()]


def mpmd_stage_child(spec_json):
    """One (stage, replica) of the kernel arm in its own process:
    MPMDStageRunner over the stage's blocks on the card, MPMD_STEPS steps;
    prints READY, then RESULT with its launches, step seconds, edge bytes,
    accumulator seconds and step 2's gap to step 1; writes step 1's
    gradients (flat f32, in the stage's parameter order) to the
    workdir."""
    from torch.func import functional_call

    from hetu_tpu_torch import ops
    from hetu_tpu_torch.parallel.mpmd import MPMDStageRunner

    spec = json.loads(spec_json)
    g = globals()
    for k, v in spec["consts"].items():
        g[k] = tuple(v) if isinstance(v, list) else v
    stage, replica = int(spec["stage"]), int(spec["replica"])
    device = spec["device"]
    model, ids = mpmd_model(int(spec["seed"]), device)
    blocks = _mpmd_stage_blocks(model, stage)
    own = [[n for n, _ in b.named_parameters()] for b in blocks]
    params = {f"{i}.{n}": p.detach() for i, b in enumerate(blocks)
              for n, p in b.named_parameters()}
    dtype = model.c.dtype
    mb = MPMD_B // MPMD_M

    def stage_fn(p, x):
        h = x.to(dtype)
        for i, b in enumerate(blocks):
            h = functional_call(b, {n: p[f"{i}.{n}"] for n in own[i]},
                                (h,))
        return h

    runner = MPMDStageRunner(
        stage_fn, stage=stage, replica=replica, stage_dps=list(MPMD_DPS),
        n_microbatches=MPMD_M, in_shape=(mb, MPMD_S, H),
        out_shape=(mb, MPMD_S, H), host="127.0.0.1", port=int(spec["port"]),
        grad_size=sum(p.numel() for p in params.values()), device=device)
    first, last = stage == 0, stage == len(MPMD_DPS) - 1
    data = loss_fn = None
    order = []
    if first:
        with torch.no_grad():
            h = model._embed(ids, model.pos_emb[None, :MPMD_S])
        data = [h[m * mb:(m + 1) * mb] for m in range(MPMD_M)]
    if last:
        tok = model.tok_emb.detach()

        def loss_fn(o):
            m = order.pop(0)  # run_step calls it in ascending order
            return ops.lm_head_cross_entropy(
                model.ln_f(o)[:, :-1], tok, ids[m * mb:(m + 1) * mb, 1:])
    print("READY", stage, replica, f"jax={int('jax' in sys.modules)}",
          flush=True)
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    steps = []
    for _ in range(MPMD_STEPS):
        order[:] = runner._my_microbatches()
        _sync(device)
        t0 = time.perf_counter()
        loss, grads = runner.run_step(params, loss_fn=loss_fn, data=data)
        _sync(device)
        steps.append(dict(loss=loss, s=time.perf_counter() - t0,
                          acc=dict(runner.acc_seconds),
                          flat=torch.cat([g.reshape(-1)
                                          for g in grads.values()])))
    launches = [c.launches for c in counters]
    a, b = steps[0]["flat"], steps[-1]["flat"]
    excess = float(((b - a).abs() - MPMD_STEP_RTOL * a.abs()).max())
    np.save(os.path.join(spec["workdir"], f"grads_{stage}_{replica}.npy"),
            a.cpu().numpy())
    edges = runner.edge_bytes()
    runner.close()
    print("RESULT", json.dumps({
        "stage": stage, "replica": replica, "launches": launches,
        "loss": [s["loss"] for s in steps], "step_s": [s["s"] for s in steps],
        "acc_s": [s["acc"] for s in steps], "step2_excess": excess,
        "step2_bitwise": bool(torch.equal(a, b)), "edges": edges,
        "names": _mpmd_flat_names(blocks),
        "jax": int("jax" in sys.modules)}), flush=True)
    return 0


def _mpmd_children(specs, workdir):
    """Start one stage process a spec; returns (procs, line queues)."""
    import queue

    root = os.path.dirname(os.path.abspath(__file__))
    procs, qs = [], []
    for spec in specs:
        tag = f"stage{spec['stage']}_{spec['replica']}"
        with open(os.path.join(workdir, f"{tag}.err"), "w") as err:
            p = subprocess.Popen(
                [sys.executable, "-c", _MPMD_CHILD_SRC, root,
                 json.dumps(spec)], stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE, stderr=err, text=True)
        p.tag, p.err_path = tag, os.path.join(workdir, f"{tag}.err")
        q = queue.Queue()

        def reader(proc=p, q=q):
            for line in proc.stdout:
                q.put(line.strip())
            q.put(None)

        threading.Thread(target=reader, daemon=True).start()
        procs.append(p)
        qs.append(q)
    return procs, qs


def _mpmd_collect(procs, qs, deadline):
    """Each child's RESULT (and its READY line), or fail with its error
    tail."""
    import queue

    out = []
    for p, q in zip(procs, qs):
        lines = []
        while True:
            try:
                line = q.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                line = None
                lines.append("<deadline>")
            if line is None:
                break
            lines.append(line)
        res = [ln for ln in lines if ln.startswith("RESULT ")]
        if not res:
            with open(p.err_path) as f:
                print(f.read()[-3000:], file=sys.stderr)
        check(bool(res), f"mpmd (a) {p.tag}: no result ({lines[-3:]})")
        rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        check(rc == 0, f"mpmd (a) {p.tag}: exit {rc}")
        r = json.loads(res[0].split(" ", 1)[1])
        r["ready"] = next((ln for ln in lines if ln.startswith("READY")), "")
        out.append(r)
    return out


def _mpmd_reference(seed, device):
    """The same MPMD_L-block stack and loss in this process on the card,
    over the whole batch: the loss, the gradients by stage (flat f32, in
    each stage's parameter order) and their per-parameter max|G|."""
    from hetu_tpu_torch import ops

    model, ids = mpmd_model(seed, device)
    with torch.no_grad():
        h = model._embed(ids, model.pos_emb[None, :MPMD_S])
    x = h
    for b in model.blocks:
        x = b(x)
    loss = ops.lm_head_cross_entropy(model.ln_f(x)[:, :-1],
                                     model.tok_emb.detach(), ids[:, 1:])
    out = {"loss": float(loss.detach()), "grads": {}}
    for s in range(len(MPMD_DPS)):
        blocks = _mpmd_stage_blocks(model, s)
        ps = [p for b in blocks for p in b.parameters()]
        gs = torch.autograd.grad(loss, ps, retain_graph=True)
        out["grads"][s] = [(g.float().cpu(), p.numel()) for g, p in
                           zip(gs, ps)]
    del model, x, loss
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def _mpmd_kernel_arm(card, seed, workdir, device="cuda", during=None):
    """(a): three stage processes (stage dps [2, 1]) over one van process
    on the card against the same stack in this process.  ``during()``
    runs in this process while they start and train (the numpy arms: the
    stage processes need no help from this one), and its result is
    returned beside (a)'s."""
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )

    if device == "cuda":
        check(torch.cuda.is_available(), "mpmd (a): CUDA is not available")
    port = free_port()
    vanp = spawn_shard_server(workdir, port, "mpmd_a")
    procs = []
    try:
        check(vanp.ready[1:] == ["jax=0", "torch=0"],
              f"mpmd (a): the van process READY {vanp.ready}")
        specs = [dict(stage=s, replica=r, seed=seed, port=port,
                      workdir=workdir, device=device, consts=mpmd_consts())
                 for s, dp in enumerate(MPMD_DPS) for r in range(dp)]
        t0 = time.perf_counter()
        deadline = time.monotonic() + 2 * MPMD_WAIT_S
        procs, qs = _mpmd_children(specs, workdir)
        other = during() if during is not None else None
        # the single process's stack
        ref = _mpmd_reference(seed, device)
        res = _mpmd_collect(procs, qs, deadline)
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        vanp.kill()
        vanp.wait()
    launches = [sum(r["launches"][i] for r in res) for i in range(6)]
    last = next(r for r in res if r["stage"] == len(MPMD_DPS) - 1)
    losses = [x / MPMD_M for x in last["loss"]]
    gap = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
    worst, worst_name = 0.0, ""
    for r in res:
        got = torch.from_numpy(np.load(os.path.join(
            workdir, f"grads_{r['stage']}_{r['replica']}.npy")))
        off = 0
        for name, (g, n) in zip(r["names"], ref["grads"][r["stage"]]):
            share = float((got[off:off + n] - g.reshape(-1)).abs().max()
                          / (TOL_TRAIN_GRAD * g.abs().max()))
            if share > worst:
                worst, worst_name = share, f"stage {r['stage']} {name}"
            off += n
        check(off == got.numel(), f"mpmd (a) stage {r['stage']}: "
                                  f"{got.numel()} gradient elements, "
                                  f"{off} expected")
    for r in sorted(res, key=lambda r: (r["stage"], r["replica"])):
        acc = r["acc_s"][-1]
        print(f"[mpmd] (a) stage {r['stage']} replica {r['replica']}: step "
              f"ms {[round(t * 1e3, 3) for t in r['step_s']]}; edges "
              f"{r['edges']}; accumulator push/pull ms "
              f"{round(acc['push'] * 1e3, 3)}/{round(acc['pull'] * 1e3, 3)};"
              f" step 2 vs step 1 "
              f"{'bitwise' if r['step2_bitwise'] else 'differs'} (largest "
              f"|d| - rtol|g| {r['step2_excess']:.3e}); launches "
              f"{r['launches']}; {r['ready']} [{card}]")
    exp = mpmd_expected()
    print(f"[mpmd] (a) stage_dps {list(MPMD_DPS)} GPT-2-small H={H} NH={NH} "
          f"FFN={FFN} bf16 flash no remat, {MPMD_L} blocks "
          f"({MPMD_L // len(MPMD_DPS)} a stage) B={MPMD_B} S={MPMD_S} "
          f"M={MPMD_M}: loss/M {[round(x, 6) for x in losses]} vs the stack "
          f"in one process {ref['loss']:.6f} (gap {gap:.3e}, gate "
          f"{TOL_MPMD_LOSS:.3e}); gradients' largest share {worst:.4f} of "
          f"{TOL_TRAIN_GRAD:g} max|G| ({worst_name}); launches over the "
          f"three processes {launches} (expected {exp}); the arm "
          f"{wall:.1f} s, (b) and (c) run meanwhile [{card}]", flush=True)
    check(all(r["jax"] == 0 for r in res), "mpmd (a): a stage loaded jax")
    check(gap <= TOL_MPMD_LOSS, f"mpmd (a): loss gap {gap:.3e}")
    check(all(abs(x - losses[0]) <= MPMD_STEP_RTOL * abs(losses[0])
              for x in losses), f"mpmd (a): the steps' losses {losses}")
    check(worst <= 1.0, f"mpmd (a): gradient share {worst:.3f} "
                        f"({worst_name})")
    check(all(r["step2_excess"] <= 0.0 for r in res),
          f"mpmd (a): step 2's gradients off step 1's "
          f"{[r['step2_excess'] for r in res]}")
    if device == "cuda":
        check(launches == exp,
              f"mpmd (a): launches {launches}, expected {exp}")
    stage0 = [r for r in res if r["stage"] == 0]
    return other, dict(launches=launches, loss_gap=gap, grad_share=worst,
                wall_s=wall,
                step_ms={f"{r['stage']}.{r['replica']}":
                         [round(t * 1e3, 3) for t in r["step_s"]]
                         for r in res},
                edges={f"{r['stage']}.{r['replica']}": r["edges"]
                       for r in res},
                acc_ms=[round(max(r["acc_s"][-1][k] for r in stage0) * 1e3,
                              3) for k in ("push", "pull")])


def _mpmd_el_kw(seed, port, **kw):
    return dict(MPMD_EL, data_seed=seed, lease_s=MPMD_LEASE_S,
                suspect_grace_s=MPMD_GRACE_S, own_van=False, port=port,
                spawn_timeout_s=MPMD_WAIT_S, **kw)


def _mpmd_peak_stash(log_paths):
    """stage -> the largest activation stash its logged steps held."""
    peak = {}
    for path in log_paths:
        with open(path) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    peak[r["stage"]] = max(peak.get(r["stage"], 0),
                                           r["peak_stash"])
    return [peak[s] for s in sorted(peak)]


def _mpmd_elastic_arm(card, seed, root, port):
    """(b): the clean 1F1B run, a stash-bounded GPipe run, and a 1F1B
    run whose middle stage is SIGKILLed at the seeded step, each an
    in-process supervisor over the phase's van process."""
    from hetu_tpu_torch.parallel.mpmd_elastic import MPMDPipelineSupervisor
    from hetu_tpu_torch.resilience.faults import FaultInjector, FaultSchedule
    from hetu_tpu_torch.telemetry import timeline, trace

    schedule = FaultSchedule.generate(stage_kills=1, n_stages=3, **MPMD_KILL)
    (ev,) = schedule.events
    check(ev.kind == "stage_kill" and int(ev.arg) == 1,
          f"mpmd (b): the seeded schedule drew {ev}")
    runs = {}
    tracer = trace.Tracer()
    for tag, kw in (("1f1b", {}),
                    ("gpipe", dict(schedule="gpipe",
                                   stash_limit=MPMD_EL_STASH)),
                    ("kill", {})):
        workdir = os.path.join(root, f"b_{tag}")
        os.makedirs(workdir)
        t0 = time.perf_counter()
        sup = MPMDPipelineSupervisor(3, workdir=workdir,
                                     **_mpmd_el_kw(seed, port, **kw))
        try:
            if tag != "kill":
                rep = sup.run(deadline_s=MPMD_WAIT_S)
            else:
                sup.injector = FaultInjector(schedule, stage_procs=sup.procs)
                trace.enable(tracer=tracer)
                try:
                    rep = sup.run(deadline_s=MPMD_WAIT_S)
                finally:
                    trace.disable()
                rep["killed"] = sup.injector.counters["stage_procs_killed"]
        finally:
            sup.close()
        rep["seconds"] = time.perf_counter() - t0
        rep["ready"] = _elastic_no_torch(workdir, f"(b) {tag}",
                                         "stage_*_*.log", "mpmd", 3)
        runs[tag] = rep
    clean = runs["1f1b"]["final_params"]
    for tag in ("gpipe", "kill"):
        same = all(np.array_equal(clean[s], runs[tag]["final_params"][s])
                   for s in clean)
        print(f"[mpmd] (b) {tag}: final parameters "
              f"{'bitwise equal to' if same else 'DIFFER from'} the clean "
              f"1F1B run's; {runs[tag]['seconds']:.2f} s", flush=True)
        check(same, f"mpmd (b) {tag}: final parameters differ")
    kill = runs["kill"]
    pairs = [p for p in timeline.correlate(tracer.events)
             if p.kind == "stage_kill"]
    check(kill["killed"] == 1 and len(kill["replacements"]) == 1,
          f"mpmd (b) kill: {kill['killed']} killed, replacements "
          f"{kill['replacements']}")
    check(len(pairs) == 1 and pairs[0].paired and
          pairs[0].recovery_name == "pipeline.stage_replace",
          f"mpmd (b) kill: the fault's pairing {pairs}")
    stash = {t: _mpmd_peak_stash(runs[t]["log_paths"])
             for t in ("gpipe", "1f1b")}
    rec = kill["replacements"][0]
    print(f"[mpmd] (b) stage 1 SIGKILLed at step {ev.step}: detect "
          f"{pairs[0].detect_s:.3f} s, recover {pairs[0].recover_s:.3f} s "
          f"(resume at step {rec['resume_step']}, replacement downtime "
          f"{rec['downtime_s']:.3f} s); peak stash by stage GPipe "
          f"(stash_limit {MPMD_EL_STASH}) {stash['gpipe']} vs 1F1B "
          f"{stash['1f1b']}; clean run {runs['1f1b']['seconds']:.2f} s; "
          f"every stage READY jax=0 torch=0 [{card}]", flush=True)
    return dict(clean=clean, detect_s=pairs[0].detect_s,
                recover_s=pairs[0].recover_s, stash=stash,
                seconds={t: round(r["seconds"], 3) for t, r in runs.items()})


def _mpmd_digests(params):
    import hashlib
    return {str(s): hashlib.blake2b(np.ascontiguousarray(w).tobytes(),
                                    digest_size=16).hexdigest()
            for s, w in params.items()}


def _mpmd_standby_arm(card, seed, workdir, clean):
    """(c): a controller process over its own van process, a standby
    process on plane="mpmd"; the controller SIGKILLed when its progress
    line reaches the seeded step.  Hard: PROMOTED -> RESOLVED -> ALLDONE
    and the digests of the final parameters equal (b)'s clean run's;
    every process said jax=0 torch=0."""
    from pathlib import Path

    from hetu_tpu_torch.parallel.mpmd_elastic import StageSpec
    from hetu_tpu_torch.resilience.faults import FaultInjector, FaultSchedule
    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_module, spawn_shard_server,
    )

    schedule = FaultSchedule.generate(controller_kills=1, **MPMD_KILL)
    (ev,) = schedule.events
    check(ev.kind == "controller_kill", f"mpmd (c): the draw {ev}")
    port = free_port()
    procs = [spawn_shard_server(workdir, port, "mpmd_c")]
    log = lambda p: Path(p.log_path).read_text(errors="replace")  # noqa
    try:
        check(procs[0].ready[1:] == ["jax=0", "torch=0"],
              f"mpmd (c): the van process READY {procs[0].ready}")
        cfg = os.path.join(workdir, "ctrl.json")
        with open(cfg, "w") as f:
            json.dump({"workdir": workdir, "port": port, "n_stages": 3,
                       "lease_s": MPMD_LEASE_S,
                       "suspect_grace_s": MPMD_GRACE_S,
                       "ctrl_lease_s": MPMD_CTRL_LEASE_S,
                       "deadline_s": MPMD_WAIT_S, "data_seed": seed,
                       **MPMD_EL}, f)
        ctrl = spawn_module(workdir, "mpmd_ctrl",
                            "hetu_tpu_torch.parallel.mpmd_elastic",
                            ["--controller", cfg], timeout_s=MPMD_WAIT_S)
        procs.append(ctrl)
        spec = StageSpec.from_json(
            sorted(Path(workdir).glob("stage_*_*.json"))[0].read_text())
        sb_cfg = os.path.join(workdir, "standby.json")
        with open(sb_cfg, "w") as f:
            json.dump({"workdir": workdir, "port": port, "plane": "mpmd",
                       "membership_table": spec.membership_table,
                       "n_slots": spec.n_stages,
                       "lease_bound_s": MPMD_LEASE_S, "poll_s": 0.05,
                       "watch_timeout_s": MPMD_WAIT_S,
                       "resolve_timeout_s": MPMD_WAIT_S,
                       "takeover_kwargs": {
                           "lease_s": MPMD_LEASE_S,
                           "suspect_grace_s": MPMD_GRACE_S}}, f)
        sb = spawn_module(workdir, "mpmd_standby",
                          "hetu_tpu_torch.resilience.standby", [sb_cfg],
                          timeout_s=MPMD_WAIT_S)
        procs.append(sb)
        deadline = time.monotonic() + MPMD_WAIT_S
        while "WATCHING" not in log(sb):
            check(sb.poll() is None and time.monotonic() < deadline,
                  f"mpmd (c): the standby never watched: {log(sb)[-800:]}")
            time.sleep(0.05)
        inj = FaultInjector(schedule, ctrl_procs=[ctrl])
        fired = 0
        while ctrl.poll() is None:
            check(time.monotonic() < deadline,
                  f"mpmd (c): the seeded kill never fired: "
                  f"{log(ctrl)[-800:]}")
            cur = sum(1 for ln in log(ctrl).splitlines()
                      if ln.startswith("STEP"))
            for t in range(fired + 1, cur + 1):
                inj.on_step(t)
            fired = max(fired, cur)
            time.sleep(0.02)
        t_kill = time.perf_counter()
        check(inj.counters["controller_procs_killed"] == 1,
              f"mpmd (c): {inj.counters}")
        rc = sb.wait(timeout=2 * MPMD_WAIT_S)
        t_done = time.perf_counter()
        text = log(sb)
        check(rc == 0, f"mpmd (c): the standby exited {rc}: {text[-1500:]}")
        lines = {ln.split(" ", 1)[0]: ln for ln in text.splitlines() if ln}
        order = [ln.split(" ", 1)[0] for ln in text.splitlines()
                 if ln.split(" ", 1)[0] in ("PROMOTED", "RESOLVED",
                                            "ALLDONE")]
        check(order == ["PROMOTED", "RESOLVED", "ALLDONE"],
              f"mpmd (c): the standby's markers {order}")
        got = json.loads(lines["RESOLVED"].split(" ", 1)[1])
        same = got["digests"] == _mpmd_digests(clean)
        ready = [ln for p in Path(workdir).glob("*.log")
                 for ln in p.read_text(errors="replace").splitlines()
                 if ln.startswith("READY")]
        no_torch = all(ln.split()[-2:] == ["jax=0", "torch=0"]
                       for ln in ready)
        promoted_s = float(lines["PROMOTED"].split()[1])
        alldone_s = float(lines["ALLDONE"].split()[1])
        print(f"[mpmd] (c) controller SIGKILLed at progress step "
              f"{ev.step}: standby PROMOTED {promoted_s:.3f} s after the "
              f"silence (incarnation {got['takeover']['incarnation']}, "
              f"resume step {got['takeover']['resume_step']}), ALLDONE "
              f"{alldone_s:.3f} s after; kill -> standby exit "
              f"{t_done - t_kill:.3f} s; final parameters' digests "
              f"{'equal' if same else 'DIFFER from'} (b)'s clean run; the "
              f"van and {len(ready)} READY lines (controller, standby, "
              f"stages) {'all' if no_torch else 'NOT all'} jax=0 torch=0 "
              f"[{card}]", flush=True)
        check(same, f"mpmd (c): digests {got['digests']}")
        check(got["takeover"]["resume_step"] < MPMD_EL["steps"],
              f"mpmd (c): the standby adopted a finished pipeline "
              f"{got['takeover']}")
        check(no_torch and len(ready) >= 2 + 3,
              f"mpmd (c): READY lines {ready}")
        _elastic_no_torch(workdir, "(c)", "stage_*_*.log", "mpmd", 3)
        return dict(promoted_s=promoted_s, alldone_s=alldone_s,
                    kill_to_exit_s=t_done - t_kill,
                    incarnation=got["takeover"]["incarnation"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        subprocess.run(["pkill", "-9", "-f", workdir], capture_output=True,
                       timeout=30)


def phase_mpmd(card, seed, device="cuda"):
    """The MPMD pipeline plane in processes of its own: (a) the kernel arm
    on the card, (b) the elastic numpy pipeline and a stage kill, (c) the
    controller killed under a standby.  Returns the numbers for the
    summary and the kernels line."""
    import tempfile

    from hetu_tpu_torch.resilience.shardproc import (
        free_port, spawn_shard_server,
    )

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="mpmd_") as root:

        def numpy_arms():
            with _elastic_blas_threads():
                port = free_port()
                vanp = spawn_shard_server(root, port, "mpmd_b")
                try:
                    check(vanp.ready[1:] == ["jax=0", "torch=0"],
                          f"mpmd (b): the van process READY {vanp.ready}")
                    b = _mpmd_elastic_arm(card, seed, root, port)
                finally:
                    vanp.kill()
                    vanp.wait()
                c_dir = os.path.join(root, "c")
                os.makedirs(c_dir)
                return b, _mpmd_standby_arm(card, seed, c_dir, b["clean"])

        a_dir = os.path.join(root, "a")
        os.makedirs(a_dir)
        (out["b"], out["c"]), out["a"] = _mpmd_kernel_arm(
            card, seed, a_dir, device, during=numpy_arms)
        if device == "cuda":
            torch.cuda.empty_cache()
        subprocess.run(["pkill", "-9", "-f", root], capture_output=True,
                       timeout=30)
    out["launches"] = out["a"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[mpmd] phase {out['seconds']:.1f} s (budget {MPMD_BUDGET_S:g} "
          f"s: {'met' if out['seconds'] <= MPMD_BUDGET_S else 'missed'}); "
          f"launches rows 1-6 {out['launches']} [{card}]", flush=True)
    return out


def _paths_entry(key, moe_launches, ctr, gates, later):
    """The launches by path of a kernel's entry in the kernels line (the
    MoE step, the four gates' steps summed, the CTR step, then ``later``:
    path -> this kernel's launches on the paths that run none of the six,
    the CNN, RNN and GCN steps), and its times at the CTR step's
    shapes."""
    i = {"topk": 0, "gather": 1, "scatter": 2}[key]
    by_gates = sum(g["launches"][i] for g in gates.values())
    if key == "topk":  # not on the gates' path: 0 there
        return {"launches_by_path": {"train_moe": moe_launches,
                                     "train_moe_gates": by_gates, **later}}
    if key == "gather":
        shape = (f"ctr: table [{CTR_V}, {CTR_DIM}] f32, {CTR_B * CTR_F} ids "
                 f"(cold rows, {CTR_GATHER_SETS} batches in turn)")
        return {"launches_by_path": {"train_moe": moe_launches,
                                     "train_moe_gates": by_gates,
                                     "ctr": ctr["launches"][0], **later},
                "by_shape": {shape: ctr["gather"]}}
    if key == "scatter":
        return {"launches_by_path": {"train_moe": moe_launches,
                                     "train_moe_gates": by_gates,
                                     "ctr": ctr["launches"][1], **later},
                "by_shape": {
                    f"ctr deduplicate: {CTR_B * CTR_F} rows of {CTR_DIM} f32 "
                    f"-> {CTR_B * CTR_F} segments, sorted route ({tag} ids)":
                        m for tag, m in ctr["scatter"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and requests")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on the "
              "card only", file=sys.stderr)
        return 2
    try:
        import hetu_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    card = card_line()
    phase_device(card)
    phase_build()
    max_err, timings, design = phase_kernel(card)
    bwd = phase_kernel_bwd(card)
    moe_kernels = phase_kernel_moe(card)
    serve_launches, engine = phase_slice(card, args.seed)
    phase_profile(engine, card)
    del engine
    torch.cuda.empty_cache()
    train = phase_train(card, args.seed)
    torch.cuda.empty_cache()
    moe = phase_train_moe(card, args.seed)
    torch.cuda.empty_cache()
    moe_gates = phase_train_moe_gates(card, args.seed)
    torch.cuda.empty_cache()
    llama_serve, llama_engine = phase_llama_serve(card, args.seed)
    phase_paged_serve(card, args.seed, llama_engine)
    migrate = phase_migrate(card, args.seed, llama_engine,
                            llama_serve["tokens"])
    server = phase_server(card, args.seed, llama_engine, llama_serve,
                          migrate)
    del llama_engine
    torch.cuda.empty_cache()
    pool = phase_pool(card, args.seed)
    torch.cuda.empty_cache()
    crosshost = phase_crosshost(card, args.seed)
    torch.cuda.empty_cache()
    vanchaos = phase_vanchaos(card, args.seed)
    torch.cuda.empty_cache()
    traffic = phase_traffic(card, args.seed)
    torch.cuda.empty_cache()
    llama_train = phase_train_llama(card, args.seed)
    torch.cuda.empty_cache()
    bert = phase_train_bert(card, args.seed)
    torch.cuda.empty_cache()
    ctr = phase_train_ctr(card, args.seed)
    torch.cuda.empty_cache()
    phase_ps_ctr(card, args.seed)
    torch.cuda.empty_cache()
    recsys = phase_recsys(card, args.seed)
    torch.cuda.empty_cache()
    supervise = phase_supervise(card, args.seed)
    torch.cuda.empty_cache()
    elastic = phase_elastic(card, args.seed)
    cnn = phase_train_cnn(card, args.seed)
    torch.cuda.empty_cache()
    rnn = phase_train_rnn(card, args.seed)
    torch.cuda.empty_cache()
    gcn = phase_train_gcn(card, args.seed)
    torch.cuda.empty_cache()
    sampled = phase_gcn_sampled(card, args.seed)
    torch.cuda.empty_cache()
    phase_ops_zoo(card)
    torch.cuda.empty_cache()
    compressed = phase_train_compressed(card, args.seed)
    torch.cuda.empty_cache()
    mesh = phase_mesh(card, args.seed, sharded=True, dppipe=True)
    sharded = phase_sharded(card, mesh["sharded"])
    dppipe = phase_dppipe(card, mesh["dppipe"])
    torch.cuda.empty_cache()
    mpmd = phase_mpmd(card, args.seed)
    torch.cuda.empty_cache()
    shapes_fwd, shapes_bwd = phase_kernel_shapes(card)
    # each kernel's launches on the paths that run none of the six
    later = [{"train_cnn": cnn["launches"][i], "train_rnn": rnn["launches"][i],
              "train_gcn": gcn["launches"][i],
              "gcn_sampled": sampled["launches"][i],
              "train_compressed": compressed["launches"][i],
              # the supervisor's GPT arm (all its runs, the children's
              # included) and its PS arm
              "supervise": supervise["launches"][i],
              "supervise_ps": supervise["ps_launches"][i],
              # online CTR serving gathers its rows on the host
              "recsys": recsys["launches"][i],
              # the elastic training plane's processes run no kernel
              "elastic": elastic["launches"][i],
              # the two tp/dp ranks together (their MoE rows: 0)
              "mesh": mesh["launches"][i],
              # ShardedGPT's arms over both ranks
              "sharded": sharded["launches"][i],
              # the elastic, preduce, distributed GCN, 1F1B and HetPipe
              # arms over both ranks
              "dppipe": dppipe["launches"][i],
              # the MPMD kernel arm's three stage processes
              "mpmd": mpmd["launches"][i]}
             for i in range(6)]

    shape = [TRAIN_B, NH, TRAIN_S, HEAD_DIM]
    src = "hetu_tpu/ops/pallas_kernels/flash_attention.py"
    t = timings[(TRAIN_B, TRAIN_S)]
    report = {"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "hetu_tpu_torch/csrc/flash_attention.cu",
         "replaces": f"{src}:52", "launches": train["launches"][0],
         "max_abs_err": max_err,
         **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "tflops")},
         "design": design,
         "shape": shape, "dtype": "bfloat16",
         "launches_by_path": {"serve": serve_launches,
                              "train": train["launches"][0],
                              "llama_serve": llama_serve["launches"],
                              "paged_serve": 0,
                              "migrate": migrate["launches"],
                              "server": server["launches"],
                              "pool": pool["launches"],
                              # summed over the member processes
                              "crosshost": crosshost["launches"],
                              "vanchaos": vanchaos["launches"],
                              "traffic": traffic["launches"],
                              "llama_train": llama_train["launches"][0],
                              "bert_train": bert["launches"][0],
                              **later[0]},
         # the serving path's largest prompt bucket, and S = 512
         "serve_s128": timings[(1, 128)], "serve_s512": timings[(1, 512)],
         # the Llama (head dim 128) and BERT (non-causal) paths' shapes
         "by_shape": shapes_fwd},
        *({"name": f"flash_attention_bwd_{k}", "route": "cuda",
           "source": "hetu_tpu_torch/csrc/flash_attention_bwd.cu",
           "replaces": f"{src}:{line}", "launches": train["launches"][i],
           "max_abs_err": bwd[k]["max_abs_err"],
           **{f: bwd[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms",
                                     "whole_bwd_ms")},
           "shape": shape, "dtype": "bfloat16",
           "launches_by_path": {"train": train["launches"][i],
                                "llama_train": llama_train["launches"][i],
                                "bert_train": bert["launches"][i],
                                **later[i]},
           "by_shape": shapes_bwd[k]}
          for i, k, line in ((1, "dkdv", 198), (2, "dq", 239))),
        *({"name": name, "route": "cuda",
           "source": f"hetu_tpu_torch/csrc/{src_file}",
           "replaces": f"hetu_tpu/ops/pallas_kernels/embedding.py:{line}",
           "launches": moe["launches"][i],
           **{f: moe_kernels[key][f] for f in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")},
           "per": per, **{f: moe_kernels[key][f]
                          for f in ("by_call", "by_route", "by_shape")
                          if f in moe_kernels[key]},
           **_paths_entry(key, moe["launches"][i], ctr, moe_gates,
                          later[3 + i])}
          for name, key, i, src_file, line, per in (
              ("topk_gating", "topk", 0, "topk_gating.cu", 175,
               f"one call, logits [{MOE_T}, {MOE_E}] f32, k {MOE_K}"),
              ("embedding_gather", "gather", 1, "embedding.cu", 35,
               f"the sum of a layer's two calls: dispatch (table "
               f"[{MOE_T}, {MOE_H}] bf16, {MOE_E * MOE_C} ids) and "
               f"combine ([{MOE_E * MOE_C}, {MOE_H}] f32, "
               f"{MOE_T * MOE_K} ids)"),
              ("embedding_scatter_add", "scatter", 2, "embedding.cu", 75,
               f"the inverse route the MoE step runs: the sum of a layer's "
               f"two calls, dispatch backward ([{MOE_E * MOE_C}, {MOE_H}] "
               f"bf16 -> {MOE_T} rows, inverse [{MOE_T}, {MOE_K}]) and "
               f"combine backward ([{MOE_T * MOE_K}, {MOE_H}] f32 -> "
               f"{MOE_E * MOE_C} rows, inverse [{MOE_E * MOE_C}, 1]), plus "
               f"the slot_route build; by_route has both routes")))]}
    # the kernels line runs past a short output tail: the cross-process
    # phase's own numbers again, on a line that stays in it
    print(f"[crosshost] summary: phase {crosshost['seconds']:.1f} s, "
          f"{crosshost['prefills']} member prefills, flash forwards "
          f"launched {crosshost['launches']} [{card}]")
    print(f"[vanchaos] summary: phase {vanchaos['seconds']:.1f} s, "
          f"{vanchaos['prefills']} member prefills, flash forwards "
          f"launched {vanchaos['launches']}; promotions at incarnations "
          f"{[x['incarnation'] for x in vanchaos['f32']['rounds']]}, "
          f"standby PROMOTED {vanchaos['bf16']['detect_to_promoted_s']:.3f}"
          f" s [{card}]")
    g = traffic["tenants"].get("gold", {})
    print(f"[traffic] summary: phase {traffic['seconds']:.1f} s, r1 "
          f"{traffic['r1']:.3f}/s, {traffic['issued']} issued, ok-QPS "
          f"{traffic['ok_qps']:.3f}, {traffic['ups']} up / "
          f"{traffic['downs']} down, peak {traffic['peak_members']} "
          f"members, gold TTFT p99 {g.get('ttft_p99_s')} s "
          f"({'met' if traffic['gold_p99_met'] else 'missed'}), "
          f"{traffic['prefills']} member prefills, flash forwards launched "
          f"{traffic['launches']} [{card}]")
    print(recsys_summary(recsys, card))
    sg, sp = supervise["gpt"], supervise["ps"]
    print(f"[supervise] summary: phase {supervise['seconds']:.1f} s; gpt "
          f"step {sg['step_ms']:.3f} ms supervised, {sg['bare_ms']:.3f} ms "
          f"bare ({sg['overhead_pct']:.2f} %), preempted at step "
          f"{SUP_HOLD_AT + 1}, SIGTERM -> exit {sg['sigterm_exit_s']:.3f} s, "
          f"resumed past a corrupt checkpoint "
          f"{'bitwise' if sg['bitwise'] else 'within the twins gap'} "
          f"(twins {'bitwise' if sg['reproducible'] else 'differ'}); ps "
          f"shard repaired {sp['death_to_repaired_s']:.3f} s after its kill, "
          f"repair {sp['repair_ms']:.1f} ms; flash launches "
          f"{supervise['launches'][:3]} [{card}]")
    ea, eb, ec = elastic["a"], elastic["b"], elastic["c"]
    print(f"[elastic] summary: phase {elastic['seconds']:.1f} s (budget "
          f"{ELASTIC_BUDGET_S:g} s); step ms median (a) "
          f"{[round(x, 3) for x in ea['step_ms']]}, (b) {eb['step_ms']:.3f},"
          f" (c) {ec['step_ms']:.3f}; van MiB a step (a) "
          f"{[round(x, 3) for x in ea['mib']]}; twins bitwise, replay max "
          f"|d| {ea['max_gap']:.3e}; worker kill -> shrink "
          f"{eb['shrink_s']:.3f} s, replacement READY {eb['ready_s']:.3f} s,"
          f" READY -> grow {eb['ready_to_grow_s']:.3f} s; controller kill "
          f"-> hand-off {ec['handoff_s']:.3f} s (incarnation "
          f"{ec['incarnation']}); re-pushed (b) {eb['repushed']}, (c) "
          f"{ec['repushed']}; launches {elastic['launches']}; the script "
          f"{time.perf_counter() - t_script:.1f} s [{card}]")
    print(f"[mesh] summary: phase {mesh['seconds']:.1f} s (budget "
          f"{MESH_BUDGET_S:g} s), two gloo ranks {mesh['ranks_s']:.1f} s "
          f"(up after {mesh['start_s']:.1f} s); (a) tp=2 step ms "
          f"{[round(x, 3) for x in mesh['step_ms']]}; staged through the "
          f"host {mesh['staged'] or 'none'}; (e) nccl one rank "
          f"{'bitwise' if mesh['nccl'].get('bitwise') else 'differs'}; "
          f"flash launches {mesh['launches'][:3]} [{card}]")
    print(f"[sharded] summary: phase {sharded['seconds']:.1f} s (budget "
          f"{SHARDED_BUDGET_S:g} s); bf16 step ms after the first "
          f"{sharded['step_ms']}; staged through the host (rank 1) "
          f"{sharded['staged']}; ring forward ms (non-causal, causal) "
          f"{[round(sharded['ring'][c]['ring_ms'], 4) for c in (False, True)]}"
          f" vs single-process flash "
          f"{[round(sharded['ring'][c]['flash_ms'], 4) for c in (False, True)]}"
          f"; launches {sharded['launches']}; the script "
          f"{time.perf_counter() - t_script:.1f} s [{card}]")
    print(f"[dppipe] summary: phase {dppipe['seconds']:.1f} s (budget "
          f"{DPPIPE_BUDGET_S:g} s); arms s {dppipe['arms']}; resize "
          f"downtime_s {[round(x, 4) for x in dppipe['downtime']]}; GCN ms "
          f"a call {dppipe['gcn_ms']}; 1F1B GPT value_and_grad "
          f"{dppipe['pipe_ms']:.1f} ms; launches {dppipe['launches']}; the "
          f"script {time.perf_counter() - t_script:.1f} s [{card}]")
    ma, mb_, mc = mpmd["a"], mpmd["b"], mpmd["c"]
    print(f"[mpmd] summary: phase {mpmd['seconds']:.1f} s (budget "
          f"{MPMD_BUDGET_S:g} s); (a) stage_dps {list(MPMD_DPS)} step ms "
          f"{ma['step_ms']}, edge bytes {ma['edges']}, accumulator push/pull "
          f"ms {ma['acc_ms']}, loss gap {ma['loss_gap']:.3e}, gradient share "
          f"{ma['grad_share']:.4f}; (b) stage kill detect "
          f"{mb_['detect_s']:.3f} s, recover {mb_['recover_s']:.3f} s, peak "
          f"stash GPipe {mb_['stash']['gpipe']} vs 1F1B "
          f"{mb_['stash']['1f1b']}; (c) standby PROMOTED "
          f"{mc['promoted_s']:.3f} s, ALLDONE {mc['alldone_s']:.3f} s; "
          f"launches {mpmd['launches']}; the script "
          f"{time.perf_counter() - t_script:.1f} s [{card}]")
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
