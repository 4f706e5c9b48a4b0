#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ggnn_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: print the ``nvidia-smi`` name and power-limit line; a CUDA device
   is required (there is no CPU fallback).
2. Kernel build: compile ``ggnn_torch/csrc/adjacency_dot.cu``,
   ``ggnn_torch/csrc/beam_dedup.cu``, ``ggnn_torch/csrc/approx_topk.cu``
   and ``ggnn_torch/csrc/gather_dist.cu`` from this checkout, one ``nvcc``
   each, all at once, and print the
   seconds each took and the libraries' paths
   (named by the hash of the source and the nvcc flags), then each kernel's
   registers, shared and local (spill) bytes (``cuobjdump -res-usage``) and
   the count of ``I2F*`` instructions in the adjacency kernels' SASS
   (``cuobjdump -sass``; 0 by design), or "not available" where the
   toolkit has no ``cuobjdump``.
3. Kernel against plain: ``adjacency_dot`` vs ``adjacency_dot_plain`` on the
   card at the paths' shapes (B=8192 rows, P=8 anchors, D=128 bytes per
   code row, ~10% empty anchors: 48 rows per block for group 1, 24 for
   int4, 96 over half as many blocks for group 2), live lanes compared at
   rtol 1e-5 / atol 1e-2 (f32 summation order); both timed with CUDA events
   after a warm-up. Phases 4 and 6 repeat the check on the real anchors of
   a fused query's third walk step for each layout.
3b. Dedup kernel against plain: ``beam_dedup_mask`` (the fused query's and
   the quantized merge's steps) and ``beam_dedup_compact`` (the row query's,
   the f32 merge's and the sym walk's steps) against their plain versions
   at each step's shape (``DEDUP_SHAPES``: B=8192 rows, k_build=48, P=8;
   and k_query 6000's 1,000 rows with a beam of 6,048 and a ring of 2,144):
   about half the candidates repeat another column or are already seen,
   ~10% are -1. Every entry of ``ok`` and ``packed`` must equal the plain
   version's (0 differing). The kernel's device time is read from a CUDA
   graph of ``DEDUP_LAUNCHES`` captured launches, replayed between CUDA
   events (as the walks run it: no host path per launch); beside it the
   host path's ms (CUDA events around Python calls of the wrapper), the
   plain version's ms, the bytes bound, the rows (warps) per block, the
   shared bytes per block and the kernel's registers and spills.
3c. Approximate top-k against plain: ``approx_smallest_k`` (the seeding's
   fused distance epilogue + binning + top-k, ``csrc/approx_topk.cu``)
   against ``finish`` + ``approx_smallest_k_plain`` on the same cuBLAS dot
   products, at ``APPROX_SHAPES`` (the headline's 8,192 x 30,752 tiles at
   k=8 and k=32, its padded last tile, a row below 128, an exact row of
   passes) and at three of them in cosine: ids must be equal and the
   distances bit-equal (cosine: within 2 ulp). Prints the kernel's device
   ms (a CUDA graph of launches, as in phase 3b) and its host path's, the
   plain version's, the exact route's (``finish`` + ``torch.topk``), the
   bytes bound and its share, the seeds' recall against the exact top-k,
   the kernel the launcher took (``approx_topk.kernel_layout``: the warp
   kernel's ring or the block kernel), rows per block, shared bytes and
   registers. The same check runs again on each
   path's own seeding inputs once the path is done
   (``approx_on_real_inputs``: phases 4, 7, 9, 10, 12 in cosine and uint8,
   and 13): each dense-seeded merge's first chunk against its layer's
   representatives at k=32, each query tile against the fused index's
   representatives at the benchmark's num_seeds.
3d. The walks' fused gather + distance against plain: ``gather_dist``
   (``csrc/gather_dist.cu``) against ``gather_dist_plain`` (the gather,
   cuBLAS's einsum and ``finish``) on the same inputs at
   ``GATHER_SHAPES``: each walk's step (the row query's 10,000 x 288, the
   f32 merge's 8,192 x 192 on layer 0 and through a translation, the
   merges' own distances 8,192 x 1 -- the most launched shape -- on layer
   0 and through a translation, the descent's ``seed_beam`` 8,192 x S =
   32, the sym walk's 32,768 x 192 with Q = 2, the re-rank's 8,192 x 16
   also in cosine, the uint8 base's row step) and the CPU tests' edge
   cases (D = 20, K = 1, uint8 cosine, translation). The kernel's base ids
   (asked for once) must equal the plain version's, every distance must
   lie within ``gather_dist.error_bound`` (D * 2^-23 * (q_sq + c_sq),
   cosine D * 2^-22: two summation orders), and the distances without base
   ids -- the form every walk calls -- must equal those with them bit for
   bit; the largest ratio of error to bound and the entries over it (0)
   are printed, with the kernel's device ms in the walks' form (a CUDA
   graph of launches, as in phase 3b), its host path's, the plain
   version's, ``torch.bmm`` alone on rows gathered beforehand, the bound
   by distinct rows and by gathered rows and the shares of both.
3e. The beam ops' sort kernel (``ops/beam_sort.py``) against the
   ``torch.sort`` route (``beam_insert_plain``, ``cap_candidates_plain``)
   on the same inputs at ``BEAM_SORT_SHAPES``: the benchmark cells' walks
   at 10,240 rows (the row query's 64 + 144 and uncapped 64 + 192, the
   fused query's 32 + 32 and its cap cut 192 -> 32), the build merges' and
   the sym walk's at 8,192, the smoke's k_build 48 row step. Every
   distance's bits, id and flag must equal the route's (0 differing
   entries); printed with the admitted share, the kernel's device ms (a
   CUDA graph of launches, as in phase 3b), its host path's, the route's,
   ``torch.sort`` alone on the row's distances, the bytes bound and its
   share, the keys a lane and rows a block.
3f. The beam ops' pop kernel (``csrc/beam_pop.cu``) against the plain
   pop (``beam_pop_plain``) on the same state at ``BEAM_POP_SHAPES``: the
   benchmark cells' fused query steps (gist1m's 1,024 x 32 with a ring of
   3,200; sift1m's 8,192 x 32, ring 128), the row query's, the fused
   merge's, the sym walk's (its own criterion and row mask) and k_query
   6000's. Every output (anchors, active, the beam's bits, flags, ring,
   head) must equal the plain pop's (0 differing entries) and the kernel
   must return the state's own tensors; printed with the hits a row, the
   kernel's device ms (a CUDA graph of one pop on each of 20 copies of
   the state, restored before each replay, outside the timed replay), its
   host path's, the plain pop's (a graph of launches, as in phase 3b), the
   bytes bound (each row's beam read up to its P-th hit, the outputs
   written once) and its share, and the kernel's registers and spills.
4. Main path: ``GGNN(device="cuda")`` builds a 262,144-point graph
   (k_build=48, tau_build=0.5, 2 refinements) over the benchmark's
   synthetic SIFT-like data, derives the fused index, computes brute-force
   ground truth for 10,000 queries and sweeps fused-query operating points
   cheapest first until c@1 >= 0.90. QPS is timed with CUDA events around
   the queries alone, queries already on the card and results left there.
   The kernel's launch counter must rise during the build and again during
   the queries, and so must the approximate top-k's (the build's merges
   and the queries' seeding) and the gather + distance's (the merges' own
   distances, the queries' re-rank); every count includes the launches replayed
   from CUDA graphs (one per captured launch per replay). At the operating point the
   graph route (the walks' steps replayed as CUDA graphs, the live count read
   once per replay) must return the eager route's ids and dists bit for
   bit: the count of differing rows is printed and must be 0, with each
   route's ms per call. Then one call at the operating point runs under
   ``torch.profiler``: its host-clock ms, the device's busy ms and share,
   its kernel count, the adjacency kernel's launches and ms in it, the host
   syncs per query tile, and the graphs captured with their pools' bytes.
   Then the tile plan (a batch walks tiles of 8,192 rows, the last padded to
   a power of two of at least 256): a call of 3,000 queries, whose tile
   shape no call walked before, with its captures, and the same call
   again; then the batch sizes ``MIX`` twice through graphs and once
   eagerly, with each pass's ms and captures.
5. Row engine on the same graph and queries (``engine="row"``,
   ``pops_per_iter=8``, ``fetch_cap_fraction=0.75``): the (tau, pop budget)
   sweep ``ROW_SWEEP`` cheapest first until c@1 >= 0.90, timed like phase 4
   (3 timed calls after 1 warm-up); the returned
   distances must be the exact ones. Prints the device bytes of the row
   layout (graph + f32 base) beside the fused index's. The kernel must not
   launch: the row walk gathers f32 rows. The graph route must equal the
   eager route at the operating point. The dedup kernel (fused with the
   compaction) must launch, and so must the gather + distance. Then the
   row call at the operating point with the dedup kernel and with the
   plain dedup (``plain_dedup``): ms per call and one profile each, the
   dedup's share before and after; the same with the gather kernel and
   the plain gather (``plain_gather``), with the c@1 of each; and every
   swept point on both gather routes, whose c@1 must lie within 0.003
   (``gather_sweep``). Then
   k_query=6000 (the reference's
   bound) on the same graph: one fused and one row call for 1,000 queries
   through graphs (pop budget 2,000; the first call captures, the second is
   timed), rows sorted without duplicates, c@1/c@10 of the first 10
   columns, the graphs captured and their pools' bytes.
6. Layouts on the fused path's graph: ``build_fused_index(group=2)``,
   ``build_fused_index(group=4)`` and ``build_fused_index(bits=4)``, each
   followed by the fused sweep until c@1 >= 0.90; prints each layout's
   device bytes per point, index seconds and kernel launches. The kernel
   must launch in all three, in ``nibbles`` mode (and only so) for int4.
   Graph route against eager at each layout's operating point, as in phase
   4. Then the path's ``GGNN`` is dropped
   without ``close``: no walk program and no graph pool may be left, and
   the memory allocated must come back within 256 MiB of where it was
   before phase 4.
7. The exact f32-fetch build (``quantized_fetch=False``, the schedule every
   base above 1,048,576 points takes at k=48, D=128) of the same 262,144
   points, then the row sweep on it until c@1 >= 0.90, every swept point
   also on the plain gather (c@1 within 0.003). The kernel must not
   launch during the build; the gather + distance must.
8. The reference's own build shape (``dense_seed_merge=False``,
   ``sym_mode="walk"``: segment-seeded hierarchic descent, every unconnected
   pair walked) at 262,144 points and 10,000 queries, then the row sweep
   until c@1 >= 0.90. The kernel must launch in the build (the descent's
   quantized legs). The sym walks step on their default route, the
   per-step loop: prints the sym seconds per layer (the build's phase
   timer), each sym pass's walked pairs, live-count reads and graphs
   captured, the graphs' pools left after the build and the build's peak
   device memory (allocated and reserved). Then the last layer-0 sym pass
   of the build is run again on its own input through both routes, the
   per-step loop and CUDA graphs of 4 steps: the count of rows of the new
   graph that differ must be 0 and every counter of the pass equal (the
   walk's own reads and captures aside), with each route's seconds and
   peak device memory. Then the first walk chunk of that input (the pass's
   own chunk size and pops per step, its request buffer as it starts) runs
   under ``torch.profiler`` on the default route: its device busy ms and
   share, its top 5 kernels by device time and its host syncs, with the
   dedup kernel and again with the plain dedup; on each gather route
   (ms, a profile each, the request rows that differ); and once through
   graphs, for the bytes of its program's pool. The dedup kernel must
   launch in the build (alone in the merges, fused with the compaction in
   the sym walks) and in the layer-0 pass's two runs, and so must the
   gather + distance. Every swept row point also runs on the plain gather
   (c@1 within 0.003).
9. Shards out of core: 1,048,576 points (the JAX benchmark's 1M headline
   scale) as 4 shards of 262,144 on the one card, with at most 2 shards on
   the device (``set_max_device_shards(2)``) and a ``set_cpu_memory_limit``
   that holds one shard's host cache -- user settings that make the
   rotation reach the disk tier, since 80 GB would hold all four. Build,
   fused index (group 1, bits 8), brute force (10,000 x 1,048,576, k=100)
   and the fused sweep until c@1 >= 0.90 (CUDA events around the query
   calls, rotation included; 3 timed calls after 1 warm-up). Prints the
   evictions, spills, read-backs and stage-ins with their seconds, the build
   seconds per shard and the kernel launches. At the operating point the
   cap is raised to 4: the ids must equal the rotated run's exactly; then
   ``store()``, and a fresh ``GGNN`` through ``load(48)`` and
   ``build_fused_index()`` must reuse all 4 sidecars and return the same
   ids again. The walks run through graphs; a shard staged in is copied
   into the device buffers an evicted shard left, so the graphs keyed on
   their addresses serve every shard that rotates through them: identical
   ids here mean no graph read a stale shard. The rotated call at the
   operating point is timed through both routes in the same run (ids
   identical), with its captures and stage-ins per call.
10. Several devices: 524,288 points as 2 shards of 262,144 on two slots of
   the one card (``set_devices(["cuda:0", "cuda:0"])``): a build with one
   worker per slot (``num_build_workers`` must be 2; its wall seconds
   beside the sum of the shards' seconds), the fused index (group 1, bits
   8), brute force through the device merge, which must equal the host
   merge's ground truth, and the fused sweep through the device merge until
   c@1 >= 0.90 (3 timed calls after 1 warm-up). At the operating point the
   host merge (the native merger, which must be built) returns identical
   ids, and so does ``query_async`` on either route; the ms per call of
   the device merge (CUDA events) and of the host merge (host clock, the
   partials' copy to the host included) are printed. The kernel must
   launch in the build and in the queries. The two build workers capture
   their merge walks' graphs on one card at once; each must capture some.
11. The benchmark CLI: a 65,536-point base and 1,000 queries written as
   fvecs to a temporary directory (read back by the native reader, which
   must be built), then ``python -m ggnn_torch.benchmark
   --shard_size 32768 --fused_group 2 --graph_dir <tmp>`` twice: the first
   run builds and stores, the second loads and reuses the sidecars; both
   must exit 0 and print their c@1 lines.
12. The other measure and dtype: a cosine build of 65,536 points of the
   same generator with the fused sweep until c@1 >= 0.90 (ground truth and
   the exact-distance check by cosine), and the generator rounded into a
   uint8 base (``UCharDataset``, uint8 queries) with the fused and the row
   sweep; graph route against eager at every operating point (and for the
   cosine row walk at (0.5, 64)). The kernel must launch in the builds and
   in the fused queries.
12b. The entry points (``ggnn_torch/entry.py``, the counterpart of the JAX
   package's ``__graft_entry__``): ``entry()``'s fused query tile at its own
   shape (2,048 points, 256 queries) through both routes, which must agree
   bit for bit (0 differing rows), with each route's ms per call; its ids
   against the same tile run on the CPU (the plain kernels) on the same
   inputs: at most 1% of rows may differ (the kernel sums in another order
   than its plain version) and rows of equal ids must have dists within
   rtol 1e-5. Then the tile at full width (``ENTRY_FULL``: 262,144 points,
   k_build=48, 8,192 queries, 1.6 GB of codes): the seconds to draw its
   inputs, each route's ms per tile, 0 differing rows. Then
   ``dryrun_multichip(8)`` over 8 slots of the card: its seconds, build
   workers (8) and merge route (``devices``). Both kernels must launch in
   each of the three parts.
13. The headline: ``bench_torch.run`` (the port of the JAX package's
   ``bench.py``) at its own scale, 1,000,000 points resident on the card
   and 50,000 queries (k_build=48, group 1, one build, no cache): build,
   fused index, brute force (50,000 x 1,000,000, k=100) and ``bench.py``'s
   sweep. Prints its result line (``headline: {...}``), the build's phase
   seconds, the brute-force, index and sweep seconds, every sweep point,
   the index's and the base's device bytes per point and the peak device
   memory of each stage. A sweep point must reach c@1 >= 0.90, the kernel
   must launch in the build and again in the queries, and the ground
   truth's distances on a sample of rows must be the exact ones. Then one
   call at the operating point under ``torch.profiler`` (as in phase 4)
   and the kernel against its plain version on that call's real anchors.
   The approximate top-k must launch in the build and in the queries. It
   prints the graph's digest (``sym_bench.graph_digest``) and sweeps
   every point again with exact then approximate seeds (``seed_approx``;
   c@1 within 0.003 printed, not enforced), then approximate seeds with
   the re-rank on the plain gather (c@1 within 0.003 of the kernel's,
   enforced); the gather + distance must launch in the build and in the
   queries; and profiles the operating
   point with each, the device ms of the ``seed``, ``walk`` and ``rerank``
   ranges per tile beside the kernels, and the approximate top-k's
   launches in the trace beside those its wrapper counted.
14. The ``nvidia-smi`` name and power-limit line again, then one JSON line
   with the kernels' numbers: ``adjacency_dot`` (its bound: the bytes it must
   move -- each block a live anchor names read once, the query rows and
   anchors read once, each live output lane written once -- at the H100's
   3.35 TB/s, against 2 flops per code at 67 TFLOP/s f32; the share of it
   reached; the int4, group-2 and real-anchor numbers; launches per path;
   the resources and the I2F count of phase 2), ``beam_dedup`` and
   ``beam_dedup_compact`` (phase 3b's numbers at every shape, the bytes
   bound -- each input read once, each output written once; launches per
   path), ``approx_topk`` (phase 3c's numbers at every shape, the bytes
   bound, ``library_ms`` the exact route's; the checks on each path's own
   inputs; launches per path), ``gather_dist`` (phase 3d's numbers at
   every shape, the bytes bound, ``library_ms`` ``torch.bmm`` on
   pre-gathered rows; the row call and the sym walk chunk on both gather
   routes; launches per path), ``beam_sort`` (phase 3e's numbers at every
   shape, the bytes bound, ``library_ms`` ``torch.sort`` alone; launches of
   the kernel and of the torch.sort route per path), ``beam_pop`` (phase
   3f's numbers at every shape; launches of the kernel and the plain pops
   on the card per path, which must be 0), then the last line
   ``{"ok": true,
   "device": {...}}``.

Every phase prints its seconds. Every kernel's launch counts are set to 0
just before each path runs and read just after it (launches inside CUDA
graphs count once per replay); the dedup kernel must launch on every path
that walks (phases 4-10, 12, 12b, 13), the approximate top-k in phases 4
and 13, the gather + distance in phases 4, 5, 7, 8 and 13. A failure prints its traceback to stdout
and the script exits 1 without a result line.
"""

import functools
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

import bench_torch
from bench_torch import QKW, make_dataset
from sym_bench import graph_digest
from ggnn_torch import (DistanceMeasure, Evaluator, GGNN, GraphConfig,
                        UCharDataset, store_fvecs)
from ggnn_torch.native import build as native_build
from ggnn_torch.native import io as native_io
from ggnn_torch import ggnn as ggnn_mod
from ggnn_torch.build import construction
from ggnn_torch.build import sym as sym_mod
from ggnn_torch.entry import dryrun_multichip, entry
from ggnn_torch.native import merge as native_merge
from ggnn_torch.ops import adjacency, approx_topk, beam, beam_sort, gather_dist
from ggnn_torch.ops.distance import finish, squared_norms
from ggnn_torch.ops.topk import smallest_k_positions
from ggnn_torch.ops import traverse as traverse_mod
from ggnn_torch.parallel import merge_over_devices
from ggnn_torch.query import fused as fused_mod
from ggnn_torch.query.ann import ann_query
from ggnn_torch.utils import graphs

N, NQ, D = 262_144, 10_000, 128
K_BUILD, TAU_BUILD, K_QUERY = 48, 0.5, 10
# the fused-query knobs of the benchmark (bench_torch.QKW, imported above)
# and points of its (tau, pop budget, pops per step) sweep, cheapest first
SWEEP = [
    (0.64, 20, 4), (0.64, 24, 4), (0.64, 28, 4), (0.64, 32, 4),
    (0.64, 40, 5), (0.64, 48, 8), (0.51, 64, 8), (0.64, 100, 8),
    (0.64, 200, 8),
]
TARGET_C1 = 0.90
# row-engine (tau, pop budget) points, cheapest first, and its knobs; the
# four cheapest come before the JAX package's row points, whose first
# already lies far above c@1 0.90 on this data
ROW_SWEEP = [(0.4, 24), (0.45, 32), (0.5, 48), (0.5, 64),
             (0.5, 100), (0.64, 200), (0.7, 200), (0.64, 400), (1.0, 400)]
ROW_KW = {"engine": "row", "pops_per_iter": 8, "fetch_cap_fraction": 0.75}
N_DESCENT = 262_144
N_SHARDED, N_SHARD, MAX_DEVICE_SHARDS = 1_048_576, 262_144, 2
N_DEVICES, SLOTS = 524_288, 2
N_CLI, NQ_CLI, CLI_SHARD = 65_536, 1_000, 32_768
# k_query at the reference's bound: queries, pop budget, fused pops per step
KQ_MAX, NQ_KQ, KQ_BUDGET, KQ_FUSED_P = 6000, 1_000, 2_000, 32
N_MEASURES = 65_536  # the cosine build and the uint8 base
# the entry tile at full width: points, k_build, queries (the
# fused path's tile); the share of rows that may differ from the CPU run
ENTRY_FULL = {"n": 262_144, "k_build": 48, "batch": 8192}
ENTRY_CPU_ROWS = 0.01
# bench.py's own scale: points resident on the card, queries
N_HEADLINE, NQ_HEADLINE = 1_000_000, 50_000
# batch sizes of the tile-plan check, in this order, each a call of its own
MIX = (1000, 3000, 777, 5000, 10000, 1500, 4096, 2500, 8192, 300)
# the H100's published peaks (SXM, 700 W): HBM bytes/s and f32 FLOP/s
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12
# launches of the dedup kernel captured into the CUDA graph that phase 3b
# replays to read its device time
DEDUP_LAUNCHES = 20
# the dedup kernel's check shapes, each walk's step at k_build=48, P=8
# (ggnn_torch/config.py geometry): (label, rows, candidates K, beam W,
# ring V, compaction cap or None for the dedup alone)
DEDUP_SHAPES = [
    ("fused query step", 8192, 32, 32, 32, None),
    ("quantized merge step", 8192, 96, 96, 160, None),
    ("row query step", 8192, 384, 64, 192, 288),
    ("f32 merge step", 8192, 384, 96, 160, 192),
    ("sym walk step", 8192, 384, 64, 64, 192),
    (f"k_query {KQ_MAX} fused step", NQ_KQ, 384, 6048, 2144, None),
    (f"k_query {KQ_MAX} row step", NQ_KQ, 384, 6048, 2144, 288),
]

# the approximate top-k's check shapes: (label, rows, representatives n,
# seeds k, query rows): the headline's seeding tiles at 1,000,000 points
# (30,752 layer-1 representatives; the benchmark's num_seeds and the build
# merge's), the last tile of its 50,000 queries (848 rows padded to 1,024),
# a row shorter than 128 (no reduction) and an exact row of more than 8
# bins a thread (passes); and those checked in cosine too
APPROX_SHAPES = [
    ("query seeding", 8192, 30752, 8, 8192),
    ("merge seeding", 8192, 30752, 32, 8192),
    ("padded tail tile", 1024, 30752, 8, 848),
    ("n below 128", 8192, 100, 8, 8192),
    ("exact, passes", 1024, 3000, 100, 1024),
]
APPROX_COSINE = ("merge seeding", "padded tail tile", "n below 128")

# the fused gather + distance's check shapes: (label, rows B, candidates K,
# query vectors Q, base dtype, D, measure, base rows, translated): each
# walk's step at k_build=48, P=8 (the compaction caps of ``DEDUP_SHAPES``)
# over the smoke's 262,144-point base -- the row query's step, the f32
# merge's (on layer 0 and, translated, on an upper layer), the merges' own
# distances (``build/merge.py``: one candidate a row, the shape launched
# most in the builds, on layer 0 and translated), the descent's
# ``seed_beam`` (S = 32 segment ids a row, through the top layer's
# translation), the sym walk's (Q = 2, ``build/sym.py:_WALK_BATCH`` rows),
# the fused query's re-rank --, the uint8 base's row step (phase 12's
# 65,536 points), and the CPU tests' edge cases: D = 20 (the scalar path),
# K = 1, cosine, u8 with translation
GATHER_SHAPES = [
    ("row query step", 10000, 288, 1, "f32", D, "euclidean", N, False),
    ("f32 merge step", 8192, 192, 1, "f32", D, "euclidean", N, False),
    ("f32 merge step, translated", 8192, 192, 1, "f32", D, "euclidean", N, True),
    ("merge own distance", 8192, 1, 1, "f32", D, "euclidean", N, False),
    ("merge own distance, translated", 8192, 1, 1, "f32", D, "euclidean", N,
     True),
    # S = 32: the segment size at k_build=48 (``GraphConfig``)
    ("descent seed_beam", 8192, 32, 1, "f32", D, "euclidean", N, True),
    ("sym walk step", sym_mod._WALK_BATCH, 192, 2, "f32", D, "euclidean", N,
     False),
    ("re-rank", 8192, 16, 1, "f32", D, "euclidean", N, False),
    ("re-rank, cosine", 8192, 16, 1, "f32", D, "cosine", N, False),
    ("uint8 row step", 10000, 288, 1, "u8", D, "euclidean", N_MEASURES, False),
    ("D 20, K 1", 256, 1, 1, "f32", 20, "euclidean", 4096, True),
    ("D 20, u8, cosine", 256, 40, 2, "u8", 20, "cosine", 4096, False),
    ("u8, cosine, translated", 256, 40, 1, "u8", D, "cosine", 4096, True),
]

# the sort kernel's check shapes: (label, rows, beam W, candidates K, kept
# columns: None for an insert, else the cut's cap) -- the benchmark cells'
# walks at their 10,240-row tiles (k_build 24, P 8), the build merges' and
# the sym walk's at 8,192, the smoke's own k_build 48 row step
BEAM_SORT_SHAPES = [
    ("row query step", 10240, 64, 144, None),
    ("row query uncapped step", 10240, 64, 192, None),
    ("fused query step", 10240, 32, 32, None),
    ("fused query cap cut", 10240, 0, 192, 32),
    ("fused merge cap cut", 8192, 0, 192, 64),
    ("fused merge step", 8192, 64, 64, None),
    ("f32 merge and sym walk step", 8192, 64, 96, None),
    ("k_build 48 row step", 8192, 64, 288, None),
]

# the pop kernel's check shapes: (label, rows, beam W, pops P, k_best, ring
# V, the sym walk's own criterion and row mask) -- the benchmark cells'
# fused query steps at their tiles, the row query's, the build merges' and
# the sym walk's at 8,192 rows (k_build 24), k_query 6000's fused step
BEAM_POP_SHAPES = [
    ("gist1m fused query step", 1024, 32, 16, 10, 3200, False),
    ("sift1m fused query step", 8192, 32, 8, 10, 128, False),
    ("row query step", 8192, 64, 8, 10, 192, False),
    ("fused merge step", 8192, 64, 8, 25, 192, False),
    ("sym walk step", 8192, 64, 8, 12, 64, True),
    ("k_query 6000 fused step", 1024, 6048, 32, 6000, 32, False),
]


def time_ms(fn, device, reps=10, warmup=2):
    """Mean milliseconds per call: CUDA events around ``reps`` calls on a
    CUDA device (host clock after a synchronise on the CPU, for rehearsals
    at a tiny size)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def synthetic_inputs(device, nibbles, CR, B=8192, P=8, Nb=N):
    """Kernel inputs at one of the paths' shapes: ``CR`` code rows per block
    (48 for group 1, 96 for group 2, 24 for int4 at k=48) over ``Nb``
    blocks, ~10% empty anchors."""
    gen = torch.Generator(device=device).manual_seed(1 + nibbles)
    # query rows at the main path's magnitudes (uint8-range data, scale ~1)
    qs = torch.rand((B, D), generator=gen, device=device) * 255.0
    anchors = torch.randint(0, Nb, (B, P), generator=gen, device=device,
                            dtype=torch.int32)
    empty = torch.rand((B, P), generator=gen, device=device) < 0.1
    anchors = torch.where(empty, -1, anchors)
    blocks = torch.randint(0, 256, (Nb, CR, D), generator=gen, device=device,
                           dtype=torch.uint8)
    return qs, anchors, blocks


def check_kernel(device, nibbles, CR, B=8192, P=8, Nb=N):
    """Kernel vs its plain version on :func:`synthetic_inputs`."""
    qs, anchors, blocks = synthetic_inputs(device, nibbles, CR, B=B, P=P, Nb=Nb)
    return measure_kernel(device, qs, anchors, blocks, nibbles, "synthetic")


def bound(anchors, blocks, nibbles):
    """The least time the card could take for one kernel call: each block
    that a live anchor names read once, the query rows and anchors read
    once, each live output lane written once; 2 flops per code. Returns
    (bytes, flops, bound ms, "bytes" or "operations")."""
    B, P = anchors.shape
    _, CR, Dq = blocks.shape
    K = 2 * CR if nibbles else CR
    live = anchors >= 0
    n_live = int(live.sum())
    n_blocks = int(torch.unique(anchors[live]).numel())
    nbytes = n_blocks * CR * Dq + B * Dq * 4 + B * P * 4 + n_live * K * 4
    flops = 2 * n_live * K * Dq
    bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return nbytes, flops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def measure_kernel(device, qs, anchors, blocks, nibbles, label):
    """The kernel against its plain version on these inputs (live lanes at
    rtol 1e-5 / atol 1e-2: f32 summation order), both timed, and the least
    time the card could take for the call."""
    out = adjacency.adjacency_dot(qs, anchors, blocks, nibbles=nibbles)
    _sync(device)
    ref = adjacency.adjacency_dot_plain(qs, anchors, blocks, nibbles=nibbles)
    live = (anchors >= 0)[:, :, None].expand_as(ref)
    err = float((out - ref).abs()[live].max())
    if not torch.allclose(out[live], ref[live], rtol=1e-5, atol=1e-2):
        raise AssertionError(f"adjacency_dot (nibbles={nibbles}, {label}) "
                             f"disagrees with its plain version: max abs err {err}")
    ms, _ = time_ms(lambda: adjacency.adjacency_dot(qs, anchors, blocks,
                                                    nibbles=nibbles), device)
    plain_ms, _ = time_ms(lambda: adjacency.adjacency_dot_plain(
        qs, anchors, blocks, nibbles=nibbles), device)
    nbytes, flops, bound_ms, bound_by = bound(anchors, blocks, nibbles)
    B, P = anchors.shape
    _, CR, Dq = blocks.shape
    n_live = int(live[:, :, 0].sum())
    n_blocks = int(torch.unique(anchors[anchors >= 0]).numel())
    ops_ms = flops / F32_FLOP_S * 1e3
    gbs = n_live * CR * Dq / (ms * 1e-3) / 1e9
    print(f"adjacency_dot {label} nibbles={nibbles} B={B} P={P} CR={CR} "
          f"blocks={blocks.shape[0]} D={Dq}: live anchors {n_live}, distinct "
          f"blocks {n_blocks} | max abs err {err:.6g} | kernel {ms:.4f} ms "
          f"({gbs:.0f} GB/s of live blocks) | plain {plain_ms:.4f} ms | bound "
          f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s; {flops} flop at 67 "
          f"TFLOP/s: {ops_ms:.4f} ms) | share of bound {bound_ms / ms:.3f}",
          flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes}


def dedup_inputs(device, B, K, W, V, with_valid, seed=0):
    """Inputs of the dedup at one walk's step shape: a beam of W ids (~10%
    empty), a ring of V (~30% empty), and K candidates per row of which
    about a quarter repeat another column of the row, a quarter are taken
    from the beam or the ring and ~10% are -1; with ``with_valid`` a mask
    per anchor's group of K/8 columns, ~10% of them off, as a walk's pops
    give it."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def ids(shape, empty):
        t = torch.randint(0, N, shape, generator=gen, device=device,
                          dtype=torch.int32)
        return torch.where(torch.rand(shape, generator=gen, device=device) < empty,
                           -1, t)

    i, vis = ids((B, W), 0.1), ids((B, V), 0.3)
    cand = ids((B, K), 0.0)
    col = torch.arange(K, device=device).expand(B, K)
    u = torch.rand((B, K), generator=gen, device=device)
    other = torch.randint(0, K, (B, K), generator=gen, device=device)
    cand = torch.gather(cand, 1, torch.where(u < 0.25, other, col))
    seen = torch.cat([i, vis], dim=1)
    pick = torch.randint(0, W + V, (B, K), generator=gen, device=device)
    cand = torch.where((u >= 0.25) & (u < 0.5), torch.gather(seen, 1, pick), cand)
    cand = torch.where(torch.rand((B, K), generator=gen, device=device) < 0.1,
                       -1, cand).contiguous()
    valid = None
    if with_valid:
        groups = torch.rand((B, 8), generator=gen, device=device) >= 0.1
        valid = groups.repeat_interleave(-(-K // 8), dim=1)[:, :K].contiguous()
    st = beam.beam_init(B, W, 0.0, V, device=device)._replace(i=i, vis=vis)
    return st, cand, valid


def dedup_bound(B, K, W, V, cap, with_valid):
    """The least time the card could take for one dedup call: each input
    read once (candidates, ``valid``, beam and ring ids) and each output
    written once (``ok``, the packed ids) at 3.35 TB/s. Returns (bytes,
    bound ms)."""
    nbytes = B * (K * 4 + (K if with_valid else 0) + (W + V) * 4 + K
                  + (min(cap, K) * 4 if cap is not None else 0))
    return nbytes, nbytes / HBM_BYTES_S * 1e3


def replay_ms(fn, device, launches=DEDUP_LAUNCHES, reps=10):
    """Device ms per call of ``fn``: ``launches`` calls captured into one
    CUDA graph (after a warm-up call on a side stream, outside the capture),
    replayed ``reps`` times between CUDA events -- the way the walks run a
    kernel, without the host's path per call. On the CPU (rehearsals at a
    tiny size) the calls' host clock, as :func:`time_ms`."""
    if device.type != "cuda":
        return time_ms(fn, device)[0]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms, _ = time_ms(graph.replay, device, reps=reps, warmup=1)
    del graph
    return ms / launches


def dedup_resources(res, compact, K):
    """Registers, local (spill) and static shared bytes of the dedup
    kernel that a launch at K runs, alone or fused with the compaction,
    from ``res`` (``beam.kernel_resources()``: ``cuobjdump -res-usage``;
    None where the toolkit lacks it), or "not available"."""
    # the template arguments <compact, register chunks>, mangled
    tag = f"ILb{int(compact)}ELi{beam.register_chunks(K)}EE"
    return next(({f: r[f] for f in ("REG", "SHARED", "LOCAL", "STACK") if f in r}
                 for name, r in (res or {}).items() if tag in name),
                "not available")


def measure_dedup(device, label, B, K, W, V, cap, resources=None):
    """The dedup kernel (with ``cap``: fused with the compaction) against
    its plain version at one shape: the entries of ``ok`` and ``packed``
    that differ (must be 0); the kernel's device ms (:func:`replay_ms`) and
    its host path's, the plain version's ms, the bound, the launch's rows
    per block and shared bytes per block and the kernel's ``resources``."""
    with_valid = cap is not None
    st, cand, valid = dedup_inputs(device, B, K, W, V, with_valid)
    want = beam.beam_dedup_mask_plain(st, cand, valid)
    if cap is None:
        def run():
            return beam.beam_dedup_mask(st, cand, valid), None

        def plain():
            return beam.beam_dedup_mask_plain(st, cand, valid)
        want_packed = None
    else:
        def run():
            return beam.beam_dedup_compact(st, cand, valid, cap)

        def plain():
            ok = beam.beam_dedup_mask_plain(st, cand, valid)
            return beam.beam_compact_candidates_plain(cand, ok, cap)
        want_packed = beam.beam_compact_candidates_plain(cand, want, cap)
    ok, packed = run()
    _sync(device)
    differ = int((ok != want).sum())
    if want_packed is not None:
        differ += int((packed != want_packed).sum())
    kept = float(want.float().mean())
    if differ:
        raise AssertionError(f"beam dedup ({label}) differs from its plain "
                             f"version in {differ} entries")
    ms = replay_ms(run, device)
    host_ms, _ = time_ms(run, device)
    plain_ms, _ = time_ms(plain, device)
    nbytes, bound_ms = dedup_bound(B, K, W, V, cap, with_valid)
    what = f"with compaction to {cap}" if cap is not None else "alone"
    rows, smem = beam.rows_per_block(K, W, V), beam.shared_bytes(K, W, V)
    timing = (f"device: a CUDA graph of {DEDUP_LAUNCHES} launches"
              if device.type == "cuda" else "host clock, CPU")
    print(f"beam dedup {label} ({what}) B={B} K={K} W={W} V={V}: kept "
          f"{kept:.3f} | differing entries {differ} | kernel {ms:.4f} ms "
          f"({timing}) | host path "
          f"{host_ms:.4f} ms | plain {plain_ms:.4f} ms | bound {bound_ms:.4f} "
          f"ms ({nbytes} B at 3.35 TB/s) | share of bound {bound_ms / ms:.3f} "
          f"| rows per block {rows}, shared bytes per block {smem} | resources "
          f"{json.dumps(resources)}", flush=True)
    return {"max_abs_err": 0, "differing": differ, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "bound_share": bound_ms / ms, "bytes": nbytes,
            "rows_per_block": rows, "shared_bytes": smem,
            "resources": resources, "kept": kept}


def check_dedup(device, shapes=DEDUP_SHAPES):
    """Phase 3b: the dedup kernel against its plain version at every walk's
    step shape. Returns {label: numbers}."""
    out = {}
    res = beam.kernel_resources()
    for label, B, K, W, V, cap in shapes:
        out[label] = measure_dedup(device, label, B, K, W, V, cap,
                                   dedup_resources(res, cap is not None, K))
        torch.cuda.empty_cache()
    return out


def beam_sort_inputs(device, B, W, K, seed=0):
    """A beam as a walk leaves it and a tile of candidates on ``device``:
    each row's finite distances ascending in a prefix of 1/2 to all of W,
    a fifth of its columns blanked to +inf (``beam_pop``'s holes), a fifth
    of the candidates -1 and their distances uniform on [0, 2); criteria
    0.5 (about a quarter admitted) and a row mask of ~90%. Returns (state,
    ids, dists, criteria, row_mask)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    col = torch.arange(W, device=device)[None, :]
    fill = (W * (0.5 + 0.5 * rand(B, 1))).long()
    hole = (col >= fill) | (rand(B, W) < 0.2)
    d = torch.where(hole, float("inf"), torch.sort(rand(B, W), dim=-1)[0])
    i = torch.where(hole, -1, torch.randint(0, 1 << 24, (B, W), generator=g,
                                            device=device, dtype=torch.int32))
    exp = rand(B, W) < 0.5
    state = beam.BeamState(d, i, exp, torch.full((B, 1), -1, dtype=torch.int32,
                                                 device=device),
                           torch.zeros(B, dtype=torch.int32, device=device),
                           torch.zeros(B, device=device))
    ids = torch.randint(1 << 24, 1 << 25, (B, K), generator=g, device=device,
                        dtype=torch.int32)
    ids = torch.where(rand(B, K) < 0.2, -1, ids)
    crit = torch.full((B,), 0.5, device=device)
    return state, ids, 2 * rand(B, K), crit, rand(B) < 0.9


def measure_beam_sort(device, label, B, W, K, cap, resources=None):
    """The sort kernel (through ``beam_insert`` or ``cap_candidates``)
    against the torch.sort route on the same inputs at one shape: the
    entries that differ (must be 0); the kernel's device ms
    (:func:`replay_ms`) and its host path's, the route's device ms,
    ``torch.sort`` alone on the row's distances, the bytes bound and its
    share, the keys a lane and rows a block."""
    st, ids, d, crit, mask = beam_sort_inputs(device, B, W, K)
    if cap is None:
        def run():
            return beam.beam_insert(st, ids, d, mask, criteria=crit)[:3]

        def plain():
            return beam.beam_insert_plain(st, ids, d, mask, criteria=crit)[:3]
        keys = torch.cat([st.d, d], dim=-1)
        out = W
    else:
        def run():
            return beam.cap_candidates(ids, d, cap, criteria=crit)

        def plain():
            return beam.cap_candidates_plain(ids, d, cap, criteria=crit)
        keys = d
        out = cap
    got, want = run(), plain()
    _sync(device)
    differ = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                 if a.dtype == torch.float32 else int((a != b).sum())
                 for a, b in zip(got, want))
    admitted = float(((ids != -1) & (d < crit[:, None])).float().mean())
    if differ:
        raise AssertionError(f"beam sort ({label}) differs from the torch.sort "
                             f"route in {differ} entries")
    ms = replay_ms(run, device)
    host_ms, _ = time_ms(run, device)
    plain_ms = replay_ms(plain, device)
    sort_ms = replay_ms(lambda: torch.sort(keys, dim=-1, stable=True), device)
    # each input read once (beam 9 B an entry, a candidate 8, a row's
    # criterion 4 and mask 1), each output written once (9 B, 8 for a cut)
    nbytes = B * (W * 9 + K * 8 + 4 + (1 if cap is None else 0)
                  + out * (9 if cap is None else 8))
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    n = W + K
    lanes = beam_sort.keys_per_lane(W, K) if device.type == "cuda" else None
    rows = beam_sort.rows_per_block(W, K)
    what = "insert" if cap is None else f"cut to {cap}"
    timing = (f"device: a CUDA graph of {DEDUP_LAUNCHES} launches"
              if device.type == "cuda" else "host clock, CPU")
    print(f"beam sort {label} ({what}) B={B} W={W} K={K}: admitted "
          f"{admitted:.3f} | differing entries {differ} | kernel {ms:.4f} ms "
          f"({timing}) | host path {host_ms:.4f} ms | torch.sort route "
          f"{plain_ms:.4f} ms | torch.sort alone [B, {n}] {sort_ms:.4f} ms | "
          f"bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s) | share of bound "
          f"{bound_ms / ms:.3f} | keys a lane {lanes}, rows per block {rows} | "
          f"resources {json.dumps(resources)}", flush=True)
    return {"max_abs_err": 0, "differing": differ, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "library_ms": sort_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "bound_share": bound_ms / ms, "bytes": nbytes,
            "admitted": admitted, "keys_per_lane": lanes, "rows_per_block": rows}


def check_beam_sort(device, shapes=BEAM_SORT_SHAPES):
    """Phase 3e: the sort kernel against the torch.sort route at each
    walk's shape. Returns {label: numbers}."""
    res = None
    if device.type == "cuda":
        beam_sort.build_kernel()  # 0.0 where phase 2 built it
        res = beam_sort.kernel_resources()
    out = {}
    for label, B, W, K, cap in shapes:
        lanes = beam_sort.keys_per_lane(W, K)
        inst = next(({f: r[f] for f in ("REG", "SHARED", "LOCAL", "STACK") if f in r}
                     for name, r in (res or {}).items()
                     if f"kernelILi{lanes}E" in name), "not available")
        out[label] = measure_beam_sort(device, label, B, W, K, cap, inst)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def beam_pop_inputs(device, B, W, V, k_best, sym, seed=0):
    """A beam as a walk leaves it on ``device``: each row's finite
    distances ascending in a prefix of 1/2 to all of W (+inf after), ids
    distinct, the columns before ``k_best`` 80% expanded and the rest 20%,
    a slack of 0.1 (about a tenth of the unexpanded entries past the
    k_best-th distance pass); the ring half filled at a random head. With
    ``sym`` the criterion (the best distance + the slack) and a row mask of
    ~90%. Returns (state, criteria or None, row_mask or None)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device)

    col = torch.arange(W, device=device)[None, :]
    fill = (W * (0.5 + 0.5 * rand(B, 1))).long()
    hole = col >= fill
    d = torch.where(hole, float("inf"), torch.sort(rand(B, W), dim=-1)[0])
    i = torch.where(hole, -1, torch.argsort(rand(B, 4 * W), dim=-1)[:, :W]
                    .to(torch.int32))
    exp = (rand(B, W) < torch.where(col < k_best, 0.8, 0.2)) & ~hole
    vis = torch.where(rand(B, V) < 0.5, torch.randint(
        0, 1 << 24, (B, V), generator=g, device=device, dtype=torch.int32), -1)
    head = torch.randint(0, V, (B,), generator=g, device=device,
                         dtype=torch.int32)
    xi = torch.full((B,), 0.1, device=device)
    state = beam.BeamState(d, i, exp, vis, head, xi)
    if not sym:
        return state, None, None
    return state, d[:, 0] + xi, rand(B) < 0.9


def pop_graph_ms(pop, states, master, device, reps=10):
    """Device ms per pop of ``pop`` (which updates its state in place): one
    pop on each state of ``states`` captured into one CUDA graph (after a
    warm-up pop on a copy, on a side stream), each replay timed between
    CUDA events after every state is restored from ``master``."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        pop(beam.BeamState(*(t.clone() for t in master)))
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for st in states:
            pop(st)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        for st in states:
            for dst, src in zip(st, master):
                dst.copy_(src)
        torch.cuda.synchronize(device)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        total += start.elapsed_time(end)
    del graph
    return total / reps / len(states)


def measure_beam_pop(device, label, B, W, P, k_best, V, sym, resources=None):
    """The pop kernel (through ``beam_pop``) against the plain pop on the
    same state at one shape: the entries that differ (must be 0); the
    kernel's device ms (:func:`pop_graph_ms`) and its host path's, the
    plain pop's device ms (:func:`replay_ms`), the bytes bound and its
    share."""
    master, crit, mask = beam_pop_inputs(device, B, W, V, k_best, sym)

    def kernel(st):
        return beam.beam_pop(st, P, k_best, mask, criteria=crit)

    def plain():
        return beam.beam_pop_plain(master, P, k_best, mask, criteria=crit)

    want_a, want_act, want = plain()
    st = beam.BeamState(*(t.clone() for t in master))
    got_a, got_act, got = kernel(st)
    _sync(device)
    differ = int((got_a != want_a).sum()) + int((got_act != want_act).sum())
    for a, b in zip(got, want):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        differ += int((a != b).sum())
    # the kernel returns the state's own tensors (the CPU's plain route a
    # new state)
    in_place = device.type != "cuda" or all(a is b for a, b in zip(got, st))
    if differ or not in_place:
        raise AssertionError(f"beam pop ({label}) differs from the plain pop in "
                             f"{differ} entries (in place: {in_place})")
    cnt = (want_a != -1).sum(dim=-1)
    # each row reads its beam (9 B a column) up to its P-th hit, or all of
    # it short of P hits, and its vectors (head, slack or criterion, mask);
    # it writes its anchors, active, head, and a ring slot and a flag a hit
    # (a blanked hit 8 B more)
    popped = want.exp & ~master.exp
    col = torch.arange(W, device=device)[None, :]
    last = torch.where(popped, col, -1).amax(dim=-1)
    read_cols = torch.where(cnt < P, W, last + 1)
    blanked = int((popped & (col >= k_best)).sum())
    nbytes = (int(read_cols.sum()) * 9 + B * (4 + 4 + (1 if sym else 0))
              + B * (P * 4 + 1 + 4) + int(cnt.sum()) * 5 + blanked * 8)
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    states = [beam.BeamState(*(t.clone() for t in master))
              for _ in range(DEDUP_LAUNCHES)] if device.type == "cuda" else None
    if device.type == "cuda":
        ms = pop_graph_ms(kernel, states, master, device)
    else:
        ms = time_ms(lambda: kernel(beam.BeamState(*(t.clone() for t in master))),
                     device)[0]
    del states
    scratch = beam.BeamState(*(t.clone() for t in master))
    host_ms, _ = time_ms(lambda: kernel(scratch), device)
    plain_ms = replay_ms(plain, device)
    timing = (f"device: a CUDA graph of {DEDUP_LAUNCHES} pops"
              if device.type == "cuda" else "host clock, CPU")
    print(f"beam pop {label} B={B} W={W} P={P} k_best={k_best} V={V}: hits a row "
          f"{float(cnt.float().mean()):.2f}, columns read a row "
          f"{float(read_cols.float().mean()):.1f} | differing entries {differ} | "
          f"kernel {ms:.4f} ms ({timing}) | host path {host_ms:.4f} ms | plain "
          f"pop {plain_ms:.4f} ms | bound {bound_ms:.5f} ms ({nbytes} B at 3.35 "
          f"TB/s) | share of bound {bound_ms / ms:.3f} | resources "
          f"{json.dumps(resources)}", flush=True)
    return {"max_abs_err": 0, "differing": differ, "ms": ms, "host_ms": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms, "bytes": nbytes,
            "hits": float(cnt.float().mean())}


def check_beam_pop(device, shapes=BEAM_POP_SHAPES):
    """Phase 3f: the pop kernel against the plain pop at each walk's
    shape. Returns {label: numbers}."""
    res = "not available"
    if device.type == "cuda":
        beam.build_kernel()  # 0.0 where phase 2 built it
        found = beam.pop_kernel_resources()
        res = next(({f: r[f] for f in ("REG", "SHARED", "LOCAL", "STACK") if f in r}
                    for name, r in (found or {}).items()
                    if "beam_pop_kernel" in name), res)
    out = {}
    for label, *shape in shapes:
        out[label] = measure_beam_pop(device, label, *shape, resources=res)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def approx_inputs(device, B, n, rows, measure=DistanceMeasure.Euclidean):
    """The seeding's inputs at one shape: ``n`` representatives and ``B``
    query rows from the benchmark's data (its generator at seed 1), the
    rows past ``rows`` zero (a padded tile); for cosine one representative
    of zero norm. Returns (dot = q @ c.T by cuBLAS, q_sq, c_sq) on
    ``device``."""
    reps, qs = make_dataset(n, B, d=D, seed=1)
    q = torch.from_numpy(qs).to(device)
    q[rows:] = 0
    c = torch.from_numpy(reps).to(device)
    if measure == DistanceMeasure.Cosine:
        c[0] = 0
    return q @ c.T, squared_norms(q), squared_norms(c)


def approx_bound(B, n, k):
    """The least time the card could take for one approximate top-k: the
    dot matrix, both norms read once and the [B, k] distances and positions
    written once, at 3.35 TB/s, against the epilogue's 4 f32 operations an
    element (add, multiply, subtract, compare) at 67 TFLOP/s. Returns
    (bytes, bound ms, "bytes" or "operations")."""
    nbytes = B * n * 4 + n * 4 + B * 4 + B * k * 8
    bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, 4 * B * n / F32_FLOP_S * 1e3
    return nbytes, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def approx_resources(res, n, k, measure=DistanceMeasure.Euclidean):
    """Registers, local (spill) and static shared bytes of the approximate
    top-k kernel instance that a launch at (n, k) runs
    (``approx_topk.kernel_layout``), from ``res``
    (``approx_topk.kernel_resources()``), or "not available"."""
    tag = approx_topk.kernel_layout(n, k, measure=measure).template
    return next(({f: r[f] for f in ("REG", "SHARED", "LOCAL", "STACK") if f in r}
                 for name, r in (res or {}).items() if tag in name),
                "not available")


def measure_approx(device, label, B, n, k, rows, measure=DistanceMeasure.Euclidean,
                   resources=None):
    """The approximate top-k kernel against its plain version on the same
    dot products (Euclidean: ids equal and distances bit-equal; cosine: ids
    equal and distances within 2 ulp, ``rsqrtf``); the kernel's device ms
    (:func:`replay_ms`) and its host path's, the plain version's (``finish``
    + the op in torch), the current exact
    route's (``finish`` + ``smallest_k_positions``: ``torch.topk``, the
    exact set, not the binned one), the bound and its share, the seeds'
    recall against the exact top-k on the query rows."""
    dot, q_sq, c_sq = approx_inputs(device, B, n, rows, measure)

    def run():
        return approx_topk.approx_smallest_k(dot, q_sq, c_sq, k, measure)

    def dists():
        return finish(dot, q_sq[:, None], c_sq[None, :], measure)

    def plain():
        return approx_topk.approx_smallest_k_plain(dists(), k)

    def exact():
        return smallest_k_positions(dists(), k)

    d, p = run()
    _sync(device)
    want_d, want_p = plain()
    ids_differ = int((p != want_p).sum())
    ulp = int((d.view(torch.int32).long()
               - want_d.view(torch.int32).long()).abs().max())
    err = float((d - want_d).abs().max())
    if ids_differ or ulp > (0 if measure == DistanceMeasure.Euclidean else 2):
        raise AssertionError(f"approx top-k ({label}, {measure.name}) differs from "
                             f"its plain version: {ids_differ} ids, distances "
                             f"up to {ulp} ulp")
    _, exact_p = exact()
    hit = (p[:rows, :, None] == exact_p[:rows, None, :]).any(-1)
    recall = float(hit.float().mean())
    ms = replay_ms(run, device)
    host_ms, _ = time_ms(run, device)
    plain_ms, _ = time_ms(plain, device)
    library_ms, _ = time_ms(exact, device)
    del dot
    nbytes, bound_ms, bound_by = approx_bound(B, n, k)
    M = approx_topk.reduction_size(n, k)
    lay = approx_topk.kernel_layout(n, k, measure=measure)
    timing = (f"device: a CUDA graph of {DEDUP_LAUNCHES} launches"
              if device.type == "cuda" else "host clock, CPU")
    print(f"approx top-k {label} ({measure.name}) B={B} n={n} k={k} rows={rows} "
          f"bins={M}: differing ids {ids_differ}, distances max {ulp} ulp (max "
          f"abs err {err:.3g}) | recall vs exact {recall:.4f} | kernel {ms:.4f} "
          f"ms ({timing}) | host path {host_ms:.4f} ms | plain {plain_ms:.4f} "
          f"ms | exact route (finish + torch.topk) {library_ms:.4f} ms | bound {bound_ms:.4f} ms ({nbytes} B at 3.35 "
          f"TB/s) | share of bound {bound_ms / ms:.3f} | {lay.kernel} kernel, "
          f"rows per block {lay.rows_per_block}, bins a lane {lay.bins_per_lane}"
          f" x {lay.passes} passes, shared bytes per block {lay.shared_bytes} "
          f"| resources {json.dumps(resources)}", flush=True)
    return {"max_abs_err": err, "differing": ids_differ, "max_ulp": ulp,
            "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes, "recall": recall,
            "bins": M, "kernel": lay.kernel, "rows_per_block": lay.rows_per_block,
            "shared_bytes": lay.shared_bytes, "resources": resources}


def check_approx(device, shapes=APPROX_SHAPES, cosine=APPROX_COSINE):
    """Phase 3c: the approximate top-k kernel against its plain version at
    every shape, Euclidean, and at ``cosine``'s shapes cosine. Returns
    {label: numbers}."""
    out = {}
    res = approx_topk.kernel_resources()
    for label, B, n, k, rows in shapes:
        out[label] = measure_approx(device, label, B, n, k, rows,
                                    resources=approx_resources(res, n, k))
        torch.cuda.empty_cache()
    for label, B, n, k, rows in shapes:
        if label in cosine:
            out[f"{label}, cosine"] = measure_approx(
                device, label, B, n, k, rows, DistanceMeasure.Cosine,
                approx_resources(res, n, k, DistanceMeasure.Cosine))
            torch.cuda.empty_cache()
    return out


def approx_on_real_inputs(device, g, query_dev, label,
                          measure=DistanceMeasure.Euclidean, chunk=8192):
    """The approximate top-k kernel against its plain version on a path's
    own seeding inputs, on each shard of ``g`` resident on the card: each
    dense-seeded merge's first chunk (``chunk`` of layer l's points against
    layer l+1's representatives at k = 32, as ``build/merge.py`` seeds them,
    on the graph as built) and each tile of ``query_dev``'s tile plan
    against the fused index's representatives at the benchmark's
    ``num_seeds`` (the padded last tile included; none without an index).
    Ids equal and distances bit-equal (cosine: within 2 ulp), else it
    raises. Its launches are not the path's: call it after the path's
    counts are read. Returns the shapes checked, differing ids, max ulp."""
    tol = 0 if measure == DistanceMeasure.Euclidean else 2
    shards = [s for s in g._shards
              if s.graph is not None and s.base_dev is not None]
    f32 = torch.float32
    cases = []
    for shard in shards:
        base, base_sq, tr = shard.base_dev, shard.base_sq, shard.graph.translation
        for layer in range(len(tr) - 1):
            rows = (tr[layer][:chunk].long() if layer else
                    torch.arange(min(chunk, base.shape[0]), device=base.device))
            reps = tr[layer + 1].long()
            cases.append((f"merge layer {layer}", base[rows].to(f32),
                          base_sq[rows], base[reps].to(f32), base_sq[reps],
                          min(32, reps.shape[0])))
        index = shard.fused_index
        if index is None:
            continue
        for lo, rows, tile in fused_mod.tile_plan(query_dev.shape[0], chunk, device):
            q = fused_mod.pad_rows(query_dev[lo:lo + rows], tile).to(f32)
            cases.append((f"query tile {lo}", q, torch.sum(q * q, dim=-1),
                          index.rep_vecs, index.rep_sq, QKW["num_seeds"]))
    shapes, differing, max_ulp = [], 0, 0
    for what, q, q_sq, c, c_sq, k in cases:
        dot = approx_topk.seeding_product(q, c)  # as the seeding makes it
        d, p = approx_topk.approx_smallest_k(dot, q_sq, c_sq, k, measure)
        want_d, want_p = approx_topk.approx_smallest_k_plain(
            finish(dot, q_sq[:, None], c_sq[None, :], measure), k)
        ids = int((p != want_p).sum())
        ulp = int((d.view(torch.int32).long()
                   - want_d.view(torch.int32).long()).abs().max())
        if ids or ulp > tol:
            raise AssertionError(f"approx top-k on {label}'s {what} ({tuple(dot.shape)}"
                                 f", k={k}, {measure.name}) differs from its plain "
                                 f"version: {ids} ids, distances up to {ulp} ulp")
        shapes.append([*dot.shape, k])
        differing, max_ulp = differing + ids, max(max_ulp, ulp)
        del dot
    out = {"shards": f"{len(shards)} of {len(g._shards)}", "inputs": len(shapes),
           "shapes": sorted({tuple(s) for s in shapes}), "differing": differing,
           "max_ulp": max_ulp}
    print(f"approx top-k on {label}'s own seeding inputs ({measure.name}; "
          f"resident shards {out['shards']}): {len(shapes)} inputs, shapes "
          f"(B, n, k) {out['shapes']} | differing ids {differing}, distances "
          f"max {max_ulp} ulp", flush=True)
    return out


def gather_inputs(device, B, K, Q, dtype, dim, n_base, translated, seed=0):
    """The fused gather + distance's inputs at one shape: a base of
    ``n_base`` rows (uniform in the uint8 range, f32 or uint8), ``Q``
    query vectors a row at the same magnitudes, ``K`` ids a row over a
    layer of the base's rows (half of them through a translation when
    ``translated``), ~10% of them -1. Returns (qs, q_sq, ids, base,
    base_sq, translation or None)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.rand((n_base, dim), generator=gen, device=device) * 255.0
    if dtype == "u8":
        base = base.to(torch.uint8)
    base_sq = squared_norms(base)
    qs = torch.rand((B, Q, dim), generator=gen, device=device) * 255.0
    q_sq = torch.sum(qs * qs, dim=-1)
    n_layer = n_base // 2 if translated else n_base
    ids = torch.randint(0, n_layer, (B, K), generator=gen, device=device,
                        dtype=torch.int32)
    ids[torch.rand((B, K), generator=gen, device=device) < 0.1] = -1
    tr = (torch.randperm(n_base, generator=gen, device=device)[:n_layer]
          .to(torch.int32) if translated else None)
    return qs, q_sq, ids, base, base_sq, tr


def gather_bound(ids, translation, dim, elem, Q, with_ids=False):
    """The least time the card could take for one gather + distance: the ids
    read once, each distinct translation entry, base row (``dim`` elements
    of ``elem`` bytes) and norm the ids name read once, the ``Q`` query
    vectors and norms of each row read once, the distances written once
    (and the base ids, ``with_ids``: no walk asks for them), at 3.35 TB/s;
    against 2 flops a product at 67 TFLOP/s. Returns (bytes, flops, bound
    ms, "bytes" or "operations")."""
    B, K = ids.shape
    layer = torch.unique(ids.clamp_min(0).long())
    if translation is not None:
        n_rows = int(torch.unique(translation[layer]).numel())
        n_tr = int(layer.numel())
    else:
        n_rows, n_tr = int(layer.numel()), 0
    nbytes = (B * K * 4 + n_tr * 4 + n_rows * (dim * elem + 4)
              + B * Q * (dim * 4 + 4) + B * Q * K * 4
              + (B * K * 8 if with_ids else 0))
    flops = 2 * B * Q * K * dim
    bytes_ms, ops_ms = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOP_S * 1e3
    return nbytes, flops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def measure_gather(device, label, B, K, Q, dtype, dim, measure, n_base,
                   translated):
    """The fused gather + distance kernel against its plain version at one
    shape: base ids equal, every distance within ``gather_dist.error_bound``
    (the largest ratio of error to bound and the entries over it, 0, are
    printed), and the distances without base ids (the walks' form) equal
    to those with them bit for bit; the kernel's device ms in the walks'
    form (:func:`replay_ms`) and its host path's, the plain version's ms,
    ``torch.bmm`` alone on rows gathered beforehand (the library yardstick,
    the gather excluded), the bound by distinct rows (each input byte once)
    and by gathered rows (each candidate's row once), and the shares of
    both."""
    measure = DistanceMeasure[measure.capitalize()]
    qs, q_sq, ids, base, base_sq, tr = gather_inputs(
        device, B, K, Q, dtype, dim, n_base, translated)

    def run():  # the walks' form: no base ids
        return gather_dist.gather_dist(qs, q_sq, ids, base, base_sq, tr,
                                       measure, with_ids=False)

    def plain():
        return gather_dist.gather_dist_plain(qs, q_sq, ids, base, base_sq, tr,
                                             measure, with_ids=False)

    d, base_ids = gather_dist.gather_dist(qs, q_sq, ids, base, base_sq, tr,
                                          measure)
    d_walk, _ = run()
    _sync(device)
    want_d, want_ids = gather_dist.gather_dist_plain(qs, q_sq, ids, base,
                                                     base_sq, tr, measure)
    ids_differ = int((base_ids != want_ids).sum())
    walk_form_equal = torch.equal(d_walk, d)
    bound = gather_dist.error_bound(q_sq, base_sq[want_ids], dim, measure)
    err = (d - want_d).abs()
    ratio = float((err / bound).max())
    over = int((err > bound).sum())
    max_err = float(err.max())
    if ids_differ or over or not walk_form_equal:
        raise AssertionError(f"gather_dist ({label}) differs from its plain "
                             f"version: {ids_differ} base ids, {over} distances "
                             f"over the bound (largest ratio {ratio:.3f}); "
                             f"without base ids equal to with them: "
                             f"{walk_form_equal}")
    del d, d_walk, base_ids, want_d, err, bound
    vecs = base[want_ids].to(torch.float32)  # gathered beforehand
    q_t = qs.transpose(1, 2)

    def library():
        return torch.bmm(vecs, q_t)

    ms = replay_ms(run, device)
    host_ms, _ = time_ms(run, device)
    plain_ms, _ = time_ms(plain, device)
    library_ms, _ = time_ms(library, device)
    del vecs
    elem = 1 if dtype == "u8" else 4
    nbytes, flops, bound_ms, bound_by = gather_bound(ids, tr, dim, elem, Q)
    gathered = (B * K * (dim * elem + 4 + 4) + B * Q * (dim * 4 + 4)
                + B * Q * K * 4)
    gathered_ms = gathered / HBM_BYTES_S * 1e3
    timing = (f"device: a CUDA graph of {DEDUP_LAUNCHES} launches"
              if device.type == "cuda" else "host clock, CPU")
    print(f"gather_dist {label} B={B} K={K} Q={Q} {dtype} D={dim} "
          f"{measure.name} base {n_base}{' translated' if translated else ''}: "
          f"base ids differing {ids_differ} | largest error / bound {ratio:.4f},"
          f" entries over the bound {over} (max abs err {max_err:.4g}) | kernel "
          f"{ms:.4f} ms ({timing}) | host path {host_ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | torch.bmm on pre-gathered rows {library_ms:.4f}"
          f" ms | bound {bound_ms:.4f} ms ({nbytes} B, distinct rows, at 3.35 "
          f"TB/s; {flops} flop) share {bound_ms / ms:.3f} | each gathered row "
          f"once {gathered_ms:.4f} ms ({gathered} B) share "
          f"{gathered_ms / ms:.3f}", flush=True)
    return {"max_abs_err": max_err, "max_err_ratio": ratio,
            "over_bound": over, "differing": ids_differ, "ms": ms,
            "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes,
            "gathered_bound_ms": gathered_ms,
            "gathered_bound_share": gathered_ms / ms}


def check_gather(device, shapes=GATHER_SHAPES):
    """Phase 3d: the fused gather + distance kernel against its plain
    version at every walk's step shape and the CPU tests' edge cases.
    Returns {label: numbers}."""
    out = {}
    for label, *shape in shapes:
        out[label] = measure_gather(device, label, *shape)
        torch.cuda.empty_cache()
    print(f"gather_dist vs plain: largest error / bound "
          f"{max(r['max_err_ratio'] for r in out.values()):.4f}, entries over "
          f"the bound {sum(r['over_bound'] for r in out.values())}, base ids "
          f"differing {sum(r['differing'] for r in out.values())}", flush=True)
    return out


@contextmanager
def plain_gather():
    """While inside, the walks' distance steps and the re-rank take the
    plain gather + einsum (``gather_dist_plain``) in place of the kernel:
    both routes on one card in one run. Every walk program is released on
    entry and on exit, so that no graph captured on one side replays on the
    other."""
    mods = (traverse_mod, sym_mod, fused_mod)
    graphs.clear()
    for m in mods:
        m.gather_dist = gather_dist.gather_dist_plain
    try:
        yield
    finally:
        for m in mods:
            m.gather_dist = gather_dist.gather_dist
        graphs.clear()


def gather_before_after(device, label, call, evaluate=None, reps=3):
    """``call()`` with the gather kernel and with the plain gather
    (:func:`plain_gather`): the ms per call of each (CUDA events, after two
    warm-ups: each side starts with no walk program, so its first call
    captures the walk's graphs, and the call after it still runs slower
    than the later ones), one profile of each, and ``evaluate`` of each
    call's result (c@1, or the requests a sym chunk made). Returns both."""
    out = {}
    for side in ("kernel", "plain"):
        with plain_gather() if side == "plain" else nullcontext():
            ms, res = time_ms(call, device, reps=reps, warmup=2)
            out[side] = {"ms": ms, "profile": profile_call(
                device, call, f"{label} ({side} gather)")}
            if evaluate is not None:
                out[side]["result"] = evaluate(res)
    print(f"{label}: ms per call with the gather kernel {out['kernel']['ms']:.3f}"
          f", with the plain gather {out['plain']['ms']:.3f} | results "
          f"{json.dumps({k: v.get('result') for k, v in out.items()})}",
          flush=True)
    return out


def gather_sweep(g, query_dev, evaluator, points, kw, label):
    """Each of the (tau, pop budget) ``points`` with the gather kernel and
    with the plain gather (one call each, 10,000 queries): c@1 of the two
    must lie within 0.003 -- the kernel sums in another order than cuBLAS,
    which may swap near ties, nothing more. Returns [{point, kernel c@1,
    plain c@1}]."""
    out = []
    for side in ("kernel", "plain"):
        with plain_gather() if side == "plain" else nullcontext():
            for i, (tau, iters) in enumerate(points):
                res = g.query(query_dev, K_QUERY, tau, iters, **kw)
                c1 = evaluator.evaluate_results(np.asarray(res.ids)).c1
                if side == "kernel":
                    out.append({"tau": tau, "iters": iters, "kernel_c1": c1})
                else:
                    out[i]["plain_c1"] = c1
    for p in out:
        print(f"{label} tau={p['tau']} iters={p['iters']}: c@1 gather kernel "
              f"{p['kernel_c1']:.4f}, plain gather {p['plain_c1']:.4f}",
              flush=True)
        if abs(p["kernel_c1"] - p["plain_c1"]) > 0.003:
            raise AssertionError(f"{label}: c@1 with the gather kernel "
                                 f"{p['kernel_c1']} is not within 0.003 of the "
                                 f"plain route's {p['plain_c1']}")
    return out


def fused_call(g, query_dev, point, route=None, k=K_QUERY):
    """One fused query of shard 0 at ``point`` with the smoke's knobs, as
    ``GGNN.query`` makes it, through ``route`` (None: CUDA graphs on the
    card; ``graphs.EAGER``: the host-stepped plain version), seeded as
    ``GGNN.query`` seeds by default (the TPU's approximate top-k)."""
    shard = g._shards[0]
    kw = {n: v for n, v in QKW.items() if n != "engine"}
    return fused_mod.fused_query(
        query_dev, shard.fused_index, shard.base_dev, k, point["tau"],
        point["iters"], g._measure, base_sq=shard.base_sq,
        pops_per_iter=point["P"], route=route, seed_approx=True, **kw)


def row_call(g, query_dev, point, route=None, k=K_QUERY):
    """One row-engine query of shard 0 at ``point``, as ``GGNN.query``."""
    shard = g._shards[0]
    return ann_query(query_dev, shard.base_dev, shard.graph, g._cfg, k,
                     point["tau"], point["iters"], g._measure,
                     base_sq=shard.base_sq, pops_per_iter=ROW_KW["pops_per_iter"],
                     fetch_cap_fraction=ROW_KW["fetch_cap_fraction"], route=route)


def graph_vs_eager(device, label, call, reps=3):
    """``call(route)`` through CUDA graphs and through the eager loop: ids
    and dists must be identical, bit for bit. Prints the count of rows
    that differ (must be 0) and each route's ms per call (CUDA events)."""
    eager = call(graphs.EAGER)
    got = call(None)
    ids_e, d_e = (t.cpu().numpy() for t in eager)
    ids_g, d_g = (t.cpu().numpy() for t in got)
    rows = int(np.sum(np.any((ids_e != ids_g) | (d_e != d_g), axis=1)))
    eager_ms, _ = time_ms(lambda: call(graphs.EAGER), device, reps=reps, warmup=0)
    graph_ms, _ = time_ms(lambda: call(None), device, reps=reps, warmup=0)
    print(f"{label}: graph route vs eager route: {rows} of {ids_e.shape[0]} rows "
          f"differ (ids and dists bit for bit) | ms per call: graphs "
          f"{graph_ms:.3f}, eager {eager_ms:.3f}", flush=True)
    if rows:
        raise AssertionError(f"{label}: the graph route differs from the eager "
                             f"route in {rows} rows")
    return {"rows_differing": rows, "graph_ms": graph_ms, "eager_ms": eager_ms}


@contextmanager
def eager_walks():
    """``GGNN.query``'s walks take the eager route (the plain version)
    while inside: both routes timed on the one call path."""
    fused, row = ggnn_mod.fused_query, ggnn_mod.ann_query
    ggnn_mod.fused_query = functools.partial(fused, route=graphs.EAGER)
    ggnn_mod.ann_query = functools.partial(row, route=graphs.EAGER)
    try:
        yield
    finally:
        ggnn_mod.fused_query, ggnn_mod.ann_query = fused, row


def _dedup_compact_plain(state, cand_i, valid, cap):
    ok = beam.beam_dedup_mask_plain(state, cand_i, valid)
    return ok, beam.beam_compact_candidates_plain(cand_i, ok, cap)


@contextmanager
def plain_dedup():
    """While inside, the walks dedup (and compact) with the plain versions
    in place of the kernel: the dedup's share of a call, before and after,
    on one card in one run. Every walk program is released on entry and on
    exit, so that no graph captured on one side replays on the other."""
    swaps = [(traverse_mod, "beam_dedup_mask", beam.beam_dedup_mask_plain),
             (traverse_mod, "beam_dedup_compact", _dedup_compact_plain),
             (sym_mod, "beam_dedup_compact", _dedup_compact_plain),
             (fused_mod, "beam_dedup_mask", beam.beam_dedup_mask_plain)]
    kept = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    graphs.clear()
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in kept:
            setattr(m, name, fn)
        graphs.clear()


def dedup_before_after(device, label, call, reps=3):
    """``call()`` with the dedup kernel and with the plain dedup
    (:func:`plain_dedup`): the ms per call of each (CUDA events, after one
    warm-up) and one profile of each. Returns both."""
    out = {}
    for side in ("kernel", "plain"):
        with plain_dedup() if side == "plain" else nullcontext():
            ms, _ = time_ms(call, device, reps=reps, warmup=1)
            out[side] = {"ms": ms, "profile": profile_call(
                device, call, f"{label} ({side} dedup)")}
    print(f"{label}: ms per call with the dedup kernel {out['kernel']['ms']:.3f}, "
          f"with the plain dedup {out['plain']['ms']:.3f}", flush=True)
    return out


def batch_mix(device, g, query_dev, point):
    """The tile plan under changing batch sizes at ``point``: one call of
    3,000 queries, whose 4,096-row tile no call walked before (its graphs
    captured in it), and the same call again; then the batch sizes of
    ``MIX``, one call each, twice through the graph route and once through
    the eager one. Prints each pass's ms (CUDA events per call), its
    graphs captured and the tile shapes the mix walks."""
    kw = dict(QKW, pops_per_iter=point["P"])

    def call(n):
        return g.query(query_dev[:n], K_QUERY, point["tau"], point["iters"], **kw)

    out = {}
    for label in ("first_call", "second_call"):
        captured = graphs.stats()["captures"]
        ms, _ = time_ms(lambda: call(3000), device, reps=1, warmup=0)
        out[label] = {"ms": ms, "captures": graphs.stats()["captures"] - captured}
    for label in ("graphs_pass1", "graphs_pass2", "eager"):
        captured = graphs.stats()["captures"]
        with eager_walks() if label == "eager" else nullcontext():
            ms = [time_ms(lambda: call(n), device, reps=1, warmup=0)[0] for n in MIX]
        out[label] = {"ms": ms, "total_ms": sum(ms),
                      "captures": graphs.stats()["captures"] - captured}
    # the tiles of GGNN.query's default chunk
    tiles = sorted({t for n in MIX for _, _, t in fused_mod.tile_plan(n, 8192)})
    out["tiles"] = tiles
    out["graph_pool_bytes"] = graphs.pool_bytes()
    print(f"tile plan: 3,000 queries (a 4,096-row tile) first call "
          f"{out['first_call']['ms']:.3f} ms with {out['first_call']['captures']} "
          f"captures, again {out['second_call']['ms']:.3f} ms with "
          f"{out['second_call']['captures']} | batch sizes {list(MIX)} walk tiles "
          f"{tiles}: graphs pass 1 {out['graphs_pass1']['total_ms']:.3f} ms "
          f"({out['graphs_pass1']['captures']} captures), pass 2 "
          f"{out['graphs_pass2']['total_ms']:.3f} ms "
          f"({out['graphs_pass2']['captures']} captures), eager "
          f"{out['eager']['total_ms']:.3f} ms | per call (ms): pass 1 "
          f"{[round(x, 3) for x in out['graphs_pass1']['ms']]}, pass 2 "
          f"{[round(x, 3) for x in out['graphs_pass2']['ms']]}, eager "
          f"{[round(x, 3) for x in out['eager']['ms']]} | pools "
          f"{out['graph_pool_bytes']} B", flush=True)
    return out


def kernel_on_real_anchors(device, g, query_dev, point, label):
    """The kernel measured on the inputs of the third launch (the third walk
    step of the first query tile) of one fused query call at ``point`` (tau,
    pop budget, P): real anchors on the shard's real index, past the first
    steps, whose anchors are the few shared seeds. The call takes the eager
    route (a graph replay does not pass through the Python wrapper). Its
    launches are not the path's: call this after the path's counts are
    read."""
    calls = []
    launch = fused_mod.adjacency_dot

    def record(qs, anchors, blocks, *, nibbles=False):
        if len(calls) < 3:
            calls.append((qs.clone(), anchors.clone(), blocks, nibbles))
        return launch(qs, anchors, blocks, nibbles=nibbles)

    fused_mod.adjacency_dot = record
    try:
        fused_call(g, query_dev, point, route=graphs.EAGER)
    finally:
        fused_mod.adjacency_dot = launch
    qs, anchors, blocks, nibbles = calls[-1]
    return measure_kernel(device, qs, anchors, blocks, nibbles,
                          f"real anchors ({label})")


def profile_call(device, fn, label, tiles=1):
    """One call of ``fn`` (after one warm-up) under ``torch.profiler``: its
    host-clock ms under the profiler, the ms in which the card ran a kernel
    or a copy (the union of their spans in the trace), its kernel count, the
    5 kernels (by name) with the most device ms, the adjacency and the
    dedup kernels' launches and device ms -- what tells a slower call's
    host from its device --, the approximate top-k's, the device ms of the
    kernels launched inside each of the fused tile's profiler ranges
    (``seed``, ``walk``, ``rerank``: matched to the ranges through their
    launches' correlation ids), and its host syncs per query tile (the trace's
    ``aten::_local_scalar_dense`` events, a tensor read on the host, and
    the walks' live-count reads), with the graphs captured so far and the
    bytes of their pools. The profiler runs a warm-up step (one more call,
    traced and dropped) before the step it keeps. The approximate top-k's
    launches counted by its wrapper in that call stand beside the trace's,
    with each ``seed`` range's kernels of it and its launch calls that the
    trace holds no device record for. None on the CPU rehearsal, which has
    no device trace."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    _sync(device)
    with tempfile.TemporaryDirectory(prefix="ggnn_smoke_trace_") as tmp:
        path = Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                     ) as prof:
            fn()
            _sync(device)
            prof.step()
            reads = graphs.stats()["live_reads"]
            counted = approx_topk.launches
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall_ms = (time.perf_counter() - t0) * 1e3
            counted = approx_topk.launches - counted
            reads = graphs.stats()["live_reads"] - reads
            prof.step()
        events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    adj = [e["dur"] for e in kernels if e["name"].startswith("adjacency_dot")]
    dedup = [e["dur"] for e in kernels if "beam_dedup_kernel" in e["name"]]
    approx = [e["dur"] for e in kernels if "approx_topk_kernel" in e["name"]]
    ranges = {name: range_device_ms(events, name)
              for name in ("seed", "walk", "rerank")}
    seed_ranges = approx_by_seed_range(events)
    syncs = sum(1 for e in events if e.get("name") == "aten::_local_scalar_dense")
    st = graphs.stats()
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e3 / wall_ms, "kernels": len(kernels),
           "adjacency_launches": len(adj), "adjacency_ms": sum(adj) / 1e3,
           "dedup_launches": len(dedup), "dedup_ms": sum(dedup) / 1e3,
           "approx_topk_launches": len(approx),
           "approx_topk_launches_counted": counted,
           "approx_topk_ms": sum(approx) / 1e3,
           "seed_ranges_approx_unrecorded": seed_ranges,
           "ranges_ms": {k: v[0] for k, v in ranges.items()},
           "ranges_ms_per_tile": {k: v[0] / tiles for k, v in ranges.items()},
           "ranges_kernels": {k: v[1] for k, v in ranges.items()},
           "host_syncs_per_tile": syncs / tiles,
           "live_reads_per_tile": reads / tiles,
           "graphs_captured": st["captures"], "graphs_cached": st["graphs"],
           "graph_pool_bytes": graphs.pool_bytes(),
           "graph_buffer_bytes": st["buffer_bytes"],
           "top_kernels_ms": [[name[:80], ms] for name, ms in top]}
    print(f"profile of one {label} call: {wall_ms:.3f} ms on the host clock "
          f"under the profiler | device busy {out['device_busy_ms']:.3f} ms "
          f"({out['busy_share']:.3f}) in {len(kernels)} kernels | adjacency "
          f"kernel {len(adj)} launches, {out['adjacency_ms']:.3f} ms | dedup "
          f"kernel {len(dedup)} launches, {out['dedup_ms']:.3f} ms | approx "
          f"top-k kernel {len(approx)} launches in the trace ({counted} counted "
          f"by its wrapper; per seed range [its launches, launch calls without "
          f"a device record] {json.dumps(seed_ranges)}), "
          f"{out['approx_topk_ms']:.3f} ms "
          f"| device ms by range (kernels) "
          f"{json.dumps({k: [round(v[0], 3), v[1]] for k, v in ranges.items()})}"
          f", per tile {json.dumps({k: round(v, 3) for k, v in out['ranges_ms_per_tile'].items()})} | host "
          f"syncs per tile {out['host_syncs_per_tile']:.2f} (live-count reads "
          f"{out['live_reads_per_tile']:.2f}) over {tiles} tiles | graphs "
          f"captured so far {st['captures']}, cached {st['graphs']} in "
          f"{st['programs']} programs, pools {out['graph_pool_bytes']} B, "
          f"static buffers {st['buffer_bytes']} B | top 5 kernels by device "
          f"ms {json.dumps(out['top_kernels_ms'])}", flush=True)
    return out


def range_device_ms(events, name):
    """Device ms and count of the kernels, copies and sets launched inside
    the profiler ranges called ``name`` (``torch.profiler.record_function``)
    of a Chrome trace's ``events``: the runtime calls inside a range's span
    name the device work by their correlation ids."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    corr = {e["args"]["correlation"] for e in events
            if str(e.get("cat", "")).startswith("cuda_")
            and "correlation" in e.get("args", {})
            and any(a <= e["ts"] <= b for a, b in spans)}
    work = [e["dur"] for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in corr]
    return sum(work) / 1e3, len(work)


def approx_by_seed_range(events):
    """For each ``seed`` range of a Chrome trace's ``events``, in order: the
    approximate top-k kernels launched inside it, and its runtime launch
    calls whose correlation id no device record carries (a kernel the
    trace lost)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == "seed")
    device = {e["args"].get("correlation"): e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    calls = [e for e in events if str(e.get("cat", "")).startswith("cuda_")
             and "Launch" in e.get("name", "")]
    out = []
    for a, b in spans:
        inside = [device.get(e["args"].get("correlation"))
                  for e in calls if a <= e["ts"] <= b]
        out.append([sum(1 for d in inside if d is not None
                        and "approx_topk_kernel" in d["name"]),
                    sum(1 for d in inside if d is None)])
    return out


def zero_launches():
    """Every kernel's launch counts to 0 (just before a path runs)."""
    adjacency.launches = adjacency.launches_nibbles = 0
    beam.launches = beam.launches_compact = 0
    approx_topk.launches = 0
    gather_dist.launches = 0
    beam_sort.launches = beam_sort.launches_torch = 0
    beam.pops_kernel = beam.pops_plain = 0


def launches_now():
    """Every kernel's launches since :func:`zero_launches`: the adjacency
    kernel's (and those in int4 mode), the dedup kernel's alone and fused
    with the compaction, the seeding's approximate top-k's, the walks'
    fused gather + distance's, the beam ops' sort kernel's and their
    torch.sort route's, the pop kernel's and the plain pops on the card."""
    pops = beam.pop_launches()
    return {"adjacency_dot": adjacency.launches,
            "adjacency_dot_nibbles": adjacency.launches_nibbles,
            "beam_dedup": beam.launches - beam.launches_compact,
            "beam_dedup_compact": beam.launches_compact,
            "approx_topk": approx_topk.launches,
            "gather_dist": gather_dist.launches,
            "beam_sort": beam_sort.launches,
            "beam_sort_torch": beam_sort.launches_torch,
            "beam_pop": pops["kernel"],
            "beam_pop_plain": pops["plain"]}


def _minus(a, b):
    return {k: a[k] - b[k] for k in a}


def _launched(count, what, device, kernel="the adjacency kernel"):
    """The kernel must have launched (on the card; the CPU rehearsal runs
    the plain version, which counts nothing)."""
    if device.type == "cuda" and count <= 0:
        raise AssertionError(f"{what} never launched {kernel}")


def _not_launched(count, what):
    if count != 0:
        raise AssertionError(f"{what} launched the adjacency kernel {count} "
                             "times; its path runs no such kernel")


def _gather_launched(counts, what, device):
    """The fused gather + distance kernel must have launched in ``counts``."""
    _launched(counts["gather_dist"], what, device,
              "the gather + distance kernel")


def _dedup_launched(counts, what, device, compact=False):
    """The dedup kernel must have launched in ``counts``: alone, or with
    ``compact`` fused with the compaction."""
    key = "beam_dedup_compact" if compact else "beam_dedup"
    _launched(counts[key], what, device, f"the dedup kernel ({key})")


def _check_exact(ids, dists, base, query, measure=DistanceMeasure.Euclidean,
                 rows=(0,)):
    """The returned distances of the query ``rows`` (the first by default)
    are the exact ones (squared L2, or cosine)."""
    for r in rows:
        row = ids[r][ids[r] >= 0]
        b = base[row].astype(np.float64)
        q = np.asarray(query[r], dtype=np.float64)
        if measure == DistanceMeasure.Euclidean:
            exact = np.sum((b - q) ** 2, axis=-1)
            tol = dict(rtol=1e-4, atol=1e-2)
        else:
            exact = np.abs(1.0 - b @ q / np.sqrt(np.sum(b * b, -1) * np.sum(q * q)))
            tol = dict(rtol=1e-3, atol=1e-5)
        if not np.allclose(dists[r][: len(row)], exact, **tol):
            raise AssertionError(f"the distances of query {r} are not the exact ones")


def sweep(g, query_dev, base, query, evaluator, points, kw, device, label,
          reps=5, warmup=2, measure=DistanceMeasure.Euclidean):
    """Query operating points cheapest first until c@1 >= 0.90; QPS from
    CUDA events around the query calls alone (results left on the card).
    Returns the first point that reached the target."""
    nq = query.shape[0]
    g.set_return_results_on_device(True)
    best = None
    for point in points:
        tau, iters = point[:2]
        call_kw = dict(kw) if len(point) == 2 else dict(kw, pops_per_iter=point[2])
        ms, res = time_ms(
            lambda: g.query(query_dev, K_QUERY, tau, iters, **call_kw), device,
            reps=reps, warmup=warmup,
        )
        ids = res.ids.cpu().numpy()
        dists = res.dists.cpu().numpy()
        if ids.shape != (nq, K_QUERY) or not np.all(np.isfinite(dists)):
            raise AssertionError(f"{label} query returned malformed results")
        ev = evaluator.evaluate_results(ids)
        qps = nq / (ms * 1e-3)
        print(f"{label} query tau={tau} iters={iters} "
              f"P={call_kw['pops_per_iter']}: c@1={ev.c1:.4f} "
              f"c@10={ev.cKQuery:.4f} qps={qps:.1f} ({ms:.3f} ms / {nq} "
              "queries)", flush=True)
        if ev.c1 >= TARGET_C1:
            best = {"tau": tau, "iters": iters, "P": call_kw["pops_per_iter"],
                    "qps": qps, "c1": ev.c1, "c10": ev.cKQuery}
            _check_exact(ids, dists, base, query, measure)
            break
    g.set_return_results_on_device(False)
    if best is None:
        raise AssertionError(f"{label}: no sweep point reached c@1 >= {TARGET_C1}")
    return best


def build(g, device, label, **kw):
    """One build; prints its seconds by phase kind and by phase."""
    t0 = time.perf_counter()
    g.build(k_build=K_BUILD, tau_build=TAU_BUILD, refinement_iterations=2, **kw)
    build_s = time.perf_counter() - t0
    print_build(label, build_s, g._base.shape[0],
                g.last_build_stats["shards"][0]["phases"])
    return build_s


def print_build(label, build_s, n, phases):
    """A build's seconds, by phase kind and by phase."""
    kinds = {}
    for name, sec in phases.items():
        kinds[name.split("[")[0]] = kinds.get(name.split("[")[0], 0.0) + sec
    print(f"{label} build: {build_s:.2f} s for N={n} ({build_s * 1e6 / n:.2f} "
          f"us/point) | by kind "
          f"{json.dumps({k: round(v, 3) for k, v in kinds.items()})}", flush=True)
    print(f"{label} build phases (s): "
          + json.dumps({k: round(v, 3) for k, v in phases.items()}), flush=True)


def ground_truth(g, base, query, measure=DistanceMeasure.Euclidean):
    t0 = time.perf_counter()
    gt_ids, gt_d = g.bf_query(query, k_gt=100)
    bf_s = time.perf_counter() - t0
    if gt_ids.shape != (query.shape[0], 100) or not np.all(np.isfinite(gt_d)):
        raise AssertionError("brute force returned malformed ground truth")
    print(f"brute force ({query.shape[0]} x {base.shape[0]}, k=100): "
          f"{bf_s:.2f} s", flush=True)
    return Evaluator(base, query, gt_ids, k_query=K_QUERY, measure=measure), bf_s


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main_path(device, n=N, nq=NQ):
    """The fused path: build, index, ground truth and the fused sweep.
    Returns a summary with the kernel's launches in the build and in the
    whole path, and what the row phase reuses (graph, data, evaluator)."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    g = GGNN(device=device)
    g.set_base(base)
    zero_launches()
    build_s = build(g, device, "fused-path")
    counts_build = launches_now()
    launches_build = counts_build["adjacency_dot"]
    t0 = time.perf_counter()
    g.build_fused_index(group=1)
    print(f"fused index: {time.perf_counter() - t0:.2f} s", flush=True)
    evaluator, bf_s = ground_truth(g, base, query)
    query_dev = torch.from_numpy(query).to(device)
    best = sweep(g, query_dev, base, query, evaluator, SWEEP, QKW, device,
                 "fused")
    counts_queries = _minus(launches_now(), counts_build)
    launches_total = launches_build + counts_queries["adjacency_dot"]
    _launched(launches_build, "the build", device)
    _launched(counts_queries["adjacency_dot"], "the fused queries", device)
    _dedup_launched(counts_build, "the build", device)
    _dedup_launched(counts_queries, "the fused queries", device)
    _launched(counts_build["approx_topk"], "the build's merges", device,
              "the approximate top-k kernel")
    _launched(counts_queries["approx_topk"], "the fused queries' seeding",
              device, "the approximate top-k kernel")
    _gather_launched(counts_build, "the build's merges", device)
    _gather_launched(counts_queries, "the fused queries' re-rank", device)
    print(f"operating point: {json.dumps(best)} | kernel launches: build "
          f"{json.dumps(counts_build)}, queries {json.dumps(counts_queries)}",
          flush=True)
    print(f"graphs captured by the build: "
          f"{g.last_build_stats['shards'][0]['graphs_captured']}", flush=True)
    identity = graph_vs_eager(device, "fused (group 1)",
                              lambda r: fused_call(g, query_dev, best, r))
    real = kernel_on_real_anchors(device, g, query_dev, best, "group 1")
    approx_real = approx_on_real_inputs(device, g, query_dev, "the fused path")
    profile = profile_call(device, lambda: g.query(
        query_dev, K_QUERY, best["tau"], best["iters"],
        **dict(QKW, pops_per_iter=best["P"])), "fused query",
        tiles=-(-nq // 8192))
    mix = batch_mix(device, g, query_dev, best)
    summary = {"launches": launches_total, "build_s": build_s, "bf_s": bf_s,
               "counts": {"build": counts_build, "queries": counts_queries},
               "real": real, "approx_real": approx_real, "profile": profile,
               "graph_vs_eager": identity,
               "batch_mix": mix,
               "graphs_captured_build":
                   g.last_build_stats["shards"][0]["graphs_captured"], **best}
    return summary, {"g": g, "base": base, "query": query,
                     "query_dev": query_dev, "evaluator": evaluator}


def row_path(device, ctx):
    """The row engine on the fused path's graph and queries."""
    g = ctx["g"]
    graph = g.get_graph()
    shard = g._shards[0]
    row_bytes = _nbytes([*graph.neighbors, *graph.selection, *graph.translation,
                         shard.base_dev])
    fused_bytes = _nbytes(shard.fused_index)
    n = g._base.shape[0]
    print(f"device bytes: row layout (graph + f32 base) {row_bytes} "
          f"({row_bytes / n:.1f} B/point) | fused index {fused_bytes} "
          f"({fused_bytes / n:.1f} B/point; the fused engine also keeps the "
          "base for its re-rank)", flush=True)
    zero_launches()
    best = sweep(g, ctx["query_dev"], ctx["base"], ctx["query"],
                 ctx["evaluator"], ROW_SWEEP, ROW_KW, device, "row",
                 reps=3, warmup=1)
    counts = launches_now()
    _not_launched(counts["adjacency_dot"], "the row queries")
    _dedup_launched(counts, "the row queries", device, compact=True)
    _gather_launched(counts, "the row queries", device)
    print(f"row operating point: {json.dumps(best)} | kernel launches "
          f"{json.dumps(counts)}", flush=True)
    identity = graph_vs_eager(device, "row", lambda r: row_call(
        g, ctx["query_dev"], best, r))
    dedup = dedup_before_after(device, "row query call",
                               lambda: row_call(g, ctx["query_dev"], best))
    gather = gather_before_after(
        device, "row query call", lambda: row_call(g, ctx["query_dev"], best),
        lambda res: ctx["evaluator"].evaluate_results(res[0].cpu().numpy()).c1)
    gather["sweep"] = gather_sweep(g, ctx["query_dev"], ctx["evaluator"],
                                   _swept(ROW_SWEEP, best), ROW_KW, "row")
    return {**best, "row_bytes": row_bytes, "fused_bytes": fused_bytes,
            "graph_vs_eager": identity, "counts": counts, "dedup": dedup,
            "gather": gather}


def _swept(points, best):
    """The (tau, pop budget) points a sweep ran: up to ``best``."""
    return points[:points.index((best["tau"], best["iters"])) + 1]


def _check_rows(ids, dists, label):
    """Rows sorted ascending (empty slots last) with no duplicate id."""
    fin = np.isfinite(dists)
    with np.errstate(invalid="ignore"):
        down = (np.diff(dists, axis=1) < 0) & fin[:, 1:]
    if np.any(fin[:, 1:] & ~fin[:, :-1]) or np.any(down):
        raise AssertionError(f"{label}: rows not sorted")
    for r in range(ids.shape[0]):
        valid = ids[r][ids[r] >= 0]
        if len(np.unique(valid)) != len(valid):
            raise AssertionError(f"{label}: duplicate ids in row {r}")


def kquery_path(device, ctx):
    """k_query at the reference's bound of 6000 on the fused path's graph:
    one fused and one row call for NQ_KQ queries through graphs (the first
    call of each captures, the second is timed), the rows checked, c@1 and
    c@10 of their first 10 columns, the graph pools' bytes. Returns the
    numbers and the kernel's launches in the fused calls."""
    g, query_dev = ctx["g"], ctx["query_dev"][:NQ_KQ]
    gt = ctx["evaluator"].gt[:NQ_KQ]
    evaluator = Evaluator(ctx["base"], ctx["query"][:NQ_KQ], gt, k_query=K_QUERY)
    out = {}
    for label, point, call in (
            ("fused", {"tau": 0.64, "iters": KQ_BUDGET, "P": KQ_FUSED_P},
             lambda p: g.query(query_dev, KQ_MAX, p["tau"], p["iters"],
                               engine="fused", pops_per_iter=p["P"])),
            ("row", {"tau": 0.64, "iters": KQ_BUDGET, "P": ROW_KW["pops_per_iter"]},
             lambda p: g.query(query_dev, KQ_MAX, p["tau"], p["iters"], **ROW_KW))):
        zero_launches()
        captures = graphs.stats()["captures"]
        ms, res = time_ms(lambda: call(point), device, reps=1, warmup=1)
        counts = launches_now()
        launches = counts["adjacency_dot"]
        ids, dists = res.ids, res.dists
        if ids.shape != (NQ_KQ, KQ_MAX):
            raise AssertionError(f"k_query {KQ_MAX} {label}: shape {ids.shape}")
        _check_rows(ids, dists, f"k_query {KQ_MAX} {label}")
        ev = evaluator.evaluate_results(ids[:, :K_QUERY])
        filled = float(np.mean(ids >= 0))
        st = graphs.stats()
        out[label] = {"ms": ms, "c1": ev.c1, "c10": ev.cKQuery, "filled": filled,
                      "launches": launches, "counts": counts,
                      "graphs_captured": st["captures"] - captures,
                      "graph_pool_bytes": graphs.pool_bytes(),
                      "graph_buffer_bytes": st["buffer_bytes"]}
        print(f"k_query {KQ_MAX} {label} (tau 0.64, budget {KQ_BUDGET}, P "
              f"{point['P']}), {NQ_KQ} queries through graphs: {ms:.3f} ms | "
              f"c@1 {ev.c1:.4f} c@10 {ev.cKQuery:.4f} of the first 10 | slots "
              f"filled {filled:.4f} | graphs captured {out[label]['graphs_captured']}"
              f" | pools {out[label]['graph_pool_bytes']} B, static buffers "
              f"{st['buffer_bytes']} B | kernel launches {json.dumps(counts)}",
              flush=True)
    _launched(out["fused"]["launches"], f"the k_query {KQ_MAX} fused call", device)
    _not_launched(out["row"]["launches"], f"the k_query {KQ_MAX} row call")
    _dedup_launched(out["fused"]["counts"], f"the k_query {KQ_MAX} fused call",
                    device)
    _dedup_launched(out["row"]["counts"], f"the k_query {KQ_MAX} row call",
                    device, compact=True)
    return out


def other_build(device, label, n, nq, start, **build_kw):
    """Build ``n`` points with ``build_kw``, then the row sweep from sweep
    point ``start`` on. Returns (kernel launches in the build, by kernel;
    summary with the build's peak device memory; the shard's build
    stats)."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    g = GGNN(device=device)
    g.set_base(base)
    zero_launches()
    peak = peak_memory(device)
    build_s = build(g, device, label, **build_kw)
    build_peak = peak()
    counts = launches_now()
    evaluator, _ = ground_truth(g, base, query)
    query_dev = torch.from_numpy(query).to(device)
    best = sweep(g, query_dev, base, query, evaluator, ROW_SWEEP[start:],
                 ROW_KW, device, f"{label} row", reps=3, warmup=1)
    print(f"{label}: {json.dumps(best)} | kernel launches in the build "
          f"{json.dumps(counts)} | build peak device memory "
          f"{json.dumps(build_peak)}", flush=True)
    best["gather_sweep"] = gather_sweep(
        g, query_dev, evaluator, _swept(ROW_SWEEP[start:], best), ROW_KW,
        f"{label} row")
    approx_real = (approx_on_real_inputs(device, g, query_dev, f"the {label} build")
                   if build_kw.get("dense_seed_merge", True) else None)
    return (counts, {"build_s": build_s, "build_peak": build_peak,
                     "approx_real": approx_real, **best},
            g.last_build_stats["shards"][0])


@contextmanager
def last_layer0_sym(route=None):
    """While inside, builds run their sym passes (on ``route`` if given,
    else on the pass's default) and the input of the last layer-0 pass is
    kept: yields a dict that receives its positional ``args`` and keywords
    ``kw``."""
    recorded = {}
    sym_pass = construction.sym_pass
    on_route = {} if route is None else {"route": route}

    def record(*args, **kw):
        if args[6] == 0:  # the layer
            recorded["args"], recorded["kw"] = args, kw
        return sym_pass(*args, **kw, **on_route)

    construction.sym_pass = record
    try:
        yield recorded
    finally:
        construction.sym_pass = sym_pass


def walk_chunk(device, args, kw, route=graphs.EAGER):
    """The first walk chunk of a layer-0 ``sym_pass(*args, **kw)`` in walk
    mode (as :func:`last_layer0_sym` keeps them: the pass's own chunk size
    and pops per step), against the pass's request buffer as it starts.
    Returns (a call that walks it through ``route``, its pairs, the tensors
    its programs read)."""
    bound = inspect.signature(sym_mod.sym_pass).bind(*args, **kw)
    bound.apply_defaults()
    a = bound.arguments
    base, base_sq, nbrs, cfg = a["base"], a["base_sq"], a["nbrs"], a["cfg"]
    KL, Nl = cfg.KL, cfg.Ns[0]
    need = sym_mod._rows_needing_walk(nbrs, KL=KL)
    rows = torch.nonzero(need.reshape(-1))[:, 0]
    chunk_rows = sym_mod._walk_chunk_rows(rows.shape[0], Nl, KL,
                                          a["chunk_nodes"])
    rows = rows[:chunk_rows]
    nn1_stats, tau, measure = a["nn1_stats"], a["tau_build"], a["measure"]
    sym_buffer = torch.full((Nl, cfg.KF), -1, dtype=torch.int32, device=device)
    sym_atomic = torch.zeros((Nl,), dtype=torch.int32, device=device)
    tau = torch.tensor(tau, dtype=torch.float32, device=device)
    if DistanceMeasure(measure) == DistanceMeasure.Euclidean:  # as sym_pass
        xi = nn1_stats[0] * nn1_stats[0] * tau * tau
    else:
        xi = nn1_stats[0] * tau

    def chunk():
        sym_buffer.fill_(-1)
        sym_atomic.zero_()
        sym_mod._walk_requests(rows, nbrs, None, base, base_sq, xi, sym_buffer,
                               sym_atomic, cfg=cfg, measure=measure,
                               chunk_rows=chunk_rows,
                               pops_per_iter=a["pops_per_iter"], route=route)

    return chunk, rows.shape[0], (nbrs, sym_buffer)


def peak_memory(device):
    """Zero the allocator's peaks; returns a call that gives the device
    bytes allocated and reserved at their peak since, and allocated
    before (None off the card)."""
    if device.type != "cuda":
        return lambda: None
    _sync(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)

    def read():
        _sync(device)
        return {"peak_allocated": torch.cuda.max_memory_allocated(device),
                "peak_reserved": torch.cuda.max_memory_reserved(device),
                "allocated_before": before}

    return read


def sym_routes(device, args, kw, routes):
    """The sym pass on ``args`` once per entry of ``routes``
    (``graphs.EAGER`` or ``graphs.GRAPHS``), each timed on the host clock
    around a synchronise, with its peak device memory. Returns
    [(new_nbrs, stats, seconds, peak memory)]."""
    out = []
    for route in routes:
        peak = peak_memory(device)
        t0 = time.perf_counter()
        new, stats = construction.sym_pass(*args, **kw, route=route)
        _sync(device)
        out.append((new, stats, time.perf_counter() - t0, peak()))
    return out


def descent_path(device, n=N_DESCENT, nq=NQ):
    """Phase 8: the descent + walk build with its row sweep (``other_build``),
    the sym passes' seconds per layer, live-count reads and captures, the
    last layer-0 sym pass again through both routes with their peak device
    memory, and one walk chunk of it under the profiler. Returns (kernel
    launches in the build by kernel, summary with the launches of the
    layer-0 pass's two runs)."""
    with last_layer0_sym() as recorded:
        counts, out, stats = other_build(
            device, "descent+walk", n, nq, 0, dense_seed_merge=False,
            sym_mode="walk")
    passes = stats["sym"]
    sym_s = {k: v for k, v in stats["phases"].items() if k.startswith("sym[")}
    out["sym"] = {
        "seconds_per_layer": sym_s,
        "walk_rows": [p["walk_rows"] for p in passes],
        "live_reads": [p["walk_live_reads"] for p in passes],
        "graphs_captured": sum(p["walk_graphs_captured"] for p in passes),
        "graphs_captured_build": stats["graphs_captured"],
        "pool_bytes_after_build": graphs.pool_bytes(),
    }
    print(f"descent+walk sym passes ({len(passes)}, layers "
          f"{[p['layer'] for p in passes]}): seconds per layer "
          f"{json.dumps({k: round(v, 3) for k, v in sym_s.items()})} | walked "
          f"pairs per pass {out['sym']['walk_rows']} | live-count reads per pass "
          f"{out['sym']['live_reads']} | graphs captured in the sym passes "
          f"{out['sym']['graphs_captured']} (build {stats['graphs_captured']}) "
          f"| pools after the build {out['sym']['pool_bytes_after_build']} B",
          flush=True)

    # the last layer-0 pass again, on its own input, through both routes
    args, kw = recorded["args"], recorded["kw"]
    zero_launches()
    (want, want_st, eager_s, eager_mem), (got, got_st, graph_s, graph_mem) = \
        sym_routes(device, args, kw, (graphs.EAGER, graphs.GRAPHS))
    sym_counts = launches_now()
    _dedup_launched(sym_counts, "the layer-0 sym pass (walk)", device,
                    compact=True)
    _gather_launched(sym_counts, "the layer-0 sym pass (walk)", device)
    rows = int(torch.any(got != want, dim=1).sum())
    keys = [k for k in want_st if not k.startswith("walk_")] + ["walk_rows"]
    same = all(got_st[k] == want_st[k] for k in keys)
    print(f"layer-0 sym pass (walk, {want_st['walk_rows']} pairs walked): graph "
          f"route vs eager route: {rows} of {want.shape[0]} rows differ | "
          f"counters equal: {same} ({json.dumps({k: got_st[k] for k in keys})}) "
          f"| s: graphs {graph_s:.3f}, eager {eager_s:.3f} | live-count reads: "
          f"graphs {got_st['walk_live_reads']}, eager {want_st['walk_live_reads']}"
          f" | graphs captured {got_st['walk_graphs_captured']} | peak device "
          f"memory: graphs {json.dumps(graph_mem)}, eager {json.dumps(eager_mem)}",
          flush=True)
    if rows or not same:
        raise AssertionError("the layer-0 sym pass differs between the graph "
                             f"and the eager route: {rows} rows, counters "
                             f"{got_st} vs {want_st}")
    out["sym"]["layer0_pass"] = {
        "rows_differing": rows, "counters_equal": same, "graph_s": graph_s,
        "eager_s": eager_s, "live_reads_graphs": got_st["walk_live_reads"],
        "live_reads_eager": want_st["walk_live_reads"],
        "graphs_captured": got_st["walk_graphs_captured"],
        "peak_memory_graphs": graph_mem, "peak_memory_eager": eager_mem,
        "launches": sym_counts}
    del want, got

    chunk, pairs, (_, requests) = walk_chunk(device, args, kw)
    out["sym"]["chunk_profile"] = profile_call(
        device, chunk, f"sym walk chunk ({pairs} pairs, per-step loop)")
    with plain_dedup():
        out["sym"]["chunk_profile_plain_dedup"] = profile_call(
            device, chunk, f"sym walk chunk ({pairs} pairs, per-step loop, "
            "plain dedup)")
    # the chunk on each gather route: ms, and the requests it made
    made = []

    def made_requests(_):
        made.append(requests.clone())
        return int((requests >= 0).sum())

    gather = gather_before_after(
        device, f"sym walk chunk ({pairs} pairs, per-step loop)", chunk,
        made_requests)
    gather["request_rows_differing"] = int(torch.any(made[0] != made[1],
                                                     dim=1).sum())
    print(f"sym walk chunk: request rows differing between the gather kernel "
          f"and the plain gather {gather['request_rows_differing']} of "
          f"{requests.shape[0]}", flush=True)
    out["sym"]["chunk_gather"] = gather
    del made
    chunk, _, reads = walk_chunk(device, args, kw, graphs.GRAPHS)
    chunk()
    out["sym"]["chunk_pool_bytes"] = graphs.pool_bytes()
    print(f"sym walk chunk: {pairs} pairs | its program's pool through graphs "
          f"{out['sym']['chunk_pool_bytes']} B", flush=True)
    graphs.drop(*reads)
    return counts, out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def layouts_path(device, ctx):
    """The grouped (2 and 4) and int4 fused layouts on the fused path's graph, each
    swept until c@1 >= 0.90. Returns each layout's operating point, index
    seconds, device bytes per point and kernel launches."""
    g = ctx["g"]
    n = g._base.shape[0]
    out = {}
    for label, kw in (("group2", {"group": 2}), ("group4", {"group": 4}),
                      ("int4", {"bits": 4})):
        t0 = time.perf_counter()
        g.build_fused_index(**kw)
        _sync(device)
        index_s = time.perf_counter() - t0
        index = g._shards[0].fused_index
        if (index.group, index.bits) != (kw.get("group", 1), kw.get("bits", 8)):
            raise AssertionError(f"{label}: the index has group {index.group}, "
                                 f"bits {index.bits}")
        per_point = _nbytes(index) / n
        zero_launches()
        best = sweep(g, ctx["query_dev"], ctx["base"], ctx["query"],
                     ctx["evaluator"], SWEEP, QKW, device, f"fused {label}",
                     reps=3, warmup=1)
        counts = launches_now()
        launches, nibbles = counts["adjacency_dot"], counts["adjacency_dot_nibbles"]
        _launched(launches, f"the {label} fused queries", device)
        _dedup_launched(counts, f"the {label} fused queries", device)
        want = launches if label == "int4" else 0
        if device.type == "cuda" and nibbles != want:
            raise AssertionError(f"{label}: {nibbles} of {launches} launches in "
                                 f"nibbles mode, expected {want}")
        print(f"{label} layout: index {index_s:.2f} s | device bytes "
              f"{per_point:.1f} B/point | operating point {json.dumps(best)} | "
              f"kernel launches {launches} (nibbles {nibbles})", flush=True)
        identity = graph_vs_eager(device, f"fused ({label})", lambda r: fused_call(
            g, ctx["query_dev"], best, r))
        real = kernel_on_real_anchors(device, g, ctx["query_dev"], best, label)
        out[label] = {**best, "index_s": index_s, "bytes_per_point": per_point,
                      "launches": launches, "launches_nibbles": nibbles,
                      "counts": counts, "real": real,
                      "graph_vs_eager": identity}
    return out


def shards_path(device, n=N_SHARDED, n_shard=N_SHARD, nq=NQ):
    """Several shards on one card, out of core: at most MAX_DEVICE_SHARDS on
    the device and a host-RAM cap of about one shard's graph cache, so the
    rotation goes down to the disk tier. Build, fused index, brute force,
    the fused sweep; then the same operating point all resident and after
    store/load must return identical ids."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    work = Path(tempfile.mkdtemp(prefix="ggnn_smoke_shards_"))
    g = GGNN(device=device)
    try:
        g.set_base(base)
        g.set_shard_size(n_shard)
        g.set_max_device_shards(MAX_DEVICE_SHARDS)
        cfg = GraphConfig.create(N=n_shard, D=D, KBuild=K_BUILD)
        # graph + fused meta of one shard, with room to spare: a second
        # shard's cache goes over the cap and spills
        cap = int(1.5 * (cfg.graph_size_bytes() + n_shard * 4 + 4096))
        g.set_cpu_memory_limit(cap)
        zero_launches()
        t0 = time.perf_counter()
        g.build(k_build=K_BUILD, tau_build=TAU_BUILD, refinement_iterations=2)
        build_s = time.perf_counter() - t0
        per_shard = [round(s["build_time_s"], 3) for s in g.last_build_stats["shards"]]
        counts_build = launches_now()
        launches_build = counts_build["adjacency_dot"]
        print(f"sharded build: {build_s:.2f} s for N={n} as {g.num_shards} x "
              f"{n_shard} (per shard {per_shard} s) | host cap {cap} B | "
              f"kernel launches {launches_build}", flush=True)
        t0 = time.perf_counter()
        g.build_fused_index()
        index_s = time.perf_counter() - t0
        print(f"sharded fused index: {index_s:.2f} s", flush=True)
        evaluator, bf_s = ground_truth(g, base, query)
        query_dev = torch.from_numpy(query).to(device)
        zero_launches()
        before = dict(g.tier_stats)
        t0 = time.perf_counter()
        best = sweep(g, query_dev, base, query, evaluator, SWEEP, QKW, device,
                     "sharded fused", reps=3, warmup=1)
        sweep_s = time.perf_counter() - t0
        counts_query = launches_now()
        launches_query = counts_query["adjacency_dot"]
        _launched(launches_build, "the sharded build", device)
        _launched(launches_query, "the sharded fused queries", device)
        _dedup_launched(counts_build, "the sharded build", device)
        _dedup_launched(counts_query, "the sharded fused queries", device)
        stats = dict(g.tier_stats)
        in_sweep = {k: stats[k] - before[k] for k in stats}
        print(f"tier moves: whole run {json.dumps(stats)} | in the sweep "
              f"{json.dumps(in_sweep)} | stage-ins {in_sweep['stage_ins_s']:.3f} s "
              f"of the sweep's {sweep_s:.3f} s on the host clock", flush=True)
        if stats["spills"] <= 0 or stats["stage_ins"] <= 0 or stats["unspills"] <= 0:
            raise AssertionError(f"the rotation never reached the disk tier: {stats}")

        kw = dict(QKW, pops_per_iter=best["P"])
        args = (K_QUERY, best["tau"], best["iters"])
        # the rotated call through both routes; the graph route's programs
        # are keyed on the device buffers the shards rotate through
        routes, ids = {}, {}
        for route in ("graphs", "eager"):
            captured = graphs.stats()["captures"]
            stage_ins = g.tier_stats["stage_ins"]
            with eager_walks() if route == "eager" else nullcontext():
                ms, res = time_ms(lambda: g.query(query_dev, *args, **kw), device,
                                  reps=3, warmup=1)
            ids[route] = res.ids
            routes[route] = {
                "ms": ms, "captures_per_call": (graphs.stats()["captures"]
                                                - captured) / 4,
                "stage_ins_per_call": (g.tier_stats["stage_ins"] - stage_ins) / 4}
        if not np.array_equal(ids["graphs"], ids["eager"]):
            raise AssertionError("rotated: the graph route's ids differ from the "
                                 "eager route's")
        print(f"sharded rotated call at the operating point ({nq} queries, 4 "
              f"shards through 2 sets of buffers): graphs {routes['graphs']['ms']:.3f} ms "
              f"({routes['graphs']['captures_per_call']:.2f} captures and "
              f"{routes['graphs']['stage_ins_per_call']:.1f} stage-ins per call), "
              f"eager {routes['eager']['ms']:.3f} ms; ids identical", flush=True)
        rotated = ids["graphs"]
        g.set_max_device_shards(g.num_shards)
        resident = g.query(query_dev, *args, **kw).ids
        if not np.array_equal(rotated, resident):
            raise AssertionError("all-resident ids differ from the rotated run's: "
                                 f"{np.mean(np.any(rotated != resident, 1))} of rows")
        print(f"sharded: rotated and all-resident ids identical through graphs "
              f"(a shard staged in is copied into the buffers an evicted one left) "
              f"| graphs {graphs.stats()}", flush=True)
        approx_real = approx_on_real_inputs(device, g, query_dev,
                                            "the sharded path")
        g.set_working_directory(work / "graph")
        t0 = time.perf_counter()
        g.store()
        store_s = time.perf_counter() - t0
    finally:
        g.close()
    try:
        g2 = GGNN(device=device)
        g2.set_base(base)
        g2.set_shard_size(n_shard)
        g2.set_working_directory(work / "graph")
        t0 = time.perf_counter()
        g2.load(K_BUILD)
        g2.build_fused_index()
        _sync(device)
        load_s = time.perf_counter() - t0
        reused = g2.tier_stats["sidecar_reuses"]
        if reused != g2.num_shards:
            raise AssertionError(f"{reused} of {g2.num_shards} sidecars reused")
        loaded = g2.query(query_dev, *args, **kw).ids
        if not np.array_equal(loaded, rotated):
            raise AssertionError("ids after store/load differ from the rotated run's")
        g2.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"sharded: ids identical rotated / all resident / after store+load; "
          f"store {store_s:.2f} s, load + index from {reused} sidecars "
          f"{load_s:.2f} s", flush=True)
    return {**best, "build_s": build_s, "build_s_per_shard": per_shard,
            "index_s": index_s, "bf_s": bf_s, "store_s": store_s,
            "load_s": load_s, "tier_stats": stats, "tier_stats_sweep": in_sweep,
            "sweep_s": sweep_s, "rotated_routes": routes,
            "launches_build": launches_build, "launches_query": launches_query,
            "counts": {"build": counts_build, "queries": counts_query},
            "approx_real": approx_real}


def devices_path(device, n=N_DEVICES, nq=NQ):
    """Two shards on two slots of one device: build with a worker per slot,
    fused index, brute force and the fused sweep through the device merge;
    at the operating point the host merge (native) and ``query_async`` must
    return the same ids. Returns the build, merge and sweep numbers and the
    kernel launches in the build and in the queries."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    g = GGNN(device=device)
    g.set_devices([device] * SLOTS)
    g.set_base(base)
    zero_launches()
    t0 = time.perf_counter()
    g.build(k_build=K_BUILD, tau_build=TAU_BUILD, refinement_iterations=2)
    build_s = time.perf_counter() - t0
    stats = g.last_build_stats
    counts_build = launches_now()
    launches_build = counts_build["adjacency_dot"]
    per_shard = [s["build_time_s"] for s in stats["shards"]]
    print(f"devices build: {g.num_shards} x {n // g.num_shards} on slots "
          f"{[str(d) for d in g.devices]} | workers {stats['num_build_workers']} "
          f"| wall {stats['wall_time_s']:.3f} s, sum of shards "
          f"{stats['sum_time_s']:.3f} s (per shard {per_shard}) | kernel "
          f"launches {launches_build}", flush=True)
    if stats["num_build_workers"] != SLOTS or g.num_shards != SLOTS:
        raise AssertionError(f"{stats['num_build_workers']} build workers for "
                             f"{g.num_shards} shards on {SLOTS} slots")
    captured = [s["graphs_captured"] for s in stats["shards"]]
    print(f"devices build: graphs captured by the two workers on one card "
          f"{captured}", flush=True)
    if device.type == "cuda" and min(captured) <= 0:
        raise AssertionError("a build worker captured no graph")
    t0 = time.perf_counter()
    g.build_fused_index(group=1, bits=8)
    _sync(device)
    index_s = time.perf_counter() - t0
    evaluator, bf_s = ground_truth(g, base, query)
    if g.last_merge_route != "devices":
        raise AssertionError(f"brute force merged on the {g.last_merge_route}")
    g.set_device_merge(False)
    gt_host, _ = g.bf_query(query, k_gt=100)
    g.set_device_merge(True)
    if g.last_merge_route != "host" or not np.array_equal(gt_host, evaluator.gt):
        raise AssertionError("brute force: the host merge's ground truth differs "
                             "from the device merge's")
    print(f"devices fused index {index_s:.2f} s | ground truth identical "
          "through the device and the host merge", flush=True)
    query_dev = torch.from_numpy(query).to(device)
    zero_launches()
    best = sweep(g, query_dev, base, query, evaluator, SWEEP, QKW, device,
                 "devices fused", reps=3, warmup=1)
    if g.last_merge_route != "devices":
        raise AssertionError(f"the sweep merged on the {g.last_merge_route}")

    kw = dict(QKW, pops_per_iter=best["P"])
    args = (K_QUERY, best["tau"], best["iters"])
    on_device = g.query(query_dev, *args, **kw).ids
    if not native_merge.available():
        raise AssertionError("the native merger is not built")
    g.set_device_merge(False)
    on_host = g.query(query_dev, *args, **kw).ids
    if g.last_merge_route != "host" or not np.array_equal(on_host, on_device):
        raise AssertionError("host-merge ids differ from the device merge's: "
                             f"{np.mean(np.any(on_host != on_device, 1))} of rows")
    host_ms, _ = time_ms(lambda: g.query(query_dev, *args, **kw), device,
                         reps=3, warmup=1)
    async_host = g.query_async(query_dev, *args, **kw).result().ids
    g.set_device_merge(True)
    async_dev = g.query_async(query_dev, *args, **kw).result().ids
    if not (np.array_equal(async_host, on_device)
            and np.array_equal(async_dev, on_device)):
        raise AssertionError("query_async ids differ from query's")
    counts_query = launches_now()
    launches_query = counts_query["adjacency_dot"]
    _launched(launches_build, "the two-slot build", device)
    _launched(launches_query, "the two-slot queries", device)
    _dedup_launched(counts_build, "the two-slot build", device)
    _dedup_launched(counts_query, "the two-slot queries", device)
    # the merges alone, on one call's partials (global ids, one per shard)
    g.set_device_merge(False)
    partials = g._query_partials(query_dev, *args, None, "fused",
                                 {k: v for k, v in kw.items() if k != "engine"})
    g.set_device_merge(True)
    device_merge_ms, _ = time_ms(lambda: merge_over_devices(partials, K_QUERY),
                                 device)
    host_merge_ms, _ = time_ms(lambda: g._merge_on_host(partials, K_QUERY),
                               torch.device("cpu"))
    print(f"devices: host merge ids identical (native merger "
          f"{native_merge.available()}), query_async identical on both routes | "
          f"per call of {nq} queries: device merge {device_merge_ms:.4f} ms, "
          f"host merge {host_merge_ms:.4f} ms (partials to the host included) | "
          f"whole query through the host merge {host_ms:.3f} ms "
          f"({nq / (host_ms * 1e-3):.1f} QPS) | kernel launches: build "
          f"{launches_build}, queries {launches_query}", flush=True)
    approx_real = approx_on_real_inputs(device, g, query_dev, "the two-slot path")
    g.close()
    return {**best, "build_s": build_s, "build_wall_s": stats["wall_time_s"],
            "build_sum_s": stats["sum_time_s"], "build_s_per_shard": per_shard,
            "num_build_workers": stats["num_build_workers"], "index_s": index_s,
            "bf_s": bf_s, "device_merge_ms": device_merge_ms,
            "host_merge_ms": host_merge_ms, "host_route_ms": host_ms,
            "launches_build": launches_build, "launches_query": launches_query,
            "counts": {"build": counts_build, "queries": counts_query},
            "graphs_captured_build": captured, "approx_real": approx_real}


def cli_path(device, n=N_CLI, nq=NQ_CLI, n_shard=CLI_SHARD):
    """``python -m ggnn_torch.benchmark`` twice on fvecs files (read by the
    native reader): the first run builds and stores the parts with their
    group-2 sidecars, the second loads them and reuses the sidecars.
    Returns each run's seconds."""
    if not native_io.available():
        raise AssertionError("the native TEXMEX reader is not built")
    print(f"native reader: {native_build.library_path()}", flush=True)
    repo = Path(__file__).resolve().parent
    base, query = make_dataset(n, nq, d=D, seed=1)
    work = Path(tempfile.mkdtemp(prefix="ggnn_smoke_cli_"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(repo), env.get("PYTHONPATH", "")) if p)
    out = {}
    try:
        store_fvecs(work / "base.fvecs", base)
        store_fvecs(work / "query.fvecs", query)
        argv = [sys.executable, "-m", "ggnn_torch.benchmark",
                "--base", str(work / "base.fvecs"),
                "--query", str(work / "query.fvecs"),
                "--gt", str(work / "gt.ivecs"),
                "--graph_dir", str(work / "graph"),
                "--shard_size", str(n_shard), "--fused_group", "2",
                "--device", device.type]
        for run, marker in (("build", "build:"), ("load", "loading graph from")):
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=repo, env=env, capture_output=True,
                                  text=True, timeout=600)
            out[run] = time.perf_counter() - t0
            lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
            print(f"CLI {run} run: exit {proc.returncode}, {out[run]:.2f} s",
                  flush=True)
            for ln in lines:
                print(f"  {ln}", flush=True)
            if proc.returncode:
                raise AssertionError(f"CLI {run} run failed:\n{proc.stderr[-4000:]}")
            c1 = [ln for ln in lines if ln.lstrip().startswith("c@1 ")]
            if len(c1) != 4 or marker not in proc.stderr:
                raise AssertionError(f"CLI {run} run: unexpected output\n"
                                     f"{proc.stderr[-4000:]}")
        if f"fused index: {n // n_shard} of {n // n_shard} shards from their " \
                "sidecars" not in proc.stderr:
            raise AssertionError("the CLI's load run did not reuse its sidecars")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def measures_path(device, n=N_MEASURES, nq=NQ):
    """The other distance and the other dtype: a cosine build of ``n``
    points of ``make_dataset(seed=0)`` swept on the fused engine, and the
    same generator rounded into a uint8 base (``UCharDataset``, uint8
    queries) swept on the fused and the row engine, each until c@1 >= 0.90
    and held graph against eager at each operating point. Returns each
    case's build seconds, points, identity checks and kernel launches."""
    base, query = make_dataset(n, nq, d=D, seed=0)
    cos, euc = DistanceMeasure.Cosine, DistanceMeasure.Euclidean
    cases = (("cosine", base, query, cos),
             ("uint8", UCharDataset(np.rint(base)), UCharDataset(np.rint(query)),
              euc))
    out = {}
    for label, b, q, measure in cases:
        b, q = np.asarray(b), np.asarray(q)
        g = GGNN(device=device)
        g.set_base(b)
        zero_launches()
        build_s = build(g, device, label, measure=measure)
        counts_build = launches_now()
        launches_build = counts_build["adjacency_dot"]
        g.build_fused_index()
        evaluator, _ = ground_truth(g, b, q, measure)
        query_dev = torch.from_numpy(q).to(device)
        zero_launches()
        res = {"build_s": build_s, "launches_build": launches_build,
               "graphs_captured_build":
                   g.last_build_stats["shards"][0]["graphs_captured"]}
        best = sweep(g, query_dev, b, q, evaluator, SWEEP, QKW, device,
                     f"{label} fused", reps=3, warmup=1, measure=measure)
        res["fused"] = {**best, "graph_vs_eager": graph_vs_eager(
            device, f"{label} fused", lambda r: fused_call(g, query_dev, best, r))}
        counts_queries = launches_now()
        res["launches_queries"] = counts_queries["adjacency_dot"]
        res["counts"] = {"build": counts_build, "fused_queries": counts_queries}
        if label == "uint8":
            zero_launches()
            best = sweep(g, query_dev, b, q, evaluator, ROW_SWEEP, ROW_KW, device,
                         f"{label} row", reps=3, warmup=1, measure=measure)
            res["counts"]["row_queries"] = counts = launches_now()
            _not_launched(counts["adjacency_dot"], f"the {label} row queries")
            _dedup_launched(counts, f"the {label} row queries", device,
                            compact=True)
        else:
            best = {"tau": 0.5, "iters": 64, "P": ROW_KW["pops_per_iter"]}
        res["row"] = {**best, "graph_vs_eager": graph_vs_eager(
            device, f"{label} row", lambda r: row_call(g, query_dev, best, r))}
        _launched(launches_build, f"the {label} build", device)
        _launched(res["launches_queries"], f"the {label} fused queries", device)
        _dedup_launched(counts_build, f"the {label} build", device)
        _dedup_launched(counts_queries, f"the {label} fused queries", device)
        res["approx_real"] = approx_on_real_inputs(device, g, query_dev,
                                                   f"the {label} path", measure)
        print(f"{label}: {json.dumps(res)}", flush=True)
        g.close()
        out[label] = res
    return out


def entry_path(device):
    """The entry points: the tile at its own shape on both routes and
    against the CPU, at full width on both routes, and the dry run over 8
    slots of ``device``. Returns each part's numbers and kernel launches."""
    fn, args = entry(device)
    zero_launches()
    own = graph_vs_eager(device, "entry (2,048 points, 256 queries)",
                         lambda r: fn(*args, route=r), reps=10)
    ids, dists = (t.cpu().numpy() for t in fn(*args))
    counts_own = launches_now()
    fn_cpu, args_cpu = entry("cpu")
    ids_cpu, dists_cpu = (t.numpy() for t in fn_cpu(*args_cpu))
    differ = np.any(ids != ids_cpu, axis=1)
    same = ~differ
    err = float(np.max(np.abs(dists[same] - dists_cpu[same]), initial=0.0))
    own.update(rows_vs_cpu=int(differ.sum()), max_abs_err_vs_cpu=err)
    print(f"entry: card vs CPU (plain kernels): {own['rows_vs_cpu']} of "
          f"{len(ids)} rows differ in ids | equal-id rows' dists max abs err "
          f"{err:.3e} | kernel launches {json.dumps(counts_own)}", flush=True)
    if differ.sum() > ENTRY_CPU_ROWS * len(ids):
        raise AssertionError(f"entry: {int(differ.sum())} rows differ from the "
                             "CPU run")
    if not np.allclose(dists[same], dists_cpu[same], rtol=1e-5, atol=0):
        raise AssertionError("entry: equal-id rows' dists differ from the CPU "
                             "run beyond rtol 1e-5")

    t0 = time.perf_counter()
    fn, args = entry(device, **ENTRY_FULL)
    _sync(device)
    inputs_s = time.perf_counter() - t0
    zero_launches()
    full = graph_vs_eager(device, f"entry at full width ({json.dumps(ENTRY_FULL)})",
                          lambda r: fn(*args, route=r))
    counts_full = launches_now()
    full["inputs_s"] = inputs_s
    print(f"entry at full width: inputs drawn and on the card in {inputs_s:.2f} "
          f"s | kernel launches {json.dumps(counts_full)}", flush=True)
    del fn, args

    zero_launches()
    dry = dryrun_multichip(8, device=device)
    counts_dry = launches_now()
    dry = {k: dry[k] for k in ("seconds", "workers", "route", "slots")}
    print(f"dryrun_multichip(8): {dry['seconds']:.2f} s | slots {dry['slots']} | "
          f"build workers {dry['workers']} | merge route {dry['route']} | kernel "
          f"launches {json.dumps(counts_dry)}", flush=True)
    counts = {"entry": counts_own, "entry_full": counts_full, "dryrun": counts_dry}
    for part, c in counts.items():
        _launched(c["adjacency_dot"], f"the {part} path", device)
        _dedup_launched(c, f"the {part} path", device)
    return {"entry": own, "entry_full": full, "dryrun": dry, "counts": counts}


def headline_path(device, n=N_HEADLINE, nq=NQ_HEADLINE):
    """The port's headline benchmark (``bench_torch.run``) at ``n`` points
    resident and ``nq`` queries, one build and no cache. Prints its result
    line and what it saw; the result must hold an operating point at c@1 >=
    0.90, the kernel must launch in the build and in the queries, and the
    ground truth's distances on 16 sampled rows must be the exact ones.
    Returns (the result, its stats without the data)."""
    stats = {}
    zero_launches()
    result = bench_torch.run(n=n, nq=nq, k_build=K_BUILD, group=1, device=device,
                             cache=None, warm_build=False, curve=False,
                             stats=stats)
    counts = launches_now()
    launches = counts["adjacency_dot"]
    print(f"headline: {json.dumps(result)}", flush=True)
    base, query = stats.pop("base"), stats.pop("query")
    gt_ids, gt_dists = stats.pop("gt_ids"), stats.pop("gt_dists")
    if gt_ids.shape != (nq, 100) or not np.all(np.isfinite(gt_dists)):
        raise AssertionError("headline: malformed ground truth")
    sample = np.random.default_rng(0).choice(nq, 16, replace=False)
    _check_exact(gt_ids, gt_dists, base, query, rows=sample)
    print_build("headline", stats["build_or_load_s"], n, stats["build_phases"])
    peaks = stats.get("peak_memory", {})
    peak = {k: max((p[k] for p in peaks.values()), default=None)
            for k in ("allocated", "reserved")}
    print(f"headline ({n} points, {nq} queries): fused index "
          f"{stats['index_s']:.2f} s | brute force "
          f"{stats['bf_s']:.2f} s | sweep {stats['sweep_s']:.2f} s | device bytes "
          f"per point: index {stats['index_bytes_per_point']:.1f}, base "
          f"{stats['base_bytes_per_point']} | peak device memory by stage "
          f"{json.dumps(peaks)}, over the run {json.dumps(peak)} | kernel "
          f"launches: build {stats['launches_build']}, queries "
          f"{stats['launches_queries']} | dedup kernel launches: build "
          f"{stats['dedup_launches_build']}, queries "
          f"{stats['dedup_launches_queries']}", flush=True)
    for p in stats["points"]:
        print(f"headline query tau={p['tau']} iters={p['iters']} P={p['P']}: "
              f"c@1={p['c1']:.4f} c@10={p['c10']:.4f} qps={p['qps']:.1f}",
              flush=True)
    g = stats.pop("ggnn")
    try:
        if result["value"] <= 0:
            raise AssertionError(f"headline: no sweep point reached c@1 >= {TARGET_C1}")
        _launched(stats["launches_build"], "the headline build", device)
        _launched(stats["launches_queries"], "the headline queries", device)
        _launched(stats["dedup_launches_build"], "the headline build", device,
                  "the dedup kernel")
        _launched(stats["dedup_launches_queries"], "the headline queries",
                  device, "the dedup kernel")
        _launched(stats["approx_launches_build"], "the headline build", device,
                  "the approximate top-k kernel")
        _launched(stats["approx_launches_queries"], "the headline queries",
                  device, "the approximate top-k kernel")
        _launched(stats["gather_launches_build"], "the headline build",
                  device, "the gather + distance kernel")
        _launched(stats["gather_launches_queries"], "the headline queries' "
                  "re-rank", device, "the gather + distance kernel")
        dedup = counts["beam_dedup"] + counts["beam_dedup_compact"]
        if (stats["launches_build"] + stats["launches_queries"] != launches
                or stats["dedup_launches_build"]
                + stats["dedup_launches_queries"] != dedup
                or stats["approx_launches_build"]
                + stats["approx_launches_queries"] != counts["approx_topk"]
                or stats["gather_launches_build"]
                + stats["gather_launches_queries"] != counts["gather_dist"]):
            raise AssertionError("headline: kernel launches outside the build and "
                                 "the queries")
        stats["digest"] = graph_digest(g)
        print(f"headline graph digest (SHA-256 of the neighbour lists): "
              f"{stats['digest']}", flush=True)
        # every swept point again with exact and approximate seeds in turns
        # (bench_torch's timing), then the operating point under the profiler
        # with each, and the kernel on its real anchors (launches made after
        # the path's counts were read)
        query_dev = torch.from_numpy(query).to(device)
        stats["seeds"] = seeds_sweep(g, query_dev, nq, stats["points"],
                                     Evaluator(base, query, gt_ids,
                                               k_query=K_QUERY))
        d = result["detail"]
        point = {"tau": d["tau_query"], "iters": d["max_iterations"],
                 "P": d["pops_per_iter"]}
        for approx in (True, False):
            key = "profile" if approx else "profile_exact_seeds"
            stats[key] = profile_call(device, lambda: g.query(
                query_dev, K_QUERY, point["tau"], point["iters"],
                **dict(QKW, pops_per_iter=point["P"], seed_approx=approx)),
                f"headline fused query (seed_approx={approx})",
                tiles=-(-nq // 8192))
        stats["real"] = kernel_on_real_anchors(device, g, query_dev, point,
                                               "headline")
        stats["approx_real"] = approx_on_real_inputs(device, g, query_dev,
                                                     "the headline")
    finally:
        g.close()
    return result, dict(stats, peak_memory_run=peak, counts=counts)


def seeds_sweep(g, query_dev, nq, points, evaluator):
    """Each swept point with ``seed_approx=False``, then ``True``, then
    ``True`` with the re-rank on the plain gather (:func:`plain_gather`),
    timed as ``bench_torch`` times a point. Whether c@1 with approximate
    seeds comes within 0.003 of exact seeds' is printed, not enforced (a
    miss is a finding); the plain gather's c@1 must come within 0.003 of
    the kernel's (the re-rank's sums in another order may swap near ties,
    nothing more). Returns [{point, exact: {qps, c1, c10}, approx: {...},
    approx_plain_gather: {...}}]."""
    out = []
    for p in points:
        row = {"tau": p["tau"], "iters": p["iters"], "P": p["P"]}
        for key, approx, ctx in (("exact", False, nullcontext),
                                 ("approx", True, nullcontext),
                                 ("approx_plain_gather", True, plain_gather)):
            got = []
            with ctx():
                bench_torch._run_config(
                    g, evaluator, query_dev, nq, K_QUERY, p["tau"], p["iters"],
                    dict(QKW, seed_approx=approx), None, pops_per_iter=p["P"],
                    points=got)
            row[key] = {k: got[0][k] for k in ("qps", "c1", "c10")}
        row["c1_within_0.003"] = abs(row["approx"]["c1"]
                                     - row["exact"]["c1"]) <= 0.003
        gap = abs(row["approx"]["c1"] - row["approx_plain_gather"]["c1"])
        print(f"headline seeds tau={p['tau']} iters={p['iters']} P={p['P']}: "
              f"exact c@1={row['exact']['c1']:.4f} qps={row['exact']['qps']:.1f}"
              f" | approximate c@1={row['approx']['c1']:.4f} qps="
              f"{row['approx']['qps']:.1f} | c@1 within 0.003: "
              f"{row['c1_within_0.003']} | plain gather re-rank c@1="
              f"{row['approx_plain_gather']['c1']:.4f} qps="
              f"{row['approx_plain_gather']['qps']:.1f}", flush=True)
        if gap > 0.003:
            raise AssertionError(f"headline at {row}: c@1 with the gather kernel "
                                 "is not within 0.003 of the plain gather's")
        out.append(row)
    return out


def released_check(device, allocated):
    """After the fused path's GGNN went out of scope (no ``close``): no
    walk program is left, its graphs' pools are gone, and the device memory
    allocated is back near what it was before the path (the cuBLAS
    workspaces of the walks' streams stay). Prints the numbers."""
    graphs.synchronize(device)
    torch.cuda.empty_cache()
    st = graphs.stats()
    pools = graphs.pool_bytes()
    now = torch.cuda.memory_allocated(device)
    print(f"fused path's GGNN dropped: allocated {now} B (before the path "
          f"{allocated} B) | programs left {st['programs']}, pools {pools} B",
          flush=True)
    if st["programs"] or pools:
        raise AssertionError("the dropped GGNN's walk programs are still cached")
    if now - allocated > 256 << 20:
        raise AssertionError(f"{now - allocated} B still allocated after the "
                             "fused path's GGNN was dropped")
    return {"allocated_before": allocated, "allocated_after": now}


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return time.perf_counter()


def run(device):
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = _phase("device", t0)

    # the kernels' sources compile at once, one nvcc each
    with ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(m.build_kernel)
                  for m in (adjacency, beam, approx_topk, gather_dist)]
        build_s = [f.result() for f in builds]
    print(f"kernel build: {build_s[0]:.2f} s | library {adjacency.library_path()}"
          f" | dedup kernel build {build_s[1]:.2f} s | library "
          f"{beam.library_path()} | approx top-k kernel build {build_s[2]:.2f} s "
          f"| library {approx_topk.library_path()} | gather + distance kernel "
          f"build {build_s[3]:.2f} s | library {gather_dist.library_path()}",
          flush=True)
    # registers, shared and local (spill) bytes per kernel, and the I2F
    # count of its SASS, from the toolkit's cuobjdump
    resources = {}
    for label, m in (("adjacency_dot", adjacency), ("beam_dedup", beam),
                     ("approx_topk", approx_topk), ("gather_dist", gather_dist),
                     ("beam_sort", beam_sort), ("beam_pop", None)):
        res = (beam.pop_kernel_resources() if m is None
               else m.kernel_resources())
        resources[label] = "not available" if res is None else {
            k: {f: r[f] for f in ("REG", "SHARED", "LOCAL", "STACK", "I2F")
                if f in r} for k, r in res.items()}
    i2f = ("not available" if resources["adjacency_dot"] == "not available"
           else sum(r.get("I2F", 0) for r in resources["adjacency_dot"].values()))
    print(f"kernel resources (cuobjdump -res-usage; LOCAL holds spills): "
          f"{json.dumps(resources)} | I2F instructions in the adjacency "
          f"kernels' SASS (cuobjdump -sass): {i2f}", flush=True)
    t0 = _phase("kernel build", t0)
    u8 = check_kernel(device, False, 48)
    int4 = check_kernel(device, True, 24)
    group2 = check_kernel(device, False, 96, Nb=N // 2)
    torch.cuda.empty_cache()
    t0 = _phase("kernel vs plain", t0)
    dedup = check_dedup(device)
    t0 = _phase("dedup kernel vs plain", t0)
    approx = check_approx(device)
    t0 = _phase("approx top-k kernel vs plain", t0)
    gather = check_gather(device)
    t0 = _phase("gather + distance kernel vs plain", t0)
    sorts = check_beam_sort(device)
    t0 = _phase("beam sort kernel vs torch.sort route", t0)
    pops = check_beam_pop(device)
    t0 = _phase("beam pop kernel vs plain", t0)

    allocated = torch.cuda.memory_allocated(device)
    summary, ctx = main_path(device)
    t0 = _phase("fused path (build, index, ground truth, sweep)", t0)
    row = row_path(device, ctx)
    t0 = _phase("row engine sweep", t0)
    kquery = kquery_path(device, ctx)
    t0 = _phase(f"k_query {KQ_MAX} (fused + row)", t0)
    layouts = layouts_path(device, ctx)
    del ctx
    released = released_check(device, allocated)
    t0 = _phase("group-2, group-4 and int4 layouts + fused sweeps", t0)
    start = ROW_SWEEP.index((row["tau"], row["iters"]))
    f32_counts, f32, _ = other_build(device, "f32-fetch", N, NQ, start,
                                     quantized_fetch=False)
    _not_launched(f32_counts["adjacency_dot"], "the f32-fetch build")
    _dedup_launched(f32_counts, "the f32-fetch build", device, compact=True)
    _gather_launched(f32_counts, "the f32-fetch build", device)
    _launched(f32_counts["beam_sort"], "the f32-fetch build", device,
              "the sort kernel")
    torch.cuda.empty_cache()
    t0 = _phase("f32-fetch build + row sweep", t0)
    descent_counts, descent = descent_path(device)
    _launched(descent_counts["adjacency_dot"], "the descent build's quantized "
              "legs", device)
    _dedup_launched(descent_counts, "the descent build's merges", device)
    _dedup_launched(descent_counts, "the descent build's sym walks", device,
                    compact=True)
    _gather_launched(descent_counts, "the descent build", device)
    _launched(descent_counts["beam_sort"], "the descent build", device,
              "the sort kernel")
    torch.cuda.empty_cache()
    t0 = _phase("descent build + row sweep", t0)
    sharded = shards_path(device)
    torch.cuda.empty_cache()
    t0 = _phase("shards out of core (build, index, ground truth, sweep, "
                "store/load)", t0)
    devices = devices_path(device)
    torch.cuda.empty_cache()
    t0 = _phase("several devices (two slots: build, index, ground truth, "
                "sweep, host merge, async)", t0)
    cli = cli_path(device)
    t0 = _phase("benchmark CLI (build + store, load)", t0)
    measures = measures_path(device)
    torch.cuda.empty_cache()
    t0 = _phase("cosine build and uint8 base (builds, sweeps, graph vs eager)", t0)
    entries = entry_path(device)
    torch.cuda.empty_cache()
    t0 = _phase("entry points (the tile at its own shape and at full width, "
                "dryrun_multichip(8))", t0)
    headline, headline_stats = headline_path(device)
    torch.cuda.empty_cache()
    t0 = _phase(f"headline (bench_torch.run: {N_HEADLINE} points, {NQ_HEADLINE} "
                "queries)", t0)
    print("summary: " + json.dumps({
        "fused": {k: summary[k] for k in ("tau", "iters", "P", "qps", "c1",
                                          "c10", "build_s", "profile")},
        "fused_graph_vs_eager": summary["graph_vs_eager"],
        "batch_mix": summary["batch_mix"], "released": released,
        "graphs_captured_build": summary["graphs_captured_build"],
        "row": row, "kquery": kquery, "measures": measures,
        "layouts": {k: {f: v for f, v in r.items() if f != "real"}
                    for k, r in layouts.items()}, "f32_fetch_build": f32,
        "descent_walk_build": descent, "sharded": sharded, "devices": devices,
        "cli_s": cli,
        "entry_points": {k: v for k, v in entries.items() if k != "counts"},
        "headline": {"result": headline, **{
            k: v for k, v in headline_stats.items() if k != "real"}},
    }), flush=True)

    # every kernel's launches per path (each path's counts set to 0 just
    # before it and read just after; the headline's over its build and
    # queries)
    paths = {
        "fused_build": summary["counts"]["build"],
        "fused_queries": summary["counts"]["queries"],
        "row_queries": row["counts"],
        "kquery_fused": kquery["fused"]["counts"],
        "kquery_row": kquery["row"]["counts"],
        **{f"{k}_queries": layouts[k]["counts"] for k in ("group2", "group4", "int4")},
        "f32_fetch_build": f32_counts,
        "descent_build": descent_counts,
        "descent_layer0_sym_pass": descent["sym"]["layer0_pass"]["launches"],
        "sharded_build": sharded["counts"]["build"],
        "sharded_queries": sharded["counts"]["queries"],
        "devices_build": devices["counts"]["build"],
        "devices_queries": devices["counts"]["queries"],
        "cosine_build": measures["cosine"]["counts"]["build"],
        "cosine_queries": measures["cosine"]["counts"]["fused_queries"],
        "uint8_build": measures["uint8"]["counts"]["build"],
        "uint8_queries": measures["uint8"]["counts"]["fused_queries"],
        "uint8_row_queries": measures["uint8"]["counts"]["row_queries"],
        **entries["counts"],
        "headline": headline_stats["counts"],
    }

    def per_path(kernel):
        return {p: c[kernel] for p, c in paths.items()}

    def numbers(r, extra=()):
        return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "bound_share", "bytes", *extra)}

    adj_paths = dict(per_path("adjacency_dot"),
                     int4_queries_nibbles=layouts["int4"]["launches_nibbles"],
                     headline_build=headline_stats["launches_build"],
                     headline_queries=headline_stats["launches_queries"])
    kernels = [{
        "name": "adjacency_dot",
        "route": "cuda",
        "source": "ggnn_torch/csrc/adjacency_dot.cu",
        "replaces": "ggnn_tpu/ops/adjacency_pallas.py:156",
        "launches": sum(per_path("adjacency_dot").values()),
        **numbers(u8),
        # no single PyTorch call computes the gather + per-row dot
        "library_ms": None,
        "int4": numbers(int4),
        "group2": numbers(group2),
        "real_anchors": {"group1": numbers(summary["real"]),
                         "group2": numbers(layouts["group2"]["real"]),
                         "group4": numbers(layouts["group4"]["real"]),
                         "int4": numbers(layouts["int4"]["real"]),
                         "headline": numbers(headline_stats["real"])},
        "launches_per_path": adj_paths,
        "resources": resources["adjacency_dot"],
        "i2f": i2f,
    }]
    # the dedup's two entry points, each at its callers' step shapes; the
    # top-level numbers at the shape of the build merges' steps (the
    # headline's) and of the row query's step. No single PyTorch call
    # computes them: ``torch.isin`` tests against one flat set, not a set
    # per row, and nothing drops a row's repeats in place
    extra = ("host_ms", "rows_per_block", "shared_bytes", "differing")
    for name, main_shape, compact in (
            ("beam_dedup", "quantized merge step", False),
            ("beam_dedup_compact", "row query step", True)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "ggnn_torch/csrc/beam_dedup.cu",
            # no Pallas kernel: the XLA fusion of beam_dedup_mask (and of
            # beam_compact_candidates after it)
            "replaces": ("ggnn_tpu/ops/beam.py:112, :141" if compact
                         else "ggnn_tpu/ops/beam.py:112"),
            "launches": sum(per_path(name).values()),
            **numbers(dedup[main_shape], extra),
            "library_ms": None,
            "shapes": {label: numbers(dedup[label], extra)
                       for label, *_, cap in DEDUP_SHAPES
                       if (cap is not None) == compact},
            "launches_per_path": per_path(name),
            "resources": resources["beam_dedup"],
        })
    # the seeding's approximate top-k, at its callers' shapes; the top-level
    # numbers at the build merge's (the headline build's seeding). No
    # PyTorch call computes the binned selection: ``library_ms`` is the
    # current exact route's at the same shape (``finish`` + ``torch.topk``
    # through ``smallest_k_positions``, the exact set, not the binned one)
    kernels.append({
        "name": "approx_topk",
        "route": "cuda",
        "source": "ggnn_torch/csrc/approx_topk.cu",
        # no Pallas kernel: XLA's TPU ApproxTopK of jax.lax.approx_min_k
        "replaces": "ggnn_tpu/query/fused.py:758, ggnn_tpu/build/merge.py:108",
        "launches": sum(per_path("approx_topk").values()),
        **numbers(approx["merge seeding"], ("host_ms", "library_ms",
                                           "differing", "max_ulp", "recall")),
        "library": "finish + torch.topk (smallest_k_positions): the exact set",
        "shapes": {label: numbers(r, ("host_ms", "library_ms", "differing",
                                      "max_ulp", "recall", "bins", "kernel",
                                      "rows_per_block", "shared_bytes"))
                   for label, r in approx.items()},
        # the same check on each path's own seeding inputs
        "real_inputs": {"fused": summary["approx_real"],
                        "f32_fetch": f32["approx_real"],
                        "sharded": sharded["approx_real"],
                        "devices": devices["approx_real"],
                        "cosine": measures["cosine"]["approx_real"],
                        "uint8": measures["uint8"]["approx_real"],
                        "headline": headline_stats["approx_real"]},
        "launches_per_path": dict(
            per_path("approx_topk"),
            headline_build=headline_stats["approx_launches_build"],
            headline_queries=headline_stats["approx_launches_queries"]),
        "resources": resources["approx_topk"],
    })
    # the walks' fused gather + distance, at its callers' shapes; the
    # top-level numbers at the row query's step. ``library_ms``: torch.bmm
    # alone on rows gathered beforehand (the gather excluded)
    kernels.append({
        "name": "gather_dist",
        "route": "cuda",
        "source": "ggnn_torch/csrc/gather_dist.cu",
        # no Pallas kernel: XLA's fusion of a gather into an einsum
        "replaces": "ggnn_tpu/ops/traverse.py:33, ggnn_tpu/build/sym.py:55, "
                    "ggnn_tpu/query/fused.py:782",
        "launches": sum(per_path("gather_dist").values()),
        **numbers(gather["row query step"], ("host_ms", "library_ms",
                                             "max_err_ratio", "over_bound",
                                             "differing", "gathered_bound_ms",
                                             "gathered_bound_share")),
        "library": "torch.bmm on rows gathered beforehand",
        "shapes": {label: numbers(r, ("host_ms", "library_ms", "max_err_ratio",
                                      "over_bound", "differing",
                                      "gathered_bound_ms",
                                      "gathered_bound_share"))
                   for label, r in gather.items()},
        "before_after": {
            "row_call": {k: {"ms": v["ms"], "c1": v["result"]}
                         for k, v in row["gather"].items() if k != "sweep"},
            "sym_walk_chunk": {
                k: {"ms": v["ms"], "requests": v["result"]}
                for k, v in descent["sym"]["chunk_gather"].items()
                if k in ("kernel", "plain")}},
        "launches_per_path": dict(
            per_path("gather_dist"),
            headline_build=headline_stats["gather_launches_build"],
            headline_queries=headline_stats["gather_launches_queries"]),
        "resources": resources["gather_dist"],
    })
    # the beam ops' sort kernel, at its callers' shapes; the top-level
    # numbers at the row query's step. ``library_ms``: torch.sort alone on
    # the rows' distances (the route adds the criterion, the payload's
    # gather and the row mask)
    kernels.append({
        "name": "beam_sort",
        "route": "cuda",
        "source": "ggnn_torch/csrc/beam_sort.cu",
        # no Pallas kernel: XLA's TPU sort of beam_insert and the cap cut
        "replaces": "ggnn_tpu/ops/beam.py:191, ggnn_tpu/query/fused.py:527",
        "launches": sum(per_path("beam_sort").values()),
        **numbers(sorts["row query step"], ("host_ms", "library_ms",
                                            "differing", "admitted")),
        "library": "torch.sort alone on the rows' distances",
        "shapes": {label: numbers(r, ("host_ms", "library_ms", "differing",
                                      "admitted", "keys_per_lane",
                                      "rows_per_block"))
                   for label, r in sorts.items()},
        "launches_per_path": per_path("beam_sort"),
        "torch_route_per_path": per_path("beam_sort_torch"),
        "resources": resources["beam_sort"],
    })
    # the beam ops' pop kernel, at its callers' shapes; the top-level
    # numbers at gist1m's fused query step. No single PyTorch call computes
    # the pop; the plain pop must never run on the card's paths
    kernels.append({
        "name": "beam_pop",
        "route": "cuda",
        "source": "ggnn_torch/csrc/beam_pop.cu",
        # no Pallas kernel: the XLA fusion of beam_pop
        "replaces": "ggnn_tpu/ops/beam.py:205",
        "launches": sum(per_path("beam_pop").values()),
        **numbers(pops["gist1m fused query step"], ("host_ms", "differing",
                                                    "hits")),
        "library_ms": None,
        "shapes": {label: numbers(r, ("host_ms", "differing", "hits"))
                   for label, r in pops.items()},
        "launches_per_path": per_path("beam_pop"),
        "plain_per_path": per_path("beam_pop_plain"),
        "resources": resources["beam_pop"],
    })
    if any(per_path("beam_pop_plain").values()):
        raise AssertionError(f"plain pops on the card: "
                             f"{per_path('beam_pop_plain')}")
    # the card's line again beside the numbers, should the head of the log
    # be cut
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        sys.exit(2)
    try:
        run(torch.device("cuda", 0))
    except Exception:
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
