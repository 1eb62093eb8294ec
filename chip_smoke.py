#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Usage: ``python3 chip_smoke.py`` from the root of a checkout (one CUDA card).

Phases:
  0. the card (nvidia-smi name + power limit), torch version, kernel build;
  1. each kernel against its plain PyTorch twin, at every shape the main
     path gave it (batch sizes B = 256, 8 and 1; group and candidate counts
     kk as the searcher's budget sets them), on the cell's own data: K1
     (group max) and K2 (gather + rescore) within REL_TOL on each cell's
     slab and mask (phase 2's is 1,007,616 x 256 bf16); K3 (one class of
     the flat lane: tail scores, hot partial, padding mask, group maxima
     and rows, in one pass) bitwise on every length class at every (B, T)
     of phases 4 and 7; K4 (int8 group max) bitwise and K2-i8 (int8 gather
     + rescore) within REL_TOL on phase 5's int8 slab, its B=256 call
     (group order) bitwise the concatenation of 32 B=8 calls on the same
     rows (pair order); K5 (per-tile top-k)
     within REL_TOL on phase 2's slab, its first candidates bitwise K1's
     tile maxima, and bitwise on seeded adversarial tiles through both of
     its entries. It runs inside phases 2-7, after their main-path runs, so
     that it knows those shapes;
  2. semantic serving at 1M docs: ``TwoTierIndex.create`` + fast-only
     ``TwoTierSearcher.search_batch`` (256 queries, then 8 singletons),
     recall@10 against an exact f32 scan, index sets against the plain scan;
  3. hybrid serving at the dense BM25 lane's ceiling (~60k docs, just under
     2,097,152 postings): the fused phase-1 lane with the on-device RRF tail,
     held bitwise to the host RRF oracle on the same arm outputs; then the
     same corpus with the blocked threshold lowered and the hot arm off, the
     pruned lane, held to the dense lane's candidates, and the retired
     selectivity-grouped dispatch bitwise the pruned lane per query;
  4. hybrid serving at 1M docs (the reference's tools/bench_hybrid_1m.py
     corpus: 14 zipf(1.35) words over 50,000, ~10M postings) over phase 2's
     vectors: the split lexical layout (hot arm, flat lane on K3, packed
     DAAT), the daat, blocked and mixed lanes, lexical top-k against an
     exact f64 host BM25, singleton bits against their batch rows, and the
     device RRF bitwise against the host oracle;
  5. the fast tier's other scan modes over phase 2's vectors, through the
     unfused path: ``scan_mode="int8"`` over an int8 ``TwoTierIndex``
     (kernels K4 and K2's int8 form) fast-only and hybrid with phase 4's
     lexical arm (its pools held to phase 4's within 1e-6), certified and
     served behind the recall-certificate gate, then reopened with the
     persisted certificate; ``scan_mode="pallas"`` (kernel K5) over phase
     2's bf16 index, held to the K1/K2 lane. recall@10 against the exact
     f32 scan (int8 >= 0.97, pallas >= 0.99); singletons (four-word
     queries, whose vector budget is the batch's) bitwise equal to their
     batch rows (hybrid: their lexical budget is not the batch's, so the
     lexical and vector score bits of the docs both lists hold);
  6. the A/B scan over phase 2's slab and queries (B = 256, 8, 1; k = 30,
     60): ``scan_topk_hierarchical_ab(emit="tile_topk")``, whose per-tile
     group candidates come from kernel K6, bitwise equal to the K1/K2 route,
     as is ``group_select="iter"``; ``rescore="xla"`` (the f32 query) held
     to the same rescore over K1's groups and to f64 dot products; then K6
     against its twin (values within REL_TOL, group ids equal except where
     two groups' maxima tie, every value K1's maximum for its group, K1's
     time alone beside K6's), and K6's selection bitwise against the argmax
     passes on crafted maxima (ties, both zeros, masked groups and tiles);
  7. hybrid-1M with a Model2Vec fast tier (hybrid-1M-m2v): a seeded
     500,000 x 256 table, phase 4's 1M docs embedded through the bag lane
     (``embed_corpus``, twice: the same bits) into a bf16 index, served with
     phase 4's lexical arm and traffic through the fully fused lane (the
     embed inside the pass): the daat, blocked and mixed lanes, the device
     RRF bitwise against the host oracle, singletons against their batch
     rows, the lexical pools against phase 4's, vector recall@10 against an
     exact f32 scan of the pass's own query vectors, and the results against
     the same batch embedded on the host first; every Model2Vec pool call of
     the main path (the fused pass's, at its B and T) held bit for bit to
     the plain twin on its own ids and mask, and the pool's wrapper timed
     at POOL_SHAPES;
  8. hybrid-1M with a 1M x 384 quality tier (hybrid-1M-quality): the trained
     encoder, the Refined phase of ``search_batch`` and ``search()`` (aligned
     rescore and rescan, K1/K2 at d = 384), a seeded cross-encoder, and the
     held-out lift against the CPU, its per-query nDCG@10 from the port's
     quality harness (15c);
  9. the scan lanes and the write path: semantic-1M-f32 (phase 2's vectors
     as an f32 slab; ``auto`` on K1 and K2's f32 forms and ``pallas`` on
     K5's, B = 256, 8, 1, doc sets against the plain f32 scan up to ties
     within F32_TIE_REL at the k-th score); semantic-1M-mrl (phase 2's
     index with ``mrl_search_dims=64``, recall@10, a B=8 subset against the
     same op on CPU copies); the int4 two-pass scan over phase 2's vectors
     (a B=8 subset against the CPU); semantic-1M-ivf (a clustered 1M
     corpus, its IVF arm built on the card: build time, recall@10 at nprobe
     8 and 32, scanned fraction, full probe against the hierarchical scan up
     to ties within bf16 rounding, every probe on K2-ivf and none on K2,
     K2-ivf at the probe's shapes and the calibration's widest against its
     twin and timed beside K2's path and, at the full probe, one cuBLAS
     product, a calibrated nprobe certified, persisted, served behind the
     gate and rebound after a reopen); the write path over phase 2's index (10,000
     appends, 1,000 deletes, a WAL sync: each appended doc its own top hit,
     no deleted doc returned, ``mode="ivf"`` refused until ``enable_ivf()``
     runs again, then ``compact()`` and a reopen with the top-10 bitwise
     unchanged);
 10. built-1M-m2v, the library's entry point: ``IndexBuilder(root)`` (no
     device named: the card) over phase 4's 1M docs with phase 7's
     Model2Vec table (the embed through the bag lane on the card, the
     default bf16 slab), its stats and artifacts checked (every doc kept,
     an FLXB generation, sidecars); ``open_hybrid(root)`` (the FLXB arm on
     the card in the split layout, behind a ``DeltaLexicalIndex``); phase
     7's batch and singletons through the fused lane, K1, K2 and K3
     counted, doc ids, fused scores and lexical pools bitwise phase 7's,
     the device RRF bitwise the host oracle; 10,000 new docs (the vector
     tier's append, then ``handle.delta``) each the top lexical hit of its
     unique term before a seal; an incremental seal to a two-segment
     stack on the card whose top-10 equals an exact f64 host BM25 over
     1,010,000 docs; 1,000 deletes (half new) never returned; K1, K2 and K3
     against their twins at the phase's shapes;
 11. cli-400k, the product CLI: phase 4's first 400,000 docs (``CLI_DOCS``,
     a depth cut for the script's time limit) as a JSONL corpus through
     ``cli index`` (in process, no ``--device``: the card; the default
     stack, HashEmbedder(256), a bf16 slab and the FLXB arm), then ``cli
     serve --warmup --serve-max-batch 256 --coalesce-ms 200`` in process on
     a pipe: phase 4's 256 queries as pipelined ``search`` frames coalesced
     into one ``search_batch`` (K1, K2 and K3 counted), eight singletons
     each followed by a ``ping`` (so through ``search()``), a ``search_batch``
     op, a stream search, ``status`` and ``shutdown``; every reply bitwise
     (through JSON) the library's ``search_batch`` / ``search()`` over the
     handle serve opened, the root's lexical top-k against an exact
     f64 BM25; ``version`` and ``doctor --verify`` as two subprocesses
     started together (``python -m frankensearch_tpu_torch.cli``, on the
     card); K1, K2 and
     K3 against their twins at the phase's shapes;
 12. cli-live-400k, the CLI's live-ingest and interactive path over phase
     11's root: two 20,000-doc roots (phase 3's corpus, its first and its
     next 20,000 docs, each through ``cli index``) and a one-shot
     ``search`` subprocess over the first (rows bitwise ``search()``'s, on
     the card); ``cli daemon --concurrency 4`` over it
     as a subprocess, a burst of 64 embeds from 8 threads bitwise the
     local HashEmbedder(256); ``cli watch`` twice (768 new docs, then
     modified, deleted, renamed and created files and dropped NDJSON
     records under ``--durability-window``: the fast appends within the
     spare rows and the seals at exit timed); ``cli tui`` in process (phase
     4's queries, a token query for every changed doc, prefix chains,
     boolean and negated lines, ``:status``, ``:metrics``): every line's
     results bitwise the library's over the handle it opened, each
     created, modified, renamed and untouched doc its token's top hit, no
     gone id returned, the pool reused, K1, K2 and K3 counted; ``search
     --federate`` over the two small roots with ``--daemon-socket``
     (coverage 2/2, the rows bitwise the library's federated search over
     both, every embed served by the daemon, whose ``requests_served``
     equals the requests sent); ``daemon --wal-poll`` folding the WAL with
     the fast top-10 unchanged across a reopen; ``shadow --candidate
     device`` on the card (no shadow error; a divergence only at a tie);
     K1, K2 and K3 against their twins at the phase's shapes;
 13. cli-fleet-400k, the rest of the CLI over phase 12's root: ``serve
     --fleet-dir --warmup`` in process (phase 4's 256 pipelined queries and
     8 singletons, every reply bitwise the library's over the handle serve
     opened, K1, K2 and K3 counted) while ``fleet --live`` and ``fleet
     --live --slo`` read its node (healthy, this process's pid, the root's
     doc count and generation, qps / p50 / p99 from the frames served,
     errors 0, its card-memory share one the server sensed and at least the
     slab's, the node file valid against its schema) beside a ``daemon
     --fleet-dir`` subprocess over the small root, which is killed and
     reported down and reaped; serve's node file gone after ``shutdown``;
     ``repro`` over the small root (its phases and results bitwise
     ``search()``'s over a library handle, the card in
     ``environment.json``); ``footprint`` of the CLI's root (its row counts
     the FTVI's); ``download``, ``update`` (check, apply, rollback) and
     ``uninstall --dry-run`` on local bundles; K1, K2 and K3 against their
     twins at the shapes phases 11-12 did not give them;
 14. refresh-1M-quality, the background refresh path, run right after
     phase 8 on its two-tier index (so no second 1M index is built or
     held, and phase 9's index is untouched), with a WAL root of its own:
     an ``EmbeddingQueue(1024)`` gets the edited seed docs that
     ``ReembedPolicy`` passes (priority 1), 512 new docs with a unique
     token each and 32 duplicates (refused); a ``RefreshWorker``
     (max_batch 64, HashEmbedder(256) fast, the
     trained encoder on the card for quality) drains it from its thread
     while four readers run phase 4's batch (Refined, with the quality
     rescan) and the singletons through ``search()``, after the same
     readers ran alone: no reader raises, every returned id seeded or
     appended, K1 and K2 counted during the race, ``docs_embedded`` the
     ENQUEUED pushes with no error, the fast WAL holding every append,
     every appended doc its own top fast-tier hit, both tiers' appended
     rows on the card against the CPU (the HashEmbedder's bitwise, the
     encoder's within ENC_F32_TOL); ms per cycle split into embed, WAL
     append, ``with_appended`` and ``_realign``, reader p50 / p99 alone
     and under the writer; K1 and K2 against their twins at shapes no
     earlier phase checked; then, on a 20,000-doc two-tier index on the
     card (a depth cut), a queue of the same capacity pushed until it
     answers FULL, its 1,024 docs drained by a worker against direct
     appends of the same batches (doc ids and scores bitwise), and a
     worker whose quality embed raises on its third batch (``stop()``
     raises it, one error, that batch in the fast tier only);
 15. gauntlet-1M, the port's evaluation modules judging the card's 1M paths,
     run right after phase 14 on what phases 2, 4 and 8 left on the card
     (no new 1M index): 15a ``run_differential_campaign`` over phase 4's
     corpus (50 generated queries, 5 of them guaranteed misses), the 1M
     lexical arm's ``search_candidates`` against an exact f64 host BM25
     (``ExactBm25``) as the arm serves (each query's lane logged) and with
     every query on the flat lane (K3 counted), every case agreeing; 15b
     ``run_interaction_matrix`` over all eight lanes of ``LANE_CATALOG``
     (``mrl`` and ``plan`` included) x 10 queries (phase 4's 8 singletons
     and two four-word queries) x 5 oracles on a ``TwoTierSearcher`` over
     phase 8's two-tier index (the encoder on the card) with phase 4's
     arm, with each lane's config and again with the quality rescan: 400
     checks each, none violated, K1 and K2 counted at d = 256 and 384 and
     K3, each lane's phases and wall time; 15c phase 8c's lift gate through
     ``utils/quality_harness`` (two reports per run, ``compare_systems``);
     15d the boolean laws (oracle, ``DeviceBm25Index`` and
     ``BulkDeviceBm25Index`` on the card, FTS5) over 2,000 generated docs
     with budgets that hold whole match sets (the bulk arm beside the
     oracle breaks arm parity where the reference's does, recorded), the
     reload law and the append-delete-compact law on a ``TwoTierIndex`` on
     the card over 20,000 docs, all ``[]``; 15e both campaigns' and sweeps'
     outcomes as ``core/e2e_artifact`` records, read back, validated and
     linted, the schema lockstep, and phase 4's B=256 ``search_batch``
     timed twice by ``perf_ratchet.measure`` and judged by ``run_ratchet``
     (reported, not gated); K1, K2 and K3 against their twins at the
     phase's new shapes;
 16. sharded-1M, the multi-device serving path, run after phase 15 on
     phase 2's vectors and phase 4's arm with a mesh of 4 shards on the
     one card (no new 1M root): 16a a ``ShardedDeviceVectorIndex`` (4 x
     253,952 rows, each shard a view of the card's slab at an 8192-row
     boundary) behind a fast-only searcher, phase 2's batch and 8
     singletons (auto: K1 + K2 per shard, 4 launches each a scan) bitwise
     phase 2's single-device rows, recall@10 >= 0.99, and the int8 lane
     (K4 + K2-i8 per shard) at recall@10 >= 0.97; 16b phase 4's arm
     block-sharded (``ShardedBulkDeviceBm25Index``: the unsplit graded
     layout rebuilt from its ~9.4M host postings, each shard on the pruned
     lane) with phase 4's 256 queries in one batch against the exact f64
     BM25, the blocks skipped; 16c a hybrid searcher over both through the
     sharded fused lane (``last_phase1_lex_lane == "sharded"``), the device
     RRF bitwise the host oracle, singletons bitwise their batch rows, doc
     ids equal to phase 4's except where lexical scores within 1e-6
     reorder (counted); 16d the retired hot combine
     (``hot_daat_topk_ab``) at B=8 on a 20,000-doc split layout, rank-equal
     to the flat lane (K3) within 1e-5; K1, K2, K4 and K2-i8 against their
     twins at the per-shard shapes. Phase 3 runs the retired grouped
     dispatch (``grouped_blocked_dispatch``) on its pruned index, bitwise
     the pruned lane per query. 16e runs after phase 13 on phase 12's
     20,000-doc corpus (a depth cut; ``make_mesh`` gives one shard a card):
     ``IndexBuilder`` and ``open_hybrid`` with ``mesh_shards=4`` (the
     batch through the sharded fused lane against the unsharded open), an
     append, a delete, a seal, ``compact()`` and a reopen on the mesh, then
     ``search --shards 2`` and ``serve --shards 2`` over ``fed_root``
     against the same commands unsharded.
 17. train-384, the training path, run last on nothing the earlier phases
     left: data/quality_encoder_384's config (vocab 396, H 384, 6 layers, 12
     heads) from the port's random init, on the lift world's 90 training
     pairs. 17a one step at batch 16 x 32 tokens on a (dp 2, tp 2) mesh of
     four shards of the card (tensor-parallel dense layers, sequence
     parallelism, remat) against the step on a mesh of one and on the CPU
     from the same state (loss and gradients within stated tolerances, and
     one AdamW update from identical gradients on each), and each step's
     time by CUDA events; 17b
     ``finetune_quality_tier`` with the recipe that made the artifact (200
     steps, batch 16, lr 5e-4, seed 11), then 100 steps with a checkpoint
     and a resume to 200: losses and weights bitwise the uninterrupted
     run's, the loss falling; 17c the tuned encoder through
     ``save_artifact`` and ``load_artifact`` (certificate verified) as the
     lift world's quality tier, its held-out lift significant and above the
     untrained control's; 17d the GPipe pipeline over three stages of the
     card within 2e-5 of the sequential forwards, a batch of 5 refused; 17e
     ``graft_entry.dryrun_multichip(4)`` and ``entry()`` on the card. The
     training path has no kernel of its own (the encoder's products are
     cuBLAS's); the searches of 17c and 17e (the lift world's index, the
     dry run's sharded fused lane) launch K1 and K2, counted on the kernels
     line and held to their twins at those shapes, and the Model2Vec pool,
     each of its calls held bit for bit to its twin on the same inputs.

The kernels line gives each kernel's time, its twin's, and its bound: the
larger of the bytes it must move (each input read once, each output
written once; a gather counts the distinct groups it reads) over 3.35 TB/s
and its operations over the H100's dense peak for their type (integer
compares at the INT32 lanes' rate). K1, K2 and K5 on an f32 slab (their
FFMA forms) and the IVF probe's kernel (K2-ivf) have entries of their own.
The Model2Vec pool's entry is its wrapper's time by CUDA events, at its
sizes the host's enqueue; ``profile_chip.py --pool`` gives its device time.
Each entry is one launch at its headline shape; K3's is the mean over the length classes of one flat scan
at the widest batch tile, the unit its launch count counts.

The kernels' launch counters are zeroed right before each phase drives the
main path and read right after; the kernel checks and the other comparison
runs come later and do not count.
Any failed check raises. The last stdout line is the result JSON; the line
before it is the card's name and power limit. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 20261016
N_DOCS = 1_000_000
DIM = 256
K = 10
HYBRID_DOCS = 60_000
HYBRID_VOCAB = 50_000
POSTINGS_RANGE = (1_500_000, 2_097_152)
REL_TOL = 1e-5  # kernel vs twin: bf16 products are exact, f32 sums differ in order
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
#: integer compares: one instruction per lane on the 64 INT32 lanes of each
#: Hopper SM per clock (NVIDIA's Hopper tuning guide, arithmetic throughput
#: of compute capability 9.0), 132 SMs at the 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
PEAK_OPS_PER_S = {"bf16": 989e12, "f16": 989e12, "int8": 1979e12, "f32": 67e12,  # dense
                  "int32": INT32_OPS_PER_S}
INT8_RECALL_FLOOR = 0.97  # the reference's own recall@10 figure for the int8 lane
AB_BATCHES = (256, 8, 1)  # phase 6: the serve batch, the fused lane's pad, a singleton
AB_KS = (30, 60)  # the searcher's candidate budgets at k = 10
AB_TILE = 8192  # K6's widest tile: 64 groups
M2V_ROWS = 500_000  # of the order of potion-multilingual-128M's 128M parameters over 256 dims
M2V_COS_FLOOR = 0.99999  # bag lane vs embed_batch (tests/test_bulk_embed.py)
#: the pool kernel's timed shapes (B, T, tokens a row): an interactive
#: query of 6 words in the 16-token bucket, and 64-query batches in the 16-
#: and 32-token buckets
POOL_SHAPES = ((1, 16, 6), (64, 16, 6), (64, 32, 20))
#: how far rounding a unit query and a unit doc vector to bf16 (unit
#: roundoff u = 2^-9) can move their dot product: (2u + u^2) |q| |d|, plus
#: f32 sums; two docs closer than twice this may swap against an f32 scan
BF16_DOT_BOUND = 2.0**-8 + 2.0**-18 + 1e-5
LEX_REL_TOL = 1e-6  # pruned vs dense lane: the same f32 terms summed in another order
H1M_DOCS = 1_000_000  # tools/bench_hybrid_1m.py: 1M docs of 14 zipf(1.35) words
H1M_VOCAB = 50_000
H1M_WORDS = 14
H1M_ZIPF = 1.35
H1M_MIN_POSTINGS = 1 << 21  # the blocked layout's threshold
ORACLE_REL_TOL = 1e-5  # f32 device BM25 vs the exact f64 host sum
Q_DIM = 384  # the quality tier's width: data/quality_encoder_384 is MiniLM-L6's H = 384
QUALITY_ARTIFACT = "data/quality_encoder_384"
#: cross-encoder/ms-marco-MiniLM-L-6-v2's config.json (its weights are not
#: in the repository: phase 8 draws them from a seed)
CE_CONFIG = {"vocab_size": 30522, "hidden": 384, "layers": 6, "heads": 12, "intermediate": 1536,
             "max_position": 512}
ENC_BATCHES = (256, 8, 1)  # the serve batch, the fused lane's pad, a singleton
#: card vs CPU, the tolerances tests/test_torch_rerank.py states for the
#: port against the reference: f32 sums in another order (quality vectors,
#: cross-encoder scores), a bf16 rounding landing the other way, int8
#: activations rounded to the neighbouring value (each such step moves a
#: product by 1/127 of its row's largest activation, through six layers)
ENC_F32_TOL = 1e-5
ENC_BF16_TOL = 5e-4
CE_F32_TOL = 1e-5
CE_INT8_TOL = 5e-3
#: a query's quality vector alone (B=1) against its row of the B=256
#: forward, elementwise on unit vectors: the batch pads every query to the
#: length bucket of its longest one, and cuBLAS picks its GEMM by row
#: count, so the f32 sums may run in another order (f32); under bf16
#: compute such a difference can move an intermediate's bf16 rounding (the
#: bf16 tolerance above)
SOLO_BATCH_TOL = {"f32": 1e-5, "bf16": ENC_BF16_TOL}
LIFT_FLOOR = 0.0406  # the recorded held-out lift CI's lower end (tests/test_trained_quality_384.py)
LIFT_TOL = 0.005  # card vs CPU mean lift on the same world
LIFT_SEED = 11  # tools/train_quality_lift.py's world
F32_TIE_REL = 1e-6  # f32 slab lanes vs the plain f32 scan: the same f32 products summed in another order
MRL_DIMS = 64  # semantic-1M-mrl's pass-1 dims (the reference's default search_dims)
MRL_CPU_TOL = 1e-6  # MRL card vs CPU: f32 sums in another order
IVF_CENTRES = 2_000  # the clustered corpus's centres: the IVF arm's default cluster count at 1M docs
IVF_SPREAD = 0.125  # per-dim noise: |noise| ~ 2 at d = 256, as tests/test_ivf.py's 0.25 at d = 64
IVF_QUERY_NOISE = 0.025  # |noise| ~ 0.4 at d = 256, as that test's 0.05 at d = 64
IVF_NPROBES = (8, 32)  # the default ivf_nprobe and a wider probe
#: calibrate_nprobe's target: per-query recall@10 is a multiple of 0.1, and
#: so is the certified recall (a lower quantile of it): 0.9 is the highest
#: target short of every query's full top-10
IVF_TARGET_RECALL = 0.9
#: the nprobe values calibrated: a certified (lower-quantile) recall of 0.9
#: can take hundreds of probes where the capacity-balanced assignment has
#: placed docs away from their nearest clusters
IVF_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
IVF_OWN_HIT_FLOOR = 0.99  # appended docs found first by the rebuilt arm at nprobe 8 (spill can place a doc past its probes)
APPEND_DOCS = 10_000
DELETE_DOCS = 1_000  # half of them appended docs, half phase 2's


#: the kernels line: name, launch counter, source, the TPU kernel it
#: replaces, the cell whose largest shape is the headline
KERNELS = (
    ("group_max", "K1", "frankensearch_tpu_torch/ops/csrc/group_max.cu",
     "frankensearch_tpu/ops/topk_scan.py:220", "semantic-1M"),
    ("gather_rescore", "K2", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M"),
    ("flat_fused", "K3", "frankensearch_tpu_torch/ops/csrc/flat_score.cu",
     "frankensearch_tpu/lexical/device_bm25.py:405", "hybrid-1M"),
    ("group_max_int8", "K4", "frankensearch_tpu_torch/ops/csrc/group_max.cu",
     "frankensearch_tpu/ops/topk_scan.py:240", "semantic-1M-int8"),
    ("gather_rescore_i8", "K2-i8", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M-int8"),
    ("tile_topk", "K5", "frankensearch_tpu_torch/ops/csrc/tile_topk.cu",
     "frankensearch_tpu/ops/topk_scan.py:114", "semantic-1M"),
    ("group_candidates", "K6", "frankensearch_tpu_torch/ops/csrc/group_candidates.cu",
     "frankensearch_tpu/ops/ab_primitives.py:103", "semantic-1M"),
    ("group_max_f32", "K1-f32", "frankensearch_tpu_torch/ops/csrc/group_max.cu",
     "frankensearch_tpu/ops/topk_scan.py:220", "semantic-1M-f32"),
    ("gather_rescore_f32", "K2-f32", "frankensearch_tpu_torch/ops/csrc/gather_rescore.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M-f32"),
    ("tile_topk_f32", "K5-f32", "frankensearch_tpu_torch/ops/csrc/tile_topk.cu",
     "frankensearch_tpu/ops/topk_scan.py:114", "semantic-1M-f32"),
    ("ivf_probe", "K2-ivf", "frankensearch_tpu_torch/ops/csrc/ivf_probe.cu",
     "frankensearch_tpu/ops/topk_scan.py:362", "semantic-1M-ivf"),
    ("embed_pool", "pool", "frankensearch_tpu_torch/ops/csrc/embed_pool.cu",
     "none (XLA): frankensearch_tpu/embed/model2vec.py:48", "hybrid-1M-m2v"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_median_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Median device time of ``fn`` in ms, one CUDA event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(got, want, what: str) -> float:
    """max |got - want| over finite entries; -inf must match exactly."""
    import torch

    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{what}: finite pattern differs from the twin")
    err = (got[fin] - want[fin]).abs()
    bound = REL_TOL * torch.clamp(want[fin].abs(), min=1.0)
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: max abs err {err.max().item():.3e} over tolerance")
    return float(err.max().item()) if err.numel() else 0.0


def unit_rows(gen, n: int, d: int, device):
    import torch

    x = torch.randn(n, d, generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def check_kernels(cell: str, slab, mask, shapes: set, done: set = frozenset()) -> list[dict]:
    """Phase 1 for one cell: K1/K2 against their plain twins on the cell's
    slab and mask, at each shape in ``shapes`` (as :func:`drive` noted them:
    ("group_max", B, 0) and ("gather_rescore", B, kk)) not already checked on
    the same slab (``done``), with seeded unit queries; K2 rescores the
    top-kk groups of K1's output, sorted as the scan sorts them. Times are
    CUDA-event medians."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for name in ("group_max", "gather_rescore"):
        if not any(s[0] == name for s in shapes):
            raise AssertionError(f"phase1 {cell}: the main path gave {name} no shape")
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 1)
    n, d = slab.shape
    kind, form = kernel_form(slab)
    recs = []
    todo = shapes - set(done)
    for b in sorted({s[1] for s in shapes if s[0] == "group_max"}, reverse=True):
        q = unit_rows(gen, b, d, slab.device)
        gm = ts.group_max(slab, q, mask)
        if ("group_max", b, 0) in todo:
            err = check_close(gm, ts.group_max_plain(slab, q, mask), f"phase1 {cell} K1 B={b}")
            ms = cuda_median_ms(lambda: ts.group_max(slab, q, mask))
            plain_ms = cuda_median_ms(lambda: ts.group_max_plain(slab, q, mask))
            recs.append({"kernel": "group_max" + form, "cell": cell, "n": n, "b": b, "kk": None,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                         "bound": bound(nbytes(slab, q, mask, gm), 2 * b * n * d, kind)})
        for kk in sorted(s[2] for s in todo if s[0] == "gather_rescore" and s[1] == b):
            _, groups = ts.topk_desc_rowasc(gm, kk)
            groups = torch.sort(groups.to(torch.int32), dim=1).values
            r = ts.gather_rescore(slab, q, groups)
            err = check_close(r, ts.gather_rescore_plain(slab, q, groups),
                              f"phase1 {cell} K2 B={b} kk={kk}")
            ms = cuda_median_ms(lambda: ts.gather_rescore(slab, q, groups))
            plain_ms = cuda_median_ms(lambda: ts.gather_rescore_plain(slab, q, groups))
            recs.append({"kernel": "gather_rescore" + form, "cell": cell, "n": n, "b": b, "kk": kk,
                         "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                         "bound": bound(gathered_bytes(slab, groups) + nbytes(q, groups, r),
                                        2 * r.numel() * d, kind)})
    log_kernel_records(cell, recs)
    return recs


def kernel_form(slab) -> tuple[str, str]:
    """(the operations' type for the bound, the kernels line's name suffix)
    of a slab: bf16/f16 score on the tensor cores, f32 by FFMA (the kernels'
    f32 forms, entries of their own on the kernels line)."""
    import torch

    return {torch.bfloat16: ("bf16", ""), torch.float16: ("f16", ""), torch.float32: ("f32", "_f32")}[slab.dtype]


def log_kernel_records(cell: str, recs: list[dict]) -> None:
    for r in recs:
        log(f"phase1 {cell} {r['kernel']} N={r['n']} B={r['b']}"
            + (f" kk={r['kk']}" if r["kk"] is not None else "")
            + f": {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]})"
            f" max abs err {r['max_abs_err']:.3e} (tolerance {REL_TOL:g} x max(1, |twin|))")


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for a kernel that must
    move ``bytes_moved`` bytes and do ``ops`` operations of type ``kind``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gathered_bytes(slab, groups) -> int:
    """Bytes of the distinct 128-row groups a gather must read."""
    import torch

    return int(torch.unique(groups).numel()) * 128 * slab.shape[1] * slab.element_size()


def launch_counters() -> dict:
    """Kernel name -> its wrapper (each counts its launches)."""
    from frankensearch_tpu_torch.embed import model2vec
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops import topk_scan as ts

    return {"K1": ts.group_max, "K2": ts.gather_rescore, "K3": bm.flat_class_fused,
            "K4": ts.group_max_int8, "K2-i8": ts.gather_rescore_i8, "K5": ts.tile_topk,
            "K6": ts.group_candidates, "K2-ivf": ts.ivf_probe_topk, "pool": model2vec.gather_pool_normalize}


class PoolNoted:
    """``model2vec.gather_pool_normalize`` with each call on the card kept in
    ``calls`` as (table, ids, mask, out), copies of all but the table. Its
    ``launches`` are the wrapper's own: the wrapper counts them under its
    module name, which this object holds while it is swapped in."""

    def __init__(self, real, calls: list):
        self.real, self.calls = real, calls

    def __call__(self, emb, ids, mask):
        out = self.real(emb, ids, mask)
        if out.is_cuda:
            self.calls.append((emb, ids.clone(), mask.clone(), out.clone()))
        return out

    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.real.launches = n


def drive(fn, shapes: set, flat_inputs: dict | None = None, *, dim: int | None = None,
          pool_calls: list | None = None):
    """Run ``fn`` with the kernels' launch counters zeroed; returns
    (result, {kernel: launches}) of that run alone. Adds to ``shapes`` the
    kernel shapes of every scan in the run (with ``dim``, of every
    hierarchical scan over a slab of that width): a hierarchical scan runs K1 at
    ("group_max", B, 0) and K2 at ("gather_rescore", B, kk), an int8 scan
    K4 at ("group_max_int8", B, 0) and K2-i8 at ("gather_rescore_i8", B,
    kk), a per-tile scan K5 at ("tile_topk", B, kk). ``flat_inputs``
    collects, for each (B, T) at which the flat lane ran K3, a copy of the
    first query rows, hot partial and group-row map it got. ``pool_calls``
    collects every Model2Vec pool call on the card (:class:`PoolNoted`),
    from ``embed_batch`` and from the fused pass alike."""
    from frankensearch_tpu_torch.embed import model2vec
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops import hybrid_phase1, topk_scan as ts

    scan, scan_i8, scan_tiles = ts.scan_topk_hierarchical, ts.scan_topk_hierarchical_int8, ts.scan_topk_pallas
    flat = bm._graded_scan_flat

    def scan_noted(slab, queries, k, mask=None):
        b = queries.shape[0]
        if dim is None or slab.shape[1] == dim:
            shapes.add(("group_max", b, 0))
            shapes.add(("gather_rescore", b, min(k, slab.shape[0] // ts.GROUP)))
        return scan(slab, queries, k, mask)

    def scan_i8_noted(slab_i8, scale, queries, k, mask=None, *, group_overfetch=1):
        b = queries.shape[0]
        shapes.add(("group_max_int8", b, 0))
        shapes.add(("gather_rescore_i8", b, min(max(k * group_overfetch, k), slab_i8.shape[0] // ts.GROUP)))
        return scan_i8(slab_i8, scale, queries, k, mask, group_overfetch=group_overfetch)

    def tiles_noted(slab, queries, k, mask=None, *, tile_n=ts.TILE_N):
        shapes.add(("tile_topk", queries.shape[0], min(k, tile_n)))
        return scan_tiles(slab, queries, k, mask, tile_n=tile_n)

    def flat_noted(classes, q_ids, q_w, s_phys, dmap_groups, **kw):
        if flat_inputs is not None and tuple(q_ids.shape) not in flat_inputs:
            flat_inputs[tuple(q_ids.shape)] = (q_ids.clone(), q_w.clone(),
                                               None if s_phys is None else s_phys.clone(), dmap_groups)
        return flat(classes, q_ids, q_w, s_phys, dmap_groups, **kw)

    counters = launch_counters()
    for wrapper in counters.values():
        wrapper.launches = 0
    pool = model2vec.gather_pool_normalize
    ts.scan_topk_hierarchical, ts.scan_topk_hierarchical_int8, ts.scan_topk_pallas = (
        scan_noted, scan_i8_noted, tiles_noted)
    bm._graded_scan_flat = flat_noted
    if pool_calls is not None:
        model2vec.gather_pool_normalize = hybrid_phase1.gather_pool_normalize = PoolNoted(pool, pool_calls)
    try:
        result = fn()
    finally:
        ts.scan_topk_hierarchical, ts.scan_topk_hierarchical_int8, ts.scan_topk_pallas = scan, scan_i8, scan_tiles
        bm._graded_scan_flat = flat
        model2vec.gather_pool_normalize = hybrid_phase1.gather_pool_normalize = pool
    return result, {name: wrapper.launches for name, wrapper in counters.items()}


def need_launches(phase: str, launches: dict, names=("K1", "K2")) -> None:
    """Fail unless every named kernel launched on the phase's main path."""
    for name in names:
        if launches[name] < 1:
            raise AssertionError(f"{phase}: {name} was not launched on the main path ({launches})")


def timed(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0


def query_texts(rng, vocab, probs, n: int) -> list[str]:
    lens = rng.integers(1, 5, size=n)
    return [" ".join(vocab[i] for i in rng.choice(len(vocab), size=int(m), p=probs)) for m in lens]


def semantic_cell(dev, tmp: str):
    """The semantic-1M cell: 1M seeded unit vectors in a ``TwoTierIndex``,
    a fast-only searcher, 256 query texts. Returns (searcher, index,
    embedder, vectors, queries)."""
    import numpy as np

    from frankensearch_tpu_torch import HashEmbedder, TwoTierConfig, TwoTierIndex, TwoTierSearcher

    rng = np.random.default_rng(SEED + 2)
    vecs = rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ids = [f"doc-{i:07d}" for i in range(N_DOCS)]
    emb = HashEmbedder(dim=DIM)
    t0 = time.perf_counter()
    index = TwoTierIndex.create(os.path.join(tmp, "semantic"), vecs, ids, emb.identity(), device=dev)
    log(f"semantic-1M index build {time.perf_counter() - t0:.1f} s ({N_DOCS} docs, "
        f"slab {tuple(index.fast.slab.shape)})")
    searcher = TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True))
    vocab = [f"w{i}" for i in range(5000)]
    probs = 1.0 / np.arange(1, len(vocab) + 1); probs /= probs.sum()
    return searcher, index, emb, vecs, query_texts(rng, vocab, probs, 256)


def phase2_semantic(dev, tmp: str) -> tuple[dict, dict, list[dict], dict]:
    import numpy as np
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    searcher, index, emb, vecs, queries = semantic_cell(dev, tmp)
    singles = queries[:8]
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up: host caches, allocator

    def main_path():
        batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        single_ms = [timed(lambda q=q: searcher.search_batch([q], k=K))[1] for q in singles]
        return batch, batch_ms, single_ms

    (batch, batch_ms, single_ms), launches = drive(main_path, shapes)
    log(f"phase2 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + " ms")
    need_launches("phase2", launches)
    kernels = check_kernels("semantic-1M", index.fast.slab, index.fast._effective_mask(None, None), shapes)

    # checks (comparison runs; not counted)
    qv = emb.embed_batch(queries)
    exact_ids = ts.scan_topk_xla(
        torch.from_numpy(vecs).to(dev), torch.from_numpy(qv).to(dev), K, precise=True
    ).indices.cpu().numpy()
    recalls = []
    for j, out in enumerate(batch):
        got = {int(r.doc_id[4:]) for r in out.results}
        if len(out.results) != K:
            raise AssertionError(f"phase2: query {j} returned {len(out.results)} results")
        recalls.append(len(got & set(exact_ids[j].tolist())) / K)
    recall = float(np.mean(recalls))
    log(f"phase2 recall@10 vs exact f32 scan: {recall:.4f}")
    if recall < 0.99:
        raise AssertionError(f"phase2: recall@10 {recall} < 0.99")
    hier = index.fast.search_batch(qv, K, mode="hierarchical")
    plain = index.fast.search_batch(qv, K, mode="xla")
    off = 0
    for j in range(len(queries)):
        hs, ps = set(hier.indices[j].tolist()), set(plain.indices[j].tolist())
        if hs != ps:
            kth = float(plain.scores[j, -1])
            for row in hs ^ ps:  # a differing row must tie the k-th score
                s = float(torch.from_numpy(qv[j]).to(dev).to(torch.bfloat16).float()
                          @ index.fast.slab[row, :DIM].float())
                if abs(s - kth) > REL_TOL:
                    raise AssertionError(f"phase2: query {j} row {row} differs from the plain scan")
            off += 1
    for j, out in enumerate(batch):
        top = [int(r.doc_id[4:]) for r in out.results]
        if top != hier.indices[j].tolist()[: len(top)]:
            raise AssertionError(f"phase2: query {j} results differ from the index scan")
    log(f"phase2 index sets vs plain bf16 scan: {len(queries) - off} equal, {off} differ only at ties")
    del searcher, hier, plain
    torch.cuda.empty_cache()
    # phase 4 serves its lexical corpus over this index (same doc ids);
    # phase 5 its other scan modes over the same vectors and queries
    semantic = {"index": index, "emb": emb, "shapes": shapes, "vecs": vecs, "queries": queries,
                "exact_ids": exact_ids, "rows": [rows_of(out) for out in batch]}
    return ({"recall_at_10": recall, "batch_ms": batch_ms, "single_ms": single_ms},
            launches, kernels, semantic)


def rows_of(out) -> list[tuple]:
    """One outcome's results as (doc id, fused, lexical and vector score)."""
    return [(r.doc_id, r.score, r.lexical_score, r.fast_score) for r in out.results]


def hybrid_corpus(rng):
    import numpy as np

    from frankensearch_tpu_torch import IndexableDocument

    vocab = [f"w{i}" for i in range(HYBRID_VOCAB)]
    probs = np.arange(1, HYBRID_VOCAB + 1) ** -1.07
    probs /= probs.sum()
    lens = rng.integers(9, 63, size=HYBRID_DOCS)
    toks = rng.choice(HYBRID_VOCAB, size=int(lens.sum()), p=probs)
    titles = rng.choice(HYBRID_VOCAB, size=(HYBRID_DOCS, 2), p=probs)
    docs, pos = [], 0
    for i, m in enumerate(lens):
        words = toks[pos : pos + m]
        pos += m
        docs.append(IndexableDocument(
            doc_id=f"src-{i:06d}",
            content=" ".join(vocab[t] for t in words),
            title=" ".join(vocab[t] for t in titles[i]),
        ))
    return docs, vocab, probs


def hybrid_cell(dev, tmp: str):
    """The hybrid-60k cell: a seeded zipf corpus just under the dense BM25
    lane's ceiling, its HashEmbedder vectors in a ``TwoTierIndex``, a
    fast-only hybrid searcher, 256 query texts. Returns (searcher, index,
    BM25 index, queries)."""
    import numpy as np

    from frankensearch_tpu_torch import (
        DeviceBm25Index,
        HashEmbedder,
        MemoryLexicalIndex,
        TwoTierConfig,
        TwoTierIndex,
        TwoTierSearcher,
    )

    rng = np.random.default_rng(SEED + 3)
    docs, vocab, probs = hybrid_corpus(rng)
    t0 = time.perf_counter()
    bm25 = DeviceBm25Index(MemoryLexicalIndex.bulk_build(docs), device=dev)
    log(f"hybrid-60k BM25 build {time.perf_counter() - t0:.1f} s: {bm25.n_docs} docs, "
        f"{bm25.posting_count} postings, vocab {bm25.vocab_size}")
    if not POSTINGS_RANGE[0] <= bm25.posting_count < POSTINGS_RANGE[1]:
        raise AssertionError(f"hybrid-60k: {bm25.posting_count} postings outside {POSTINGS_RANGE}")
    emb = HashEmbedder(dim=DIM)
    t0 = time.perf_counter()
    index = TwoTierIndex.create(
        os.path.join(tmp, "hybrid"), emb.embed_batch([d.content for d in docs]),
        [d.doc_id for d in docs], emb.identity(), device=dev,
    )
    log(f"hybrid-60k vector index build {time.perf_counter() - t0:.1f} s")
    searcher = TwoTierSearcher(index, emb, lexical=bm25, config=TwoTierConfig(fast_only=True))
    return searcher, index, bm25, query_texts(rng, vocab, probs, 256)


def phase3_hybrid(dev, tmp: str) -> tuple[dict, dict, list[dict]]:
    searcher, index, bm25, queries = hybrid_cell(dev, tmp)
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up

    def main_path():
        batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        single_ms = [timed(lambda q=q: searcher.search_batch([q], k=K))[1] for q in queries[:8]]
        return batch, batch_ms, single_ms

    (batch, batch_ms, single_ms), launches = drive(main_path, shapes)
    log(f"phase3 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + " ms")
    need_launches("phase3", launches)
    kernels = check_kernels("hybrid-60k", index.fast.slab, index.fast._effective_mask(None, None), shapes)
    if not all(o.metrics.phase1_fused for o in batch):
        raise AssertionError("phase3: the fused phase-1 lane did not run")
    if not all(len(o.results) == K for o in batch):
        raise AssertionError("phase3: a query returned fewer than k results")
    if searcher.last_fusion_path != "device":
        raise AssertionError(f"phase3: fusion path {searcher.last_fusion_path!r}, not device")

    # the device RRF against the host oracle (the per-query fusion) on the
    # same arm outputs: with the device tail switched off, the searcher
    # fuses the identical arm bits on the host, query by query
    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    if searcher.last_fusion_path != "host":
        raise AssertionError(f"phase3: oracle fusion path {searcher.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(batch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase3: query {j} differs from the host RRF oracle")
    log("phase3 fused rows and scores bitwise equal to the host RRF oracle")
    del searcher._device_rrf_tail
    pruned = phase3_pruned(dev, bm25, queries[:64])
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "postings": bm25.posting_count,
             "pruned": pruned}, launches, kernels)


def same_ranking(got, want, rel: float, what: str) -> None:
    """Two candidate lists of one query: scores equal position by position
    within ``rel``, and the same docs, except that docs whose score lies
    within ``rel`` of the last kept score may be swapped for each other."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} candidates, want {len(want)}")
    for (gd, gs), (wd, ws) in zip(got, want):
        if abs(gs - ws) > rel * abs(ws):
            raise AssertionError(f"{what}: score {gs!r} vs {ws!r}")
    if not want:
        return
    kth = want[-1][1]
    edge = {d for d, s in got + want if abs(s - kth) <= rel * abs(kth)}
    if {d for d, _ in got} - edge != {d for d, _ in want} - edge:
        raise AssertionError(f"{what}: candidate sets differ away from the k-th score")


def phase3_pruned(dev, bm25, queries) -> dict:
    """The hybrid-60k corpus once more with the blocked threshold lowered and
    the hot arm off: the pruned lane (block-max skipping, exact 8-term FMA
    chunks) against the dense lane's candidates on the same queries."""
    import numpy as np

    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.lexical import hot_arm

    saved = bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS
    bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS = 1, 1 << 62
    try:
        t0 = time.perf_counter()
        pruned = bm.DeviceBm25Index(bm25._source, device=dev)
        build_s = time.perf_counter() - t0
    finally:
        bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS = saved
    if pruned._blocked is None or pruned._hot is not None:
        raise AssertionError("phase3: the pruned layout was not built")
    pruned.daat_mode = "blocked"
    want, _ = timed(lambda: bm25.search_candidates_batch(queries, 30))
    got, ms = timed(lambda: pruned.search_candidates_batch(queries, 30))
    if pruned.last_lane != "blocked":
        raise AssertionError(f"phase3: pruned lane {pruned.last_lane!r}")
    for j, (g, w) in enumerate(zip(got, want)):
        same_ranking([(c.doc_id, c.score) for c in g], [(c.doc_id, c.score) for c in w],
                     LEX_REL_TOL, f"phase3 pruned query {j}")
    skipped = pruned.last_blocks_skipped
    single_ms, solo_skips = [], []
    for q in queries[:8]:
        g, t = timed(lambda q=q: pruned.search_candidates_batch([q], 30))
        single_ms.append(t)
        solo_skips.append(pruned.last_blocks_skipped)
        same_ranking([(c.doc_id, c.score) for c in g[0]],
                     [(c.doc_id, c.score) for c in bm25.search_candidates_batch([q], 30)[0]],
                     LEX_REL_TOL, f"phase3 pruned singleton {q!r}")
    # the retired selectivity-grouped dispatch (phase 16's item): bitwise
    # the single-batch lane per query
    from frankensearch_tpu_torch.ops.ab_primitives import grouped_blocked_dispatch

    ids, w = pruned._query_sparse_rows(list(queries))
    bounds = pruned._blocked.query_bounds(ids, w)
    (gs, gi), grouped_ms = timed(lambda: grouped_blocked_dispatch(pruned, ids, w, bounds, 30))
    for j, cands in enumerate(got):
        grouped = [(pruned.doc_ids[int(gi[j, c])], gs[j, c].view("u4")) for c in range(gs.shape[1]) if gs[j, c] > 0.0]
        if grouped != [(c.doc_id, np.float32(c.score).view("u4")) for c in cands]:
            raise AssertionError(f"phase3: the grouped dispatch differs from the pruned lane on query {j}")
    selective = int(((bounds <= 0.0).mean(axis=0) >= 0.5).sum())
    log(f"phase3 grouped_blocked_dispatch ({selective} selective queries in sub-batches of 8): {grouped_ms:.2f} ms, "
        f"bitwise the pruned lane per query, {pruned.last_blocks_skipped} blocks skipped")
    n_blk = pruned._blocked.n_blk
    log(f"phase3 pruned lane ({n_blk} blocks, build {build_s:.1f} s): "
        f"{len(queries)} queries' candidates equal to the dense lane's within {LEX_REL_TOL:g}; "
        f"B={len(queries)} {ms:.2f} ms, {skipped} blocks skipped; singletons skipped {solo_skips}")
    return {"n_blocks": n_blk, "batch_ms": ms, "blocks_skipped": skipped,
            "single_ms": single_ms, "single_blocks_skipped": solo_skips,
            "grouped_ms": grouped_ms, "grouped_selective": selective}


def hybrid1m_docs(rng):
    """tools/bench_hybrid_1m.py's corpus: H1M_DOCS docs of H1M_WORDS words
    drawn zipf(H1M_ZIPF) over w00000..w49999, content only; doc ids match
    phase 2's vector index. Returns (docs, vocab)."""
    import numpy as np

    from frankensearch_tpu_torch import IndexableDocument

    vocab = np.array([f"w{i:05d}" for i in range(H1M_VOCAB)])
    words = vocab[(rng.zipf(H1M_ZIPF, size=(H1M_DOCS, H1M_WORDS)) - 1) % H1M_VOCAB]
    docs = [IndexableDocument(doc_id=f"doc-{i:07d}", content=" ".join(row)) for i, row in enumerate(words)]
    return docs, vocab


def hybrid1m_queries(rng, vocab, bm25) -> tuple[list[str], list[str]]:
    """256 queries of 1-4 zipf words; the 8 singletons are the batch's
    first six, a pure-tail query of one rare word (the DAAT lane) and a
    query of the two commonest words (the hot arm), placed at batch rows 6
    and 7."""
    import numpy as np

    lens = rng.integers(1, 5, size=256)
    queries = [" ".join(vocab[(rng.zipf(H1M_ZIPF, size=int(m)) - 1) % H1M_VOCAB]) for m in lens]
    arm = bm25._arms["content"]
    df = np.bincount(bm25._cold_host[0].astype(np.int64), minlength=bm25.vocab_size)
    rare = [w for w in vocab[-5000:] if (t := arm.term_ids.get(str(w))) is not None
            and 2 <= df[t] <= 20 and bm25._hot.hot_row_of[t] < 0]
    if not rare:
        raise AssertionError("phase4: no rare tail word in the corpus")
    queries[6] = str(rare[0])
    queries[7] = f"{vocab[0]} {vocab[1]}"
    return queries, queries[:8]


def check_flat_kernel(cell: str, classes, flat_inputs: dict, *, timed: bool = True) -> list[dict]:
    """Phase 1 for K3: the fused kernel against its twin, bitwise (masked
    scores, group maxima and group rows), on every length class at every
    (B, T) the flat lane ran it with, on the query rows, hot partial and
    row map the lane gave it there. Times are CUDA-event medians of one
    launch (one class). The bound counts the bytes (term and tf words, the
    hot slice, the row map and the query rows read once; the three outputs
    written once) against the integer compares this data needs at the INT32
    rate: one filter probe per (l, slot) per query tile, and B * T compares
    for each (l, slot) whose term a query row of the tile holds; the naive
    count, B * T for every (l, slot), is logged beside it."""
    import torch

    from frankensearch_tpu_torch.lexical import device_bm25 as bm

    if not flat_inputs:
        raise AssertionError(f"phase1 {cell}: the main path gave the flat lane no query rows")
    recs = []
    for (b, t_q), (q_ids, q_w, s_phys, dmap_groups) in sorted(flat_inputs.items(), reverse=True):
        off = goff = 0
        for c, cls in enumerate(classes):
            n_c, l_c, d_pad = cls.term_t.shape
            gc = d_pad // 128
            dmap = dmap_groups[goff : goff + n_c * gc].reshape(n_c, d_pad)
            args = (cls.term_t, cls.tf_t, q_ids, q_w, s_phys, off, dmap)
            got = bm.flat_class_fused(*args)
            want = bm.flat_class_fused_plain(*args)
            for what, g, w in zip(("scores", "group maxima", "group rows"), got, want):
                if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"phase1 {cell} K3 class {c} B={b} T={t_q}: {what} not bitwise")
            off += n_c * d_pad
            goff += n_c * gc
            if not timed:
                continue
            ms = cuda_median_ms(lambda: bm.flat_class_fused(*args), iters=10)
            plain_ms = cuda_median_ms(lambda: bm.flat_class_fused_plain(*args), warmup=1, iters=5)
            slots = cls.term_t.numel()
            hits = int(torch.isin(cls.term_t, q_ids).sum().item())
            row_tiles = -(-b // min(64, 4096 // (t_q | 1)))  # the kernel's query tiles
            compares = slots * row_tiles + hits * b * t_q
            hot_bytes = 0 if s_phys is None else n_c * d_pad * b * 4
            recs.append({"kernel": "flat_fused", "cell": cell, "class": c, "n_c": n_c, "l": l_c,
                         "d_pad": d_pad, "b": b, "t": t_q, "ms": ms, "plain_ms": plain_ms,
                         "max_abs_err": 0.0, "hit_words": hits, "words": slots,
                         "bound": bound(nbytes(cls.term_t, cls.tf_t, q_ids, q_w, dmap, *got) + hot_bytes,
                                        compares, "int32"),
                         "naive_compare_ms": slots * b * t_q / INT32_OPS_PER_S * 1e3})
            r = recs[-1]
            log(f"phase1 {cell} K3 class {c} ({n_c} x {l_c} x {d_pad}) B={b} T={t_q}: {ms:.4f} ms "
                f"(plain {plain_ms:.4f}, bound {r['bound'][0]:.4f} by {r['bound'][1]}; naive compares "
                f"{r['naive_compare_ms']:.4f} ms; {hits} of {slots} words hit), bitwise equal")
            del got, want
    if not timed:
        log(f"phase1 {cell} K3 bitwise equal to its twin on {len(classes)} classes at (B, T) "
            f"{sorted(flat_inputs)}")
    return recs


class ExactBm25:
    """An exact f64 host BM25 over an arm's postings: each query's column
    summed in f64 over its terms' postings, hot and tail; for a segment
    stack, each segment's postings with the stack's global idf weights.
    ``search`` ranks a query's docs by that column (ties in row order),
    the oracle of the gauntlet's differential campaign."""

    def __init__(self, arm) -> None:
        import numpy as np
        from scipy import sparse

        from frankensearch_tpu_torch.lexical.segments import SegmentedBm25

        self.arm = arm
        self.stacked = isinstance(arm, SegmentedBm25)
        self.postings, self.doc_ids = [], []
        for seg in arm.segments if self.stacked else [arm]:
            terms, docs, tfs = seg._post_host
            self.postings.append(sparse.csc_matrix(  # a term's postings are its column (duplicates summed)
                (tfs.astype(np.float64), (docs.astype(np.int64), terms.astype(np.int64))),
                shape=(seg.n_docs, seg.vocab_size)))
            self.doc_ids += seg.doc_ids
        self.row_of = {d: r for r, d in enumerate(self.doc_ids)}

    def pairs(self, queries: list[str]) -> list:
        """Each segment's (term id, weight) pairs of each query."""
        if self.stacked:
            return self.arm.query_pairs(queries)
        return [[self.arm._query_terms(text) for text in queries]]

    def column(self, pairs, j: int):
        """Query ``j``'s exact scores over every doc, in row order."""
        import numpy as np

        parts = []
        for x, seg_pairs in zip(self.postings, pairs):
            col = np.zeros(x.shape[0], np.float64)
            for tid, w in {tid: w for tid, w in seg_pairs[j]}.items():  # a repeated term: its last weight
                s, e = x.indptr[tid], x.indptr[tid + 1]
                col[x.indices[s:e]] += x.data[s:e] * float(np.float32(w))  # a column holds a row once
            parts.append(col)
        return np.concatenate(parts)

    @staticmethod
    def top_rows(col, k: int):
        """The top-k rows of a column: score descending, ties in row order."""
        import numpy as np

        pos = np.flatnonzero(col > 0.0)
        if len(pos) > k:  # every doc at or above the k-th score, in row order
            kth_score = np.partition(col[pos], len(pos) - k)[len(pos) - k]
            pos = pos[col[pos] >= kth_score]
        return pos[np.argsort(-col[pos], kind="stable")][:k]

    def search(self, query: str, k: int) -> list:
        """The exact top-k of one query as ranked hits."""
        from frankensearch_tpu_torch.lexical.base import LexicalCandidate

        col = self.column(self.pairs([query]), 0)
        return [LexicalCandidate(doc_id=self.doc_ids[r], score=float(col[r])) for r in self.top_rows(col, k)]


def lexical_oracle_check(arm, queries: list[str], k: int, *, phase: str = "phase4", exact=None) -> int:
    """The device lanes' top-k against :class:`ExactBm25` (``exact``, or one
    built over ``arm``): equal doc sets up to ties within ORACLE_REL_TOL at
    the k-th score, scores within it too. Returns how many queries' sets
    were equal outright."""
    exact = ExactBm25(arm) if exact is None else exact
    pairs = exact.pairs(queries)
    doc_ids, row_of = exact.doc_ids, exact.row_of
    got = arm.search_candidates_batch(queries, k)
    outright = 0
    for j, cands in enumerate(got):
        col = exact.column(pairs, j)
        top = exact.top_rows(col, k)
        want = {doc_ids[r] for r in top}
        have = {c.doc_id for c in cands}
        for c in cands:
            e = col[row_of[c.doc_id]]
            if abs(c.score - e) > ORACLE_REL_TOL * e:
                raise AssertionError(f"{phase} oracle query {j}: {c.doc_id} scored {c.score}, exact {e}")
        if len(have) != len(want):
            raise AssertionError(f"{phase} oracle query {j}: {len(have)} docs, exact top-k has {len(want)}")
        if have == want:
            outright += 1
            continue
        kth = col[top[-1]]
        for d in have ^ want:
            if abs(col[row_of[d]] - kth) > ORACLE_REL_TOL * kth:
                raise AssertionError(f"{phase} oracle query {j}: {d} differs away from the k-th score")
    return outright


def hybrid1m_lexical(dev):
    """The hybrid-1M corpus, its BM25 arm (split layout, packed term-major
    copy) and the traffic. Returns (BM25 index, queries, singletons, layout
    record, the docs' texts)."""
    import numpy as np

    from frankensearch_tpu_torch import BulkDeviceBm25Index

    rng = np.random.default_rng(SEED + 4)
    t0 = time.perf_counter()
    docs, vocab = hybrid1m_docs(rng)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bm25 = BulkDeviceBm25Index(docs, device=dev)  # raises if the native ingest cannot load
    build_s = time.perf_counter() - t0
    texts = [d.content for d in docs]  # phase 7 embeds them
    del docs
    t0 = time.perf_counter()
    tm = bm25._term_major()
    tm_s = time.perf_counter() - t0
    hot = bm25._hot
    layout = {
        "postings": bm25.posting_count, "tail_postings": bm25.cold_posting_count,
        "hot_terms": None if hot is None else hot.n_hot,
        "classes": None if hot is None else [tuple(c.term_t.shape) for c in bm25._blocked.classes],
        "cold_docs": None if hot is None else int((hot.cold_rows >= 0).sum().item()),
        "daat_packed": None if tm is None else tm.packed,
        "corpus_s": gen_s, "build_s": build_s, "term_major_s": tm_s,
    }
    log(f"hybrid-1M BM25: " + json.dumps(layout))
    if bm25.posting_count < H1M_MIN_POSTINGS:
        raise AssertionError(f"hybrid-1M: {bm25.posting_count} postings < {H1M_MIN_POSTINGS}")
    if hot is None or tm is None or not tm.packed:
        raise AssertionError("hybrid-1M: the split layout with a hot arm and a packed term-major copy was not built")
    queries, singles = hybrid1m_queries(rng, vocab, bm25)
    return bm25, queries, singles, layout, texts


def hybrid1m_cell(dev, index, emb):
    """The hybrid-1M cell over a 1M-doc vector index with phase 2's doc ids:
    :func:`hybrid1m_lexical` and a fast-only hybrid searcher. Returns
    (searcher, BM25 index, queries, singletons, layout record, the docs'
    texts)."""
    from frankensearch_tpu_torch import TwoTierConfig, TwoTierSearcher

    if index.fast.n_rows != H1M_DOCS:
        raise AssertionError(f"hybrid-1M: the vector index holds {index.fast.n_rows} docs, not {H1M_DOCS}")
    bm25, queries, singles, layout, texts = hybrid1m_lexical(dev)
    searcher = TwoTierSearcher(index, emb, lexical=bm25, config=TwoTierConfig(fast_only=True))
    return searcher, bm25, queries, singles, layout, texts


def phase4_hybrid1m(dev, semantic) -> tuple[dict, dict, list[dict], dict]:
    """The hybrid-1M cell over phase 2's vector index. Returns its record,
    launches and kernel records, and the lexical arm with the traffic and
    the batch's lexical pools, for phase 5."""
    index, emb, done_shapes = semantic["index"], semantic["emb"], semantic["shapes"]
    searcher, bm25, queries, singles, layout, texts = hybrid1m_cell(dev, index, emb)
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    lanes: list[str] = []
    flat_inputs: dict = {}
    pools: dict = {}
    fill = searcher._fill_fused

    def fill_noted(fused, live, *rest):  # the batch's lexical pools
        if not pools:
            pools.update({i: [(c.doc_id, c.score) for c in fused[1][j]] for j, i in enumerate(live)})
        return fill(fused, live, *rest)

    def main_path():
        searcher._fill_fused = fill_noted
        try:
            batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        finally:
            del searcher._fill_fused
        lanes.append(searcher.last_phase1_lex_lane)
        solo, single_ms = [], []
        for q in singles:
            out, t = timed(lambda q=q: searcher.search_batch([q], k=K))
            solo.append(out[0])
            single_ms.append(t)
            lanes.append(searcher.last_phase1_lex_lane)
        return batch, batch_ms, solo, single_ms

    (batch, batch_ms, solo, single_ms), launches = drive(main_path, shapes, flat_inputs)
    log(f"phase4 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + f" ms; lanes {lanes}")
    need_launches("phase4", launches, ("K1", "K2", "K3"))
    if not {"daat", "blocked", "mixed"} <= set(lanes):
        raise AssertionError(f"phase4: lanes {sorted(set(lanes))}, want daat, blocked and mixed")
    if not all(o.metrics.phase1_fused for o in batch) or searcher.last_fusion_path != "device":
        raise AssertionError("phase4: the fused phase-1 lane or the device fusion did not run")
    if sum(1 for o in batch if o.results) < len(batch) // 2:
        raise AssertionError("phase4: most queries returned nothing")

    for j, one in enumerate(solo):
        if rows_of(one) != rows_of(batch[j]):
            raise AssertionError(f"phase4: singleton {singles[j]!r} differs from its batch row")
    log("phase4 singletons bitwise equal to their batch rows (fused, lexical and vector scores)")

    kernels = check_kernels("hybrid-1M", index.fast.slab, index.fast._effective_mask(None, None),
                            shapes, done_shapes)
    kernels += check_flat_kernel("hybrid-1M", bm25._blocked.classes, flat_inputs)

    t0 = time.perf_counter()
    outright = lexical_oracle_check(bm25, queries[:32], K)
    log(f"phase4 lexical top-{K} of 32 queries vs exact f64 host BM25: {outright} equal, "
        f"{32 - outright} differ only at ties within {ORACLE_REL_TOL:g} ({time.perf_counter() - t0:.1f} s)")

    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    if searcher.last_fusion_path != "host":
        raise AssertionError(f"phase4: oracle fusion path {searcher.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(batch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase4: query {j} differs from the host RRF oracle")
    log("phase4 fused rows and scores bitwise equal to the host RRF oracle")
    del searcher._device_rrf_tail
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "lanes": lanes, "layout": layout,
             "oracle_equal": outright}, launches, kernels,
            {"bm25": bm25, "queries": queries, "singles": singles, "pools": pools, "texts": texts,
             "rows": [rows_of(out) for out in batch]})


def recall_at_k(batch, exact_ids) -> float:
    """Mean recall@K of the outcomes' doc ids ("doc-%07d") against the
    exact scan's rows; every query must return K results."""
    import numpy as np

    recalls = []
    for j, out in enumerate(batch):
        if len(out.results) != K:
            raise AssertionError(f"query {j} returned {len(out.results)} results")
        recalls.append(len({int(r.doc_id[4:]) for r in out.results} & set(exact_ids[j].tolist())) / K)
    return float(np.mean(recalls))


def four_word_singletons(queries: list[str], n: int = 8) -> list[str]:
    """The batch's first ``n`` four-word queries. Their class (natural
    language) sets the batch's vector budget, so alone they get the same
    budget, and an approximate lane the same candidate pool, as in the
    batch."""
    from frankensearch_tpu_torch.core.query_class import QueryClass

    picked = [q for q in queries if QueryClass.classify(q) is QueryClass.NATURAL_LANGUAGE][:n]
    if len(picked) < n:
        raise AssertionError(f"only {len(picked)} four-word queries in the batch")
    return picked


def serve(searcher, queries: list[str], singles: list[str]):
    """The batch, then each singleton alone: (batch, batch ms, singleton
    outcomes, singleton ms)."""
    batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
    solo, single_ms = [], []
    for q in singles:
        out, t = timed(lambda q=q: searcher.search_batch([q], k=K))
        solo.append(out[0])
        single_ms.append(t)
    return batch, batch_ms, solo, single_ms


def check_singletons(what: str, queries, batch, singles, solo, *, lanes_only: bool = False) -> None:
    """Each singleton equals its batch row bitwise. With ``lanes_only``,
    where the batch's lexical budget (its largest class multiplier)
    differs from the singleton's own, only the lane bits are held: every
    doc in both lists has the same lexical and vector score bits."""
    for q, one in zip(singles, solo):
        want = rows_of(batch[queries.index(q)])
        got = rows_of(one)
        if not lanes_only:
            if got != want:
                raise AssertionError(f"{what}: singleton {q!r} differs from its batch row")
            continue
        lanes = {r[0]: r[2:] for r in want}
        shared = [r for r in got if r[0] in lanes]
        if not shared or any(lanes[r[0]] != r[2:] for r in shared):
            raise AssertionError(f"{what}: singleton {q!r} lane scores differ from its batch row")


def class_budgets(queries: list[str]) -> tuple[float, float]:
    """The (vector, lexical) budget multipliers ``search_batch`` gives a
    batch: the largest over its queries' classes."""
    from frankensearch_tpu_torch.core.canonicalize import DefaultCanonicalizer
    from frankensearch_tpu_torch.core.parsed_query import ParsedQuery
    from frankensearch_tpu_torch.core.query_class import QueryClass

    canon = DefaultCanonicalizer()
    classes = [QueryClass.classify(ParsedQuery.parse(canon.canonicalize_query(q)).positive or q) for q in queries]
    live = [c for c in classes if c is not QueryClass.EMPTY]
    return (max(c.semantic_budget_multiplier() for c in live), max(c.lexical_budget_multiplier() for c in live))


def check_singletons_by_budget(what: str, queries, batch, singles, solo) -> int:
    """Each singleton against its batch row: bitwise, which must hold where
    its class budgets are the batch's; where the batch's pools are deeper,
    a doc may hold a lane score in one list only, and every lane score
    that a doc holds in both has the same bits. Returns how many were
    bitwise."""
    batch_budgets = class_budgets(queries)
    bitwise = 0
    for q, one in zip(singles, solo):
        want = rows_of(batch[queries.index(q)])
        if rows_of(one) == want:
            bitwise += 1
            continue
        if class_budgets([q]) == batch_budgets:
            raise AssertionError(f"{what}: singleton {q!r} differs from its batch row")
        lanes = {r[0]: r[2:] for r in want}
        pairs = [(a, b) for r in rows_of(one) if r[0] in lanes
                 for a, b in zip(r[2:], lanes[r[0]]) if a is not None and b is not None]
        if not pairs or any(a != b for a, b in pairs):
            raise AssertionError(f"{what}: singleton {q!r} lane scores differ from its batch row")
    return bitwise


def check_int8_kernels(cell: str, slab_i8, scale, mask, shapes: set) -> list[dict]:
    """Phase 1 for the int8 lane: K4 against its twin, bitwise, and K2's
    int8 form within REL_TOL, at each (B, kk) ``drive`` noted, with seeded
    unit queries prepared as the lane prepares them. A batch that K2-i8
    takes in group order is also held bitwise to its rows' B=8 calls, taken
    in pair order: a row's scores must not depend on its batchmates."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for name in ("group_max_int8", "gather_rescore_i8"):
        if not any(s[0] == name for s in shapes):
            raise AssertionError(f"phase1 {cell}: the main path gave {name} no shape")
    gen = torch.Generator(device=slab_i8.device).manual_seed(SEED + 5)
    n, d = slab_i8.shape
    recs = []
    for b in sorted({s[1] for s in shapes if s[0] == "group_max_int8"}, reverse=True):
        q = unit_rows(gen, b, d, slab_i8.device)
        q_i8 = ts.prepare_query_int8(q, scale)
        gm = ts.group_max_int8(slab_i8, q_i8, mask)
        want = ts.group_max_int8_plain(slab_i8, q_i8, mask)
        if not torch.equal(gm.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"phase1 {cell} K4 B={b}: not bitwise (max err {(gm - want).abs().max().item():.3e})")
        recs.append({"kernel": "group_max_int8", "cell": cell, "n": n, "b": b, "kk": None,
                     "ms": cuda_median_ms(lambda: ts.group_max_int8(slab_i8, q_i8, mask)),
                     "plain_ms": cuda_median_ms(lambda: ts.group_max_int8_plain(slab_i8, q_i8, mask)),
                     "max_abs_err": 0.0,
                     "bound": bound(nbytes(slab_i8, q_i8, mask, gm), 2 * b * n * d, "int8")})
        q_scaled = q * scale
        for kk in sorted(s[2] for s in shapes if s[0] == "gather_rescore_i8" and s[1] == b):
            _, groups = ts.topk_desc_rowasc(gm, kk)
            groups = torch.sort(groups.to(torch.int32), dim=1).values
            r = ts.gather_rescore_i8(slab_i8, q_scaled, groups)
            err = check_close(r, ts.gather_rescore_i8_plain(slab_i8, q_scaled, groups),
                              f"phase1 {cell} K2-i8 B={b} kk={kk}")
            if b >= ts.GATHER_I8_GROUP_MIN_B:
                eights = torch.cat([ts.gather_rescore_i8(slab_i8, q_scaled[i : i + 8], groups[i : i + 8])
                                    for i in range(0, b, 8)])
                if not torch.equal(r.view(torch.int32), eights.view(torch.int32)):
                    raise AssertionError(f"phase1 {cell} K2-i8 B={b} kk={kk}: the batch's bits differ from its "
                                         f"rows' B=8 calls")
                log(f"phase1 {cell} K2-i8 B={b} kk={kk}: bitwise its {len(range(0, b, 8))} B=8 calls")
            recs.append({"kernel": "gather_rescore_i8", "cell": cell, "n": n, "b": b, "kk": kk,
                         "ms": cuda_median_ms(lambda: ts.gather_rescore_i8(slab_i8, q_scaled, groups)),
                         "plain_ms": cuda_median_ms(lambda: ts.gather_rescore_i8_plain(slab_i8, q_scaled, groups)),
                         "max_abs_err": err,
                         "bound": bound(gathered_bytes(slab_i8, groups) + nbytes(q_scaled, groups, r),
                                        2 * r.numel() * d, "f32")})
    log_kernel_records(cell, recs)
    return recs


def check_tile_rows(slab, q, mask, got_s, got_i, what: str) -> None:
    """Every finite per-tile candidate of K5 names a distinct row of its
    tile whose plain score is the candidate's score within REL_TOL."""
    import torch

    t, kk, b = got_s.shape
    full = q.to(slab.dtype).to(torch.float32) @ slab.to(torch.float32).T + mask[None, :]
    rows = got_i.permute(2, 0, 1).reshape(b, t * kk).to(torch.int64)
    got = got_s.permute(2, 0, 1).reshape(b, t * kk)
    fin = torch.isfinite(got)
    check_close(torch.gather(full, 1, rows)[fin], got[fin], f"{what} (rows)")
    tile_of = torch.arange(t, device=slab.device).repeat_interleave(kk)[None, :] * 2048
    if bool(((rows < tile_of) | (rows >= tile_of + 2048))[fin].any()):
        raise AssertionError(f"{what}: a candidate row lies outside its tile")
    pad = -1 - torch.arange(t * kk, device=slab.device)[None, :]  # distinct stand-ins
    keyed = torch.sort(torch.where(fin, rows, pad).view(b, t, kk), dim=2).values
    if bool((keyed[:, :, 1:] == keyed[:, :, :-1]).any()):
        raise AssertionError(f"{what}: a row appears twice in one tile's candidates")


def check_tile_kernel(cell: str, slab, mask, shapes: set, *, edges: bool = True) -> list[dict]:
    """Phase 1 for K5: the kernel against its twin at each (B, kk)
    ``drive`` noted, with seeded unit queries. The twin's and the kernel's
    f32 sums differ in order, so near ties may swap: the sorted scores of
    each (tile, query) agree within REL_TOL position by position, and every
    candidate row the kernel names is a distinct row of its tile whose
    plain score is the kernel's. The kernel's scores are K1's bits: each
    (tile, query)'s first candidate is bitwise the largest of K1's 16 group
    maxima over the tile. Then, with ``edges``, :func:`check_tile_edges`."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    todo = sorted((s[1], s[2]) for s in shapes if s[0] == "tile_topk")
    if not todo:
        raise AssertionError(f"phase1 {cell}: the main path gave tile_topk no shape")
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 6)
    n, d = slab.shape
    kind, form = kernel_form(slab)
    recs = []
    for b, kk in reversed(todo):
        q = unit_rows(gen, b, d, slab.device)
        got_s, got_i = ts.tile_topk(slab, q, mask, kk)
        want_s, _ = ts.tile_topk_plain(slab, q, mask, kk)
        err = check_close(got_s, want_s, f"phase1 {cell} K5 B={b} kk={kk}")
        check_tile_rows(slab, q, mask, got_s, got_i, f"phase1 {cell} K5 B={b} kk={kk}")
        del want_s
        k1_first = ts.group_max(slab, q, mask).view(b, n // ts.TILE_N, ts.TILE_N // ts.GROUP).amax(dim=2)
        if not torch.equal(got_s[:, 0, :].T.contiguous().view(torch.int32), k1_first.view(torch.int32)):
            raise AssertionError(f"phase1 {cell} K5 B={b} kk={kk}: a first candidate is not K1's tile maximum")
        recs.append({"kernel": "tile_topk" + form, "cell": cell, "n": n, "b": b, "kk": kk,
                     "ms": cuda_median_ms(lambda: ts.tile_topk(slab, q, mask, kk)),
                     "plain_ms": cuda_median_ms(lambda: ts.tile_topk_plain(slab, q, mask, kk), warmup=1, iters=5),
                     "max_abs_err": err,
                     # the selection moves no device memory: bytes and the scan's products
                     "bound": bound(nbytes(slab, q, mask, got_s, got_i), 2 * b * n * d, kind)})
    log_kernel_records(cell, recs)
    log(f"phase1 {cell} K5 first candidates bitwise equal to K1's tile maxima at (B, kk) {todo}")
    if edges:
        check_tile_edges(slab.device)
    return recs


#: the (B, kk) of K5's edge check: a ragged query tile, kk = 1 and 2, the
#: searcher's budgets, the list entry's widest kk and the wide entry's
EDGE_B = 70
EDGE_KKS = (1, 2, 30, 60, 64, 65, 2048)


def adversarial_tile_inputs(n_tiles: int, d: int, b: int, seed: int):
    """Seeded K5 inputs whose every score is exact in f32, so any summation
    order gives the same bits: slab entries are multiples of 1/8 in
    [-1/4, 1/4] and query entries integers in [-2, 2] (both exact in bf16
    and f16). Exact ties: every tile repeats 64 of its rows at 3 other
    columns each, query row 1 is zero (every score of a tile ties), and the
    values are coarse. About 10% of the rows are masked; tile 1 is masked
    whole; tile 2 holds only three finite rows, so kk above 3 reaches the
    -inf column-0 padding. Returns numpy (slab f32 (n_tiles*2048, d),
    queries f32 (b, d), additive mask f32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = n_tiles * 2048
    slab = rng.integers(-2, 3, size=(n, d), dtype=np.int8).astype(np.float32) * np.float32(0.125)
    for t in range(n_tiles):
        for src in rng.choice(2048, 64, replace=False):
            slab[t * 2048 + rng.choice(2048, 3, replace=False)] = slab[t * 2048 + src]
    q = rng.integers(-2, 3, size=(b, d)).astype(np.float32)
    if b > 1:
        q[1] = 0.0
    mask = np.where(rng.random(n) < 0.1, -np.inf, 0.0).astype(np.float32)
    if n_tiles > 1:
        mask[2048:4096] = -np.inf
    if n_tiles > 2:
        mask[4096:6144] = -np.inf
        mask[4096 + np.array([5, 700, 2047])] = 0.0
    return slab, q, mask


def check_tile_edges(dev) -> None:
    """K5's edge cases on the card: :func:`adversarial_tile_inputs` over 8
    tiles at B = EDGE_B (a full and a ragged 64-query tile), bf16, f16 and
    f32, every kk of EDGE_KKS (both entries of the kernel): rows and score
    bits equal to the twin's, and each first candidate bitwise K1's tile
    maximum."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    slab_np, q_np, mask_np = adversarial_tile_inputs(8, DIM, EDGE_B, SEED + 9)
    q, mask = torch.from_numpy(q_np).to(dev), torch.from_numpy(mask_np).to(dev)
    wide0 = ts.tile_topk.wide_launches
    dtypes = (torch.bfloat16, torch.float16, torch.float32)
    for dtype in dtypes:
        slab = torch.from_numpy(slab_np).to(dev, dtype)
        k1_first = ts.group_max(slab, q, mask).view(EDGE_B, 8, 16).amax(dim=2)
        for kk in EDGE_KKS:
            got_s, got_i = ts.tile_topk(slab, q, mask, kk)
            want_s, want_i = ts.tile_topk_plain(slab, q, mask, kk)
            if not (torch.equal(got_i, want_i) and torch.equal(got_s.view(torch.int32), want_s.view(torch.int32))):
                bad = (got_i != want_i) | (got_s.view(torch.int32) != want_s.view(torch.int32))
                raise AssertionError(f"phase1 K5 edges {dtype} kk={kk}: {int(bad.sum())} entries differ from the twin, "
                                     f"first at {bad.nonzero()[0].tolist()}")
            if not torch.equal(got_s[:, 0, :].T.contiguous().view(torch.int32), k1_first.view(torch.int32)):
                raise AssertionError(f"phase1 K5 edges {dtype} kk={kk}: a first candidate is not K1's tile maximum")
    if ts.tile_topk.wide_launches - wide0 != len(dtypes) * sum(kk > ts.TILE_TOPK_LIST_K for kk in EDGE_KKS):
        raise AssertionError("phase1 K5 edges: the wide entry did not run for every kk above the list entry's")
    log(f"phase1 K5 edges (8 tiles x {DIM}, B={EDGE_B}, ties, masked rows, a masked tile, a 3-row tile; "
        f"kk {list(EDGE_KKS)}, bf16, f16 and f32, list and wide entries): rows and score bits equal to the twin's, "
        "first candidates equal to K1's tile maxima")


def phase5_scan_modes(dev, tmp: str, semantic: dict, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """The int8 capacity lane (fast-only, hybrid, certified and gated,
    reopened) and the per-tile top-k lane, over phase 2's vectors and
    queries and phase 4's lexical arm, through the unfused path."""
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.core.errors import UncertifiedScanMode

    vecs, emb, queries = semantic["vecs"], semantic["emb"], semantic["queries"]
    bm25, h_queries, h_pools = lexical["bm25"], lexical["queries"], lexical["pools"]
    root = os.path.join(tmp, "int8")
    t0 = time.perf_counter()
    index8 = TwoTierIndex.create(root, vecs, [f"doc-{i:07d}" for i in range(N_DOCS)], emb.identity(),
                                 device=dev, slab_dtype="int8")
    build_s = time.perf_counter() - t0
    slab_i8, scale = index8.fast._int8
    log(f"phase5 int8 index build {build_s:.1f} s: int8 slab {nbytes(slab_i8)} bytes beside the "
        f"bf16 slab's {nbytes(index8.fast.slab)}")
    shapes: set = set()
    launches: dict = {}

    def count(phase, got, names):
        need_launches(phase, got, names)
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n

    singles = four_word_singletons(queries)
    rec = {"build_s": build_s, "int8_slab_bytes": nbytes(slab_i8), "bf16_slab_bytes": nbytes(index8.fast.slab)}

    # int8, fast-only
    cfg8 = TwoTierConfig(fast_only=True, scan_mode="int8")
    fast = TwoTierSearcher(index8, emb, config=cfg8)
    drive(lambda: fast.search_batch(queries[:8], k=K), shapes)  # warm-up
    (batch8, ms, solo, single_ms), got = drive(lambda: serve(fast, queries, singles), shapes)
    count("phase5 int8", got, ("K4", "K2-i8"))
    recall8 = recall_at_k(batch8, semantic["exact_ids"])
    log(f"phase5 int8 fast-only B=256: {ms:.2f} ms; singletons: " + ", ".join(f"{t:.2f}" for t in single_ms)
        + f" ms; recall@10 vs exact f32 scan {recall8:.4f}")
    if recall8 < INT8_RECALL_FLOOR:
        raise AssertionError(f"phase5: int8 recall@10 {recall8} < {INT8_RECALL_FLOOR}")
    check_singletons("phase5 int8", queries, batch8, singles, solo)
    rec["int8"] = {"batch_ms": ms, "single_ms": single_ms, "recall_at_10": recall8}

    # int8, hybrid with phase 4's lexical arm (the unfused path)
    hybrid = TwoTierSearcher(index8, emb, lexical=bm25, config=cfg8)
    h_singles = four_word_singletons(h_queries)
    drive(lambda: hybrid.search_batch(h_queries[:8], k=K), shapes)  # warm-up
    pools: dict = {}
    lex_batch = bm25.search_candidates_batch

    def lex_noted(texts, budget):  # the batch's lexical pools
        out = lex_batch(texts, budget)
        if not pools:
            pools.update({j: [(c.doc_id, c.score) for c in row] for j, row in enumerate(out)})
        return out

    bm25.search_candidates_batch = lex_noted
    try:
        (h_batch, h_ms, h_solo, h_single_ms), got = drive(lambda: serve(hybrid, h_queries, h_singles), shapes)
    finally:
        del bm25.search_candidates_batch
    count("phase5 int8 hybrid", got, ("K4", "K2-i8"))
    if any(o.metrics.phase1_fused for o in h_batch) or hybrid.last_fusion_path is not None:
        raise AssertionError("phase5: the int8 hybrid batch did not take the unfused path")
    if len(pools) != len(h_queries) or len(h_pools) != len(h_queries):
        raise AssertionError(f"phase5: {len(pools)} lexical pools here, {len(h_pools)} in phase 4")
    for j in range(len(h_queries)):
        same_ranking(pools[j], h_pools[j], LEX_REL_TOL, f"phase5 lexical pool of query {j}")
    check_singletons("phase5 int8 hybrid", h_queries, h_batch, h_singles, h_solo, lanes_only=True)
    log(f"phase5 int8 hybrid B=256: {h_ms:.2f} ms; singletons: " + ", ".join(f"{t:.2f}" for t in h_single_ms)
        + f" ms; {len(pools)} lexical pools equal to phase 4's within {LEX_REL_TOL:g}")
    rec["int8_hybrid"] = {"batch_ms": h_ms, "single_ms": h_single_ms}

    # certify, serve behind the gate, reopen with the persisted certificate
    t0 = time.perf_counter()
    cert = index8.certify_fast_scan_mode("int8", K, emb.embed_batch(queries))
    cert_s = time.perf_counter() - t0
    # the floor: the 5% quantile of 256 per-query recall@10 values, a
    # multiple of 0.1, sits at 0.9 or 1.0 when the mean is near 0.99; 0.8
    # keeps the check on the gate's mechanics, not on a tuned floor
    gated_cfg = TwoTierConfig(fast_only=True, scan_mode="int8", require_recall_certificate=True,
                              min_certified_recall=0.8)
    refusing = TwoTierSearcher(index8, emb, config=TwoTierConfig(
        fast_only=True, scan_mode="int8", require_recall_certificate=True, min_certified_recall=1.01))
    try:
        refusing.search_batch(queries[:8], k=K)
    except UncertifiedScanMode as e:
        log(f"phase5 gate refuses an unmeetable floor: {e}")
    else:
        raise AssertionError("phase5: the gate served below its floor")
    gated = TwoTierSearcher(index8, emb, config=gated_cfg)
    (g_batch, g_ms), got = drive(lambda: timed(lambda: gated.search_batch(queries, k=K)), shapes)
    count("phase5 int8 gated", got, ("K4", "K2-i8"))
    reopened = TwoTierIndex.open(root, device=dev)
    if reopened.fast.recall_certificate("int8") != cert:
        raise AssertionError("phase5: the reopened index did not rebind the persisted certificate")
    r_batch = TwoTierSearcher(reopened, emb, config=gated_cfg).search_batch(queries, k=K)
    for j, (a, b, c) in enumerate(zip(batch8, g_batch, r_batch)):
        if not rows_of(a) == rows_of(b) == rows_of(c):
            raise AssertionError(f"phase5: gated or reopened query {j} differs from the ungated batch")
    log(f"phase5 certificate ({cert_s:.1f} s): certified recall@{cert.k} {cert.certified_recall:.4f} "
        f"(mean {cert.mean_recall:.4f}) at confidence {cert.confidence}; gated B=256 {g_ms:.2f} ms; "
        "rebound after reopen; gated and reopened results equal to the ungated batch")
    rec["certificate"] = {**cert.to_record(), "certify_s": cert_s, "gated_batch_ms": g_ms}
    del reopened, r_batch

    # the per-tile top-k lane over phase 2's bf16 index
    tiles = TwoTierSearcher(semantic["index"], emb, config=TwoTierConfig(fast_only=True, scan_mode="pallas"))
    drive(lambda: tiles.search_batch(queries[:8], k=K), shapes)  # warm-up
    (p_batch, p_ms, p_solo, p_single_ms), got = drive(lambda: serve(tiles, queries, singles), shapes)
    count("phase5 pallas", got, ("K5",))
    recall_p = recall_at_k(p_batch, semantic["exact_ids"])
    if recall_p < 0.99:
        raise AssertionError(f"phase5: pallas recall@10 {recall_p} < 0.99")
    for j, (out, want) in enumerate(zip(p_batch, semantic["rows"])):
        same_ranking([(r[0], r[3]) for r in rows_of(out)], [(r[0], r[3]) for r in want],
                     REL_TOL, f"phase5 pallas query {j} vs the K1/K2 lane")
    check_singletons("phase5 pallas", queries, p_batch, singles, p_solo)
    log(f"phase5 pallas B=256: {p_ms:.2f} ms; singletons: " + ", ".join(f"{t:.2f}" for t in p_single_ms)
        + f" ms; recall@10 {recall_p:.4f}; top-10 equal to the K1/K2 lane's up to ties within {REL_TOL:g}")
    rec["pallas"] = {"batch_ms": p_ms, "single_ms": p_single_ms, "recall_at_10": recall_p}
    log(f"phase5 launches on the main path: {launches}")

    mask8 = index8.fast._effective_mask(None, None)
    kernels = check_int8_kernels("semantic-1M-int8", slab_i8, scale, mask8, shapes)
    kernels += check_tile_kernel("semantic-1M", semantic["index"].fast.slab,
                                 semantic["index"].fast._effective_mask(None, None), shapes)
    del fast, hybrid, gated, tiles, index8
    torch.cuda.empty_cache()
    return rec, launches, kernels


def check_group_ids(gm, got_g, want_g, what: str) -> int:
    """K6's group ids against its twin's, (T, t, B) each: equal, except
    where the two groups' maxima (``gm``, the twin's (B, n_groups)) tie
    within REL_TOL. Returns how many positions differ."""
    import torch

    diff = got_g != want_g
    if not bool(diff.any()):
        return 0
    q = torch.arange(gm.shape[0], device=gm.device)[None, None, :].expand_as(got_g)[diff]
    a, w = gm[q, got_g[diff].long()], gm[q, want_g[diff].long()]
    fin = torch.isfinite(w)
    if not torch.equal(torch.isfinite(a), fin) or bool(
        ((a - w).abs() > REL_TOL * w.abs().clamp(min=1.0))[fin].any()
    ):
        raise AssertionError(f"{what}: a group id differs from the twin's away from a tie")
    return int(diff.sum())


#: the values crafted K6 maxima take: ties, both zeros, -inf (masked
#: groups) and +inf
SELECT_POOL = (float("-inf"), -1.5, -0.25, -0.0, 0.0, 0.25, 1.0, 3.0, float("inf"))
#: (tile_n, t) at which K6's selection is held to its twin on crafted maxima
SELECT_EDGES = ((8192, 1), (8192, 30), (8192, 60), (8192, 64), (2048, 1), (2048, 7), (2048, 16))


def crafted_maxima(b: int, n_tiles: int, g: int, seed: int):
    """Seeded (b, n_tiles * g) f32 group maxima for K6's selection: each
    row draws from SELECT_POOL with weights of its own, so equal maxima
    share a tile, +0.0 and -0.0 fall in one tie class in either group order
    and -inf groups lie between finite ones; tile 1 is -inf whole (a masked
    tile), tile 2 holds only zeros of both signs, and query 0's tile 0 opens
    with +0.0, -0.0, +0.0, -0.0 (query 1's with the signs swapped).
    Returns numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = np.array(SELECT_POOL, np.float32)
    weights = rng.dirichlet(np.ones(len(pool)), size=b)
    gm = np.stack([pool[rng.choice(len(pool), size=n_tiles * g, p=w)] for w in weights])
    if n_tiles > 1:
        gm[:, g : 2 * g] = -np.inf
    if n_tiles > 2:
        gm[:, 2 * g : 3 * g] = np.where(rng.random((b, g)) < 0.5, np.float32(0.0), np.float32(-0.0))
    if g >= 4:
        gm[0, :4] = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
        if b > 1:
            gm[1, :4] = np.array([-0.0, 0.0, -0.0, 0.0], np.float32)
    return gm


def check_select_edges(dev) -> None:
    """K6's selection kernel (``tile_select``) on :func:`crafted_maxima`
    (B = 70 over 4 tiles; every (tile_n, t) of SELECT_EDGES): values and
    group ids bitwise its twin's, the argmax passes."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    for i, (tile_n, t) in enumerate(SELECT_EDGES):
        gm = torch.from_numpy(crafted_maxima(70, 4, tile_n // ts.GROUP, SEED + 11 + i)).to(dev)
        got_v, got_g = ts.tile_select(gm, t, tile_n)
        want_v, want_g = ts.tile_select_plain(gm, t, tile_n)
        if not (torch.equal(got_g, want_g) and torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))):
            bad = (got_g != want_g) | (got_v.view(torch.int32) != want_v.view(torch.int32))
            raise AssertionError(f"phase1 K6 selection tile_n={tile_n} t={t}: {int(bad.sum())} entries differ "
                                 f"from the passes, first at {bad.nonzero()[0].tolist()}")
    log(f"phase1 K6 selection on crafted maxima (B=70, 4 tiles: ties, +0.0/-0.0 in both orders, -inf between "
        f"finite groups, a masked tile, a tile of zeros; (tile_n, t) {list(SELECT_EDGES)}): values and group ids "
        "bitwise the argmax passes'")


def check_candidate_kernel(cell: str, slab, mask, q_all, ts_bk: list) -> list[dict]:
    """Phase 1 for K6: the kernel against its twin at each (B, t) phase 6
    ran it with, on phase 6's queries: values within REL_TOL, group ids
    equal except at ties, and every finite value the K1 maximum of its
    group, bit for bit (K6 scores with K1's kernel). Times are CUDA-event
    medians: K6's whole wrapper (K1's scan and the selection), and K1 alone
    at the same B (``k1_ms``), which gives the selection's share."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    n, d = slab.shape
    kind = "bf16" if slab.dtype == torch.bfloat16 else "f16"
    recs = []
    for b, t in sorted(ts_bk, reverse=True):
        q = q_all[:b]
        got_v, got_g = ts.group_candidates(slab, q, mask, t, AB_TILE)
        want_v, want_g = ts.group_candidates_plain(slab, q, mask, t, AB_TILE)
        what = f"phase1 {cell} K6 B={b} t={t}"
        err = check_close(got_v, want_v, what)
        swapped = check_group_ids(ts.group_max_plain(slab, q, mask), got_g, want_g, what)
        gm = ts.group_max(slab, q, mask)
        k1 = gm[torch.arange(b, device=slab.device)[None, None, :].expand_as(got_g), got_g.long()]
        fin = torch.isfinite(got_v)
        if not torch.equal(k1[fin].view(torch.int32), got_v[fin].view(torch.int32)):
            raise AssertionError(f"{what}: a value is not K1's maximum of its group")
        del want_v, want_g, gm, k1
        recs.append({"kernel": "group_candidates", "cell": cell, "n": n, "b": b, "kk": t,
                     "ms": cuda_median_ms(lambda: ts.group_candidates(slab, q, mask, t, AB_TILE)),
                     "plain_ms": cuda_median_ms(lambda: ts.group_candidates_plain(slab, q, mask, t, AB_TILE),
                                                warmup=1, iters=5),
                     "max_abs_err": err, "ids_swapped_at_ties": swapped,
                     "k1_ms": cuda_median_ms(lambda: ts.group_max(slab, q, mask)),
                     # the selection's compares are extra work the bound does not count
                     "bound": bound(nbytes(slab, q, mask, got_v, got_g), 2 * b * n * d, kind)})
    log_kernel_records(cell, recs)
    for r in recs:
        log(f"phase1 {cell} K6 B={r['b']} t={r['kk']}: K1 alone {r['k1_ms']:.4f} ms, the selection "
            f"{r['ms'] - r['k1_ms']:.4f} ms of K6's {r['ms']:.4f}")
    return recs


def phase6_ab_scan(dev, semantic: dict) -> tuple[dict, dict, list[dict]]:
    """The A/B scan lane over phase 2's slab and queries: the K6 route
    (``emit="tile_topk"``) at every (B, k), held bitwise to the K1/K2
    route; ``group_select="iter"`` likewise; ``rescore="xla"`` to the f32
    rescore of K1's groups; then K6 against its twin."""
    import torch

    from frankensearch_tpu_torch.ops import ab_primitives as ab
    from frankensearch_tpu_torch.ops import topk_scan as ts

    fast = semantic["index"].fast
    slab, mask = fast.slab, fast._effective_mask(None, None)
    n_groups = slab.shape[0] // ts.GROUP
    q_all = torch.from_numpy(semantic["emb"].embed_batch(semantic["queries"])).to(dev)
    shapes: set = set()
    cases = [(b, k) for b in AB_BATCHES for k in AB_KS]
    for b, k in cases:
        if (slab.shape[0] // AB_TILE) * min(k, AB_TILE // ts.GROUP) >= n_groups:
            raise AssertionError(f"phase6: B={b} k={k} would not take the narrowing branch")
    ab.scan_topk_hierarchical_ab(slab, q_all[:8], K, mask, emit="tile_topk")  # warm-up

    def main_path():
        return {(b, k): ab.scan_topk_hierarchical_ab(slab, q_all[:b], k, mask, emit="tile_topk")
                for b, k in cases}

    (got, ms), launches = drive(lambda: timed(main_path), shapes)
    log(f"phase6 A/B scan emit=tile_topk over {len(cases)} (B, k): {ms:.2f} ms; launches {launches}")
    need_launches("phase6", launches, ("K6", "K2"))
    if launches["K6"] != len(cases) or launches["K1"] != 0:
        raise AssertionError(f"phase6: the narrowing branch did not run for every case ({launches})")

    # checks (comparison runs; not counted)
    for (b, k), res in got.items():
        q = q_all[:b]
        want = ts.scan_topk_hierarchical(slab, q, k, mask)
        it = ab.scan_topk_hierarchical_ab(slab, q, k, mask, group_select="iter")
        for name, r in (("tile_topk", res), ("iter", it)):
            if not (torch.equal(r.indices, want.indices)
                    and torch.equal(r.scores.view(torch.int32), want.scores.view(torch.int32))):
                raise AssertionError(f"phase6 {name} B={b} k={k}: not bitwise the K1/K2 route")
        x6 = ab.scan_topk_hierarchical_ab(slab, q, k, mask, emit="tile_topk", rescore="xla")
        x1 = ab.scan_topk_hierarchical_ab(slab, q, k, mask, rescore="xla")
        for j in range(b):
            same_ranking(list(zip(x6.indices[j].tolist(), x6.scores[j].tolist())),
                         list(zip(x1.indices[j].tolist(), x1.scores[j].tolist())),
                         1e-6, f"phase6 xla B={b} k={k} query {j}")
        rows = x6.indices.to(torch.int64)
        exact = torch.einsum("bd,bkd->bk", q.double(), slab[rows.clamp(min=0)].double())
        if bool(((x6.scores.double() - exact).abs() > 1e-6 * exact.abs().clamp(min=1.0))[rows >= 0].any()):
            raise AssertionError(f"phase6 xla B={b} k={k}: scores off the f64 dot products")
    log(f"phase6 emit=tile_topk and group_select=iter bitwise equal to the K1/K2 route at "
        f"B={list(AB_BATCHES)}, k={list(AB_KS)}; rescore=xla equal to the f32 rescore of K1's "
        "groups up to 1e-6 ties and within 1e-6 of f64 dot products")
    head_q = q_all[: max(AB_BATCHES)]
    route_ms = {
        "ab_tile_topk": cuda_median_ms(lambda: ab.scan_topk_hierarchical_ab(slab, head_q, max(AB_KS), mask,
                                                                            emit="tile_topk")),
        "k1_k2": cuda_median_ms(lambda: ts.scan_topk_hierarchical(slab, head_q, max(AB_KS), mask)),
    }
    log(f"phase6 scan at B={max(AB_BATCHES)} k={max(AB_KS)}: K6 route {route_ms['ab_tile_topk']:.4f} ms, "
        f"K1/K2 route {route_ms['k1_k2']:.4f} ms")
    # K2 at the (B, kk) this lane gave it that phase 2 did not (K1's groups
    # seed its inputs; K1 itself did not run here)
    k1_shapes = {("group_max", b, 0) for b in AB_BATCHES}
    kernels = check_kernels("semantic-1M", slab, mask, k1_shapes | {("gather_rescore", b, k) for b, k in cases},
                            k1_shapes | semantic["shapes"])
    kernels += check_candidate_kernel("semantic-1M", slab, mask, q_all,
                                      sorted({(b, min(k, AB_TILE // ts.GROUP)) for b, k in cases}))
    check_select_edges(dev)
    torch.cuda.empty_cache()
    return {"batch_ms": ms, "scan_ms_b256_k60": route_ms}, launches, kernels


class HostEmbedder:
    """The Model2Vec embedder behind a plain interface, so the searcher
    embeds on the host (``embed_batch``) and takes the scan + BM25 lane."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self.dim, self.embedder_id, self.revision, self.is_semantic = (
            inner.dim, inner.embedder_id, inner.revision, True)

    def identity(self):
        return self._inner.identity()

    def embed_batch(self, texts):
        return self._inner.embed_batch(texts)


def m2v_embedder(dev):
    """hybrid-1M-m2v's fast tier: a seeded M2V_ROWS x DIM Model2Vec table
    (the reference's numpy draw, bf16 on ``dev``) over phase 4's words
    w00000..w49999, then filler words."""
    from frankensearch_tpu_torch.embed.model2vec import random_model2vec

    vocab = [f"w{i:05d}" for i in range(H1M_VOCAB)] + [f"f{i:06d}" for i in range(M2V_ROWS - H1M_VOCAB)]
    return random_model2vec(vocab, dim=DIM, seed=SEED + 7, device=dev)


def check_pool_calls(cell: str, calls: list, launches: int) -> None:
    """Hold every Model2Vec pool call of a run (:func:`drive`'s
    ``pool_calls``) to its plain twin on the same table, ids and mask: the
    same bits. Every launch the counter saw has to be among them."""
    import torch

    from frankensearch_tpu_torch.embed import model2vec

    if len(calls) != launches:
        raise AssertionError(f"{cell}: {launches} pool launches, {len(calls)} of them seen")
    shapes: dict = {}
    for emb, ids, mask, out in calls:
        want = model2vec.gather_pool_normalize_plain(emb, ids, mask)
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{cell} pool B={ids.shape[0]} T={ids.shape[1]}: the kernel's bits differ "
                                 "from the twin's")
        key = (tuple(emb.shape), emb.dtype, *ids.shape)
        shapes[key] = shapes.get(key, 0) + 1
    log(f"{cell} pool: {len(calls)} calls bitwise their twin's" + "".join(
        f"{', at (table, B, T)' if i == 0 else ','} {v}x{d} {str(dt).removeprefix('torch.')} {b}x{t} ({n})"
        for i, (((v, d), dt, b, t), n) in enumerate(sorted(shapes.items(), key=str))))


def pool_inputs(emb):
    """(B, T, ids, mask) on ``emb``'s device at each of :data:`POOL_SHAPES`:
    seeded prefix masks of 1 to the shape's token count, seeded ids under
    them and id 0 past them."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    for b, t, n_tok in POOL_SHAPES:
        lens = torch.randint(1, n_tok + 1, (b,), generator=gen)
        mask = (torch.arange(t)[None, :] < lens[:, None]).to(torch.int32)
        ids = (torch.randint(0, emb.shape[0], (b, t), generator=gen) * mask).to(torch.int32)
        yield b, t, ids.to(emb.device), mask.to(emb.device)


def check_pool_kernel(cell: str, emb) -> list[dict]:
    """The Model2Vec pool kernel against its plain twin on ``emb`` (the
    card's table) at :data:`POOL_SHAPES`, on seeded ids: the same bits, then
    CUDA-event medians of one call of each wrapper (``ms``, ``plain_ms``).
    At these sizes an event pair times the host's enqueue, not the kernel:
    ``python3 profile_chip.py --pool`` gives the device time, in a process
    of its own (the profiler stays out of this one until phase 9). The bound is the
    bytes the call must move: the gathered rows (masked positions included),
    the ids, the mask and the output."""
    import torch

    from frankensearch_tpu_torch.embed import model2vec

    v, d = emb.shape
    recs = []
    for b, t, ids, mask in pool_inputs(emb):
        got = model2vec.gather_pool_normalize(emb, ids, mask)
        want = model2vec.gather_pool_normalize_plain(emb, ids, mask)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"phase7 {cell} pool B={b} T={t}: the kernel's bits differ from the twin's")
        ms = cuda_median_ms(lambda: model2vec.gather_pool_normalize(emb, ids, mask))
        plain_ms = cuda_median_ms(lambda: model2vec.gather_pool_normalize_plain(emb, ids, mask))
        rec = {"kernel": "embed_pool", "cell": cell, "n": v, "b": b, "kk": None, "t": t, "ms": ms,
               "plain_ms": plain_ms, "max_abs_err": 0.0, "headline": b == 1,
               "bound": bound(b * t * d * emb.element_size() + nbytes(ids, mask, got), 0, "f32")}
        log(f"phase7 {cell} embed_pool V={v} D={d} B={b} T={t}: wrapper {ms:.4f} ms by CUDA events (twin "
            f"{plain_ms:.4f}; bound {rec['bound'][0]:.6f} by {rec['bound'][1]}), the twin's bits")
        recs.append(rec)
    return recs


def phase7_hybrid_m2v(dev, tmp: str, lexical: dict) -> tuple[dict, dict, list[dict], dict]:
    """hybrid-1M-m2v: phase 4's corpus and lexical arm with a seeded
    Model2Vec fast tier, served through the fully fused lane. Returns its
    record, launches and kernel records, and for phase 10 the embedder with
    the batch's and the singletons' result rows and lexical pools."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.embed import bulk
    from frankensearch_tpu_torch.embed.model2vec import gather_pool_normalize
    from frankensearch_tpu_torch.ops import topk_scan as ts

    bm25, queries, singles, texts = lexical["bm25"], lexical["queries"], lexical["singles"], lexical["texts"]
    t0 = time.perf_counter()
    m2v = m2v_embedder(dev)
    table_s = time.perf_counter() - t0
    if bulk.bag_embed_corpus(m2v, texts[:8]) is None:
        raise AssertionError("phase7: the bag lane does not apply (no native tokenizer)")
    vecs, embed_s = timed(lambda: bulk.embed_corpus(m2v, texts))
    again, embed2_s = timed(lambda: bulk.embed_corpus(m2v, texts))
    if not np.array_equal(vecs.view(np.uint32), again.view(np.uint32)):
        raise AssertionError("phase7: two embed_corpus runs gave different bits")
    del again
    sample = np.random.default_rng(SEED + 8).choice(len(texts), 4096, replace=False)
    cos = np.sum(vecs[sample] * m2v.embed_batch([texts[i] for i in sample]), axis=1)
    if cos.min() <= M2V_COS_FLOOR:
        raise AssertionError(f"phase7: bag lane vs embed_batch cosine {cos.min()} <= {M2V_COS_FLOOR}")
    docs_per_s = len(texts) / (embed2_s / 1000.0)
    log(f"phase7 Model2Vec table {M2V_ROWS} x {DIM} bf16 ({nbytes(m2v._emb)} bytes, {table_s:.1f} s); "
        f"embed_corpus of {len(texts)} docs {embed_s / 1000:.2f} s then {embed2_s / 1000:.2f} s "
        f"({docs_per_s:.0f} docs/s), the same bits both times; 4096-doc sample vs embed_batch "
        f"cosine >= {cos.min():.7f}")
    t0 = time.perf_counter()
    ids = [f"doc-{i:07d}" for i in range(len(texts))]  # phase 4's doc ids
    index = TwoTierIndex.create(os.path.join(tmp, "m2v"), vecs, ids, m2v.identity(), device=dev)
    build_s = time.perf_counter() - t0
    searcher = TwoTierSearcher(index, m2v, lexical=bm25, config=TwoTierConfig(fast_only=True))
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    lanes: list[str] = []
    embedded: list[bool] = []
    pools: dict = {}
    vec_hits: dict = {}
    fill = searcher._fill_fused

    def fill_noted(fused, live, *rest):  # the batch's lexical pools and vector hits
        if not pools:
            pools.update({i: [(c.doc_id, c.score) for c in fused[1][j]] for j, i in enumerate(live)})
            vec_hits.update({i: fused[0][j] for j, i in enumerate(live)})
        return fill(fused, live, *rest)

    def main_path():
        searcher._fill_fused = fill_noted
        try:
            batch, batch_ms = timed(lambda: searcher.search_batch(queries, k=K))
        finally:
            del searcher._fill_fused
        lanes.append(searcher.last_phase1_lex_lane)
        embedded.append(searcher.last_phase1_embed_fused)
        solo, single_ms = [], []
        for q in singles:
            out, t = timed(lambda q=q: searcher.search_batch([q], k=K))
            solo.append(out[0])
            single_ms.append(t)
            lanes.append(searcher.last_phase1_lex_lane)
            embedded.append(searcher.last_phase1_embed_fused)
        return batch, batch_ms, solo, single_ms

    flat_inputs: dict = {}
    pool_calls: list = []
    (batch, batch_ms, solo, single_ms), launches = drive(main_path, shapes, flat_inputs, pool_calls=pool_calls)
    log(f"phase7 search_batch B=256: {batch_ms:.2f} ms; singletons: "
        + ", ".join(f"{t:.2f}" for t in single_ms) + f" ms; lanes {lanes}")
    need_launches("phase7", launches, ("K1", "K2", "K3", "pool"))
    if not all(embedded) or not all(o.metrics.phase1_fused for o in batch + solo):
        raise AssertionError(f"phase7: the fully fused embed lane did not run every time ({embedded})")
    if not {"daat", "blocked", "mixed"} <= set(lanes):
        raise AssertionError(f"phase7: lanes {sorted(set(lanes))}, want daat, blocked and mixed")
    if searcher.last_fusion_path != "device":
        raise AssertionError(f"phase7: fusion path {searcher.last_fusion_path!r}, not device")
    bitwise = check_singletons_by_budget("phase7", queries, batch, singles, solo)
    if pools != lexical["pools"]:
        raise AssertionError("phase7: the lexical pools differ from phase 4's")
    log(f"phase7 fully fused embed lane for the batch and every singleton; {bitwise} of {len(singles)} "
        "singletons bitwise equal to their batch rows (required where their class budgets are the batch's), "
        "the others in every lane score both lists hold; the 256 lexical pools bitwise equal to phase 4's")

    # the vector arm's top-10 against exact scans of the pass's own query
    # vectors (the pool is batch-independent, so these are its bits): the
    # plain scan at the lane's precision (the query rounded to bf16, the
    # bf16 slab, f32 sums), and the f32 scan of the f32 doc vectors
    tok, msk = m2v.tokenize_batch(queries)
    qv = gather_pool_normalize(m2v._emb, torch.from_numpy(tok).to(dev), torch.from_numpy(msk).to(dev))
    got = [[int(h.doc_id[4:]) for h in vec_hits[j][:K]] for j in range(len(queries))]
    same_prec = ts.scan_topk_xla(index.fast.slab, qv, K, index.fast._effective_mask(None, None)).indices.cpu()
    vecs_dev = torch.from_numpy(vecs).to(dev)
    exact = ts.scan_topk_xla(vecs_dev, qv, K, precise=True).indices.cpu()
    recall_lane = float(np.mean([len(set(g) & set(same_prec[j].tolist())) / K for j, g in enumerate(got)]))
    recall = float(np.mean([len(set(g) & set(exact[j].tolist())) / K for j, g in enumerate(got)]))
    worst_gap = 0.0
    for j, g in enumerate(got):  # every miss against the f32 scan is a bf16 near tie
        missed = sorted(set(exact[j].tolist()) - set(g))
        if missed:
            sc = (vecs_dev[torch.tensor(g + missed, device=dev)].double() @ qv[j].double()).cpu()
            worst_gap = max(worst_gap, float(sc[len(g):].max() - sc[: len(g)].min()))
    log(f"phase7 vector recall@10 vs the plain scan at the lane's precision {recall_lane:.4f}; vs the exact f32 "
        f"scan {recall:.4f}, every miss within {worst_gap:.3e} of the lane's 10th doc's exact score "
        f"(bf16 rounding moves a score by up to {BF16_DOT_BOUND:.3e})")
    if recall_lane < 0.99:
        raise AssertionError(f"phase7: vector recall@10 vs the plain scan {recall_lane} < 0.99")
    if worst_gap > 2 * BF16_DOT_BOUND:
        raise AssertionError(f"phase7: a doc missed against the f32 scan leads by {worst_gap}, past bf16 rounding")
    del vecs_dev

    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    if searcher.last_fusion_path != "host":
        raise AssertionError(f"phase7: oracle fusion path {searcher.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(batch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase7: query {j} differs from the host RRF oracle: "
                                 f"{rows_of(out)} vs {rows_of(want)}")
    del searcher._device_rrf_tail
    log("phase7 fused rows and scores bitwise equal to the host RRF oracle")

    # the same batch embedded on the host first: embed_batch renormalizes
    # there, so a query vector may differ in its last bits, and where that
    # moves an element's bf16 rounding the scan scores differ by up to a
    # bf16 step of that element; where it moves none, the scan's inputs
    # are the same bits and so are its results
    q_host = torch.from_numpy(m2v.embed_batch(queries)).to(dev)
    same_q = (q_host.to(torch.bfloat16) == qv.to(torch.bfloat16)).all(dim=1).tolist()
    host = TwoTierSearcher(index, HostEmbedder(m2v), lexical=bm25, config=TwoTierConfig(fast_only=True))
    host_hits: dict = {}
    fill_h = host._fill_fused

    def fill_host(fused, live, *rest):
        host_hits.update({i: fused[0][j] for j, i in enumerate(live)})
        return fill_h(fused, live, *rest)

    host._fill_fused = fill_host
    h_batch = host.search_batch(queries, k=K)
    if host.last_phase1_embed_fused or not all(o.metrics.phase1_fused for o in h_batch):
        raise AssertionError("phase7: the host-embedded batch did not take the scan + BM25 lane")
    moved = 0
    for j in range(len(queries)):
        got_h = [(h.doc_id, h.score) for h in host_hits[j]]
        want_h = [(h.doc_id, h.score) for h in vec_hits[j]]
        if same_q[j]:
            if got_h != want_h or rows_of(h_batch[j]) != rows_of(batch[j]):
                raise AssertionError(f"phase7: query {j} differs from the host-embedded batch")
            continue
        same_ranking(got_h, want_h, BF16_DOT_BOUND, f"phase7 host-embedded vector hits of query {j}")
        moved += 1
    log(f"phase7 host-embedded batch: {len(queries) - moved} queries with the same bf16 query vector give "
        f"bitwise equal vector hits and results; {moved} whose host-normalized vector rounds an element to "
        f"another bf16 value give vector hits equal up to ties within {BF16_DOT_BOUND:.3e}")
    kernels = check_kernels("hybrid-1M-m2v", index.fast.slab, index.fast._effective_mask(None, None), shapes)
    check_pool_calls("phase7 hybrid-1M-m2v", pool_calls, launches["pool"])
    del pool_calls
    kernels += check_pool_kernel("hybrid-1M-m2v", m2v._emb)
    check_flat_kernel("hybrid-1M-m2v", bm25._blocked.classes, flat_inputs, timed=False)
    del searcher, host, index, vecs
    torch.cuda.empty_cache()
    return ({"batch_ms": batch_ms, "single_ms": single_ms, "lanes": lanes, "recall_at_10": recall,
             "recall_at_10_lane_precision": recall_lane, "f32_miss_max_gap": worst_gap,
             "singletons_bitwise": bitwise,
             "embed_s": [embed_s / 1000.0, embed2_s / 1000.0], "embed_docs_per_s": docs_per_s,
             "table_s": table_s, "index_build_s": build_s, "host_embed_other_bf16_query": moved},
            launches, kernels,
            {"m2v": m2v, "rows": [rows_of(o) for o in batch], "solo": [rows_of(o) for o in solo],
             "pools": pools})


def lift_world(seed: int = LIFT_SEED):
    """tools/train_quality_lift.py's paraphrase world, its held-out half: a
    synonym dictionary (cwNNN <-> syNNN), 90 training topics drawn first
    (each a pair: the canonical words as the query, their synonyms and four
    filler words as the doc), then 45 held-out topics of four docs each
    (the exact words, a paraphrase with one canonical anchor, a partial
    match, noise) and a canonical-word query with graded judgments. Returns
    ((doc id, text) list, queries, judgments, every word, the 90 training
    pairs)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_dict = 100
    canon_words = [f"cw{i:03d}" for i in range(n_dict)]
    syn_words = [f"sy{i:03d}" for i in range(n_dict)]
    filler = [f"fil{i:03d}" for i in range(150)]

    def draw_topic():
        idx = rng.choice(n_dict, size=4, replace=False)
        return [canon_words[i] for i in idx], [syn_words[i] for i in idx]

    pairs = []
    for _ in range(90):  # the training pairs: canonical query, synonym doc
        canon, syns = draw_topic()
        pairs.append((" ".join(canon), " ".join(syns) + " " + " ".join(rng.choice(filler, size=4))))

    def pad():
        return " ".join(rng.choice(filler, size=6))

    docs, queries, qrels = [], [], []
    for t in range(45):
        canon, syns = draw_topic()
        docs.append((f"ev{t}-exact", " ".join(canon) + " " + pad()))
        docs.append((f"ev{t}-para", canon[0] + " " + " ".join(syns[1:]) + " " + pad()))
        docs.append((f"ev{t}-part", " ".join(canon[:2]) + " " + pad()))
        other = canon_words[rng.integers(n_dict)]
        docs.append((f"ev{t}-noise", other + " " + pad()))
        queries.append(" ".join(canon))
        qrels.append({f"ev{t}-exact": 3.0, f"ev{t}-para": 2.0, f"ev{t}-part": 1.0})
    return docs, queries, qrels, canon_words + syn_words + filler, pairs


def lift_eval(dev, world, quality, root: str, *, rescan: bool, timeout_ms: float | None = None):
    """The lift world served on ``dev``: the term-identity Model2Vec fast
    tier (128 dims, seed 3), ``quality`` as the quality tier, a
    ``MemoryLexicalIndex``, and ``search()``'s phase stream per query,
    judged by the port's quality harness (``utils/quality_harness``): one
    report of the Initial phase's results (its ``search_fn`` runs
    ``search()``) and one of the Refined phase's (the same outcome's,
    Initial's where no Refined phase came). Returns (Initial report,
    Refined report, phase-2 skip reasons)."""
    import numpy as np

    from frankensearch_tpu_torch import (IndexableDocument, MemoryLexicalIndex, Model2VecEmbedder,
                                         SimpleWordTokenizer, TwoTierConfig, TwoTierIndex, TwoTierSearcher)
    from frankensearch_tpu_torch.core.types import PhaseKind
    from frankensearch_tpu_torch.utils.quality_harness import EvalQuery, evaluate

    docs, queries, qrels, words, _ = world
    rng = np.random.default_rng(3)
    table = rng.standard_normal((len(words), 128)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    fast = Model2VecEmbedder(table, SimpleWordTokenizer({w: i for i, w in enumerate(words)}), device=dev,
                             embedder_id="fast-term-id", revision="tl1")
    texts, ids = [t for _, t in docs], [d for d, _ in docs]
    index = TwoTierIndex.create(root, fast.embed_batch(texts), ids, fast.identity(), device=dev,
                                quality_vectors=quality.embed_batch(texts), quality_identity=quality.identity())
    lex = MemoryLexicalIndex()
    for d, t in docs:
        lex.add_document(IndexableDocument(doc_id=d, content=t))
    lex.commit()
    cfg = TwoTierConfig(quality_rescan=rescan)
    if timeout_ms is not None:
        cfg = TwoTierConfig(quality_rescan=rescan, quality_timeout_ms=timeout_ms)
    searcher = TwoTierSearcher(index, fast, lexical=lex, quality_embedder=quality, config=cfg,
                               cache_query_embeddings=False)
    evals = [EvalQuery(query_id=f"q{t:02d}", text=q, qrels=rel) for t, (q, rel) in enumerate(zip(queries, qrels))]
    outcomes, skips = [], []

    def initial_fn(text: str, k: int):
        out = searcher.search(text, k=k)
        outcomes.append(out)
        skips.append(out.metrics.phase2_skip_reason)
        return {p.kind: p for p in out.phases}[PhaseKind.INITIAL].results

    system = f"lift-{dev.type}-{'rescan' if rescan else 'aligned'}"
    initial = evaluate(initial_fn, evals, k=10, system=system + "-initial")
    pending = iter(outcomes)

    def refined_fn(text: str, k: int):
        by_kind = {p.kind: p for p in next(pending).phases}
        return by_kind.get(PhaseKind.REFINED, by_kind[PhaseKind.INITIAL]).results

    refined = evaluate(refined_fn, evals, k=10, system=system + "-refined")
    searcher.close()
    return initial, refined, skips


def quality_index(dev, fast_index, identity):
    """The fast tier of ``fast_index`` with a quality tier of seeded unit
    rows x Q_DIM, one per doc, in the fast tier's doc order."""
    import torch

    from frankensearch_tpu_torch import DeviceVectorIndex, TwoTierIndex

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    vecs = unit_rows(gen, fast_index.fast.n_rows, Q_DIM, dev).cpu().numpy()
    quality = DeviceVectorIndex(vecs, fast_index.fast.doc_ids, identity, device=dev)
    return TwoTierIndex(fast_index.fast, quality)


def phase_kinds(phases) -> list[str]:
    return [p.kind.value for p in phases]


def check_refined_singleton(what: str, one, want, strict: bool, q_err: float) -> None:
    """A singleton's Refined results against its batch row: equal (doc
    ids, fused, lexical, vector and quality scores) where its candidate
    budgets and quality vector bits are the batch's; otherwise every doc
    both lists hold has the same lexical and vector score bits and a
    quality score within ``q_err`` x sqrt(Q_DIM) (a dot product of a unit
    row with a query vector that moved by at most ``q_err`` per element)."""
    got = [(r.doc_id, r.score, r.lexical_score, r.fast_score, r.quality_score) for r in one.results]
    ref = [(r.doc_id, r.score, r.lexical_score, r.fast_score, r.quality_score) for r in want.results]
    if strict:
        if got != ref:
            raise AssertionError(f"{what}: the singleton differs from its batch row")
        return
    lanes = {r[0]: r for r in ref}
    shared = [r for r in got if r[0] in lanes]
    if not shared:
        raise AssertionError(f"{what}: the singleton shares no doc with its batch row")
    bound = q_err * Q_DIM**0.5 + 1e-7
    for r in shared:
        w = lanes[r[0]]
        if r[2:4] != w[2:4] or (r[4] is None) != (w[4] is None) or (
                r[4] is not None and abs(r[4] - w[4]) > bound):
            raise AssertionError(f"{what}: doc {r[0]} lane scores {r[2:]} vs its batch row's {w[2:]}")


def phase8_quality(dev, tmp: str, semantic: dict, lexical: dict) -> tuple[dict, dict, list[dict], dict]:
    """hybrid-1M-quality: phase 4's corpus and lexical arm over phase 2's
    fast tier, with a 1M x 384 quality tier and the trained 384 encoder
    (8a), a seeded cross-encoder at ms-marco-MiniLM-L-6-v2's configuration
    (8b), and the held-out lift world on the card against the CPU (8c).
    Returns its record, launches, kernel records, and the two-tier index
    with the encoder on the card and on the CPU (phase 14 refreshes that
    index)."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierSearcher
    from frankensearch_tpu_torch.rerank.bert import BertConfig, init_params
    from frankensearch_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
    from frankensearch_tpu_torch.rerank.encoder import load_artifact
    from frankensearch_tpu_torch.rerank.tokenizer import WordPieceTokenizer

    cpu = torch.device("cpu")
    art = os.path.join(os.path.dirname(os.path.abspath(__file__)), QUALITY_ARTIFACT)
    t0 = time.perf_counter()
    q32 = load_artifact(art, device=dev)  # verify=True: the certificate, fail-closed
    q16 = load_artifact(art, device=dev, compute="bf16")
    c32 = load_artifact(art, device=cpu)
    c16 = load_artifact(art, device=cpu, compute="bf16")
    load_s = time.perf_counter() - t0
    log(f"phase8 {QUALITY_ARTIFACT}: certificate verified on {dev} and on the CPU ({load_s:.1f} s)")
    t0 = time.perf_counter()
    index = quality_index(dev, semantic["index"], q32.identity())
    build_s = time.perf_counter() - t0
    log(f"phase8 quality tier {tuple(index.quality.slab.shape)} {index.quality.slab.dtype} ({build_s:.1f} s)")
    bm25, queries, texts = lexical["bm25"], lexical["queries"], lexical["texts"]
    singles = four_word_singletons(queries)
    emb = semantic["emb"]

    # --- 8a: the encoder alone, then search_batch and search() ---
    rec: dict = {"artifact_load_s": load_s, "quality_index_build_s": build_s}
    tok_t = q32.tokenize_batch(queries)[0].shape[1]
    enc_ms = {}
    for name, q_emb in (("f32", q32), ("bf16", q16)):
        for b in ENC_BATCHES:
            enc_ms[f"{name}_B{b}"] = cuda_median_ms(lambda: q_emb.forward_device(queries[:b]), iters=10)
    rec.update({"encoder_ms": enc_ms, "encoder_t_B256": tok_t})
    log(f"phase8 encoder forward (T={tok_t} at B=256; CUDA events, ms): {json.dumps(enc_ms)}")
    sample = queries[:32]
    for what, card, host, tol in (("f32", q32, c32, ENC_F32_TOL), ("bf16", q16, c16, ENC_BF16_TOL)):
        err = float(np.abs(card.embed_batch(sample) - host.embed_batch(sample)).max())
        rec[f"encoder_card_vs_cpu_{what}"] = err
        if not err <= tol:
            raise AssertionError(f"phase8: {what} quality vectors on the card differ from the CPU's by {err:.3e} > {tol}")
    rows = [queries.index(q) for q in singles]
    solo_batch = {}
    for what, card in (("f32", q32), ("bf16", q16)):
        vb = card.embed_batch(queries)
        solo = np.stack([card.embed_batch([q])[0] for q in singles])
        err = float(np.abs(solo - vb[rows]).max())
        solo_batch[what] = {"bitwise": int(sum(np.array_equal(solo[i], vb[r]) for i, r in enumerate(rows))),
                            "max_abs_diff": err}
        if not err <= SOLO_BATCH_TOL[what]:
            raise AssertionError(f"phase8: {what} B=1 quality vectors differ from their B=256 rows by {err:.3e}")
    rec["solo_vs_batch"] = solo_batch
    log(f"phase8 card vs CPU quality vectors: f32 {rec['encoder_card_vs_cpu_f32']:.3e} (tol {ENC_F32_TOL:g}), "
        f"bf16 {rec['encoder_card_vs_cpu_bf16']:.3e} (tol {ENC_BF16_TOL:g}); B=1 vs B=256 rows: {json.dumps(solo_batch)}")
    q_err = solo_batch["f32"]["max_abs_diff"]

    searchers = {
        rescan: TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=q32,
                                config=TwoTierConfig(quality_rescan=rescan), cache_query_embeddings=False)
        for rescan in (False, True)
    }
    for s in searchers.values():  # warm-up: cuBLAS handles in the phase-2 worker, allocator, host caches
        s.search_batch(queries, k=K)
        for q in singles[:2]:
            s.search(q, k=K)
    shapes: set = set()

    def main_path():
        out = {}
        for rescan, s in searchers.items():
            batch, batch_ms = timed(lambda s=s: s.search_batch(queries, k=K))
            solo = []
            for q in singles:
                seen = []
                one, ms = timed(lambda q=q, s=s: s.search(q, k=K, on_phase=seen.append))
                solo.append((one, seen, ms))
            out[rescan] = (batch, batch_ms, solo)
        return out

    out, launches = drive(main_path, shapes, dim=Q_DIM)
    need_launches("phase8", launches, ("K1", "K2", "K3"))
    if not any(sh[0] == "group_max" for sh in shapes):
        raise AssertionError("phase8: no hierarchical scan ran over the 384-wide quality tier")
    for rescan, (batch, batch_ms, solo) in out.items():
        tag = "rescan" if rescan else "aligned"
        for j, o in enumerate(batch):
            if o.metrics.quality_candidates < 1 or not any(r.quality_score is not None for r in o.results):
                raise AssertionError(f"phase8 {tag}: query {j} carries no quality scores")
        init_ms, ref_ms = [], []
        for q, (one, seen, _ms) in zip(singles, solo):
            kinds = phase_kinds(seen)
            if kinds != ["initial", "refined"] or one.metrics.phase2_skip_reason or one.metrics.phase3_skip_reason:
                raise AssertionError(f"phase8 {tag}: singleton {q!r} phases {kinds}, skip "
                                     f"{one.metrics.phase2_skip_reason!r}/{one.metrics.phase3_skip_reason!r}")
            strict = class_budgets([q]) == class_budgets(queries) and q_err == 0.0
            check_refined_singleton(f"phase8 {tag} {q!r}", one, batch[queries.index(q)], strict, q_err)
            init_ms.append(seen[0].latency_ms)
            ref_ms.append(seen[1].latency_ms)
        rec[tag] = {"batch_ms": batch_ms, "initial_ms": init_ms, "refined_ms": ref_ms,
                    "quality_candidates_mean": float(np.mean([o.metrics.quality_candidates for o in batch]))}
        log(f"phase8 {tag} search_batch B=256 (Refined): {batch_ms:.2f} ms; search() Initial "
            + ", ".join(f"{t:.2f}" for t in init_ms) + " ms; Refined " + ", ".join(f"{t:.2f}" for t in ref_ms) + " ms")
    log(f"phase8 launches {launches}; every singleton reached REFINED with no skip reason (default "
        f"{TwoTierConfig().quality_timeout_ms:g} ms timeout); lanes equal to the batch rows")
    kernels = check_kernels("hybrid-1M-quality", index.quality.slab, index.quality._effective_mask(None, None), shapes)

    # --- 8b: Reranked ---
    ce_cfg = BertConfig(**CE_CONFIG)
    ce_state = init_params(ce_cfg, torch.Generator().manual_seed(SEED + 9))
    ce_tok = WordPieceTokenizer(q32.tokenizer.vocab, max_len=512)

    def text_fn(doc_id):
        return texts[int(doc_id[4:])]

    rerank = {}
    for form in ("f32", "int8"):
        rr = CrossEncoderReranker(ce_state, ce_cfg, ce_tok, device=dev, reranker_id="ms-marco-MiniLM-L-6-v2-seeded",
                                  int8=form == "int8")
        host = CrossEncoderReranker(ce_state, ce_cfg, ce_tok, device=cpu, int8=form == "int8")
        s = TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=q32, reranker=rr,
                            config=TwoTierConfig(rerank_enabled=True), cache_query_embeddings=False, text_fn=text_fn)
        s.search(singles[0], k=K)  # warm-up

        def reranked():
            res = []
            for q in singles:
                seen = []
                res.append((s.search(q, k=K, on_phase=seen.append), seen))
            return res

        res, l8b = drive(reranked, set())
        launches = {n: launches[n] + l8b[n] for n in launches}
        ms, err = [], 0.0
        for q, (one, seen) in zip(singles, res):
            kinds = phase_kinds(seen)
            if kinds != ["initial", "refined", "reranked"] or one.metrics.phase2_skip_reason \
                    or one.metrics.phase3_skip_reason:
                raise AssertionError(f"phase8 rerank {form}: singleton {q!r} phases {kinds}, skip "
                                     f"{one.metrics.phase2_skip_reason!r}/{one.metrics.phase3_skip_reason!r}")
            ms.append(one.metrics.phase3_ms)
            pairs = [(r.doc_id, text_fn(r.doc_id)) for r in seen[1].results]
            got = rr.score_pairs(q, pairs)
            want = host.score_pairs(q, pairs)
            g = np.array([x.score for x in got])
            if not ((g >= 0.0) & (g <= 1.0)).all():
                raise AssertionError(f"phase8 rerank {form}: scores outside [0, 1]")
            err = max(err, float(np.abs(g - np.array([x.score for x in want])).max()))
        tol = CE_F32_TOL if form == "f32" else CE_INT8_TOL
        if not err <= tol:
            raise AssertionError(f"phase8 rerank {form}: card vs CPU scores differ by {err:.3e} > {tol}")
        pairs = [(f"doc-{i:07d}", texts[i]) for i in range(20)]
        rr.score_pairs(singles[0], pairs)
        t_pairs = timed(lambda: rr.score_pairs(singles[0], pairs))[1]
        rerank[form] = {"phase3_ms": ms, "card_vs_cpu": err, "score_20_pairs_ms": t_pairs}
        log(f"phase8 rerank {form}: every singleton reached RERANKED; phase 3 "
            + ", ".join(f"{t:.2f}" for t in ms) + f" ms; 20 pairs {t_pairs:.2f} ms; card vs CPU scores "
            f"{err:.3e} (tol {tol:g})")
        s.close()
    rec["rerank"] = rerank

    # --- 8c: the held-out lift, card against CPU, through the quality harness ---
    from frankensearch_tpu_torch.utils.quality_harness import compare_systems

    world = lift_world()
    lift = {}
    for rescan in (False, True):
        tag = "rescan" if rescan else "default"
        init_c, ref_c, skips = lift_eval(dev, world, q32, os.path.join(tmp, f"lift-card-{tag}"), rescan=rescan)
        init_h, ref_h, _ = lift_eval(cpu, world, c32, os.path.join(tmp, f"lift-cpu-{tag}"), rescan=rescan,
                                     timeout_ms=0)
        if any(skips):
            raise AssertionError(f"phase8 lift {tag}: phase-2 skips on the card {sorted(set(skips) - {None})}")
        i_c, r_c, i_h, r_h = ([rep.per_query[q]["ndcg"] for q in sorted(rep.per_query)]
                              for rep in (init_c, ref_c, init_h, ref_h))
        card = float(np.mean(r_c) - np.mean(i_c))
        host_lift = float(np.mean(r_h) - np.mean(i_h))
        cmp = compare_systems(init_c, ref_c)
        lift[tag] = {"initial": float(np.mean(i_c)), "refined": float(np.mean(r_c)), "lift": card,
                     "cpu_lift": host_lift, "per_query_equal": i_c == i_h and r_c == r_h,
                     "per_query": {"initial": i_c, "refined": r_c},
                     "reports": {"initial": init_c.to_dict(), "refined": ref_c.to_dict()},
                     "compare_systems": {"metric": cmp.metric, "mean_delta": cmp.mean_delta, "lo": cmp.lo,
                                         "hi": cmp.hi, "significant": cmp.significant, "better": cmp.better}}
        log(f"phase8 lift {tag} (quality harness): card Initial {np.mean(i_c):.4f} Refined {np.mean(r_c):.4f} "
            f"lift {card:+.4f}; CPU lift {host_lift:+.4f}; compare_systems {json.dumps(lift[tag]['compare_systems'])}")
        if abs(card - host_lift) > LIFT_TOL or card < LIFT_FLOOR:
            raise AssertionError(f"phase8 lift {tag}: {card:+.4f} (CPU {host_lift:+.4f}, floor {LIFT_FLOOR})")
    rec["lift"] = lift
    for s in searchers.values():
        s.close()
    del searchers
    torch.cuda.empty_cache()
    return rec, launches, kernels, {"index": index, "q32": q32, "c32": c32}


def serve_sizes(searcher, queries: list[str], texts: list[str] | None = None) -> dict:
    """``search_batch`` at B = 256 (``queries``), 8 (their first 8) and 1
    (each of those alone, or of ``texts``): {size: (outcomes, host ms)}."""
    b256 = timed(lambda: searcher.search_batch(queries, k=K))
    b8 = timed(lambda: searcher.search_batch(queries[:8], k=K))
    solo = [timed(lambda q=q: searcher.search_batch([q], k=K)) for q in (texts or queries[:8])]
    return {"B256": b256, "B8": b8, "B1": ([o[0][0] for o in solo], [o[1] for o in solo])}


def sizes_ms(out: dict) -> dict:
    return {"B256_ms": out["B256"][1], "B8_ms": out["B8"][1], "B1_ms": out["B1"][1]}


def check_sets(what: str, got_rows, want_rows, score_of, kth, tol: float) -> int:
    """Per query, the rows ``got_rows`` names equal ``want_rows``'s, except
    where a differing row's score (``score_of(j, row)``) lies within ``tol``
    (relative, at least absolute) of the query's k-th score ``kth[j]``.
    Returns how many queries differ only at such ties."""
    off = 0
    for j, (got, want) in enumerate(zip(got_rows, want_rows)):
        if set(got) == set(want):
            continue
        for row in set(got) ^ set(want):
            if abs(score_of(j, row) - kth[j]) > tol * max(abs(kth[j]), 1.0):
                raise AssertionError(f"{what}: query {j} row {row} differs from the reference scan")
        off += 1
    return off


def same_topk(got, want, rel: float, what: str) -> None:
    """Two (B, k) top-k results, query by query as :func:`same_ranking`."""
    pairs = [[list(zip(i, s)) for i, s in zip(r.indices.tolist(), r.scores.tolist())] for r in (got, want)]
    for j, (g, w) in enumerate(zip(*pairs)):
        same_ranking(g, w, rel, f"{what} query {j}")


def doc_rows(out) -> list[int]:
    return [int(r.doc_id.split("-")[1]) for r in out.results]


def clustered_cell(rng):
    """The IVF cell's corpus: 1M unit rows around IVF_CENTRES seeded
    centres, and 256 queries near corpus rows (tests/test_ivf.py's
    ``test_high_recall_on_clustered_data`` at full size). Returns (rows,
    queries)."""
    import numpy as np

    centres = rng.standard_normal((IVF_CENTRES, DIM), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    x = centres[np.repeat(np.arange(IVF_CENTRES), N_DOCS // IVF_CENTRES)]
    x += IVF_SPREAD * rng.standard_normal((N_DOCS, DIM), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.choice(N_DOCS, size=256, replace=False)] + IVF_QUERY_NOISE * rng.standard_normal((256, DIM), dtype=np.float32)
    return x, q / np.linalg.norm(q, axis=1, keepdims=True)


def device_turns(fns: dict) -> dict:
    """Each function's device ms a call (torch.profiler: the self device
    time of all its kernels and copies over 10 calls, as
    ``profile_chip.device_split``) and its per-kernel split, in turns (a,
    b, b, a): the mean of its two runs."""
    from profile_chip import device_split

    order = list(fns) + list(fns)[::-1]
    runs: dict = {name: [] for name in fns}
    for name in order:
        runs[name].append(device_split(fns[name]))
    return {name: (sum(t for t, _ in r) / len(r),
                   {k: sum(s.get(k, 0.0) for _, s in r) / len(r) for k in r[0][1]}) for name, r in runs.items()}


def check_ivf_kernel(cell: str, arm, shapes: set) -> list[dict]:
    """Phase 1 for K2-ivf: at each (B, nprobe) the IVF path ran, seeded
    near-corpus queries and their centroid top-k, the kernel's top-10
    against its twin's (scores place by place within REL_TOL, so rows
    differ only among such ties; row sets equal but at ties with the k-th
    score; the twin in chunks of queries where its f32 candidates would
    pass 4 GB). Device ms a call (torch.profiler), in turns with K2's path
    that it replaced (the probe's groups, K2, the mask and the top-k:
    ``k2_ms``): the wrapper with its merge (``ms``), its kernel alone
    (``kernel_ms``, against ``k2_kernel_ms``), and the whole probe from the
    centroid product (``probe_ms`` against ``k2_probe_ms``); the wrapper by
    CUDA events too (``wrapper_ms``: at small B the host's enqueue). The
    full probe's record is the headline, with one cuBLAS product of the
    bf16 queries and the whole slab (f32 out) as ``library_ms``."""
    import torch

    from frankensearch_tpu_torch.index import ivf
    from frankensearch_tpu_torch.ops import topk_scan as ts

    slab, mask, gpc = arm.slab, arm.mask, arm.groups_per_cluster
    n, d = slab.shape
    cap = gpc * ts.GROUP
    gen = torch.Generator(device=slab.device).manual_seed(SEED + 11)
    sms = torch.cuda.get_device_properties(slab.device).multi_processor_count
    recs = []
    for b, nprobe in sorted(shapes, reverse=True):
        rows = torch.randint(0, n, (b,), generator=gen, device=slab.device)
        q = slab[rows].to(torch.float32) + 0.02 * torch.randn(b, d, generator=gen, device=slab.device)
        probe = ivf.probe_clusters(arm.centroids, q, nprobe=nprobe)
        step = max(1, int(4e9 // (nprobe * cap * d * 4)))

        def plain():
            parts = [ts.ivf_probe_topk_plain(slab, q[i : i + step], mask, probe[i : i + step], k=K, gpc=gpc)
                     for i in range(0, b, step)]
            return ts.TopKResult(torch.cat([p.scores for p in parts]), torch.cat([p.indices for p in parts]))

        got, want = ts.ivf_probe_topk(slab, q, mask, probe, k=K, gpc=gpc), plain()
        what = f"phase1 {cell} K2-ivf B={b} nprobe={nprobe}"
        err = check_close(got.scores, want.scores, what)
        scores = [{**dict(zip(*g)), **dict(zip(*w))} for g, w in zip(
            zip(got.indices.tolist(), got.scores.tolist()), zip(want.indices.tolist(), want.scores.tolist()))]
        ties = check_sets(what, got.indices.tolist(), want.indices.tolist(), lambda j, row: scores[j][row],
                          want.scores[:, -1].tolist(), REL_TOL)
        groups = ts.cluster_groups(probe, gpc)
        runs = device_turns({
            "ms": lambda: ts.ivf_probe_topk(slab, q, mask, probe, k=K, gpc=gpc),
            "k2_ms": lambda: ts._rescore_groups(slab, q, mask, groups, k=K),
            "probe_ms": lambda: ivf._ivf_probe_rescore(arm.centroids, slab, mask, q, nprobe=nprobe, k=K, gpc=gpc),
            "k2_probe_ms": lambda: ts._rescore_groups(
                slab, q, mask, ts.cluster_groups(ivf.probe_clusters(arm.centroids, q, nprobe=nprobe), gpc), k=K),
        })
        t = {name: ms for name, (ms, _) in runs.items()}
        split = runs["ms"][1]
        t["kernel_ms"] = sum(v for name, v in split.items() if "ivf_probe_kernel" in name)
        t["k2_kernel_ms"] = sum(v for name, v in runs["k2_ms"][1].items() if "gather_rescore_kernel" in name)
        t["wrapper_ms"] = cuda_median_ms(lambda: ts.ivf_probe_topk(slab, q, mask, probe, k=K, gpc=gpc))
        distinct = int(torch.unique(probe).numel())
        moved = distinct * cap * (d * slab.element_size() + 4) + nbytes(q, probe) + b * nprobe * min(K, cap) * 8
        pair_order, splits, q_tile, kp = ts._ivf_probe_layout(b, nprobe, arm.n_clusters, gpc, K, sms)
        rec = {"kernel": "ivf_probe", "cell": cell, "n": n, "b": b, "kk": nprobe * gpc, "nprobe": nprobe,
               "distinct_clusters": distinct, "layout": {"pair_order": pair_order, "splits": splits,
                                                         "q_tile": q_tile, "kp": kp},
               **t, "plain_ms": cuda_median_ms(plain, warmup=1, iters=5), "max_abs_err": err, "tie_queries": ties,
               "bound": bound(moved, 2 * b * nprobe * cap * d, "bf16"), "library_ms": None,
               "headline": nprobe == arm.n_clusters}
        if rec["headline"]:
            qb = q.to(slab.dtype)
            rec["library_ms"] = device_turns({"mm": lambda: torch.mm(qb, slab.T, out_dtype=torch.float32)})["mm"][0]
        recs.append(rec)
        log(f"phase1 {cell} K2-ivf B={b} nprobe={nprobe} ({distinct} clusters, layout {rec['layout']}): "
            f"{t['ms']:.4f} device ms, its kernel {t['kernel_ms']:.4f} (K2's path {t['k2_ms']:.4f}, K2 "
            f"{t['k2_kernel_ms']:.4f}; bound {rec['bound'][0]:.4f} by {rec['bound'][1]}"
            + (f"; cuBLAS product {rec['library_ms']:.4f}" if rec["library_ms"] is not None else "")
            + f"; CUDA events {t['wrapper_ms']:.4f}, plain {rec['plain_ms']:.4f}), whole probe "
            f"{t['probe_ms']:.4f} device ms (K2's {t['k2_probe_ms']:.4f}); max abs err {err:.3e}, "
            f"{ties} of {b} queries' rows differ only at ties within {REL_TOL:g}")
    return recs


def phase9_scan_lanes(dev, tmp: str, semantic: dict) -> tuple[dict, dict, list[dict]]:
    """Every scan lane ``TwoTierConfig`` selects, and the live index's write
    path: semantic-1M-f32 (phase 2's vectors as an f32 slab: ``auto`` on K1
    and K2's f32 forms, ``pallas`` on K5's), semantic-1M-mrl (phase 2's bf16
    index, ``mrl_search_dims=64``), semantic-1M-ivf (a clustered 1M corpus,
    its IVF arm built on the card, probed by K2; calibrated, certified and
    served behind the gate), the int4 two-pass scan over phase 2's vectors,
    and appends, deletes, WAL sync, compaction and reopening of phase 2's
    index."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.core.errors import InvalidConfig, UncertifiedScanMode
    from frankensearch_tpu_torch.index.device_index import DeviceVectorIndex
    from frankensearch_tpu_torch.index.ivf import calibrate_nprobe
    from frankensearch_tpu_torch.ops import topk_scan as ts
    from frankensearch_tpu_torch.ops.quantize import calibrate_int4

    vecs, emb, queries = semantic["vecs"], semantic["emb"], semantic["queries"]
    ids = [f"doc-{i:07d}" for i in range(N_DOCS)]
    qv = torch.from_numpy(emb.embed_batch(queries)).to(dev)
    rec: dict = {}
    launches: dict = {}
    kernels: list[dict] = []

    def count(phase, got, names, renamed=None):
        need_launches(phase, got, names)
        for name, n in got.items():
            key = (renamed or {}).get(name, name)
            launches[key] = launches.get(key, 0) + n

    # semantic-1M-f32: K1, K2 and K5 in their f32 forms
    t0 = time.perf_counter()
    f32 = TwoTierIndex(DeviceVectorIndex(vecs, ids, emb.identity(), device=dev, slab_dtype="f32"))
    f32_build_s = time.perf_counter() - t0
    slab, mask = f32.fast.slab, f32.fast._effective_mask(None, None)
    exact = ts.scan_topk_xla(slab, qv, K, mask)  # the plain f32 scan on the card
    f32_rows = exact.indices.cpu().tolist()
    f32_kth = exact.scores[:, -1].cpu().tolist()

    def f32_score(j, row):
        return float(qv[j] @ slab[row])

    shapes: set = set()
    f32_rec = {"build_s": f32_build_s, "slab_bytes": nbytes(slab)}
    for mode, names in (("auto", ("K1", "K2")), ("pallas", ("K5",))):
        searcher = TwoTierSearcher(f32, emb, config=TwoTierConfig(fast_only=True, scan_mode=mode))
        drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
        out, got = drive(lambda: serve_sizes(searcher, queries), shapes)
        count(f"phase9 f32 {mode}", got, names, {"K1": "K1-f32", "K2": "K2-f32", "K5": "K5-f32"})
        off = check_sets(f"phase9 f32 {mode} B=256", [doc_rows(o) for o in out["B256"][0]], f32_rows,
                         f32_score, f32_kth, F32_TIE_REL)
        check_sets(f"phase9 f32 {mode} B=8", [doc_rows(o) for o in out["B8"][0]], f32_rows[:8],
                   f32_score, f32_kth, F32_TIE_REL)
        check_sets(f"phase9 f32 {mode} B=1", [doc_rows(o) for o in out["B1"][0]], f32_rows[:8],
                   f32_score, f32_kth, F32_TIE_REL)
        log(f"phase9 f32 {mode}: B=256 {out['B256'][1]:.2f} ms, B=8 {out['B8'][1]:.2f} ms, singletons "
            + ", ".join(f"{t:.2f}" for t in out["B1"][1]) + f" ms; doc sets equal to the plain f32 scan "
            f"({off} of 256 differ only at ties within {F32_TIE_REL:g} of the k-th score)")
        f32_rec[mode] = {**sizes_ms(out), "tie_queries": off}
    rec["f32"] = f32_rec
    kernels += check_kernels("semantic-1M-f32", slab, mask, shapes)
    kernels += check_tile_kernel("semantic-1M-f32", slab, mask, shapes, edges=False)
    del f32, slab, mask, exact, searcher
    torch.cuda.empty_cache()

    # semantic-1M-mrl: phase 2's bf16 index, the first 64 dims, then a rescore
    index = semantic["index"]
    mrl = TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True, mrl_search_dims=MRL_DIMS))
    drive(lambda: mrl.search_batch(queries[:8], k=K), set())  # warm-up
    out, got = drive(lambda: serve_sizes(mrl, queries), set())
    count("phase9 mrl", got, ())
    recall = recall_at_k(out["B256"][0], semantic["exact_ids"])
    fast = index.fast
    slab, mask = fast.slab, fast._effective_mask(None, None)
    card = ts.scan_topk_mrl(slab, qv[:8], K, mask, search_dims=MRL_DIMS)
    cpu = ts.scan_topk_mrl(slab.cpu(), qv[:8].cpu(), K, mask.cpu(), search_dims=MRL_DIMS)
    same_topk(card, cpu, MRL_CPU_TOL, "phase9 mrl B=8 card vs CPU")
    log(f"phase9 mrl (search_dims {MRL_DIMS}): B=256 {out['B256'][1]:.2f} ms, B=8 {out['B8'][1]:.2f} ms, "
        "singletons " + ", ".join(f"{t:.2f}" for t in out["B1"][1]) + f" ms; recall@10 vs exact f32 scan "
        f"{recall:.4f}; B=8 equal to the CPU within {MRL_CPU_TOL:g}")
    rec["mrl"] = {**sizes_ms(out), "recall_at_10": recall, "search_dims": MRL_DIMS}
    del mrl, out

    # int4: phase 2's vectors packed to 4 bits, rescored on phase 2's bf16 slab
    t0 = time.perf_counter()
    padded = np.zeros((fast.n_pad, fast.d_pad), dtype=np.float32)
    padded[:N_DOCS, :DIM] = vecs
    q4 = calibrate_int4(padded)
    del padded
    packed, scale = torch.from_numpy(q4.packed).to(dev), torch.from_numpy(q4.scale).to(dev)
    pack_s = time.perf_counter() - t0
    int4_ms = {}
    for b in (256, 8, 1):
        res, int4_ms[f"B{b}_ms"] = timed(lambda b=b: ts.scan_topk_int4_two_pass(packed, scale, slab, qv[:b], K, mask))
        if b == 256:
            int4_recall = float(np.mean([len(set(r) & set(e.tolist())) / K for r, e in
                                         zip(res.indices.cpu().tolist(), semantic["exact_ids"])]))
    card = ts.scan_topk_int4_two_pass(packed, scale, slab, qv[:8], K, mask)
    cpu = ts.scan_topk_int4_two_pass(packed.cpu(), scale.cpu(), slab.cpu(), qv[:8].cpu(), K, mask.cpu())
    same_topk(card, cpu, REL_TOL, "phase9 int4 B=8 card vs CPU")
    log(f"phase9 int4: packed {nbytes(packed)} bytes in {pack_s:.1f} s; " + ", ".join(
        f"{k} {v:.2f}" for k, v in int4_ms.items()) + f"; recall@10 {int4_recall:.4f}; B=8 equal to the CPU "
        f"within {REL_TOL:g}")
    rec["int4"] = {**int4_ms, "recall_at_10": int4_recall, "packed_bytes": nbytes(packed), "pack_s": pack_s}
    del packed, scale, q4

    # semantic-1M-ivf: a clustered corpus, its IVF arm built on the card
    rng = np.random.default_rng(SEED + 9)
    x, xq = clustered_cell(rng)
    root = os.path.join(tmp, "ivf")
    t0 = time.perf_counter()
    ivf_index = TwoTierIndex.create(root, x, ids, emb.identity(), device=dev)
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf_index.fast.enable_ivf()  # ends in host copies of the preferences: synchronous
    ivf_build_s = time.perf_counter() - t0
    arm = ivf_index.fast._ivf
    ivf_exact = ts.scan_topk_xla(torch.from_numpy(x).to(dev), torch.from_numpy(xq).to(dev), K,
                                 precise=True).indices.cpu().numpy()
    # the index's own exact scan (the arm's bf16 precision): what
    # certify_scan_mode measures the lane against
    lane_exact = ivf_index.fast.search_batch(xq, K, mode="xla").indices.cpu().numpy()
    ivf_shapes: set = set()

    def ivf_path():
        out = {}
        for nprobe in IVF_NPROBES:
            for b in (256, 8, 1):
                ivf_shapes.add((b, nprobe))
                out[(b, nprobe)] = timed(lambda: ivf_index.fast.search_batch(xq[:b], K, mode="ivf", nprobe=nprobe))
        ivf_shapes.add((8, arm.n_clusters))
        out["full"] = timed(lambda: ivf_index.fast.search_batch(xq[:8], K, mode="ivf", nprobe=arm.n_clusters))
        return out

    ivf_index.fast.search_batch(xq[:8], K, mode="ivf")  # warm-up
    out, got = drive(ivf_path, set())
    count("phase9 ivf", got, ("K2-ivf",))
    if got["K2"]:
        raise AssertionError(f"phase9 ivf: the bf16 arm's probes launched K2 ({got})")
    ivf_rec = {"create_s": create_s, "build_s": ivf_build_s, "n_clusters": arm.n_clusters, "cap": arm.cap,
               "groups_per_cluster": arm.groups_per_cluster, "arm_slab_bytes": nbytes(arm.slab)}
    def mean_recall(rows, exact):
        return float(np.mean([len(set(r) & set(e)) / K for r, e in zip(rows.tolist(), exact.tolist())]))

    for nprobe in IVF_NPROBES:
        rows = out[(256, nprobe)][0].indices.cpu().numpy()
        ivf_rec[f"nprobe{nprobe}"] = {
            "recall_at_10": mean_recall(rows, ivf_exact),
            "recall_at_10_lane_precision": mean_recall(rows, lane_exact),
            "scanned_fraction": arm.scanned_fraction(nprobe),
            **{f"B{b}_ms": out[(b, nprobe)][1] for b in (256, 8, 1)},
        }
    hier = ivf_index.fast.search_batch(xq[:8], K, mode="hierarchical")
    q8 = torch.from_numpy(xq[:8]).to(dev).to(torch.bfloat16).to(torch.float32)
    ivf_slab = ivf_index.fast.slab
    off = check_sets("phase9 ivf full probe B=8", out["full"][0].indices.cpu().tolist(), hier.indices.cpu().tolist(),
                     lambda j, row: float(q8[j] @ ivf_slab[row].to(torch.float32)),
                     hier.scores[:, -1].cpu().tolist(), BF16_DOT_BOUND)
    ivf_rec["full_probe_ms"] = out["full"][1]
    log(f"phase9 ivf: index {create_s:.1f} s, arm {ivf_build_s:.1f} s ({arm.n_clusters} clusters, cap {arm.cap}); "
        + "; ".join(f"nprobe {p}: recall@10 {ivf_rec[f'nprobe{p}']['recall_at_10']:.4f} (vs the bf16 scan "
                    f"{ivf_rec[f'nprobe{p}']['recall_at_10_lane_precision']:.4f}), scanned "
                    f"{ivf_rec[f'nprobe{p}']['scanned_fraction']:.4f}, B=256/8/1 "
                    + "/".join(f"{ivf_rec[f'nprobe{p}'][f'B{b}_ms']:.2f}" for b in (256, 8, 1)) + " ms"
                    for p in IVF_NPROBES)
        + f"; full probe B=8 {out['full'][1]:.2f} ms, doc sets equal to the hierarchical scan ({off} of 8 "
        f"differ only at ties within {BF16_DOT_BOUND:.3g})")
    # the calibration's widest probe (all 256 queries) is held to the twin too
    ivf_shapes.add((256, max(c for c in IVF_CANDIDATES if c <= arm.n_clusters)))
    kernels += check_ivf_kernel("semantic-1M-ivf", arm, ivf_shapes)

    # calibrate, certify and persist, serve behind the gate, reopen
    t0 = time.perf_counter()
    cal = calibrate_nprobe(arm, xq, lane_exact, k=K, target_recall=IVF_TARGET_RECALL, candidates=IVF_CANDIDATES)
    if cal is None:
        raise AssertionError(f"phase9 ivf: no nprobe in {IVF_CANDIDATES} certifies recall@10 >= {IVF_TARGET_RECALL}")
    nprobe = int(cal.parameter_value)
    cert = ivf_index.certify_fast_scan_mode("ivf", K, xq, nprobe=nprobe)
    cert_s = time.perf_counter() - t0
    gated_cfg = TwoTierConfig(fast_only=True, scan_mode="ivf", ivf_nprobe=nprobe,
                              require_recall_certificate=True, min_certified_recall=0.8)
    try:
        TwoTierSearcher(ivf_index, emb, config=TwoTierConfig(
            fast_only=True, scan_mode="ivf", require_recall_certificate=True,
            min_certified_recall=1.01)).search_batch(queries[:8], k=K)
    except UncertifiedScanMode as e:
        log(f"phase9 ivf gate refuses an unmeetable floor: {e}")
    else:
        raise AssertionError("phase9 ivf: the gate served below its floor")
    gated = TwoTierSearcher(ivf_index, emb, config=gated_cfg)
    (g_batch, g_ms), got = drive(lambda: timed(lambda: gated.search_batch(queries, k=K)), set())
    count("phase9 ivf gated", got, ("K2-ivf",))
    if not all(len(o.results) == K for o in g_batch):
        raise AssertionError("phase9 ivf: the gated searcher returned short results")
    reopened = TwoTierIndex.open(root, device=dev)
    if reopened.fast.recall_certificate("ivf") != cert:
        raise AssertionError("phase9 ivf: the reopened index did not rebind the persisted certificate")
    log(f"phase9 ivf certificate ({cert_s:.1f} s): calibrated nprobe {nprobe} (certified {cal.certified_recall:.4f}); "
        f"certified recall@{cert.k} {cert.certified_recall:.4f} (mean {cert.mean_recall:.4f}); gated B=256 "
        f"{g_ms:.2f} ms; rebound after reopen")
    ivf_rec["certificate"] = {**cert.to_record(), "calibrated_nprobe": nprobe, "certify_s": cert_s,
                              "gated_batch_ms": g_ms}
    rec["ivf"] = ivf_rec
    del ivf_index, reopened, gated, arm, x, hier, ivf_slab
    torch.cuda.empty_cache()

    # the write path over phase 2's index: append, delete, sync, compact, reopen
    wrng = np.random.default_rng(SEED + 10)
    new = wrng.standard_normal((APPEND_DOCS, DIM), dtype=np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new_ids = [f"new-{i:07d}" for i in range(APPEND_DOCS)]
    gone = new_ids[: DELETE_DOCS // 2] + [ids[i] for i in wrng.choice(N_DOCS, DELETE_DOCS // 2, replace=False)]
    gone_set = set(gone)
    index.wal_sync = "deferred"
    t0 = time.perf_counter()
    index.fast.enable_ivf()
    first_arm_s = time.perf_counter() - t0

    def write_path():
        w = {}
        _, w["append_ms"] = timed(lambda: index.append_fast(new_ids, new))
        try:
            index.fast.search_batch(new[:8], K, mode="ivf")
        except InvalidConfig:
            w["ivf_refused"] = True
        _, w["delete_ms"] = timed(lambda: index.delete(gone))
        _, w["sync_ms"] = timed(index.sync_wal)
        top1, w["own_hit_ms"] = timed(lambda: [index.fast.hydrate(index.fast.search_batch(new[i : i + 1000], 1))
                                             for i in range(0, APPEND_DOCS, 1000)])
        w["top1"] = [h[0].doc_id if h else None for chunk in top1 for h in chunk]
        dq = np.stack([index.fast.vector_for_row(index.fast.row_for(d)) for d in gone])
        w["gone_hits"] = index.fast.hydrate(index.fast.search_batch(dq, K))
        t0 = time.perf_counter()
        index.fast.enable_ivf()
        w["rebuild_arm_s"] = time.perf_counter() - t0
        w["ivf_top1"] = index.fast.hydrate(index.fast.search_batch(new[DELETE_DOCS:DELETE_DOCS + 256], 1,
                                                                   mode="ivf", nprobe=8))
        w["pre"] = index.fast.hydrate(index.fast.search_batch(qv.cpu().numpy(), K))
        t0 = time.perf_counter()
        compacted = index.compact()
        w["compact_s"] = time.perf_counter() - t0
        w["stats"] = {k: v.__dict__ for k, v in compacted.last_vacuum_stats.items()}
        t0 = time.perf_counter()
        reopened = TwoTierIndex.open(index.root, device=dev)
        w["reopen_s"] = time.perf_counter() - t0
        w["post"] = reopened.fast.hydrate(reopened.fast.search_batch(qv.cpu().numpy(), K))
        return w

    w, got = drive(write_path, set())
    count("phase9 write path", got, ("K1", "K2"))
    if not w.get("ivf_refused"):
        raise AssertionError("phase9 write path: mode='ivf' served after an append, before enable_ivf()")
    own = [t == d for t, d in zip(w["top1"], new_ids) if d not in gone_set]
    if not all(own):
        raise AssertionError(f"phase9 write path: {own.count(False)} appended docs are not their own top hit")
    seen = [h.doc_id for hits in (w["gone_hits"] + w["pre"]) for h in hits] + [t for t in w["top1"] if t]
    if gone_set & set(seen):
        raise AssertionError(f"phase9 write path: deleted docs came back: {sorted(gone_set & set(seen))[:5]}")
    ivf_own = float(np.mean([bool(h) and h[0].doc_id == d
                             for h, d in zip(w["ivf_top1"], new_ids[DELETE_DOCS:DELETE_DOCS + 256])]))
    if ivf_own < IVF_OWN_HIT_FLOOR:
        raise AssertionError(f"phase9 write path: the rebuilt IVF arm finds {ivf_own} of the appended docs")
    bitwise = [[(h.doc_id, h.score) for h in a] == [(h.doc_id, h.score) for h in b]
               for a, b in zip(w["pre"], w["post"])]
    if not all(bitwise):
        raise AssertionError(f"phase9 write path: {bitwise.count(False)} queries' top-10 changed across "
                             "compact() and reopen")
    log(f"phase9 write path: append {APPEND_DOCS} {w['append_ms']:.1f} ms, delete {DELETE_DOCS} "
        f"{w['delete_ms']:.1f} ms, sync {w['sync_ms']:.1f} ms; every appended doc its own top hit, no deleted "
        f"doc returned; ivf refused after the append, the rebuilt arm ({w['rebuild_arm_s']:.1f} s, first "
        f"{first_arm_s:.1f} s) finds {ivf_own:.4f} of 256 appended docs first at nprobe 8; compact "
        f"{w['compact_s']:.1f} s, reopen {w['reopen_s']:.1f} s, top-10 of 256 queries bitwise unchanged")
    rec["write_path"] = {k: w[k] for k in ("append_ms", "delete_ms", "sync_ms", "own_hit_ms", "rebuild_arm_s",
                                           "compact_s", "reopen_s", "stats")}
    rec["write_path"].update({"first_arm_s": first_arm_s, "ivf_own_hit": ivf_own})
    log(f"phase9 launches on the main path: {launches}")
    return rec, launches, kernels


def host_median_ms(fn, *, warmup: int = 2, iters: int = 10) -> float:
    """Median host wall ms of ``fn`` (synchronized) over ``iters`` warm calls."""
    for _ in range(warmup):
        timed(fn)
    return statistics.median(timed(fn)[1] for _ in range(iters))


def sidecars_of(path: str) -> bool:
    return os.path.exists(path + ".fsum") and os.path.exists(path + ".fspar")


def phase10_built_m2v(dev, tmp: str, lexical: dict, m2v_run: dict) -> tuple[dict, dict, list[dict]]:
    """built-1M-m2v: phase 4's 1M docs and phase 7's Model2Vec embedder
    through the library's entry point: ``IndexBuilder.build()`` writes a
    root (the bag-lane embed on the card, the FTVI slab, the JSON oracle
    and its packed FLXB arm, the metadata store, sidecars, the manifest),
    ``open_hybrid`` opens it on the card (the packed arm behind the delta),
    and phase 7's traffic goes through the fused lane with bitwise phase 7's
    results. Then 10,000 writes (the vector tier's append, then the lexical
    delta) searchable before a seal, an incremental seal (a two-segment
    stack held to an exact f64 BM25) and 1,000 deletes (no reopen: phase
    12's second watch opens a two-segment stack)."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import (
        BulkDeviceBm25Index, EmbedderStack, IndexableDocument, IndexBuilder, TwoTierConfig, open_hybrid,
    )
    from frankensearch_tpu_torch.lexical.delta import DeltaLease, DeltaLexicalIndex
    from frankensearch_tpu_torch.lexical.segments import SegmentedBm25

    m2v, texts, queries, singles = m2v_run["m2v"], lexical["texts"], lexical["queries"], lexical["singles"]
    root = os.path.join(tmp, "built")
    docs = [IndexableDocument(doc_id=f"doc-{i:07d}", content=t) for i, t in enumerate(texts)]  # phase 4's ids
    t0 = time.perf_counter()
    stats = IndexBuilder(root).with_documents(docs).with_embedder_stack(EmbedderStack(fast=m2v)).build()
    build_s = time.perf_counter() - t0
    del docs
    with open(os.path.join(root, "lexical", "CURRENT")) as f:
        gen_dir = os.path.join(root, "lexical", f.read().strip())
    flexb = os.path.join(gen_dir, "index.flexb")
    if stats.doc_count != H1M_DOCS or stats.skipped_low_signal or stats.per_doc_errors or stats.error_count:
        raise AssertionError(f"phase10: build stats {stats.doc_count} docs, {stats.skipped_low_signal} skipped, "
                             f"{stats.error_count} errors")
    if not os.path.exists(flexb) or not sidecars_of(flexb) or not sidecars_of(os.path.join(root, "vector.fast.idx")):
        raise AssertionError("phase10: no FLXB generation, or an artifact without its sidecars")
    sizes = {k: v for k, v in vars(stats.sizes).items()}
    log(f"phase10 IndexBuilder.build() of {stats.doc_count} docs: {build_s:.1f} s; sizes {sizes}; "
        f"warnings {stats.warnings}")

    config = TwoTierConfig(fast_only=True)  # phase 7's searcher config
    t0 = time.perf_counter()
    handle = open_hybrid(root, fast_embedder=m2v, config=config)
    open_s = time.perf_counter() - t0
    delta, searcher = handle.delta, handle.searcher
    sealed = delta.sealed if isinstance(delta, DeltaLexicalIndex) else None
    if searcher.lexical is not delta or type(sealed) is not BulkDeviceBm25Index or sealed.device != dev:
        raise AssertionError(f"phase10: the searcher's arm is {type(searcher.lexical).__name__} over "
                             f"{type(sealed).__name__}, not a delta over a packed arm on the card")
    tm = sealed._term_major()
    if sealed._hot is None or sealed._blocked is None or tm is None or not tm.packed:
        raise AssertionError("phase10: the packed arm did not load into the split layout")
    log(f"phase10 open_hybrid: {open_s:.1f} s; a DeltaLexicalIndex over the FLXB arm on {sealed.device} "
        f"(hot arm {sealed._hot.n_hot} terms, {len(sealed._blocked.classes)} flat classes, packed DAAT)")

    # the fused lane over the opened root: phase 7's traffic, phase 7's bits
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    pools: dict = {}
    fill = searcher._fill_fused

    def fill_noted(fused, live, *rest):
        if not pools:
            pools.update({i: [(c.doc_id, c.score) for c in fused[1][j]] for j, i in enumerate(live)})
        return fill(fused, live, *rest)

    def main_path():
        searcher._fill_fused = fill_noted
        try:
            return serve(searcher, queries, singles)
        finally:
            del searcher._fill_fused

    flat_inputs: dict = {}
    (batch, batch_ms, solo, single_ms), launches = drive(main_path, shapes, flat_inputs)
    need_launches("phase10", launches, ("K1", "K2", "K3"))
    if not all(o.metrics.phase1_fused for o in batch + solo) or searcher.last_fusion_path != "device":
        raise AssertionError("phase10: the fused phase-1 lane with the device fusion did not run")
    if [rows_of(o) for o in batch] != m2v_run["rows"] or [rows_of(o) for o in solo] != m2v_run["solo"]:
        raise AssertionError("phase10: the opened root's results differ from phase 7's")
    if pools != m2v_run["pools"]:
        raise AssertionError("phase10: the lexical pools differ from phase 7's")
    searcher._device_rrf_tail = lambda *args: (None, None)
    oracle = searcher.search_batch(queries, k=K)
    del searcher._device_rrf_tail
    if [rows_of(o) for o in oracle] != m2v_run["rows"] or searcher.last_fusion_path != "host":
        raise AssertionError("phase10: the device RRF differs from the host oracle")
    b256_ms = host_median_ms(lambda: searcher.search_batch(queries, k=K))
    b1_ms = host_median_ms(lambda: searcher.search_batch(singles[:1], k=K))
    log(f"phase10 fused lane over the opened root: B=256 {batch_ms:.2f} ms, then host median {b256_ms:.2f} ms "
        f"(10 warm calls), B=1 {b1_ms:.2f} ms; doc ids, fused scores and lexical pools of the batch and the "
        "singletons bitwise phase 7's; device RRF bitwise the host oracle")
    kernels = check_kernels("built-1M-m2v", handle.index.fast.slab, handle.index.fast._effective_mask(None, None),
                            shapes)
    kernels += check_flat_kernel("built-1M-m2v", sealed._blocked.classes, flat_inputs)

    # writes before a seal: the oracle arm serves them on the unfused path
    rng = np.random.default_rng(SEED + 10)
    vocab = np.array([f"w{i:05d}" for i in range(H1M_VOCAB)])
    common = vocab[(rng.zipf(H1M_ZIPF, size=(APPEND_DOCS, 2)) - 1) % H1M_VOCAB]
    new_ids = [f"new-{i:05d}" for i in range(APPEND_DOCS)]
    unique = [f"u{i:05d}x" for i in range(APPEND_DOCS)]
    new_texts = [f"{term} {a} {b}" for term, (a, b) in zip(unique, common)]
    delta.lease = DeltaLease(max_docs=2 * APPEND_DOCS, max_age_s=3600.0)  # one window, sealed below
    t0 = time.perf_counter()
    handle.index.append_fast(new_ids, m2v.embed_batch(new_texts))  # the vector tier's WAL, as a writer does
    for doc_id, text in zip(new_ids, new_texts):
        delta.add_document(IndexableDocument(doc_id=doc_id, content=text))
    delta.commit()
    write_s = time.perf_counter() - t0
    probe = sorted(rng.choice(APPEND_DOCS, 256, replace=False).tolist())
    before_seal = searcher.search_batch([unique[i] for i in probe], k=K)
    if any(o.metrics.phase1_fused for o in before_seal):
        raise AssertionError("phase10: unsealed writes took the fused lane")
    for i, out in zip(probe, before_seal):
        top = max((r for r in out.results if r.lexical_score is not None), key=lambda r: r.lexical_score, default=None)
        if top is None or top.doc_id != new_ids[i]:
            raise AssertionError(f"phase10: new doc {new_ids[i]} is not its unique term's top lexical hit")
    log(f"phase10 {APPEND_DOCS} writes (append_fast, then handle.delta) in {write_s:.1f} s; 256 of their unique terms "
        "each return their doc as the top lexical hit before the seal (the oracle arm, unfused)")

    t0 = time.perf_counter()
    receipt = delta.seal()
    seal_s = time.perf_counter() - t0
    stack = delta.sealed
    if (not os.path.exists(os.path.join(root, "lexical", receipt.generation, "seg-001.flexb"))
            or not isinstance(stack, SegmentedBm25) or len(stack.segments) != 2
            or any(seg.device != dev for seg in stack.segments)):
        raise AssertionError("phase10: the seal did not load a two-segment stack on the card")
    t0 = time.perf_counter()
    outright = lexical_oracle_check(stack, queries, K, phase="phase10")
    log(f"phase10 incremental seal {seal_s:.1f} s ({receipt.docs_sealed} docs, seg-001.flexb); the stack's "
        f"lexical top-{K} of the 256 queries vs exact f64 host BM25 over {stack.n_docs} docs: {outright} equal, "
        f"{256 - outright} differ only at ties within {ORACLE_REL_TOL:g} ({time.perf_counter() - t0:.1f} s)")

    # deletes across every arm
    victims = sorted(rng.choice(H1M_DOCS, DELETE_DOCS // 2, replace=False).tolist())
    gone = {f"doc-{i:07d}" for i in victims} | {new_ids[i] for i in rng.choice(APPEND_DOCS, DELETE_DOCS // 2,
                                                                               replace=False)}
    t0 = time.perf_counter()
    handle.delete(sorted(gone))
    delete_s = time.perf_counter() - t0
    probes = queries + [f"u{int(d[4:]):05d}x" for d in sorted(gone) if d.startswith("new-")]
    after = searcher.search_batch(probes, k=K)
    if any(r.doc_id in gone for o in after for r in o.results):
        raise AssertionError("phase10: a deleted doc was returned")
    log(f"phase10 {len(gone)} deletes ({DELETE_DOCS // 2} new) in {delete_s:.1f} s: none returned (no reopen "
        "here: phase 12's second watch opens a two-segment stack)")
    handle.close()
    del handle, stack, sealed
    torch.cuda.empty_cache()
    return ({"build_s": build_s, "open_s": open_s, "seal_s": seal_s, "write_s": write_s,
             "delete_s": delete_s, "sizes": sizes, "batch_ms": batch_ms, "single_ms": single_ms,
             "b256_host_median_ms": b256_ms, "b1_host_median_ms": b1_ms, "oracle_equal": outright},
            launches, kernels)


CLI_DOCS = 400_000  # phases 11-13: the CLI's root holds phase 4's first CLI_DOCS docs (a depth cut for the script's time)
CLI_MAX_BATCH = 256  # serve --serve-max-batch: phase 4's whole batch in one search_batch
CLI_COALESCE_MS = 200  # serve --coalesce-ms: time for the pipelined frames to arrive
CLI_WAIT_S = 900  # longest wait for a reply (the serve loop opens the CLI's root first)
#: added to every CLI subprocess's argv: empty on the card (the default
#: device); a CPU rehearsal sets ["--device", "cpu"]
CLI_DEVICE_ARGS: list = []


class LineCollector:
    """A stdout stand-in for an in-process ``serve``: keeps each line it
    is given with the host clock at its arrival."""

    def __init__(self) -> None:
        import threading

        self.lines: list[str] = []
        self.times: list[float] = []
        self._part = ""
        self._cond = threading.Condition()

    def write(self, text: str) -> int:
        with self._cond:
            self._part += text
            while "\n" in self._part:
                line, self._part = self._part.split("\n", 1)
                self.lines.append(line)
                self.times.append(time.perf_counter())
            self._cond.notify_all()
        return len(text)

    def flush(self) -> None:
        pass

    def wait(self, n: int) -> float:
        """Block until ``n`` lines have arrived; the n-th line's time."""
        with self._cond:
            if not self._cond.wait_for(lambda: len(self.lines) >= n, timeout=CLI_WAIT_S):
                raise AssertionError(f"phase11: serve wrote {len(self.lines)} lines, {n} awaited")
            return self.times[n - 1]


def run_cli(argv: list[str]) -> dict:
    """One in-process CLI call (``--format json``): its envelope."""
    import io

    from frankensearch_tpu_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["--format", "json", *argv])
    env = json.loads(out.getvalue())
    if rc != 0 or not env["ok"]:
        raise AssertionError(f"phase11: {argv[0]} failed: {env.get('error')}")
    return env


def cli_subprocess(argv: list[str]) -> tuple[dict, float]:
    """``python -m frankensearch_tpu_torch.cli --format json ARGV`` (no
    ``--device`` unless CLI_DEVICE_ARGS gives one: the card) from the
    checkout: (envelope, wall s)."""
    return cli_subprocesses(argv)[0]


def cli_subprocesses(*argvs: list[str]) -> list[tuple[dict, float]]:
    """:func:`cli_subprocess` of each ``argv``, all started together:
    [(envelope, wall s from the common start to its exit)]."""
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "frankensearch_tpu_torch.cli", "--format", "json", *argv,
                               *CLI_DEVICE_ARGS], cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for argv in argvs]
    out = []
    try:
        for argv, proc in zip(argvs, procs):
            stdout, stderr = proc.communicate(timeout=CLI_WAIT_S)
            if proc.returncode != 0:
                raise AssertionError(f"cli {argv[0]} exited {proc.returncode}: {stderr[-2000:]}")
            out.append((json.loads(stdout), time.perf_counter() - t0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)
    return out


@contextlib.contextmanager
def spied(*swaps):
    """Each ``(owner, name, make)`` swaps ``owner.name`` for
    ``make(original)`` inside the block; every original goes back on the
    way out."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in swaps]
    try:
        for (owner, name, make), (_, _, real) in zip(swaps, saved):
            setattr(owner, name, make(real))
        yield
    finally:
        for owner, name, real in reversed(saved):
            setattr(owner, name, real)


def noting(into: list):
    """A swap's ``make``: the original, each return value also appended to
    ``into``."""
    def make(real):
        def noted(*args, **kwargs):
            into.append(real(*args, **kwargs))
            return into[-1]
        return noted
    return make


def host_ms(into: list):
    """A swap's ``make``: the original, each call's host ms (the card
    synchronized first and after) appended to ``into``."""
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)

    def make(real):
        def timed_call(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            sync()
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed_call
    return make


def json_rows(results) -> list:
    """Result rows as the serve loop writes them, through JSON."""
    return json.loads(json.dumps([r.to_dict() for r in results], default=str))


def serve_session(root: str, queries: list[str], singles: list[str], *, argv: tuple = (), full: bool = True,
                  during=None) -> dict:
    """``cli serve`` in-process on ``root`` with ``--warmup`` (and
    ``argv``): the batch's ``search`` frames written at once (one
    coalesced ``search_batch``; with ``full``, twice, the second time
    warm), each singleton followed by a ``ping`` (which ends the coalescing window
    at once, so the singleton goes through ``search()`` without waiting
    out ``--coalesce-ms``), with ``full`` a ``search_batch`` op, a
    ``stream`` search and ``status``, then ``during()`` (on the client's
    thread, while the server waits for its next frame) and ``shutdown``.
    Each step's frames are written once the
    replies to the last have arrived. Returns the replies and host times
    (frame write to its step's last reply), the pressure fractions the
    server sensed, and the handle its ``_open`` returned."""
    import threading

    from frankensearch_tpu_torch.cli import main as cli
    from frankensearch_tpu_torch.ops import pressure

    sensed: dict = {"host": [], "device": []}
    collector = LineCollector()
    read_fd, write_fd = os.pipe()
    steps: dict = {}
    failed: list = []

    def client():
        try:
            with os.fdopen(write_fd, "w") as w:
                def send(name: str, frames: list[dict], n_replies: int) -> None:
                    at = len(collector.lines)
                    t0 = time.perf_counter()
                    w.write("".join(json.dumps(f) + "\n" for f in frames))
                    w.flush()
                    steps[name] = (at, at + n_replies, (collector.wait(at + n_replies) - t0) * 1e3)

                steps["ready"] = (0, 1, (collector.wait(1) - t_start) * 1e3)  # the warmup report
                # the first real batch, then the same one warm
                for name in ("batch", "batch_again") if full else ("batch",):
                    send(name, [{"op": "search", "query": q, "k": K} for q in queries], len(queries))
                for i, q in enumerate(singles):
                    send(f"single{i}", [{"op": "search", "query": q, "k": K}, {"op": "ping"}], 2)
                if full:
                    send("search_batch", [{"op": "search_batch", "queries": queries, "k": K}], 1)
                    send("stream", [{"op": "search", "query": singles[0], "k": K, "stream": True}], 3)
                    send("status", [{"op": "status"}], 1)
                try:
                    if during is not None:
                        during()
                finally:
                    send("shutdown", [{"op": "shutdown"}], 1)
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            failed.append(e)

    handles: list = []
    reader = os.fdopen(read_fd, "r")
    feeder = threading.Thread(target=client, daemon=True)
    try:
        with spied((pressure, "sense_host_memory", noting(sensed["host"])),
                   (pressure, "sense_device_hbm", noting(sensed["device"])), (cli, "_open", noting(handles)),
                   (sys, "stdin", lambda _: reader), (sys, "stdout", lambda _: collector)):
            t_start = time.perf_counter()
            feeder.start()
            rc = cli.main(["serve", "--root", root, "--serve-max-batch", str(CLI_MAX_BATCH),
                           "--coalesce-ms", str(CLI_COALESCE_MS), "--warmup", *argv])
            feeder.join(timeout=CLI_WAIT_S)
    finally:
        reader.close()
    if failed:
        raise failed[0]
    if rc != 0 or feeder.is_alive() or len(handles) != 1:
        raise AssertionError(f"phase11: serve exited {rc}, client alive {feeder.is_alive()}, "
                             f"{len(handles)} opens of the root")
    lines = [json.loads(x) for x in collector.lines]
    return {"replies": {name: lines[a:b] for name, (a, b, _) in steps.items()},
            "ms": {name: ms for name, (_, _, ms) in steps.items()}, "sensed": sensed, "handle": handles[0]}


def phase11_cli(dev, tmp: str, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """cli-400k: the product CLI over phase 4's first CLI_DOCS docs. ``index`` (in
    process, no ``--device``: the card; the default stack, HashEmbedder(256),
    a bf16 slab and the FLXB arm) builds a root from a JSONL corpus; ``serve
    --warmup`` answers phase 4's 256 queries as one coalesced batch, eight
    singletons through ``search()``, a ``search_batch`` op, a stream search
    and ``status``, every reply bitwise the library's over the handle serve
    opened (a spy on the CLI's ``_open``); the lexical top-k against an
    exact f64 BM25; then
    ``version`` and ``doctor --verify`` in two subprocesses started
    together, each on the card
    (the one-shot ``search`` subprocess runs in phase 12, over its small
    root)."""
    import torch

    from frankensearch_tpu_torch import BulkDeviceBm25Index
    from frankensearch_tpu_torch.lexical.delta import DeltaLexicalIndex
    from frankensearch_tpu_torch.ops.pressure import PressureState

    texts, queries, singles = lexical["texts"][:CLI_DOCS], lexical["queries"], lexical["singles"]
    corpus, root = os.path.join(tmp, "cli_corpus.jsonl"), os.path.join(tmp, "cli_root")
    with open(corpus, "w", encoding="utf-8") as f:
        f.writelines(json.dumps({"id": f"doc-{i:07d}", "content": t}) + "\n" for i, t in enumerate(texts))
    t0 = time.perf_counter()
    built = run_cli(["index", corpus, "--root", root])["data"]
    index_s = time.perf_counter() - t0
    if built["doc_count"] != len(texts) or built["error_count"] or built["semantic"]:
        raise AssertionError(f"phase11: index built {built}")
    log(f"phase11 cli index of {built['doc_count']} docs: {index_s:.1f} s; sizes {built['sizes']}")

    shapes: set = set()
    flat_inputs: dict = {}
    session, launches = drive(lambda: serve_session(root, queries, singles), shapes, flat_inputs)
    need_launches("phase11", launches, ("K1", "K2", "K3"))
    # the shapes phases 11-12 hold to the twins on the CLI's root; phase 13 skips them
    lexical["cli_shapes"], lexical["cli_flat"] = set(shapes), set(flat_inputs)
    lexical["cli_docs"] = len(texts)  # the root phase 12 watches
    replies, ms, sensed = session["replies"], session["ms"], session["sensed"]
    warm = replies["ready"][0]
    if not warm["ok"] or warm["data"]["op"] != "warmup":
        raise AssertionError(f"phase11: serve --warmup reported {warm}")

    # the library over the handle serve opened (a spy on the CLI's _open),
    # not a second 34-42 s open of the root
    oracle = session.pop("handle")
    oracle.searcher.governor = None
    sealed = oracle.delta.sealed if isinstance(oracle.delta, DeltaLexicalIndex) else None
    if type(sealed) is not BulkDeviceBm25Index or sealed.device != dev or sealed._blocked is None:
        raise AssertionError(f"phase11: the opened root's lexical arm is not the FLXB arm on the card, split "
                             f"({type(sealed).__name__} on {getattr(sealed, 'device', None)})")
    want = oracle.searcher.search_batch(queries, k=K)
    if not all(o.metrics.phase1_fused for o in want) or oracle.searcher.last_fusion_path != "device":
        raise AssertionError("phase11: the library's batch did not take the fused lane")
    want_rows = [json_rows(o.results) for o in want]
    for batch in (replies["batch"], replies["batch_again"]):
        if [r.get("meta") for r in batch] != [{"coalesced": len(queries)}] * len(queries):
            raise AssertionError(f"phase11: the batch did not coalesce into one call: {batch[0].get('meta')}")
        if [r["data"] for r in batch] != want_rows:
            raise AssertionError("phase11: the coalesced replies differ from the library's search_batch")
    op = replies["search_batch"][0]["data"]
    if [r["query"] for r in op] != queries or [r["results"] for r in op] != want_rows:
        raise AssertionError("phase11: the search_batch op differs from the library's search_batch")
    solo_rows = [json_rows(oracle.searcher.search(q, k=K).results) for q in singles]
    for i, q in enumerate(singles):
        reply, pong = replies[f"single{i}"]
        if pong["data"] != {"op": "pong"} or "meta" in reply or reply["data"] != solo_rows[i]:
            raise AssertionError(f"phase11: singleton {q!r} differs from the library's search()")
    frames = replies["stream"]
    if [f["seq"] for f in frames] != [1, 2, 3] or [f["kind"] for f in frames] != ["phase", "metrics", "end"]:
        raise AssertionError(f"phase11: stream frames {[(f.get('seq'), f.get('kind')) for f in frames]}")
    if frames[0]["payload"]["results"] != solo_rows[0] or frames[1]["payload"]["device_kind"] != dev.type:
        raise AssertionError("phase11: the stream's phase frame differs from search()")
    status = replies["status"][0]["data"]
    if (status["doc_count"] != len(texts) or status["lexical"] is not True or status["reloads"]
            or status["pressure"] not in PressureState.__members__):
        raise AssertionError(f"phase11: status {status}")
    log(f"phase11 serve: ready (open + warmup) {ms['ready'] / 1e3:.1f} s, warmup {warm['data']}; "
        f"{len(queries)} pipelined searches coalesced into one search_batch, frame write to last reply "
        f"{ms['batch']:.2f} ms, the same batch again {ms['batch_again']:.2f} ms; singletons (search + ping) " + ", ".join(f"{ms[f'single{i}']:.2f}"
                                                                       for i in range(len(singles)))
        + f" ms; search_batch op {ms['search_batch']:.2f} ms; status {status}; pressure fractions sensed "
        f"(host, device): last ({sensed['host'][-1]:.4f}, {sensed['device'][-1]:.6f}), max "
        f"({max(sensed['host']):.4f}, {max(sensed['device']):.6f}) over {len(sensed['host'])} observations")
    log(f"phase11 the library over the handle serve opened: the coalesced replies and the "
        f"search_batch op bitwise its search_batch, the singletons and the stream's phase bitwise its search()")

    t0 = time.perf_counter()
    outright = lexical_oracle_check(sealed, queries, K, phase="phase11")
    log(f"phase11 the root's lexical top-{K} of {len(queries)} queries vs exact f64 host BM25: {outright} equal, "
        f"{len(queries) - outright} differ only at ties within {ORACLE_REL_TOL:g} ({time.perf_counter() - t0:.1f} s)")
    kernels = check_kernels("cli-400k", oracle.index.fast.slab, oracle.index.fast._effective_mask(None, None), shapes)
    kernels += check_flat_kernel("cli-400k", sealed._blocked.classes, flat_inputs)
    oracle.close()
    del oracle, sealed, want
    torch.cuda.empty_cache()

    (version, version_s), (doctor, doctor_s) = cli_subprocesses(["version"], ["doctor", "--root", root, "--verify"])
    if len(version["data"]["devices"]) != torch.cuda.device_count() or version["data"]["torch"] != torch.__version__:
        raise AssertionError(f"phase11: version {version['data']}")
    checks = {c["check"]: c for c in doctor["data"]["findings"]}
    if (not doctor["data"]["healthy"] or checks["cuda"]["ok"] != (dev.type == "cuda")
            or "CRC verified" not in checks["lexical_generation"]["detail"]
            or "slab CRC verified" not in checks["fast_artifact_integrity"]["detail"]):
        raise AssertionError(f"phase11: doctor {doctor['data']['findings']}")
    log(f"phase11 subprocesses, started together: version {version_s:.1f} s (devices "
        f"{version['data']['devices']}), doctor --verify {doctor_s:.1f} s (healthy, slab and FLXB CRCs verified); "
        f"the one-shot search runs in phase 12")
    return ({"index_s": index_s, "sizes": built["sizes"], "serve_ms": ms, "warmup": warm["data"],
             "oracle_equal": outright, "sensed_last": [sensed["host"][-1], sensed["device"][-1]],
             "version_s": version_s, "doctor_s": doctor_s}, launches, kernels)


LIVE_FILES = 512  # phase 12: text files of the watched directory's first state
LIVE_RECORDS = 256  # records of its one NDJSON file
LIVE_CHURN = 16  # files modified, deleted, renamed and created between the two watch runs; records dropped
LIVE_UNCHANGED = 64  # run-1 docs whose tokens are queried again after run 2
FED_DOCS = 20_000  # the small root: the federation's second shard and the daemon's root
DAEMON_CALLS, DAEMON_THREADS, DAEMON_TEXTS = 64, 8, 4
DAEMON_MAX_REQUESTS = 256  # the daemon's --max-requests; pings fill what the phase did not use
SHADOW_QUERIES = 64
SHADOW_TIE_REL = 1e-5  # a shadow divergence must lie at a tie within this of the k-th score
TUI_K = 8  # the search screen's k


def live_corpus(live: str, texts: list[str]) -> dict:
    """The watched directory's first state: LIVE_FILES text files
    ``f%04d.txt`` and ``recs.jsonl`` of LIVE_RECORDS records ``wrec-%04d``,
    doc i holding the unique token ``wtok%04d`` beside phase 4's words.
    Returns {token: doc id}."""
    os.makedirs(live, exist_ok=True)
    tokens = {}
    for i in range(LIVE_FILES):
        with open(os.path.join(live, f"f{i:04d}.txt"), "w", encoding="utf-8") as f:
            f.write(f"wtok{i:04d} {texts[i]}")
        tokens[f"wtok{i:04d}"] = f"f{i:04d}.txt"
    records = []
    for j in range(LIVE_RECORDS):
        i = LIVE_FILES + j
        records.append({"id": f"wrec-{j:04d}", "content": f"wtok{i:04d} {texts[i]}"})
        tokens[f"wtok{i:04d}"] = f"wrec-{j:04d}"
    write_records(os.path.join(live, "recs.jsonl"), records)
    return tokens


def write_records(path: str, records: list[dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(r) + "\n" for r in records)


def churn(live: str, texts: list[str]) -> dict:
    """Between the watch runs: modify, delete and rename LIVE_CHURN files
    each, create LIVE_CHURN (``c%04d.txt``, token ``wnew%04d``), drop
    LIVE_CHURN records. Returns the expectations: {"top": {token: id},
    "absent": {token: id that must not appear}}."""
    n = LIVE_CHURN
    top, absent = {}, {}
    for i in range(n):  # modified: a new token, the old one gone
        with open(os.path.join(live, f"f{i:04d}.txt"), "w", encoding="utf-8") as f:
            f.write(f"wmod{i:04d} changed {texts[i]}")
        top[f"wmod{i:04d}"] = f"f{i:04d}.txt"
        absent[f"wtok{i:04d}"] = f"f{i:04d}.txt"
    for i in range(n, 2 * n):  # deleted
        os.remove(os.path.join(live, f"f{i:04d}.txt"))
        absent[f"wtok{i:04d}"] = f"f{i:04d}.txt"
    for i in range(2 * n, 3 * n):  # renamed: the same content under a new path
        os.rename(os.path.join(live, f"f{i:04d}.txt"), os.path.join(live, f"g{i:04d}.txt"))
        top[f"wtok{i:04d}"] = f"g{i:04d}.txt"
        absent[f"wtok{i:04d}#from"] = f"f{i:04d}.txt"
    for i in range(n):  # created
        with open(os.path.join(live, f"c{i:04d}.txt"), "w", encoding="utf-8") as f:
            f.write(f"wnew{i:04d} {texts[LIVE_FILES + LIVE_RECORDS + i]}")
        top[f"wnew{i:04d}"] = f"c{i:04d}.txt"
    kept = []
    for j in range(LIVE_RECORDS):  # the first LIVE_CHURN records dropped
        i = LIVE_FILES + j
        if j < n:
            absent[f"wtok{i:04d}"] = f"wrec-{j:04d}"
        else:
            kept.append({"id": f"wrec-{j:04d}", "content": f"wtok{i:04d} {texts[i]}"})
    write_records(os.path.join(live, "recs.jsonl"), kept)
    return {"top": top, "absent": absent}


def watch_run(live: str, root: str, *extra) -> tuple[dict, dict]:
    """``cli watch`` in process, once; (its envelope's data, host ms of
    its open, fast-tier appends, deletes and the seal at exit)."""
    from frankensearch_tpu_torch import builder
    from frankensearch_tpu_torch.index.two_tier import TwoTierIndex
    from frankensearch_tpu_torch.lexical.delta import DeltaLexicalIndex

    ms: dict = {"open": [], "append_fast": [], "delete": [], "seal": []}
    t0 = time.perf_counter()
    with spied((builder, "open_hybrid", host_ms(ms["open"])), (TwoTierIndex, "append_fast", host_ms(ms["append_fast"])),
               (builder.HybridHandle, "delete", host_ms(ms["delete"])), (DeltaLexicalIndex, "seal", host_ms(ms["seal"]))):
        env = run_cli(["watch", live, "--root", root, "--once", "--cycles", "1", "--debounce", "0", *extra])
    return env["data"], {"wall": (time.perf_counter() - t0) * 1e3, **ms}


def start_daemon(root: str, sock: str):
    """``cli daemon`` over ``root`` as a subprocess (its own CUDA context
    and stdout); returns the process once its socket exists."""
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "frankensearch_tpu_torch.cli", "--format", "json", "daemon", "--root", root,
            "--socket", sock, "--concurrency", "4", "--max-requests", str(DAEMON_MAX_REQUESTS),
            "--idle-timeout", str(CLI_WAIT_S), "--accept-timeout", "0.5", *CLI_DEVICE_ARGS]
    proc = subprocess.Popen(argv, cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    deadline = time.perf_counter() + CLI_WAIT_S
    while not os.path.exists(sock):
        if proc.poll() is not None or time.perf_counter() > deadline:
            proc.kill()
            out, err = proc.communicate(timeout=60)
            raise AssertionError(f"phase12: the daemon did not start (rc {proc.returncode}): {err[-2000:]}")
        time.sleep(0.1)
    return proc


def daemon_burst(sock: str, texts: list[str]) -> float:
    """DAEMON_CALLS embeds of DAEMON_TEXTS texts from DAEMON_THREADS
    threads, each bitwise the local HashEmbedder(256)'s; host s."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from frankensearch_tpu_torch import HashEmbedder
    from frankensearch_tpu_torch.core.daemon import DaemonClient

    emb = HashEmbedder(dim=DIM)
    batches = [[texts[(i * DAEMON_TEXTS + j) % len(texts)] for j in range(DAEMON_TEXTS)] for i in range(DAEMON_CALLS)]

    def call(batch):
        client = DaemonClient(sock, expect_embedder_id=emb.embedder_id, expect_revision=emb.revision,
                              expect_dim=DIM, timeout_s=60.0)
        return np.asarray(client.embed(batch), dtype=np.float32)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(DAEMON_THREADS) as pool:
        got = list(pool.map(call, batches))
    burst_s = time.perf_counter() - t0
    for batch, vecs in zip(batches, got):
        if vecs.tobytes() != emb.embed_batch(batch).tobytes():
            raise AssertionError("phase12: a daemon embed differs from the local HashEmbedder's")
    return burst_s


def stop_daemon(proc, sock: str, sent: int) -> dict:
    """Ping the daemon up to its --max-requests so it exits on its own;
    its envelope."""
    from frankensearch_tpu_torch.core.daemon import DaemonClient

    client = DaemonClient(sock, timeout_s=60.0)
    for _ in range(DAEMON_MAX_REQUESTS - sent):
        if not client.ping():
            raise AssertionError("phase12: the daemon stopped answering pings")
    out, err = proc.communicate(timeout=CLI_WAIT_S)
    if proc.returncode != 0:
        raise AssertionError(f"phase12: the daemon exited {proc.returncode}: {err[-2000:]}")
    return json.loads(out)


def tui_session(root: str, script: list[str], evidence: str) -> tuple[str, dict]:
    """``cli tui`` in process with ``script`` on stdin. Returns its frames
    and what the spies saw: the handle its ``_open`` returned
    (``handles``), each search line's query, results and host ms
    (``lines``), and the ``IncrementalSearcher`` it made (``incs``)."""
    import io

    from frankensearch_tpu_torch.cli import main as cli
    from frankensearch_tpu_torch.fusion import incremental
    from frankensearch_tpu_torch.tui import screens

    seen: dict = {"handles": [], "lines": [], "incs": []}

    def screen(base):
        class Screen(base):
            def handle(self, event, shell):
                t0 = time.perf_counter()
                super().handle(event, shell)
                if event.kind == "key" and event.value == "enter":
                    seen["lines"].append((self.query, [r.to_dict() for r in self.results],
                                          (time.perf_counter() - t0) * 1e3))
        return Screen

    def searcher(base):
        class Inc(base):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                seen["incs"].append(self)
        return Inc

    out = io.StringIO()
    with spied((cli, "_open", noting(seen["handles"])), (screens, "SearchScreen", screen),
               (incremental, "IncrementalSearcher", searcher),
               (sys, "stdin", lambda _: io.StringIO("".join(line + "\n" for line in script))),
               (sys, "stdout", lambda _: out)):
        rc = cli.main(["tui", "--root", root, "--evidence", evidence])
    if rc != 0:
        raise AssertionError(f"phase12: tui exited {rc}")
    return out.getvalue(), seen


def tui_replay(handle, lines, structured: set):
    """Each recorded line's results bitwise the library's over the same
    handle: ``SyncTwoTierSearcher`` + ``IncrementalSearcher`` for plain
    lines, ``search()`` for structured ones. Returns the replay's
    ``IncrementalSearcher``."""
    from frankensearch_tpu_torch.fusion.incremental import IncrementalSearcher
    from frankensearch_tpu_torch.fusion.sync_searcher import SyncTwoTierSearcher

    s = handle.searcher
    sync = SyncTwoTierSearcher(handle.index, lexical=s.lexical, config=s.config)
    inc = IncrementalSearcher(search_fn=lambda q, k: sync.search(q, s.fast_embedder.embed(q), k=k).results,
                              text_fn=lambda r: s.default_text_fn(r.doc_id))
    for q, got, _ in lines:
        want = s.search(q, k=TUI_K).results if q in structured else inc.search(q, k=TUI_K)
        if got != [r.to_dict() for r in want]:
            raise AssertionError(f"phase12: the tui's results for {q!r} differ from the library's")
    return inc


def freshness(handle, results: dict, expect: dict, unchanged: dict) -> dict:
    """Each created, modified, renamed and untouched doc its token's top hit
    (or, failing that, in the top TUI_K at lexical rank 1); no deleted,
    renamed-from or dropped id, no modified doc under its old token."""
    held = {"top": 0, "lexical_rank_1": 0}
    for token, doc_id in {**expect["top"], **unchanged}.items():
        ids = [r["doc_id"] for r in results[token]]
        if ids[:1] == [doc_id]:
            held["top"] += 1
            continue
        lex = handle.searcher.lexical.search(token, 1)
        if doc_id not in ids or [r.doc_id for r in lex] != [doc_id]:
            raise AssertionError(f"phase12: {doc_id} is not {token!r}'s top hit: {ids}")
        held["lexical_rank_1"] += 1
    for token, doc_id in expect["absent"].items():
        if doc_id in [r["doc_id"] for r in results[token.split("#")[0]]]:
            raise AssertionError(f"phase12: {doc_id} still answers {token.split('#')[0]!r}")
    return held


def metrics_ms(frames: str) -> dict:
    """The TUI's own latency line (``:metrics``): count, mean, p50, p95, p99."""
    line = [x for x in frames.splitlines() if x.startswith("search_ms")][-1].split()
    return dict(zip(("count", "mean", "p50", "p95", "p99"), [int(line[1])] + [float(x) for x in line[2:]]))


def same_fast_top(before: dict, after: dict) -> None:
    """Fast top-10s equal: ids and score bits, rows of equal score in any order."""
    for token, want in before.items():
        got = after[token]
        if sorted(got) != sorted(want) or [s for _, s in got] != [s for _, s in want]:
            raise AssertionError(f"phase12: the fast top-10 of {token!r} moved across the fold")


def shadow_ties(corpus: str, env: dict) -> int:
    """Every shadow divergence at a tie in the oracle's scores: a moved
    rank between two docs within SHADOW_TIE_REL of each other, a missing
    or extra doc within it of the k-th score. Returns the divergences."""
    from frankensearch_tpu_torch.cli.main import _iter_corpus
    from frankensearch_tpu_torch.lexical.memory_index import MemoryLexicalIndex

    samples = env["samples"]
    if len(samples) < sum(env["divergences_by_kind"].values()):
        raise AssertionError("phase12: shadow's samples do not hold every divergence")
    if not samples:
        return 0
    oracle = MemoryLexicalIndex.bulk_build(list(_iter_corpus(corpus)))
    full = {}
    for d in samples:
        q = d["query"]
        if q not in full:
            full[q] = oracle.search_candidates(q, 10 * K)
        scores = [c.score for c in full[q]]
        by_id = {c.doc_id: c.score for c in full[q]}
        kth = scores[K - 1] if len(scores) >= K else 0.0
        if d["kind"] == "rank_moved":
            a, b = (int(x) for x in d["detail"].split(" -> "))
            pair = (scores[a], scores[b]) if max(a, b) < len(scores) else (0.0, 1.0)
        elif d["kind"] in ("missing_doc", "extra_doc"):
            pair = (by_id.get(d["doc_id"], float("inf")), kth)
        else:
            raise AssertionError(f"phase12: shadow divergence {d}")
        if abs(pair[0] - pair[1]) > SHADOW_TIE_REL * max(abs(pair[1]), 1.0):
            raise AssertionError(f"phase12: shadow divergence {d} is not at a tie ({pair})")
    return len(samples)


def phase12_live(dev, tmp: str, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """cli-live-400k: ``watch`` into phase 11's root twice (768 docs,
    then modifies, deletes, renames, creates and dropped records under
    ``--durability-window``), ``tui`` on the sync searcher over the watched
    root (every line bitwise the library's over the handle it opened,
    freshness, pool reuse, ``:status``, K1/K2/K3 counted), the
    ``daemon`` in its own process over a 20,000-doc root (a 64-call burst
    bitwise the local embedder, then every embed of a federated ``search
    --federate --daemon-socket`` over it and a second 20,000-doc root),
    ``daemon --wal-poll`` folding the WAL,
    ``shadow --candidate device``; phase 11's one-shot ``search``
    subprocess, over the small root."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import HashEmbedder, open_hybrid
    from frankensearch_tpu_torch.fusion import daemon_fallback
    from frankensearch_tpu_torch.index.two_tier import TwoTierIndex

    texts, queries = lexical["texts"], lexical["queries"]
    root, rec = os.path.join(tmp, "cli_root"), {}
    wall = {}

    # the small root: phase 3's corpus, its first FED_DOCS docs
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)
    docs, vocab3, probs3 = hybrid_corpus(rng)
    queries3 = query_texts(rng, vocab3, probs3, 256)
    small_corpus, small = os.path.join(tmp, "fed_corpus.jsonl"), os.path.join(tmp, "fed_root")
    small2_corpus, small2 = os.path.join(tmp, "fed2_corpus.jsonl"), os.path.join(tmp, "fed2_root")
    for corpus, root_i, lo in ((small_corpus, small, 0), (small2_corpus, small2, FED_DOCS)):
        write_records(corpus, [{"id": f"fed-{i:06d}", "content": d.content, "title": d.title}
                               for i, d in enumerate(docs[lo:lo + FED_DOCS], start=lo)])
        built = run_cli(["index", corpus, "--root", root_i])["data"]
        if built["doc_count"] != FED_DOCS:
            raise AssertionError(f"phase12: the small root {root_i} built {built}")
    wall["small_index_s"] = time.perf_counter() - t0

    # phase 11's one-shot search subprocess, over the small root
    lib = open_hybrid(small)
    want = json_rows(lib.searcher.search(queries3[0], k=K).results)
    lib.close()
    one, wall["one_shot_search_s"] = cli_subprocess(["search", queries3[0], "--root", small, "-k", str(K)])
    if one["meta"]["device"] != dev.type or [{k: v for k, v in r.items() if k != "snippet"}
                                           for r in one["data"]] != want:
        raise AssertionError(f"phase12: the one-shot search differs from search(): {one['data'][:2]}")

    sock_dir = tempfile.mkdtemp(prefix="fsd-")
    if len(sock_dir) > 90:  # a unix socket path holds at most 108 bytes
        os.rmdir(sock_dir)
        sock_dir = tempfile.mkdtemp(prefix="fsd-", dir="/tmp")
    sock = os.path.join(sock_dir, "d.sock")
    t0 = time.perf_counter()
    proc = start_daemon(small, sock)
    try:
        wall["daemon_start_s"] = time.perf_counter() - t0
        wall["daemon_burst_s"] = daemon_burst(sock, queries3)
        sent = DAEMON_CALLS

        # watch, twice
        live = os.path.join(tmp, "live")
        tokens = live_corpus(live, texts)
        run1, ms1 = watch_run(live, root)
        n_live = LIVE_FILES + LIVE_RECORDS
        if (run1["batches"] != [{"ingested": n_live, "deleted": 0, "renamed": 0}]
                or run1["doc_count"] != lexical["cli_docs"] + n_live):
            raise AssertionError(f"phase12: watch run 1 {run1}")
        expect = churn(live, texts)
        run2, ms2 = watch_run(live, root, "--durability-window", "0.5")
        n = LIVE_CHURN
        want2 = {"ingested": 2 * n + LIVE_RECORDS - n, "deleted": 2 * n, "renamed": n}
        docs_after = lexical["cli_docs"] + n_live + n - 2 * n
        if run2["batches"] != [want2] or run2["doc_count"] != docs_after:
            raise AssertionError(f"phase12: watch run 2 {run2}, expected {want2} and {docs_after} docs")
        log(f"phase12 watch run 1: {n_live} docs in {ms1['wall'] / 1e3:.1f} s (open {ms1['open'][0] / 1e3:.1f} s; "
            f"fast append {ms1['append_fast']} ms; seal at exit {ms1['seal']} ms); run 2 {want2} in "
            f"{ms2['wall'] / 1e3:.1f} s (open {ms2['open'][0] / 1e3:.1f} s; fast appends {ms2['append_fast']} ms; "
            f"deletes {ms2['delete']} ms; seal {ms2['seal']} ms)")

        # tui on the sync searcher over the watched root
        unchanged = {t: d for t, d in tokens.items()
                     if t not in expect["absent"] and d not in expect["top"].values()
                     and not d.startswith(("f000", "f001", "f002", "f003", "f004"))}
        unchanged = dict(sorted(unchanged.items())[:: max(1, len(unchanged) // LIVE_UNCHANGED)][:LIVE_UNCHANGED])
        fresh = sorted({t.split("#")[0] for t in (*expect["top"], *expect["absent"], *unchanged)})
        w = [f"w{i:05d}" for i in range(40)]  # phase 4's commonest words
        chains = [q for a, b, c in ((w[5], w[9], w[30]), (w[1], w[2], w[3]), (w[7], w[11], w[13]),
                                    (w[20], w[4], w[6])) for q in (a, f"{a} {b}", f"{a} {b} {c}")]
        structured = [f"{w[5]} AND {w[9]}", f"{w[1]} OR {w[12]}", f"{w[5]} -{w[9]}", f"{w[12]} -{w[1]}"]
        script = [*queries, *fresh, *chains, *structured, ":status", ":metrics", ":q"]
        shapes, flat_inputs = set(), {}
        t0 = time.perf_counter()
        (frames, spies), launches = drive(lambda: tui_session(root, script, os.path.join(tmp, "tui.jsonl")),
                                          shapes, flat_inputs)
        lexical["cli_shapes"] |= shapes
        lexical["cli_flat"] |= set(flat_inputs)
        wall["tui_s"] = time.perf_counter() - t0
        need_launches("phase12", launches, ("K1", "K2", "K3"))
        (handle,), (tui_inc,) = spies["handles"], spies["incs"]
        if [q for q, _, _ in spies["lines"]] != script[:-3]:
            raise AssertionError("phase12: the tui did not answer every line")
        if "reload_failed" in frames:
            raise AssertionError("phase12: the tui failed a reload")
        t0 = time.perf_counter()
        replay = tui_replay(handle, spies["lines"], set(structured))
        wall["tui_replay_s"] = time.perf_counter() - t0
        results = {q: got for q, got, _ in spies["lines"]}
        held = freshness(handle, results, expect, unchanged)
        chain_reuses = tui_inc.state.pool_reuses
        if chain_reuses < 8 or replay.state.pool_reuses != chain_reuses:
            raise AssertionError(f"phase12: pool reuses {chain_reuses} (replay {replay.state.pool_reuses})")
        status = dict(line.split(None, 1) for line in frames.split("[status]")[-1].split("[metrics]")[0]
                      .splitlines()[1:] if line.strip())
        if int(status["docs"]) != docs_after:
            raise AssertionError(f"phase12: :status docs {status['docs']}, expected {docs_after}")
        tui_ms = metrics_ms(frames)
        line_ms = sorted(ms for _, _, ms in spies["lines"])
        log(f"phase12 tui: {len(spies['lines'])} lines in {wall['tui_s']:.1f} s (open included); search_ms "
            f"{tui_ms}; per-line host ms p50 {line_ms[len(line_ms) // 2]:.2f} p99 "
            f"{line_ms[int(len(line_ms) * 0.99)]:.2f}; pool reuses {chain_reuses}; every line bitwise the "
            f"library's over the handle it opened (replay {wall['tui_replay_s']:.1f} s); freshness of "
            f"{len(expect['top']) + len(unchanged)} docs: {held}; {len(expect['absent'])} gone ids absent; "
            f"status {status}; launches {launches}")
        sealed = [seg for seg in getattr(handle.delta.sealed, "segments", [handle.delta.sealed])
                  if getattr(seg, "_blocked", None) is not None]
        if len(sealed) != 1:
            raise AssertionError(f"phase12: {len(sealed)} segments in the split layout, expected 1")
        kernels = check_kernels("cli-live-400k", handle.index.fast.slab, handle.index.fast._effective_mask(None, None),
                                shapes)
        kernels += check_flat_kernel("cli-live-400k", sealed[0]._blocked.classes, flat_inputs)
        emb = HashEmbedder(dim=DIM)
        fast_before = {t: [(h.doc_id, h.score) for h in handle.index.search_fast_classified(emb.embed(t), K).hits]
                       for t in fresh}
        handle.close()
        del handle, sealed, replay, spies
        torch.cuda.empty_cache()

        # a federated one-shot search through the daemon, over the two small
        # roots, against the library's federated search over both
        from frankensearch_tpu_torch.fusion.federated import FederatedSearcher

        fed_query = queries3[1]
        lib_fed = FederatedSearcher()
        libs = [open_hybrid(r) for r in (small, small2)]
        for r, h in zip((small, small2), libs):
            lib_fed.add_shard(r, h.searcher)
        want_fed = [(r.doc_id, r.score) for r in lib_fed.search(fed_query, k=K).results]
        for h in libs:
            h.close()
        del libs, lib_fed
        made: list = []

        def noting_self(real):
            def init(self, *args, **kwargs):
                real(self, *args, **kwargs)
                made.append(self)
            return init

        t0 = time.perf_counter()
        with spied((daemon_fallback.DaemonFallbackEmbedder, "__init__", noting_self)):
            fed = run_cli(["search", fed_query, "--root", small, "--federate", small2, "--daemon-socket", sock,
                           "-k", str(K)])
        wall["federated_s"] = time.perf_counter() - t0
        cov = fed["meta"]["coverage"]
        hits = sum(fb.stats.daemon_hits for fb in made)
        if cov != {"total_shards": 2, "responded": 2, "complete": True, "failed": [], "timed_out": []}:
            raise AssertionError(f"phase12: federated coverage {cov}")
        if [(r["doc_id"], r["score"]) for r in fed["data"]] != want_fed or len(want_fed) != K:
            raise AssertionError(f"phase12: the federated rows differ from the library's: {fed['data'][:3]}")
        if len(made) != 2 or any(fb.stats.local_fallbacks for fb in made) or hits < 2:
            raise AssertionError(f"phase12: daemon hits {[vars(fb.stats) for fb in made]}")
        sent += hits
        daemon_env = stop_daemon(proc, sock, sent)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=60)
        if os.path.exists(sock):
            os.remove(sock)
        os.rmdir(sock_dir)
    served = daemon_env["data"]["requests_served"]
    if served != DAEMON_MAX_REQUESTS:
        raise AssertionError(f"phase12: the daemon served {served}, {DAEMON_MAX_REQUESTS} sent")
    log(f"phase12 daemon (its own process, --concurrency 4): ready {wall['daemon_start_s']:.1f} s; "
        f"{DAEMON_CALLS} embeds of {DAEMON_TEXTS} from {DAEMON_THREADS} threads in {wall['daemon_burst_s']:.2f} s, "
        f"bitwise HashEmbedder({DIM}); federated search over the two {FED_DOCS}-doc roots "
        f"{wall['federated_s']:.1f} s, coverage 2/2, its {K} rows bitwise the library's federated search, "
        f"{hits} embeds through the daemon and no local fallback; requests_served {served} "
        f"(= {DAEMON_CALLS} + {hits} + {DAEMON_MAX_REQUESTS - sent} pings)")

    # the WAL fold
    wal = os.path.join(root, "vector.fast.idx.wal")
    wal_bytes = os.path.getsize(wal)
    t0 = time.perf_counter()
    folded = run_cli(["daemon", "--wal-poll", "--root", root, "--cycles", "1", "--wal-threshold-bytes", "1"])["data"]
    wall["wal_poll_s"] = time.perf_counter() - t0
    if folded["compactions"] != 1 or (os.path.exists(wal) and os.path.getsize(wal)):
        raise AssertionError(f"phase12: wal-poll {folded}")
    t0 = time.perf_counter()
    reopened = TwoTierIndex.open(root, device=dev)
    wall["reopen_s"] = time.perf_counter() - t0
    same_fast_top(fast_before, {t: [(h.doc_id, h.score) for h in reopened.search_fast_classified(
        emb.embed(t), K).hits] for t in fresh})
    del reopened
    log(f"phase12 daemon --wal-poll: {wal_bytes} WAL bytes folded in {wall['wal_poll_s']:.1f} s; the reopened "
        f"index ({wall['reopen_s']:.1f} s) serves the same fast top-{K} for {len(fresh)} tokens")

    # shadow, the device candidate on the card
    qfile = os.path.join(tmp, "shadow_queries.txt")
    with open(qfile, "w", encoding="utf-8") as f:
        f.write("\n".join(queries3[:SHADOW_QUERIES]) + "\n")
    t0 = time.perf_counter()
    sh = run_cli(["shadow", small_corpus, "--candidate", "device", "--queries-file", qfile, "-k", str(K),
                  "--max-samples", "100000"])["data"]
    wall["shadow_s"] = time.perf_counter() - t0
    if sh["shadow_errors"] or sh["queries"] != SHADOW_QUERIES or sh["docs"] != FED_DOCS:
        raise AssertionError(f"phase12: shadow {sh}")
    ties = shadow_ties(small_corpus, sh)
    log(f"phase12 shadow --candidate device: {sh['queries']} queries over {sh['docs']} docs in "
        f"{wall['shadow_s']:.1f} s, agreement {sh['agreement_rate']}, shadow_errors 0, "
        f"{ties} divergences, each at a tie in the oracle's scores within {SHADOW_TIE_REL:g}; oracle "
        f"{sh['primary_ms']} ms, device {sh['shadow_ms']} ms")
    rec.update({"watch": [run1, run2], "watch_ms": [ms1, ms2], "tui_ms": tui_ms,
                "line_ms_p50": line_ms[len(line_ms) // 2], "line_ms_p99": line_ms[int(len(line_ms) * 0.99)],
                "freshness": held, "pool_reuses": chain_reuses, "daemon_served": served, "daemon_hits": hits,
                "wal_bytes": wal_bytes, "shadow": {k: sh[k] for k in ("agreement_rate", "divergent_queries",
                                                                      "primary_ms", "shadow_ms")},
                "shadow_ties": ties, "wall": wall})
    return rec, launches, kernels


FLEET_SERVE = "serve-cli"  # phase 13: the serve node's --node-id
FLEET_DAEMON = "daemon-20k"  # the daemon node's, over the small root
FLEET_BEAT_WAIT_S = 30.0  # longest wait for a node's next heartbeat (the registrar beats every 2 s)
FLEET_SETTLE_S = 0.5  # a beat this long after the last reply holds every query the server observed
MODEL_FILES = {"weights.npz": 70_000, "vocab.txt": 4_096}  # the local model bundle phase 13 downloads
SCHEMA_KEYWORDS = {"$schema", "$id", "title", "description", "type", "const", "enum", "required", "properties",
                   "additionalProperties", "items", "minimum", "maximum", "minLength", "allOf", "contains"}


def schema_errors(doc, schema: dict, at: str = "$") -> list[str]:
    """Where ``doc`` breaks ``schema``, for the JSON Schema (draft-07)
    keywords that the repository's ``schemas/`` use (SCHEMA_KEYWORDS; any
    other keyword raises, so a schema that grows one is not half checked)."""
    unknown = set(schema) - SCHEMA_KEYWORDS
    if unknown:
        raise ValueError(f"schema keywords {sorted(unknown)} at {at} are not checked here")
    is_num = isinstance(doc, (int, float)) and not isinstance(doc, bool)
    kinds = {"object": isinstance(doc, dict), "array": isinstance(doc, list), "string": isinstance(doc, str),
             "boolean": isinstance(doc, bool), "number": is_num,
             "integer": is_num and float(doc).is_integer()}
    if "type" in schema and not kinds[schema["type"]]:
        return [f"{at}: not of type {schema['type']}"]
    errs = []
    if "const" in schema and (doc != schema["const"] or isinstance(doc, bool) != isinstance(schema["const"], bool)):
        errs.append(f"{at}: not {schema['const']!r}")
    if "enum" in schema and doc not in schema["enum"]:
        errs.append(f"{at}: not one of {schema['enum']}")
    if is_num and "minimum" in schema and doc < schema["minimum"]:
        errs.append(f"{at}: below {schema['minimum']}")
    if is_num and "maximum" in schema and doc > schema["maximum"]:
        errs.append(f"{at}: above {schema['maximum']}")
    if isinstance(doc, str) and len(doc) < schema.get("minLength", 0):
        errs.append(f"{at}: shorter than {schema['minLength']}")
    if isinstance(doc, dict):
        errs += [f"{at}.{k}: missing" for k in schema.get("required", []) if k not in doc]
        extra = schema.get("additionalProperties", True)
        for k, v in doc.items():
            if k in schema.get("properties", {}):
                errs += schema_errors(v, schema["properties"][k], f"{at}.{k}")
            elif extra is False:
                errs.append(f"{at}.{k}: not allowed")
            elif isinstance(extra, dict):
                errs += schema_errors(v, extra, f"{at}.{k}")
    if isinstance(doc, list):
        if "items" in schema:
            for i, v in enumerate(doc):
                errs += schema_errors(v, schema["items"], f"{at}[{i}]")
        if "contains" in schema and not any(not schema_errors(v, schema["contains"], at) for v in doc):
            errs.append(f"{at}: holds nothing matching {schema['contains']}")
    for sub in schema.get("allOf", []):
        errs += schema_errors(doc, sub, at)
    return errs


def need_schema(doc, name: str, what: str) -> None:
    """Fail unless ``doc`` validates against ``schemas/<name>``."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "schemas", name), encoding="utf-8") as f:
        errs = schema_errors(doc, json.load(f))
    if errs:
        raise AssertionError(f"phase13: {what} breaks schemas/{name}: {errs[:5]}")


def cli_call(argv: list[str]) -> dict:
    """One CLI command through its parser in process, writing nothing to
    stdout (an in-process ``serve`` owns it): its ``--format json``
    envelope, which must be ok."""
    from frankensearch_tpu_torch.cli import main as cli

    args = cli.build_parser().parse_args(["--format", "json", *argv])
    env = args.fn(args)
    if not env["ok"]:
        raise AssertionError(f"phase13: {argv[0]} failed: {env.get('error')}")
    return env


def node_file(fleet: str, node_id: str) -> dict | None:
    try:
        with open(os.path.join(fleet, node_id + ".node.json"), encoding="utf-8") as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def next_beat(fleet: str, node_id: str, after: float) -> dict:
    """The node file of ``node_id``'s first heartbeat published after
    ``after`` (unix s)."""
    deadline = time.monotonic() + FLEET_BEAT_WAIT_S
    while True:
        rec = node_file(fleet, node_id)
        if rec is not None and rec["at"] > after:
            return rec
        if time.monotonic() > deadline:
            raise AssertionError(f"phase13: no heartbeat of {node_id} after {after} in {FLEET_BEAT_WAIT_S} s")
        time.sleep(0.05)


def recording(into: list):
    """A swap's ``make`` for ``NodeRegistrar.observe_query``: the
    original, each call's (latency ms, n) also appended to ``into``."""
    def make(real):
        def observe(self, latency_ms, n=1):
            into.append((float(latency_ms), n))
            return real(self, latency_ms, n)
        return observe
    return make


def window_stats(observed: list) -> tuple[float, float, int]:
    """(p50, p99, count) of the served queries as the registrar ranks its
    window: each (latency, n) counts n times."""
    lats = sorted(lat for lat, n in observed for _ in range(max(n, 1)))
    return lats[len(lats) // 2], lats[min(int(len(lats) * 0.99), len(lats) - 1)], len(lats)


def check_node(rec: dict, *, pid: int, docs: int, generation: str, observed: list, sensed: list,
               min_hbm: float) -> None:
    """A serve node file against what this process served and sensed."""
    need_schema(rec, "fleet-node-v1.schema.json", f"{rec['node_id']}'s node file")
    p50, p99, n = window_stats(observed)
    span = min(30.0, max(rec["at"] - rec["started_at"], 1e-3))
    want = {"pid": pid, "doc_count": docs, "generation_id": generation, "errors": 0, "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3)}
    got = {k: rec[k] for k in want}
    if got != want or not rec["p50_ms"] <= rec["p99_ms"] or abs(rec["qps"] - n / span) > 0.01 + 1e-3 * n / span:
        raise AssertionError(f"phase13: node {rec} against {want}, qps ~{n / span:.2f}")
    if rec["hbm_used_frac"] not in sensed or rec["hbm_used_frac"] < min_hbm:
        raise AssertionError(f"phase13: hbm_used_frac {rec['hbm_used_frac']} is not a sensed value >= {min_hbm}")


def start_fleet_daemon(root: str, sock: str, fleet: str):
    """``cli daemon --fleet-dir`` over ``root`` as a subprocess; returns the
    process (its node file appears once it has opened the root)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    argv = [sys.executable, "-m", "frankensearch_tpu_torch.cli", "--format", "json", "daemon", "--root", root,
            "--socket", sock, "--fleet-dir", fleet, "--node-id", FLEET_DAEMON, "--idle-timeout", str(CLI_WAIT_S),
            "--accept-timeout", "0.5", "--quiet", *CLI_DEVICE_ARGS]
    return subprocess.Popen(argv, cwd=repo, env=dict(os.environ, PYTHONPATH=repo), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def fleet_checks(fleet: str, daemon, seen: dict, observed: list) -> None:
    """While ``serve`` runs (the client's ``during``): a heartbeat after
    the last reply, ``fleet --live`` and ``--slo`` with the daemon's node
    beside it, then the daemon killed, reported down and reaped."""
    deadline = time.monotonic() + CLI_WAIT_S
    while node_file(fleet, FLEET_DAEMON) is None:
        if daemon.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"phase13: the fleet daemon did not register (rc {daemon.poll()})")
        time.sleep(0.1)
    seen["serve"] = next_beat(fleet, FLEET_SERVE, time.time() + FLEET_SETTLE_S)
    seen["observed"] = list(observed)
    seen["daemon"] = node_file(fleet, FLEET_DAEMON)
    seen["live"] = cli_call(["fleet", "--live", fleet])["data"]
    seen["p99s"] = sorted(r["p99_ms"] for r in (node_file(fleet, FLEET_SERVE), node_file(fleet, FLEET_DAEMON)))
    seen["slo"] = cli_call(["fleet", "--live", fleet, "--slo"])["data"]
    daemon.kill()
    daemon.communicate(timeout=60)
    seen["killed_file"] = node_file(fleet, FLEET_DAEMON) is not None
    seen["after_kill"] = cli_call(["fleet", "--live", fleet])["data"]
    seen["reaped_file"] = node_file(fleet, FLEET_DAEMON) is not None
    seen["after_reap"] = cli_call(["fleet", "--live", fleet])["data"]


def host_commands(tmp: str) -> dict:
    """``download`` of a local bundle, ``update --check`` / apply /
    ``--rollback`` of a local release, ``uninstall --dry-run``, each once
    in process, their envelopes as tests/test_torch_install.py holds them."""
    import hashlib

    import numpy as np

    from frankensearch_tpu_torch.embed.model_manifest import build_model_manifest, verify_model_dir

    base = os.path.join(tmp, "host")
    bundle, release, root = (os.path.join(base, d) for d in ("bundle", "release", "root"))
    for d in (bundle, release, root):
        os.makedirs(d)
    rng = np.random.default_rng(SEED + 13)
    for name, size in MODEL_FILES.items():
        with open(os.path.join(bundle, name), "wb") as f:
            f.write(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    manifest = build_model_manifest(bundle, "m2v-chip", "rev-1", DIM, "model2vec")
    with open(os.path.join(bundle, "model_manifest.json"), "w", encoding="utf-8") as f:
        f.write(manifest.to_json())
    got = run_cli(["download", "m2v-chip", "--root", root, "--from-dir", bundle, "--authorize", "chip_smoke"])["data"]
    receipt = got["receipt"]
    if (got["stages"] != ["staged_verified", "published"] or receipt["outcome"] != "published"
            or receipt["source"] != "local_bundle" or receipt["bytes_verified"] != sum(MODEL_FILES.values())
            or not verify_model_dir(got["promoted"]).ok):
        raise AssertionError(f"phase13: download {got}")
    asset = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    with open(os.path.join(release, "fs.tgz"), "wb") as f:
        f.write(asset)
    with open(os.path.join(release, "release.json"), "w", encoding="utf-8") as f:
        json.dump({"version": "9.9.9", "asset": "fs.tgz"}, f)
    with open(os.path.join(release, "SHA256SUMS"), "w", encoding="utf-8") as f:
        f.write(f"{hashlib.sha256(asset).hexdigest()}  fs.tgz\n")
    check = run_cli(["update", "--root", root, "--check", "--from-dir", release])["data"]
    applied = run_cli(["update", "--root", root, "--from-dir", release])["data"]
    back = run_cli(["update", "--root", root, "--rollback"])["data"]
    staged = os.path.join(root, "updates", "9.9.9", "fs.tgz")
    if (not check["update_available"] or check["applied"] or check["notes"] != [
            "update available: v0.1.0 -> v9.9.9 (run `frankensearch-tpu-torch update` to apply)"]
            or not applied["applied"] or open(staged, "rb").read() != asset
            or back != {"rolled_back_from": "9.9.9", "active_version": "0.1.0",
                        "notes": ["rolled back staged generation 9.9.9 -> 0.1.0"]}):
        raise AssertionError(f"phase13: update {check} / {applied} / {back}")
    gone = run_cli(["uninstall", "--root", root, "--dry-run"])["data"]
    entries = {e["target"]: (e["status"], e["reason"]) for e in gone["entries"]}
    if (gone["removed"] or gone["failed"] or not os.path.isdir(root)
            or entries["package"] != ("skipped", "python package (pip-managed; not removed)")
            or gone["entries"][0]["path"] != "frankensearch_tpu_torch" or entries["index_dir"] != ("skipped", "dry-run")):
        raise AssertionError(f"phase13: uninstall --dry-run {gone}")
    return {"download_bytes": receipt["bytes_verified"], "update": [check["latest_version"], back["active_version"]],
            "uninstall_skipped": gone["skipped"]}


def phase13_fleet(dev, tmp: str, lexical: dict, docs: int) -> tuple[dict, dict, list[dict]]:
    """cli-fleet-400k: ``serve --fleet-dir F --node-id serve-cli --warmup`` in
    process on phase 12's watched root (``docs`` docs): phase 4's
    256 pipelined queries and 8 singletons, every reply bitwise the
    library's over the handle serve opened, K1/K2/K3 counted; while it
    serves, ``fleet --live F`` (the node healthy, this process's pid, the
    root's doc count and CURRENT generation, qps / p50 / p99 from the
    frames served, errors 0, its card-memory share a sensed value of at
    least the slab's, the node file valid) and ``--slo`` (the live nodes,
    no bad failure event, the latency events the nodes' p99s), with a
    ``daemon --fleet-dir F`` subprocess over the 20,000-doc root as a second
    node, killed, reported down and reaped; serve's node file gone after
    ``shutdown``. Then ``repro`` over the small root (its phases and
    results those of ``search()`` over a library handle, the card in
    ``environment.json``, the pack valid), ``footprint`` of the CLI's root
    (its counts the FTVI's, the report valid), and the host commands."""
    import torch

    from frankensearch_tpu_torch import open_hybrid
    from frankensearch_tpu_torch.fleet.registry import NodeRegistrar
    from frankensearch_tpu_torch.index.fsvi import FLAG_TOMBSTONE, FtviFile
    from frankensearch_tpu_torch.index.two_tier import TwoTierPaths
    from frankensearch_tpu_torch.runtime import footprint

    queries, singles = lexical["queries"], lexical["singles"]
    root, small = os.path.join(tmp, "cli_root"), os.path.join(tmp, "fed_root")
    fleet = os.path.join(tmp, "fleet")
    wall: dict = {}
    with open(os.path.join(root, "lexical", "CURRENT"), encoding="utf-8") as f:
        generation = f.read().strip()
    sock_dir = tempfile.mkdtemp(prefix="fsf-", dir="/tmp")
    daemon = start_fleet_daemon(small, os.path.join(sock_dir, "d.sock"), fleet)
    observed: list = []
    seen: dict = {}
    shapes: set = set()
    flat_inputs: dict = {}
    t0 = time.perf_counter()
    try:
        with spied((NodeRegistrar, "observe_query", recording(observed))):
            session, launches = drive(lambda: serve_session(
                root, queries, singles, argv=("--fleet-dir", fleet, "--node-id", FLEET_SERVE), full=False,
                during=lambda: fleet_checks(fleet, daemon, seen, observed)), shapes, flat_inputs)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.communicate(timeout=60)
        for name in os.listdir(sock_dir):
            os.remove(os.path.join(sock_dir, name))
        os.rmdir(sock_dir)
    wall["serve_s"] = time.perf_counter() - t0
    need_launches("phase13", launches, ("K1", "K2", "K3"))
    replies, ms, sensed = session["replies"], session["ms"], session["sensed"]
    if not replies["ready"][0]["ok"] or replies["ready"][0]["data"]["op"] != "warmup":
        raise AssertionError(f"phase13: serve --warmup reported {replies['ready'][0]}")
    if node_file(fleet, FLEET_SERVE) is not None or os.listdir(fleet):
        raise AssertionError(f"phase13: node files left after shutdown: {os.listdir(fleet)}")

    handle = session.pop("handle")
    handle.searcher.governor = None
    if handle.index.doc_count() != docs:
        raise AssertionError(f"phase13: the served root holds {handle.index.doc_count()} docs, {docs} expected")
    slab = handle.index.fast.slab
    min_hbm = slab.numel() * slab.element_size() / torch.cuda.get_device_properties(dev).total_memory
    check_node(seen["serve"], pid=os.getpid(), docs=docs, generation=generation, observed=seen["observed"],
               sensed=sensed["device"], min_hbm=min_hbm)
    if len(seen["observed"]) != 1 + len(singles) or window_stats(seen["observed"])[2] != len(queries) + len(singles):
        raise AssertionError(f"phase13: the registrar observed {seen['observed']}")
    d = seen["daemon"]
    need_schema(d, "fleet-node-v1.schema.json", "the daemon's node file")
    if d["pid"] == os.getpid() or d["doc_count"] != FED_DOCS or d["generation_id"] != "" or d["qps"] != 0.0:
        raise AssertionError(f"phase13: the daemon's node {d}")
    live = {n["node"]: n for n in seen["live"]["nodes"]}
    if (sorted(live) != sorted([FLEET_SERVE, FLEET_DAEMON]) or not all(n["healthy"] for n in live.values())
            or live[FLEET_SERVE]["generation"] != generation):
        raise AssertionError(f"phase13: fleet --live {seen['live']}")
    slo = seen["slo"]
    budgets = {(b["metric_id"], b["window"]): b for b in slo["budgets"]}
    lat = budgets[("search_latency_p95", "1m")]
    if (slo["nodes"] != 2 or any(b["bad_events"] for (m, _), b in budgets.items() if m == "query_failure_rate")
            or (lat["total_events"], lat["bad_events"]) != (2, sum(p > 100.0 for p in seen["p99s"]))
            or any(a["metric_id"] == "query_failure_rate" for a in slo["alerts"])):
        raise AssertionError(f"phase13: fleet --live --slo {slo}")
    after = {n["node"]: n["healthy"] for n in seen["after_kill"]["nodes"]}
    if (not seen["killed_file"] or after != {FLEET_SERVE: True, FLEET_DAEMON: False} or seen["reaped_file"]
            or [n["node"] for n in seen["after_reap"]["nodes"]] != [FLEET_SERVE]):
        raise AssertionError(f"phase13: the killed daemon: {seen['after_kill']} then {seen['after_reap']}")
    rec_node = seen["serve"]
    log(f"phase13 serve --fleet-dir: ready {ms['ready'] / 1e3:.1f} s; {len(queries)} pipelined searches in one "
        f"search_batch {ms['batch']:.2f} ms; singletons " + ", ".join(f"{ms[f'single{i}']:.2f}" for i in range(len(singles)))
        + f" ms; node {FLEET_SERVE}: pid {rec_node['pid']} (this process), {rec_node['doc_count']} docs, generation "
        f"{rec_node['generation_id']}, qps {rec_node['qps']}, p50 {rec_node['p50_ms']} ms, p99 {rec_node['p99_ms']} ms, "
        f"errors 0, hbm_used_frac {rec_node['hbm_used_frac']:.6f} (slab share {min_hbm:.6f}), node file valid; "
        f"fleet --live: both nodes healthy; --slo: {slo['nodes']} nodes, latency events {lat['total_events']} "
        f"({lat['bad_events']} over 100 ms), no failure event; the daemon (pid {d['pid']}) killed: reported down, "
        f"reaped; serve's node file gone after shutdown; launches {launches}")

    want = handle.searcher.search_batch(queries, k=K)
    if [r["data"] for r in replies["batch"]] != [json_rows(o.results) for o in want]:
        raise AssertionError("phase13: the coalesced replies differ from the library's search_batch")
    if [r.get("meta") for r in replies["batch"]] != [{"coalesced": len(queries)}] * len(queries):
        raise AssertionError("phase13: the batch did not coalesce into one call")
    for i, q in enumerate(singles):
        reply, pong = replies[f"single{i}"]
        if pong["data"] != {"op": "pong"} or reply["data"] != json_rows(handle.searcher.search(q, k=K).results):
            raise AssertionError(f"phase13: singleton {q!r} differs from the library's search()")
    done = lexical["cli_shapes"]
    kernels = check_kernels("cli-fleet-400k", slab, handle.index.fast._effective_mask(None, None), shapes, done=done)
    new_flat = {key: v for key, v in flat_inputs.items() if key not in lexical["cli_flat"]}
    if new_flat:
        sealed = [seg for seg in getattr(handle.delta.sealed, "segments", [handle.delta.sealed])
                  if getattr(seg, "_blocked", None) is not None]
        kernels += check_flat_kernel("cli-fleet-400k", sealed[0]._blocked.classes, new_flat)
    log(f"phase13 every reply bitwise the library's over the handle serve opened; kernel shapes {sorted(shapes)}, "
        f"K3 tiles {sorted(flat_inputs)}; held to their twins here where phases 11-12 had not: {len(kernels)} records")
    handle.close()
    del handle, slab, want
    torch.cuda.empty_cache()

    # repro over the small root, against search() over a library handle
    pack = os.path.join(tmp, "repro_pack")
    with open(os.path.join(tmp, "fed_corpus.jsonl"), encoding="utf-8") as f:
        query = " ".join(json.loads(f.readline())["content"].split()[:3])  # the small root's first doc's words
    t0 = time.perf_counter()
    env = run_cli(["repro", query, "--out", pack, "--root", small, "-k", str(K)])["data"]
    wall["repro_s"] = time.perf_counter() - t0
    with open(os.path.join(pack, "evidence.jsonl"), encoding="utf-8") as f:
        events = [json.loads(line) for line in f]
    with open(os.path.join(pack, "environment.json"), encoding="utf-8") as f:
        environment = json.load(f)
    with open(os.path.join(pack, "INDEX.json"), encoding="utf-8") as f:
        index_json = json.load(f)
    lib = open_hybrid(small)
    phases: list = []
    out = lib.searcher.search(query, k=K, on_phase=phases.append)
    lib.close()
    got_phases = [(e["payload"]["kind"], e["payload"]["doc_ids"]) for e in events if e["kind"] == "phase"]
    rows = [e["payload"]["rows"] for e in events if e["kind"] == "results"][0]
    if (got_phases != [(p.kind.value, [r.doc_id for r in p.results]) for p in phases]
            or [(r["doc_id"], r["score"]) for r in rows] != [(r.doc_id, r.score) for r in out.results]
            or env["events"] != len(events) or [e["kind"] for e in events][:1] != ["query"]):
        raise AssertionError(f"phase13: repro's phases {got_phases} differ from search()'s")
    if (environment["devices"] != [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
            or environment["torch"] != torch.__version__ or environment["cuda"] != torch.version.cuda):
        raise AssertionError(f"phase13: repro's environment {environment}")
    need_schema(index_json, "repro-bundle-v1.schema.json", "repro's INDEX.json")
    log(f"phase13 repro over the {FED_DOCS}-doc root: {env['events']} events in {wall['repro_s']:.1f} s, phases "
        f"{[k for k, _ in got_phases]} and results bitwise search()'s over a library handle; environment names "
        f"{environment['devices']}; INDEX.json valid")

    # footprint of the CLI's root, against its FTVI
    t0 = time.perf_counter()
    fp = run_cli(["footprint", "--root", root])["data"]
    wall["footprint_s"] = time.perf_counter() - t0
    need_schema(fp, "footprint-advisor-v1.schema.json", "footprint's report")
    ftvi = FtviFile(TwoTierPaths(root).fast, verify_slab=False)
    dead = int(((ftvi.flags & FLAG_TOMBSTONE) != 0).sum())
    counts = footprint._tombstone_counts(root)
    fragmented = any(r["reason"].endswith("of rows are tombstoned (fragmented index)") for r in fp["recommendations"])
    if (counts != (dead, ftvi.record_count - dead) or fp["detail"]["fast_artifact_bytes"] != os.path.getsize(
            TwoTierPaths(root).fast) or fragmented != (dead >= footprint.TOMBSTONE_COMPACT_FRACTION * ftvi.record_count)
            or fp["automatic_deletion_allowed"] is not False):
        raise AssertionError(f"phase13: footprint {fp} against the FTVI's {dead} of {ftvi.record_count} tombstoned")
    log(f"phase13 footprint of the CLI's root in {wall['footprint_s']:.1f} s: {fp['total_bytes']} bytes {fp['domains']}, "
        f"rows tombstoned / live {counts} as the FTVI's flags; {len(fp['recommendations'])} recommendations; "
        f"report valid")
    del ftvi

    t0 = time.perf_counter()
    host = host_commands(tmp)
    wall["host_s"] = time.perf_counter() - t0
    log(f"phase13 download, update --check / apply / --rollback, uninstall --dry-run in process "
        f"({wall['host_s']:.1f} s): {host}")
    return ({"serve_ms": ms, "node": seen["serve"], "slo_nodes": slo["nodes"], "repro_events": env["events"],
             "footprint": {"total_bytes": fp["total_bytes"], "tombstoned_live": list(counts)}, "host": host,
             "wall": wall}, launches, kernels)


REFRESH_CAPACITY = 1024  # phase 14: the EmbeddingQueue's capacity
REFRESH_NEW = 512  # new docs, each carrying one unique token
REFRESH_DUPS = 32  # pushes of queued content under other ids (DUPLICATE)
REFRESH_EDITS = 64  # seed docs edited; ReembedPolicy decides which are pushed again
REFRESH_BATCH = 64  # the worker's max_batch
REFRESH_READERS = 4  # reader threads racing the worker
REFRESH_BASELINE_ROUNDS = 1  # each reader's batch + singleton rounds with no writer
REFRESH_CUT_DOCS = 20_000  # the depth-cut two-tier index of the worker-vs-direct, FULL and fault checks
REFRESH_FAULT_BATCH = 3  # the fault worker's quality embed raises on this batch
REFRESH_CPU_SAMPLE = 128  # appended docs whose quality rows are held to the CPU encoder's


class TimedEmbedder:
    """An embedder whose ``embed_batch`` host ms (the card synchronized
    after) is added to ``cycle[key]``; the worker's copy of a reader's
    embedder, so that only the worker's calls are timed."""

    def __init__(self, inner, cycle: dict, key: str):
        self.inner, self.cycle, self.key = inner, cycle, key

    def embed_batch(self, texts):
        import torch

        t0 = time.perf_counter()
        out = self.inner.embed_batch(texts)
        torch.cuda.synchronize()
        self.cycle[self.key] = self.cycle.get(self.key, 0.0) + (time.perf_counter() - t0) * 1e3
        return out


class FailingOn:
    """An embedder whose ``embed_batch`` raises ``exc`` on call ``n`` only."""

    def __init__(self, inner, n: int, exc: Exception):
        self.inner, self.n, self.exc, self.calls = inner, n, exc, 0

    def embed_batch(self, texts):
        self.calls += 1
        if self.calls == self.n:
            raise self.exc
        return self.inner.embed_batch(texts)


def refresh_traffic(queue, texts: list[str]) -> tuple[dict, dict]:
    """Phase 14's pushes into ``queue``, before the worker starts: 64
    edited seed docs, those ReembedPolicy passes pushed at priority 1 (so
    they drain first, as one batch); REFRESH_NEW new docs, each with a
    unique token; REFRESH_DUPS of their contents again under other ids.
    Returns ({doc id: text} of every ENQUEUED push, {result: count})."""
    import numpy as np

    from frankensearch_tpu_torch.core.fingerprint import DocumentFingerprint, ReembedPolicy
    from frankensearch_tpu_torch.fusion.queue import EnqueueResult

    rng = np.random.default_rng(SEED + 14)
    policy, enqueued, counts = ReembedPolicy(), {}, {r.value: 0 for r in EnqueueResult}

    def push(doc_id, text, priority=0):
        r = queue.push(doc_id, text, priority=priority)
        counts[r.value] += 1
        if r is EnqueueResult.ENQUEUED:
            enqueued[doc_id] = text
        return r

    reembed = 0
    for j, i in enumerate(rng.choice(len(texts), size=REFRESH_EDITS, replace=False)):
        old = texts[int(i)]
        new = old if j % 4 == 0 else f"{old} edited{j:03d}"
        if policy.should_reembed(DocumentFingerprint.of(old), DocumentFingerprint.of(new)):
            reembed += 1
            push(f"doc-{int(i):07d}", new, priority=1)
    if reembed != REFRESH_EDITS - REFRESH_EDITS // 4:
        raise AssertionError(f"phase14: ReembedPolicy passed {reembed} of {REFRESH_EDITS} edits")
    fresh = fresh_texts(texts, REFRESH_NEW, "fresh", rng)
    for n in range(REFRESH_NEW):
        if push(f"new-{n:04d}", fresh[n]) is not EnqueueResult.ENQUEUED:
            raise AssertionError(f"phase14: new doc {n} not enqueued")
    for n in range(REFRESH_DUPS):
        if push(f"dup-{n:04d}", fresh[n]) is not EnqueueResult.DUPLICATE:
            raise AssertionError(f"phase14: duplicate {n} not refused as DUPLICATE")
    return enqueued, counts


def fresh_texts(texts: list[str], n: int, token: str, rng) -> list[str]:
    """``n`` seed texts, each with a unique token appended."""
    return [f"{texts[int(i)]} {token}{j:04d}" for j, i in enumerate(rng.integers(0, len(texts), size=n))]


def reader_loop(searcher, queries: list[str], singles: list[str], known, stop, out: list, errors: list,
                rounds: int | None = None) -> None:
    """A reader: ``search_batch`` of the batch (Refined), then each
    singleton through ``search()``, until ``stop`` is set (or for
    ``rounds`` rounds); (kind, host ms) per call into ``out``. Every
    returned id must be in ``known``."""
    try:
        r = 0
        while (rounds is None and not stop.is_set()) or (rounds is not None and r < rounds):
            t0 = time.perf_counter()
            batch = searcher.search_batch(queries, k=K)
            out.append(("batch", (time.perf_counter() - t0) * 1e3))
            got = {x.doc_id for o in batch for x in o.results}
            for q in singles:
                if stop is not None and stop.is_set():
                    break
                t0 = time.perf_counter()
                one = searcher.search(q, k=K)
                out.append(("single", (time.perf_counter() - t0) * 1e3))
                got |= {x.doc_id for x in one.results}
            if any(o.metrics.quality_candidates < 1 for o in batch):
                raise AssertionError("phase14: a batch row carries no quality scores")
            stray = [d for d in got if not known(d)]
            if stray:
                raise AssertionError(f"phase14: a reader got ids neither seeded nor appended: {stray[:4]}")
            r += 1
    except Exception as e:  # handed to the phase, which raises it
        errors.append(e)


def pct(values: list[float], q: float) -> float:
    ranked = sorted(values)
    return ranked[min(len(ranked) - 1, int(len(ranked) * q))]


def latency_stats(calls: list) -> dict:
    out = {}
    for kind in ("batch", "single"):
        ms = [t for k, t in calls if k == kind]
        out[kind] = {"n": len(ms), "p50": pct(ms, 0.5), "p99": pct(ms, 0.99)} if ms else {"n": 0}
    return out


def appended_rows_check(index, emb, c32, docs: dict) -> dict:
    """Every appended doc the top fast-tier hit of its own text; both
    tiers' appended rows on the card against the same texts embedded on
    the CPU: the HashEmbedder's rows bitwise in the slab's dtype (every
    doc), the encoder's within ENC_F32_TOL (phase 8's card-vs-CPU class;
    REFRESH_CPU_SAMPLE docs spread over the appends, as phase 8 holds a
    32-query sample: the CPU forward of every doc costs half a minute);
    the quality slab's rows bitwise its host rows (every doc)."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import HashEmbedder

    ids, texts = list(docs), list(docs.values())
    fast, quality = index.fast, index.quality
    f_rows = [fast.row_for(d) for d in ids]
    q_rows = [quality.row_for(d) for d in ids]
    if None in f_rows or None in q_rows:
        raise AssertionError("phase14: an appended doc has no row in a tier")
    host = HashEmbedder(dim=emb.dim)  # the CPU's own instance
    sampled = set(range(0, len(ids), max(1, len(ids) // REFRESH_CPU_SAMPLE)))
    misses, q_err = 0, 0.0
    for s in range(0, len(ids), 256):
        chunk = slice(s, s + 256)
        want = host.embed_batch(texts[chunk])
        want /= np.linalg.norm(want, axis=1, keepdims=True)
        got = fast.slab[f_rows[chunk], : fast.dim].cpu()
        if not torch.equal(got, torch.from_numpy(want).to(fast.slab.dtype)):
            raise AssertionError("phase14: appended fast rows on the card differ from the CPU's HashEmbedder rows")
        res = fast.search_batch(want, 1)
        top = [h[0].doc_id if h else None for h in fast.hydrate(res)]
        misses += sum(t != d for t, d in zip(top, ids[chunk]))
        picks = [j for j in range(s, min(s + 256, len(ids))) if j in sampled]
        want_q = c32.embed_batch([texts[j] for j in picks])
        want_q /= np.linalg.norm(want_q, axis=1, keepdims=True)
        q_err = max(q_err, float(np.abs(quality.vectors_f32()[[q_rows[j] for j in picks]] - want_q).max()))
        got_q = quality.slab[q_rows[chunk], : quality.dim].cpu()
        if not torch.equal(got_q, torch.from_numpy(quality.vectors_f32()[q_rows[chunk]]).to(quality.slab.dtype)):
            raise AssertionError("phase14: the quality slab's appended rows are not its host rows")
    if misses:
        raise AssertionError(f"phase14: {misses} appended docs are not their own top fast-tier hit")
    if not q_err <= ENC_F32_TOL:
        raise AssertionError(f"phase14: appended quality rows differ from the CPU encoder's by {q_err:.3e}")
    return {"docs": len(ids), "own_top_hit": len(ids), "quality_cpu_sample": len(sampled),
            "quality_card_vs_cpu": q_err}


def kernel_shapes(records: list[dict], cells: tuple) -> set:
    """The (kernel, B, kk) shapes at which K1 and K2 were held to their
    twins in ``records`` of ``cells`` (check_kernels' records)."""
    return {(r["kernel"], r["b"], r["kk"] or 0) for r in records
            if r["cell"] in cells and r["kernel"] in ("group_max", "gather_rescore")}


def phase14_refresh(dev, tmp: str, semantic: dict, lexical: dict, quality: dict,
                    done: dict) -> tuple[dict, dict, list[dict]]:
    """refresh-1M-quality: the background refresh path on phase 8's
    hybrid-1M-quality index (1,000,000 x 256 bf16 fast tier padded to
    1,007,616 rows, 1M x 384 quality tier, the trained encoder on the
    card), with a WAL root of its own. An EmbeddingQueue(1024) gets 48
    edited seed docs (ReembedPolicy's picks of 64), REFRESH_NEW new docs
    and REFRESH_DUPS duplicates; a RefreshWorker
    (HashEmbedder(256) fast, the encoder for quality, max_batch 64) drains
    it from its thread while four readers run phase 4's batch (Refined,
    quality rescan) and singletons through ``search()``; the same readers
    ran first with no writer. Then: no reader raised, every id seeded or
    appended, K1 and K2 counted, the stats, every appended doc its own top
    hit and both tiers' rows against the CPU, K1 and K2 against their
    twins on the grown slabs. At a depth cut (a 20,000-doc two-tier index
    on the card): a queue of the same capacity pushed until it answers
    FULL (the 1M race would need twice its cycles to fill one), its 1,024
    docs drained by a worker against direct appends of the same batches
    (doc ids and scores bitwise), and a worker whose quality embed raises
    on its third batch. K1 and K2 are held to their twins on the
    grown slabs at the race's shapes that ``done`` ({"fast", "quality"}:
    shapes earlier phases checked on slabs of the same shape) lacks.
    Returns its record, launches and kernel records."""
    import threading

    import numpy as np
    import torch

    from frankensearch_tpu_torch import DeviceVectorIndex, TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.fusion.queue import EmbeddingQueue
    from frankensearch_tpu_torch.fusion.refresh import RefreshWorker
    from frankensearch_tpu_torch.index.wal import WriteAheadLog

    t_phase = time.perf_counter()
    emb, q32, c32 = semantic["emb"], quality["q32"], quality["c32"]
    bm25, queries, texts = lexical["bm25"], lexical["queries"], lexical["texts"]
    singles = four_word_singletons(queries)
    root = os.path.join(tmp, "refresh_wal")
    os.makedirs(root)
    index = TwoTierIndex(quality["index"].fast, quality["index"].quality, root=root)
    n_seed, spare = index.fast.n_rows, index.fast.n_pad - index.fast.n_rows
    searcher = TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=q32,
                               config=TwoTierConfig(quality_rescan=True), cache_query_embeddings=False)
    rec: dict = {"seed_rows": n_seed, "spare_rows": spare, "slab": list(index.fast.slab.shape),
                 "quality_slab": list(index.quality.slab.shape)}

    # --- the traffic, queued before the worker starts ---
    queue = EmbeddingQueue(capacity=REFRESH_CAPACITY)
    pushed, counts = refresh_traffic(queue, texts)
    rec["pushes"] = counts
    seed_ids = set(index.fast.doc_ids)

    def known(doc_id):
        return doc_id in seed_ids or doc_id in pushed

    # --- the readers alone (no writer) ---
    base_calls, errors = [], []
    threads = [threading.Thread(target=reader_loop, args=(searcher, queries, singles, known, None, base_calls,
                                                          errors, REFRESH_BASELINE_ROUNDS))
               for _ in range(REFRESH_READERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("phase14: a reader did not finish its rounds")
    rec["readers_alone_s"] = time.perf_counter() - t0

    # --- the race: the worker drains while the readers run ---
    t_race = time.perf_counter()
    cycles: list[dict] = []
    cycle: dict = {}
    worker = RefreshWorker(queue, index, TimedEmbedder(emb, cycle, "embed_fast_ms"),
                           TimedEmbedder(q32, cycle, "embed_quality_ms"), max_batch=REFRESH_BATCH,
                           poll_interval_s=0.01)
    drained = threading.Event()

    def timed_process_once(real=worker.process_once):
        cycle.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = real()
        torch.cuda.synchronize()
        if n:
            cycles.append({"docs": n, "total_ms": (time.perf_counter() - t0) * 1e3, **cycle})
        if not len(queue):
            drained.set()
        return n

    worker.process_once = timed_process_once

    def adding(key):
        def make(real):
            def timed_call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
                cycle[key] = cycle.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
                return out
            return timed_call
        return make

    realign = TwoTierIndex.__dict__["_realign"]
    race_calls: list = []

    def race():
        stop = threading.Event()
        readers = [threading.Thread(target=reader_loop, args=(searcher, queries, singles, known, stop, race_calls,
                                                              errors)) for _ in range(REFRESH_READERS)]
        t0 = time.perf_counter()
        worker.start()
        for t in readers:
            t.start()
        drained.wait(timeout=600)
        worker.stop()
        stop.set()
        for t in readers:
            t.join(timeout=600)
        if any(t.is_alive() for t in readers):
            raise AssertionError("phase14: a reader did not stop")
        return time.perf_counter() - t0

    shapes: set = set()
    with spied((WriteAheadLog, "append", adding("wal_append_ms")),
               (DeviceVectorIndex, "with_appended", adding("with_appended_ms"))):
        TwoTierIndex._realign = staticmethod(adding("realign_ms")(realign.__func__))
        try:
            race_s, launches = drive(race, shapes)
        finally:
            TwoTierIndex._realign = realign
    if errors:
        raise errors[0]
    need_launches("phase14", launches, ("K1", "K2"))
    if not any(sh[0] == "group_max" for sh in shapes):
        raise AssertionError("phase14: no hierarchical scan ran during the race")
    enqueued = counts["enqueued"]
    st = worker.stats
    if (st.docs_embedded, st.errors) != (enqueued, 0) or len(queue):
        raise AssertionError(f"phase14: stats {st} after {enqueued} enqueued pushes, {len(queue)} left")
    if index.fast.doc_ids != index.quality.doc_ids:
        raise AssertionError("phase14: the tiers hold different docs after the drain")
    new_ids = [d for d in pushed if d not in seed_ids]
    if index.fast.n_rows != n_seed + len(new_ids):
        raise AssertionError(f"phase14: {index.fast.n_rows} fast rows, {n_seed} + {len(new_ids)} expected")
    wal = WriteAheadLog(os.path.join(root, "vector.fast.idx.wal")).replay()
    if set(wal.live) != set(pushed):
        raise AssertionError("phase14: the fast WAL does not hold every appended doc")
    rec["race_s"] = race_s
    rec["before_race_s"] = t_race - t_phase
    rec["launches"] = launches
    rec["stats"] = {"batches": st.batches, "docs_embedded": st.docs_embedded, "errors": st.errors}
    rec["cycles"] = cycles
    split = {k: statistics.mean(c.get(k, 0.0) for c in cycles)
             for k in ("total_ms", "embed_fast_ms", "embed_quality_ms", "wal_append_ms", "with_appended_ms",
                       "realign_ms")}
    rec["cycle_mean_ms"] = split
    rec["readers"] = {"alone": latency_stats(base_calls), "under_writer": latency_stats(race_calls)}
    log(f"phase14 pushes {counts}: {len(pushed)} enqueued ({len(new_ids)} new, {len(pushed) - len(new_ids)} "
        f"re-embedded seeds); {st.batches} cycles, {st.docs_embedded} docs, {st.errors} errors in {race_s:.1f} s; "
        f"launches during the race {launches}")
    log("phase14 mean cycle ms (host clock, card synchronized): " + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
    log("phase14 cycles ms: " + "; ".join(
        f"{c['docs']} docs {c['total_ms']:.0f} (wal {c.get('wal_append_ms', 0):.0f}, with_appended "
        f"{c.get('with_appended_ms', 0):.0f}, realign {c.get('realign_ms', 0):.0f})" for c in cycles))
    log(f"phase14 readers (host ms): alone {json.dumps(rec['readers']['alone'])}; under the writer "
        f"{json.dumps(rec['readers']['under_writer'])}")

    t0 = time.perf_counter()
    rec["appended"] = appended_rows_check(index, emb, c32, pushed)
    rec["rows_check_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fast_shapes = {sh for sh in shapes if sh[0] in ("group_max", "gather_rescore")}
    kernels = check_kernels("refresh-1M", index.fast.slab, index.fast._effective_mask(None, None), fast_shapes,
                            done=done["fast"])
    q_shapes: set = set()
    drive(lambda: searcher.search_batch(queries, k=K), q_shapes, dim=Q_DIM)
    kernels += check_kernels("refresh-1M-quality", index.quality.slab, index.quality._effective_mask(None, None),
                             q_shapes, done=done["quality"])
    rec["kernel_checks_s"] = time.perf_counter() - t0
    searcher.close()
    del searcher, index, worker

    # --- the depth cut: FULL, worker against direct appends, the fault ---
    t0 = time.perf_counter()
    cut_ids = [f"doc-{i:07d}" for i in range(REFRESH_CUT_DOCS)]
    f0 = DeviceVectorIndex(semantic["vecs"][:REFRESH_CUT_DOCS], cut_ids, emb.identity(), device=dev)
    q0 = DeviceVectorIndex(quality["index"].quality.vectors_f32()[:REFRESH_CUT_DOCS], cut_ids, q32.identity(),
                           device=dev)
    cut_texts = fresh_texts(texts, REFRESH_CAPACITY + 1, "cut", np.random.default_rng(SEED + 15))
    cut_queue = EmbeddingQueue(capacity=REFRESH_CAPACITY)
    results = [cut_queue.push(f"cut-{n:04d}", text) for n, text in enumerate(cut_texts)]
    if {r.value for r in results[:-1]} != {"enqueued"} or results[-1].value != "full":
        raise AssertionError("phase14 cut: the queue did not answer FULL at its capacity")
    new_docs = {f"cut-{n:04d}": text for n, text in enumerate(cut_texts[:-1])}
    via_worker, direct = TwoTierIndex(f0, q0), TwoTierIndex(f0, q0)
    w = RefreshWorker(cut_queue, via_worker, emb, q32, max_batch=REFRESH_BATCH, poll_interval_s=0.01)
    w.start()
    deadline = time.time() + 120
    while w.stats.docs_embedded < len(new_docs) and time.time() < deadline:
        time.sleep(0.01)
    w.stop()
    if (w.stats.docs_embedded, w.stats.errors) != (len(new_docs), 0):
        raise AssertionError(f"phase14 cut: stats {w.stats} after {len(new_docs)} enqueued pushes")
    ids, docs_texts = list(new_docs), list(new_docs.values())
    for b0 in range(0, len(ids), REFRESH_BATCH):
        batch = slice(b0, b0 + REFRESH_BATCH)
        direct.append_fast(ids[batch], emb.embed_batch(docs_texts[batch]))
        direct.append_quality(ids[batch], q32.embed_batch(docs_texts[batch]))
    cut_queries = queries + docs_texts[:64]
    rows = []
    for idx in (via_worker, direct):
        s = TwoTierSearcher(idx, emb, quality_embedder=q32, config=TwoTierConfig(quality_rescan=True),
                            cache_query_embeddings=False)
        rows.append([[(r.doc_id, r.score, r.fast_score, r.quality_score) for r in o.results]
                     for o in s.search_batch(cut_queries, k=K)])
        s.close()
    if rows[0] != rows[1]:
        raise AssertionError("phase14 cut: the worker's index serves differently from the direct appends'")
    if not all(ids[j] in {r[0] for r in rows[0][len(queries) + j]} for j in range(64)):
        raise AssertionError("phase14 cut: an appended doc is missing from the results of its own text")
    fault = RuntimeError("injected: the quality embed failed on the card")
    faulty = TwoTierIndex(f0, q0)
    fault_queue = EmbeddingQueue(capacity=REFRESH_CAPACITY)
    for d in ids[: (REFRESH_FAULT_BATCH + 1) * REFRESH_BATCH]:
        fault_queue.push(d, new_docs[d])
    w = RefreshWorker(fault_queue, faulty, emb, FailingOn(q32, REFRESH_FAULT_BATCH, fault),
                      max_batch=REFRESH_BATCH, poll_interval_s=0.01)
    w.start()
    deadline = time.time() + 120
    while w._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    try:
        w.stop()
        raise AssertionError("phase14 fault: stop() did not raise the quality embed's fault")
    except RuntimeError as e:
        if e is not fault:
            raise
    lost = [d for d in faulty.fast.doc_ids if faulty.quality.row_for(d) is None]
    want_lost = ids[(REFRESH_FAULT_BATCH - 1) * REFRESH_BATCH: REFRESH_FAULT_BATCH * REFRESH_BATCH]
    if (w.stats.errors, w.stats.batches) != (1, REFRESH_FAULT_BATCH - 1) or lost != want_lost:
        raise AssertionError(f"phase14 fault: stats {w.stats}, {len(lost)} fast rows without quality rows")
    rec["cut"] = {"docs": REFRESH_CUT_DOCS, "full_at": REFRESH_CAPACITY,
                  "appended": len(ids), "queries": len(cut_queries), "bitwise": True,
                  "fault": {"raised": True, "errors": w.stats.errors, "fast_only_rows": len(lost)},
                  "s": time.perf_counter() - t0}
    log(f"phase14 cut ({REFRESH_CUT_DOCS} docs, two tiers on the card): the queue answered FULL at "
        f"{REFRESH_CAPACITY}; the worker's {len(ids)} appends serve "
        f"{len(cut_queries)} queries bitwise as direct appends; the fault on batch {REFRESH_FAULT_BATCH} was raised "
        f"by stop(), errors 1, {len(lost)} fast rows without quality rows ({rec['cut']['s']:.1f} s)")
    del via_worker, direct, faulty, f0, q0
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase14 total {rec['phase_s']:.1f} s")
    return rec, launches, kernels


GAUNTLET_QUERIES = 50  # phase 15a: the campaign's generated queries over phase 4's corpus (5 guaranteed misses)
GAUNTLET_SEED = SEED + 16  # their QuerySpec seed
MATRIX_QUERIES = 10  # 15b: phase 4's 8 singletons and the batch's first four-word queries not among them
LAW_DOCS = 20_000  # 15d: the reload and maintenance laws' generated corpus (a depth cut)
BOOLEAN_LAW_DOCS = 2_000  # the boolean laws' corpus: their budgets (4 k, k = 500) hold every set whole
LAW_SEED = SEED + 17
RATCHET_SAMPLES = 7  # 15e: perf_ratchet.measure's samples of phase 4's B=256 search_batch (2 warm-up calls)


def phase15_gauntlet(dev, tmp: str, semantic: dict, lexical: dict, quality: dict,
                     done: dict) -> tuple[dict, dict, list[dict]]:
    """gauntlet-1M: the port's evaluation modules judging the card's 1M
    paths, run right after phase 14 on what phases 2, 4 and 8 left on the
    card (no new 1M index). 15a: ``run_differential_campaign`` over phase
    4's corpus, 50 generated queries, the 1M lexical arm's
    ``search_candidates`` against :class:`ExactBm25`, twice: the arm as it
    serves (``daat_mode="auto"``, each query's lane logged) and with every
    query on the flat lane (``"blocked"``, K3). 15b: ``run_interaction_matrix``
    over all eight lanes of ``LANE_CATALOG`` x 10 queries x 5 oracles on a
    ``TwoTierSearcher`` over phase 8's two-tier index (phase 2's fast tier,
    the 1M x 384 quality tier, the trained encoder on the card) with phase
    4's lexical arm, twice: each lane's config as it is (the aligned
    rescore) and with ``quality_rescan`` (K1 and K2 at d = 384 in the
    Refined phase). 15d: the boolean laws on the oracle, a
    ``DeviceBm25Index`` and a ``BulkDeviceBm25Index`` on the card (and FTS5)
    over a generated corpus, the reload law and the append-delete-compact
    law on a ``TwoTierIndex`` on the card at LAW_DOCS. 15e: the campaigns'
    and sweeps' outcomes as ``core/e2e_artifact`` records, read back,
    validated and linted; the schema lockstep; phase 4's B=256
    ``search_batch`` timed by ``perf_ratchet.measure`` twice and judged by
    ``run_ratchet`` (reported, not gated). K1, K2 and K3 are held to their
    twins at the shapes this phase gave them that ``done`` ({"fast",
    "quality", "flat"}) lacks. (15c, the lift gate through the quality
    harness, runs inside phase 8.) Returns its record, launches and kernel
    records."""
    import dataclasses

    import torch

    from frankensearch_tpu_torch import (BulkDeviceBm25Index, DeviceBm25Index, HashEmbedder, IndexableDocument,
                                         MemoryLexicalIndex, TwoTierConfig, TwoTierIndex, TwoTierSearcher)
    from frankensearch_tpu_torch.core import contract_sanity, e2e_artifact
    from frankensearch_tpu_torch.core.metrics_eval import stability_verdict
    from frankensearch_tpu_torch.fusion.interaction_oracles import LANE_CATALOG, run_interaction_matrix
    from frankensearch_tpu_torch.gauntlet import perf_ratchet
    from frankensearch_tpu_torch.gauntlet.generator import CorpusSpec, QuerySpec, generate_corpus
    from frankensearch_tpu_torch.gauntlet.runner import (check_boolean_laws, check_maintenance_laws,
                                                         check_reload_law, run_differential_campaign)
    from frankensearch_tpu_torch.lexical.fts5_adapter import Fts5LexicalIndex, fts5_available

    t_phase = time.perf_counter()
    bm25, texts, queries, singles = lexical["bm25"], lexical["texts"], lexical["queries"], lexical["singles"]
    rec: dict = {}
    launches = {name: 0 for name in launch_counters()}
    flat_inputs: dict = {}

    def add(more: dict) -> None:
        for name, n in more.items():
            launches[name] += n

    # --- 15a: the differential campaign on the 1M arm ---
    t0 = time.perf_counter()
    docs = [IndexableDocument(doc_id=f"doc-{i:07d}", content=t) for i, t in enumerate(texts)]
    exact = lexical["exact"] = ExactBm25(bm25)  # phase 16 reuses it
    rec["oracle_build_s"] = time.perf_counter() - t0
    campaigns = {}
    for mode in ("auto", "blocked"):
        seen: list = []

        def candidate(query: str, k: int):
            hits = bm25.search_candidates(query, k)
            seen.append((query, bm25.last_lane, len(hits)))
            return hits

        bm25.daat_mode = mode
        t0 = time.perf_counter()
        try:
            report, l15a = drive(lambda: run_differential_campaign(
                exact.search, candidate, corpus=docs, query_spec=QuerySpec(n_queries=GAUNTLET_QUERIES,
                                                                           seed=GAUNTLET_SEED), k=K),
                set(), flat_inputs)
        finally:
            del bm25.daat_mode  # the class's "auto" again
        add(l15a)
        if not report.ok or report.cases != GAUNTLET_QUERIES:
            raise AssertionError(f"phase15a {mode}: {report.cases} cases, divergences {report.divergences[:3]}")
        misses = [(q, n) for q, _, n in seen if q.startswith("zzz-miss-")]
        if len(misses) != GAUNTLET_QUERIES // 10 or any(n for _, n in misses):
            raise AssertionError(f"phase15a {mode}: guaranteed misses {misses}")
        lanes: dict = {}
        for _, lane, _ in seen:
            lanes[lane] = lanes.get(lane, 0) + 1
        campaigns[mode] = report
        rec[f"campaign_{mode}"] = {
            "cases": report.cases, "exact_agreements": report.exact_agreements,
            "rank_swaps_within_tolerance": report.rank_swaps_within_tolerance,
            "agreement_rate": report.agreement_rate, "misses": [q for q, _ in misses], "lanes": lanes,
            "query_lanes": [(q, lane) for q, lane, _ in seen], "launches": l15a, "s": time.perf_counter() - t0}
        log(f"phase15a campaign ({mode}): {report.cases} cases, {report.exact_agreements} exact, "
            f"{report.rank_swaps_within_tolerance} rank swaps within tolerance, no divergence (agreement rate "
            f"{report.agreement_rate:.3f}); misses {[q for q, _ in misses]} empty on both; lanes {lanes}; "
            f"launches {l15a} ({rec[f'campaign_{mode}']['s']:.1f} s)")
    need_launches("phase15a", launches, ("K3",))
    del docs, exact

    # --- 15b: the interaction matrix on the 1M two-tier searcher ---
    index, q32, emb = quality["index"], quality["q32"], semantic["emb"]
    extra = [q for q in four_word_singletons(queries, 2 * MATRIX_QUERIES) if q not in singles]
    matrix_queries = list(singles) + extra[: MATRIX_QUERIES - len(singles)]
    by_dim: dict = {DIM: set(), Q_DIM: set()}  # the aligned sweep's fast-tier shapes, the rescan's quality-tier
    sweeps = {}
    l15b = {name: 0 for name in launches}
    for rescan in (False, True):
        tag = "rescan" if rescan else "aligned"
        lane_recs: list[dict] = []
        searchers: list = []

        def make_searcher(cfg):
            if rescan:
                cfg = dataclasses.replace(cfg, quality_rescan=True)
            s = TwoTierSearcher(index, emb, lexical=bm25, quality_embedder=q32, config=cfg,
                                cache_query_embeddings=False)
            searchers.append(s)
            lane = {"phases": {}, "s": 0.0}
            lane_recs.append(lane)
            search = s.search

            def noted(query, k=K, **kw):
                t0 = time.perf_counter()
                out = search(query, k=k, **kw)
                lane["s"] += time.perf_counter() - t0
                for kind in phase_kinds(out.phases):
                    lane["phases"][kind] = lane["phases"].get(kind, 0) + 1
                return out

            s.search = noted
            return s

        t0 = time.perf_counter()
        width = Q_DIM if rescan else DIM
        report, l = drive(lambda: run_interaction_matrix(make_searcher, matrix_queries, lanes=LANE_CATALOG),
                          by_dim[width], flat_inputs, dim=width)
        for s in searchers:
            s.close()
        add(l)
        l15b = {name: l15b[name] + l[name] for name in l15b}
        want = len(LANE_CATALOG) * len(matrix_queries) * 5
        if report.checked != want or not report.ok:
            raise AssertionError(f"phase15b {tag}: {report.checked} of {want} checks, violations "
                                 f"{report.violations[:3]}")
        sweeps[tag] = report
        rec[f"matrix_{tag}"] = {"checked": report.checked, "s": time.perf_counter() - t0, "launches": l,
                                "lanes": {lane.name: r for lane, r in zip(LANE_CATALOG, lane_recs)}}
        log(f"phase15b interaction matrix ({tag}): {report.checked} checks over {len(LANE_CATALOG)} lanes x "
            f"{len(matrix_queries)} queries x 5 oracles, no violation ({rec[f'matrix_{tag}']['s']:.1f} s); "
            f"per lane phases and s: " + json.dumps({n: (r["phases"], round(r["s"], 3))
                                                     for n, r in rec[f"matrix_{tag}"]["lanes"].items()}))
    need_launches("phase15b", l15b, ("K1", "K2", "K3"))
    for width in (DIM, Q_DIM):
        if not any(sh[0] == "group_max" for sh in by_dim[width]):
            raise AssertionError(f"phase15b: no hierarchical scan at d = {width} during the matrix")
    rec["matrix_queries"] = matrix_queries

    t0 = time.perf_counter()
    kernels = check_kernels("gauntlet-1M", index.fast.slab, index.fast._effective_mask(None, None),
                            by_dim[DIM], done=done["fast"])
    kernels += check_kernels("gauntlet-1M-quality", index.quality.slab, index.quality._effective_mask(None, None),
                             by_dim[Q_DIM], done=done["quality"])
    new_flat = {key: v for key, v in flat_inputs.items() if key not in done["flat"]}
    if new_flat:
        kernels += check_flat_kernel("gauntlet-1M", bm25._blocked.classes, new_flat)
    rec["kernel_checks_s"] = time.perf_counter() - t0
    log(f"phase15 K1/K2 shapes d={DIM} {sorted(by_dim[DIM])}, d={Q_DIM} {sorted(by_dim[Q_DIM])}, K3 tiles "
        f"{sorted(flat_inputs)}; held to their twins here where earlier phases had not: {len(kernels)} records")

    # --- 15d: the laws at a depth cut ---
    t0 = time.perf_counter()
    bspec = CorpusSpec(n_docs=BOOLEAN_LAW_DOCS, seed=LAW_SEED)
    corpus = generate_corpus(bspec)
    mem = MemoryLexicalIndex(preview_chars=10_000)
    for d in corpus:
        mem.add_document(d)
    mem.commit()
    arms = {"oracle": mem, "device": DeviceBm25Index(mem, device=dev)}
    if fts5_available():
        fts = Fts5LexicalIndex()
        for d in corpus:
            fts.add_document(d)
        fts.commit()
        arms["fts5"] = fts
    bulk = BulkDeviceBm25Index(corpus, device=dev, preview_chars=10_000)
    law_k = BOOLEAN_LAW_DOCS // 4
    laws = {"boolean": check_boolean_laws(arms, corpus_spec=bspec, k=law_k),
            "boolean_bulk": check_boolean_laws({"bulk": bulk}, corpus_spec=bspec, k=law_k)}
    bulk_parity = check_boolean_laws({"oracle": mem, "bulk": bulk}, corpus_spec=bspec, k=law_k)
    if any(v.law != "boolean-arm-parity" for v in bulk_parity):
        raise AssertionError(f"phase15d: the bulk arm beside the oracle broke a law of its own: {bulk_parity[:3]}")
    rec["boolean_laws_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = CorpusSpec(n_docs=LAW_DOCS, seed=LAW_SEED)
    laws["reload"] = check_reload_law(corpus_spec=spec)
    rec["reload_law_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe = HashEmbedder(dim=DIM)

    def build(c):
        return TwoTierIndex.create(os.path.join(tmp, "gauntlet_laws"), fe.embed_batch([d.content for d in c]),
                                   [d.doc_id for d in c], fe.identity(), device=dev)

    def search(ix, q, k):
        return list(ix.search_fast_classified(fe.embed(q), k).hits)

    def maintain(ix):  # append + delete the same doc, then compact: net no-op
        ix.append_fast(["transient-doc"], fe.embed_batch(["transient maintenance doc"]))
        ix.delete(["transient-doc"])
        return ix.compact()

    laws["maintenance"] = check_maintenance_laws(build, search, maintain, law="append-delete-compact-invariance",
                                                 corpus_spec=spec)
    rec["maintenance_law_s"] = time.perf_counter() - t0
    bad = {name: v[:3] for name, v in laws.items() if v}
    if bad:
        raise AssertionError(f"phase15d: laws violated: {bad}")
    rec["laws"] = {"arms": sorted(arms), "boolean_docs": BOOLEAN_LAW_DOCS, "boolean_k": law_k,
                   "law_docs": LAW_DOCS, "bulk_vs_oracle_parity": [(v.law, v.query) for v in bulk_parity]}
    log(f"phase15d laws: boolean on {sorted(arms)} over {BOOLEAN_LAW_DOCS} docs (k = {law_k}: whole match sets) "
        f"[] ({rec['boolean_laws_s']:.1f} s, the bulk arm's own laws included); the bulk arm beside the oracle: "
        f"{len(bulk_parity)} arm-parity violations (it hydrates previews: the reference's rule); reload over "
        f"{LAW_DOCS} docs [] ({rec['reload_law_s']:.1f} s); append-delete-compact on a TwoTierIndex on the card over "
        f"{LAW_DOCS} docs [] ({rec['maintenance_law_s']:.1f} s)")
    del mem, arms, bulk, corpus

    # --- 15e: the evidence stream, the lockstep, the ratchet ---
    t0 = time.perf_counter()
    path = os.path.join(tmp, "gauntlet_evidence", "gauntlet-1m.jsonl")
    os.makedirs(os.path.dirname(path))
    writer = e2e_artifact.E2eArtifactWriter(path)
    run_id = f"chip-smoke-gauntlet-1m-{SEED}"
    writer.write(e2e_artifact.E2eManifest(
        run_id=run_id, lane="gauntlet", corpus_fingerprint=campaigns["auto"].corpus_fingerprint,
        config={"docs": len(texts), "queries": GAUNTLET_QUERIES, "query_seed": GAUNTLET_SEED, "k": K,
                "matrix_queries": len(matrix_queries), "lanes": [lane.name for lane in LANE_CATALOG]}))
    for mode, report in campaigns.items():
        writer.write(e2e_artifact.OracleReport(
            run_id=run_id, oracle=f"exact-f64-bm25 vs the 1M card arm (daat_mode={mode})", cases=report.cases,
            agreements=report.exact_agreements, divergences=[dataclasses.asdict(d) for d in report.divergences]))
    for tag, report in sweeps.items():
        writer.write(e2e_artifact.OracleReport(
            run_id=run_id, oracle=f"interaction matrix on the 1M two-tier searcher ({tag})", cases=report.checked,
            agreements=report.checked - len(report.violations),
            divergences=[dataclasses.asdict(v) for v in report.violations]))
    records = writer.read_all()
    invalid = [e2e_artifact.validate_artifact(r) for r in records]
    lint = contract_sanity.lint_evidence_stream(records)
    if len(records) != 1 + len(campaigns) + len(sweeps) or any(invalid) or lint:
        raise AssertionError(f"phase15e: {len(records)} records, invalid {invalid}, lint {lint}")
    lockstep = contract_sanity.check_schema_lockstep()
    if not lockstep.ok:
        raise AssertionError(f"phase15e: schema lockstep {lockstep.violations}")
    searcher = TwoTierSearcher(semantic["index"], emb, lexical=bm25, config=TwoTierConfig(fast_only=True))
    incumbent = perf_ratchet.measure(lambda: searcher.search_batch(queries, k=K), samples=RATCHET_SAMPLES)
    null = perf_ratchet.measure(lambda: searcher.search_batch(queries, k=K), samples=RATCHET_SAMPLES)
    searcher.close()
    outcome = perf_ratchet.run_ratchet(perf_ratchet.RatchetGate("phase4-search_batch-B256"), incumbent, null, null)
    keys = {"gate", "passed", "reason", "incumbent_mean", "candidate_mean", "ratio", "aa_null_ok", "stable"}
    means = (sum(incumbent) / len(incumbent), sum(null) / len(null))
    if set(outcome.to_dict()) != keys or (outcome.stable and (outcome.incumbent_mean, outcome.candidate_mean) != means) \
            or (not outcome.stable and not outcome.reason.startswith("unstable")):
        raise AssertionError(f"phase15e: ratchet outcome {outcome.to_dict()} for means {means}")
    cvs = [stability_verdict(x).cv for x in (incumbent, null)]
    rec["evidence"] = {"records": len(records), "kinds": [r["kind"] for r in records], "lockstep_checked": lockstep.checked,
                       "ratchet": outcome.to_dict(), "samples_s": {"incumbent": incumbent, "null": null}, "cv": cvs,
                       "s": time.perf_counter() - t0}
    log(f"phase15e {len(records)} evidence records valid and linted clean; lockstep {lockstep.checked} constants ok; "
        f"ratchet (reported, not gated) {json.dumps(outcome.to_dict())}; B=256 means {means[0] * 1e3:.2f} / "
        f"{means[1] * 1e3:.2f} ms, cv {cvs[0]:.3f} / {cvs[1]:.3f}")
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase15 total {rec['phase_s']:.1f} s; launches {launches}")
    return rec, launches, kernels

SHARDS = 4  # phase 16: shards of the sharded-1M mesh, all on the one card
SHARD_OPEN = 4  # 16e: IndexBuilder / open_hybrid mesh_shards (make_mesh: one shard a card)
SHARD_CLI = 2  # 16e: the CLI's --shards
SHARD_ROOT_QUERIES = 64  # 16e: queries over the 20,000-doc roots (three words of a seeded doc each)
HOT_AB_DOCS = 20_000  # 16d: the retired hot combine's split layout (its dense hot columns are (H_pad, N_pad) f32)
HOT_AB_B = 8
HOT_AB_TOL = 1e-5  # hot combine vs the flat lane: tests/test_hot_arm.py's tolerance


def reorders(what: str, got_rows, want_rows, got_pools, want_pools) -> int:
    """Fused results of one batch against another arm's over the same
    queries: each query's lexical pools the same ranking within
    LEX_REL_TOL (``same_ranking``), and its doc ids equal unless the pools
    differ in order. Returns how many queries' doc ids differ (each a
    lexical reorder within LEX_REL_TOL)."""
    n = 0
    for j, (g, w) in enumerate(zip(got_rows, want_rows)):
        gp, wp = got_pools[j], want_pools[j]
        same_ranking(gp, wp, LEX_REL_TOL, f"{what} query {j} lexical pool")
        if [r[0] for r in g] != [r[0] for r in w]:
            if [d for d, _ in gp] == [d for d, _ in wp]:
                raise AssertionError(f"{what}: query {j} doc ids differ with the same lexical order")
            n += 1
        elif any(abs(a[1] - b[1]) > LEX_REL_TOL * abs(b[1]) for a, b in zip(g, w)):
            raise AssertionError(f"{what}: query {j} fused scores differ")
    return n


def pools_of(searcher, into: dict):
    """A ``_fill_fused`` that notes the first batch's lexical pools (doc
    id, score) per query into ``into`` while it is empty."""
    fill = searcher._fill_fused

    def fill_noted(fused, live, *rest):
        if not into:
            into.update({i: [(c.doc_id, c.score) for c in fused[1][j]] for j, i in enumerate(live)})
        return fill(fused, live, *rest)

    return fill_noted


def phase16_sharded(dev, tmp: str, semantic: dict, lexical: dict) -> tuple[dict, dict, list[dict]]:
    """sharded-1M: phase 2's 1M vectors and phase 4's 1M lexical arm on a
    mesh of SHARDS shards of the one card, no new 1M root. 16a the fast
    tier (``ShardedDeviceVectorIndex``, 4 x 253,952 rows) through a
    fast-only searcher, auto (K1 + K2 per shard) and int8 (K4 + K2-i8 per
    shard); 16b the lexical arm block-sharded (``ShardedBulkDeviceBm25Index``:
    the unsplit layout rebuilt from its host postings) against the exact
    f64 BM25; 16c the hybrid searcher over both through the sharded fused
    lane and the device RRF; 16d the retired hot combine on a 20,000-doc
    split layout; then K1, K2, K4 and K2-i8 against their twins at the
    per-shard shapes."""
    import torch

    from frankensearch_tpu_torch import TwoTierConfig, TwoTierIndex, TwoTierSearcher
    from frankensearch_tpu_torch.parallel.mesh import Mesh
    from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
    from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

    t_phase = time.perf_counter()
    fast, emb = semantic["index"].fast, semantic["emb"]
    mesh = Mesh([dev] * SHARDS, ("d",))
    rec: dict = {}
    launches = {name: 0 for name in launch_counters()}

    def add(more: dict, want: dict) -> None:
        for name, n in more.items():
            launches[name] += n
        for name, n in want.items():
            if more[name] != n:
                raise AssertionError(f"phase16: {name} launched {more[name]} times, want {n} ({more})")

    # --- 16a: the fast tier ---
    t0 = time.perf_counter()
    sharded = ShardedDeviceVectorIndex(fast.vectors_f32(), fast.doc_ids, fast.identity, mesh=mesh, normalize=False,
                                       hier_align=True)  # the card's default, said for CPU rehearsals
    rec["fast_build_s"] = time.perf_counter() - t0
    local = sharded.local_rows
    if local % 8192 or sharded.n_pad != SHARDS * local or sharded.n_pad - fast.n_rows >= SHARDS * 8192:
        raise AssertionError(f"phase16: {sharded.n_pad} padded rows, {local} a shard")
    if any(s.data_ptr() != sharded.slab[i * local:].data_ptr() for i, s in enumerate(sharded._slab_shards)):
        raise AssertionError("phase16: a shard is not a view of the slab on its own card")
    index = TwoTierIndex(sharded)
    searcher = TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True))
    queries, singles = semantic["queries"], semantic["queries"][:8]
    shapes: set = set()
    drive(lambda: searcher.search_batch(queries[:8], k=K), shapes)  # warm-up
    (batch, batch_ms, solo, single_ms), l = drive(lambda: serve(searcher, queries, singles), shapes)
    add(l, {"K1": SHARDS * (1 + len(singles)), "K2": SHARDS * (1 + len(singles))})
    for j, out in enumerate(batch):
        if rows_of(out) != semantic["rows"][j]:
            raise AssertionError(f"phase16: query {j} differs from phase 2's single-device rows")
    for j, one in enumerate(solo):
        if rows_of(one) != semantic["rows"][j]:
            raise AssertionError(f"phase16: singleton {j} differs from phase 2's batch row")
    recall = recall_at_k(batch, semantic["exact_ids"])
    if recall < 0.99:
        raise AssertionError(f"phase16: recall@10 {recall} < 0.99")
    qv = emb.embed_batch(queries)
    got, want = sharded.search_batch(qv, K), fast.search_batch(qv, K)  # comparison runs
    if not (torch.equal(got.indices, want.indices) and torch.equal(got.scores.view(torch.int32),
                                                                    want.scores.view(torch.int32))):
        raise AssertionError("phase16: the sharded index's rows or score bits differ from the single-device index's")
    rec["fast"] = {"padded_rows": sharded.n_pad, "shard_rows": local, "batch_ms": batch_ms, "single_ms": single_ms,
                   "recall_at_10": recall}
    log(f"phase16a sharded-1M fast tier ({SHARDS} x {local} rows, build {rec['fast_build_s']:.1f} s): B=256 "
        f"{batch_ms:.2f} ms, singletons " + ", ".join(f"{t:.2f}" for t in single_ms) + f" ms; rows and score bits "
        f"equal to phase 2's single-device index; recall@10 {recall:.4f}; K1 / K2 {l['K1']} / {l['K2']} launches")

    searcher8 = TwoTierSearcher(index, emb, config=TwoTierConfig(fast_only=True, scan_mode="int8"))
    t0 = time.perf_counter()
    i8_shards, scale_shards = sharded._int8_arm_sharded()
    rec["int8_calibrate_s"] = time.perf_counter() - t0
    shapes8: set = set()
    (b8, b8_ms), l = drive(lambda: timed(lambda: searcher8.search_batch(queries, k=K)), shapes8)
    add(l, {"K4": SHARDS, "K2-i8": SHARDS})
    recall8 = recall_at_k(b8, semantic["exact_ids"])
    if recall8 < INT8_RECALL_FLOOR:
        raise AssertionError(f"phase16: int8 recall@10 {recall8} < {INT8_RECALL_FLOOR}")
    rec["int8"] = {"batch_ms": b8_ms, "recall_at_10": recall8}
    log(f"phase16a sharded-1M-int8 (calibrated in {rec['int8_calibrate_s']:.1f} s): B=256 {b8_ms:.2f} ms, "
        f"recall@10 {recall8:.4f}")
    searcher.close()
    searcher8.close()

    # --- 16b: the lexical arm ---
    bm25, lq, lsingles = lexical["bm25"], lexical["queries"], lexical["singles"]
    t0 = time.perf_counter()
    arm = ShardedBulkDeviceBm25Index(bm25, mesh)
    rec["lex_build_s"] = time.perf_counter() - t0
    blocked = arm._blocked_host
    t0 = time.perf_counter()
    exact = lexical.get("exact") or ExactBm25(bm25)  # phase 15's, over the same postings
    outright = lexical_oracle_check(arm, lq, K, phase="phase16", exact=exact)
    rec["lexical"] = {"blocks": blocked.n_blk, "classes": len(blocked.classes),
                      "blocks_a_shard": [n // SHARDS for n in arm._sharded.n_pad],
                      "blocks_skipped": arm.last_blocks_skipped, "oracle_equal": outright,
                      "oracle_s": time.perf_counter() - t0, "build_s": rec["lex_build_s"]}
    log(f"phase16b sharded lexical arm ({blocked.n_blk} blocks in {len(blocked.classes)} classes, the unsplit "
        f"layout of {bm25.posting_count} postings rebuilt in {rec['lex_build_s']:.1f} s): top-{K} of {len(lq)} "
        f"queries vs exact f64 host BM25: {outright} equal, {len(lq) - outright} differ only at ties within "
        f"{ORACLE_REL_TOL:g}; {arm.last_blocks_skipped} blocks skipped at B={len(lq)}")

    # --- 16c: the hybrid searcher over both sharded arms ---
    hybrid = TwoTierSearcher(index, emb, lexical=arm, config=TwoTierConfig(fast_only=True))
    drive(lambda: hybrid.search_batch(lq[:8], k=K), shapes)  # warm-up
    pools: dict = {}
    lanes: list = []

    def hybrid_path():
        hybrid._fill_fused = pools_of(hybrid, pools)
        try:
            out = serve(hybrid, lq, lsingles)
        finally:
            del hybrid._fill_fused
        lanes.append(hybrid.last_phase1_lex_lane)
        return out

    (hbatch, hms, hsolo, hsingle_ms), l = drive(hybrid_path, shapes)
    add(l, {"K1": SHARDS * (1 + len(lsingles)), "K2": SHARDS * (1 + len(lsingles)), "K3": 0})
    if lanes != ["sharded"] or not all(o.metrics.phase1_fused for o in hbatch) or hybrid.last_fusion_path != "device":
        raise AssertionError(f"phase16: the sharded fused lane did not run ({lanes}, {hybrid.last_fusion_path})")
    hpools = dict(pools)
    check_singletons("phase16", lq, hbatch, lsingles, hsolo)
    n_reordered = reorders("phase16", [rows_of(o) for o in hbatch], lexical["rows"],
                           [hpools[j] for j in range(len(lq))], [lexical["pools"][j] for j in range(len(lq))])
    hybrid._device_rrf_tail = lambda *args: (None, None)
    oracle = hybrid.search_batch(lq, k=K)
    if hybrid.last_fusion_path != "host":
        raise AssertionError(f"phase16: oracle fusion path {hybrid.last_fusion_path!r}")
    for j, (out, want) in enumerate(zip(hbatch, oracle)):
        if [(r.doc_id, r.score) for r in out.results] != [(r.doc_id, r.score) for r in want.results]:
            raise AssertionError(f"phase16: query {j} differs from the host RRF oracle")
    del hybrid._device_rrf_tail
    hybrid.close()
    rec["hybrid"] = {"batch_ms": hms, "single_ms": hsingle_ms, "reordered": n_reordered}
    log(f"phase16c hybrid over both sharded arms: B=256 {hms:.2f} ms through the sharded fused lane, singletons "
        + ", ".join(f"{t:.2f}" for t in hsingle_ms) + " ms; device RRF bitwise the host RRF oracle; singletons "
        f"bitwise their batch rows; doc ids equal to phase 4's single-device results but {n_reordered} queries "
        f"(lexical reorders within {LEX_REL_TOL:g})")

    # --- 16d: the retired hot combine ---
    rec["hot_ab"] = phase16_hot_ab(dev, lexical)

    kernels = check_kernels("sharded-1M", sharded._slab_shards[0], sharded._mask_shards[0], shapes)
    kernels += check_int8_kernels("sharded-1M-int8", i8_shards[0], scale_shards[0], sharded._mask_shards[0], shapes8)
    del sharded, index, arm, i8_shards, scale_shards
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase16 (sharded-1M) {rec['phase_s']:.1f} s; launches {launches}")
    return rec, launches, kernels


def phase16_hot_ab(dev, lexical: dict) -> dict:
    """The term-driven lane's retired hot combine (``ab_primitives.
    hot_daat_topk_ab``) on the card at B = HOT_AB_B, on a split layout of
    phase 4's first HOT_AB_DOCS docs with the thresholds lowered, over
    queries with both hot and tail terms: rank-equal to the split layout's
    flat lane (K3) up to ties within HOT_AB_TOL, scores within it."""
    import numpy as np
    import torch

    from frankensearch_tpu_torch import BulkDeviceBm25Index, IndexableDocument
    from frankensearch_tpu_torch.lexical import daat, hot_arm
    from frankensearch_tpu_torch.lexical import device_bm25 as bm
    from frankensearch_tpu_torch.ops.ab_primitives import hot_daat_topk_ab

    t0 = time.perf_counter()
    docs = [IndexableDocument(doc_id=f"doc-{i:07d}", content=t) for i, t in enumerate(lexical["texts"][:HOT_AB_DOCS])]
    saved = bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS
    bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS = 1, 1
    try:
        idx = BulkDeviceBm25Index(docs, device=dev)
    finally:
        bm.BLOCKED_THRESHOLD_POSTINGS, hot_arm.HOT_MIN_POSTINGS = saved
    hot = idx._hot
    if hot is None:
        raise AssertionError("phase16d: the split layout was not built")
    terms, dids, tfs = idx._post_host
    cols = np.zeros((hot.h_pad, max((idx.n_docs + 127) // 128 * 128, 128)), dtype=np.float32)
    rows = hot.hot_row_of[terms.astype(np.int64)]
    sel = rows >= 0
    np.add.at(cols, (rows[sel], dids[sel].astype(np.int64)), tfs[sel])
    tm = daat.build_term_major(*idx._cold_host, vocab_size=idx.vocab_size, device=dev)
    ids, w = idx._query_sparse_rows(lexical["queries"])
    q_hot = hot_arm.split_hot_rows(hot.hot_row_of, ids, w, hot.h_pad)
    _, tail_w = hot_arm.compact_tail_rows(hot.hot_row_of, ids, w)
    both = np.flatnonzero((q_hot > 0).any(axis=1) & (tail_w > 0).any(axis=1))[:HOT_AB_B]
    if len(both) < HOT_AB_B:
        raise AssertionError(f"phase16d: {len(both)} queries with hot and tail terms")
    queries = [lexical["queries"][j] for j in both]
    plan = daat.build_gather_plan(tm.ptr, ids[both], w[both])
    args = (torch.from_numpy(cols).to(dev), torch.from_numpy(q_hot[both]).to(dev), tm.tm_doc, tm.tm_tf,
            *(torch.from_numpy(x).to(dev) for x in plan))
    (s, i), ms = timed(lambda: hot_daat_topk_ab(*args, k=K, t_run=ids.shape[1]))
    s, i = s.cpu().numpy(), i.cpu().numpy()
    idx.daat_mode = "blocked"
    flat = idx.search_candidates_batch(queries, K)
    if idx.last_lane != "blocked":
        raise AssertionError(f"phase16d: the flat lane did not run ({idx.last_lane})")
    for b, cands in enumerate(flat):
        same_ranking([(idx.doc_ids[int(i[b, j])], float(s[b, j])) for j in range(K) if s[b, j] > 0.0],
                     [(c.doc_id, c.score) for c in cands], HOT_AB_TOL, f"phase16d query {queries[b]!r}")
    out = {"docs": HOT_AB_DOCS, "hot_terms": hot.n_hot, "h_pad": hot.h_pad, "cols_shape": list(cols.shape),
           "ms": ms, "s": time.perf_counter() - t0}
    log(f"phase16d hot_daat_topk_ab at B={HOT_AB_B} over a {HOT_AB_DOCS}-doc split layout ({hot.n_hot} hot terms, "
        f"columns {cols.shape}): {ms:.2f} ms, rank-equal to the flat lane (K3) within {HOT_AB_TOL:g} "
        f"({out['s']:.1f} s)")
    return out


def phase16_roots(dev, tmp: str) -> tuple[dict, dict, list[dict]]:
    """16e, the library and the CLI on the mesh at a depth cut, over the
    20,000-doc corpus phase 12 indexed (``fed_corpus.jsonl``, the
    ``fed_root`` phase 13's ``repro`` reads): ``IndexBuilder`` with
    ``mesh_shards=SHARD_OPEN`` into a root of its own and ``open_hybrid``
    with the same (``make_mesh``: one shard on a one-card machine), its
    batch through the sharded fused lane against the unsharded open of the
    root, an append, a delete, a seal and ``compact()``, then a reopen; then
    ``search --shards`` and ``serve --shards`` over ``fed_root`` against the
    same commands unsharded. Doc ids equal (a lexical reorder within
    LEX_REL_TOL counted), fused scores within LEX_REL_TOL."""
    import numpy as np

    from frankensearch_tpu_torch import IndexableDocument, IndexBuilder, TwoTierConfig, open_hybrid
    from frankensearch_tpu_torch.parallel.sharded_bm25 import ShardedBulkDeviceBm25Index
    from frankensearch_tpu_torch.parallel.sharded_index import ShardedDeviceVectorIndex

    t_phase = time.perf_counter()
    small, corpus = os.path.join(tmp, "fed_root"), os.path.join(tmp, "fed_corpus.jsonl")
    with open(corpus) as f:
        records = [json.loads(line) for line in f]
    docs = [IndexableDocument(doc_id=r["id"], content=r["content"], title=r.get("title")) for r in records]
    rng = np.random.default_rng(SEED + 18)
    queries = [" ".join(docs[j].content.split()[:3]) for j in rng.choice(len(docs), SHARD_ROOT_QUERIES, replace=False)]
    rec: dict = {}
    launches = {name: 0 for name in launch_counters()}
    shapes: set = set()

    def add(more: dict) -> None:
        for name, n in more.items():
            launches[name] += n

    root = os.path.join(tmp, "shard_root")
    cfg = TwoTierConfig(mesh_shards=SHARD_OPEN)
    t0 = time.perf_counter()
    stats = IndexBuilder(root).with_documents(docs).with_config(cfg).build()
    rec["build_s"] = time.perf_counter() - t0
    if stats.doc_count != FED_DOCS:
        raise AssertionError(f"phase16e: the build kept {stats.doc_count} docs")
    h, plain = open_hybrid(root, config=cfg), open_hybrid(root)
    if not (isinstance(h.index.fast, ShardedDeviceVectorIndex) and isinstance(h.delta.sealed, ShardedBulkDeviceBm25Index)):
        raise AssertionError("phase16e: open_hybrid(mesh_shards) did not shard both arms")
    n_shards = len(h.index.fast.shard_devices)
    h.searcher.search_batch(queries[:8], k=K)  # warm-up
    pools: dict = {}
    h.searcher._fill_fused = pools_of(h.searcher, pools)
    try:
        (batch, ms), l = drive(lambda: timed(lambda: h.searcher.search_batch(queries, k=K)), shapes)
    finally:
        del h.searcher._fill_fused
    add(l)
    need_launches("phase16e", l)
    if h.searcher.last_phase1_lex_lane != "sharded":
        raise AssertionError(f"phase16e: lane {h.searcher.last_phase1_lex_lane!r}")
    got_pools = [pools[j] for j in range(len(queries))]
    pools.clear()
    plain.searcher._fill_fused = pools_of(plain.searcher, pools)
    try:
        want = plain.searcher.search_batch(queries, k=K)
    finally:
        del plain.searcher._fill_fused
    rec["library_reordered"] = reorders("phase16e library", [rows_of(o) for o in batch], [rows_of(o) for o in want],
                                        got_pools, [pools[j] for j in range(len(queries))])
    plain.close()

    new = IndexableDocument(doc_id="shard-new", content="zeppelinshard quartzite")
    gone = docs[5].doc_id
    h.index.append_fast([new.doc_id], h.searcher.fast_embedder.embed_batch([new.content]))
    h.delta.add_document(new)
    h.delta.commit()
    h.delete([gone])
    if not isinstance(h.index.fast, ShardedDeviceVectorIndex):
        raise AssertionError("phase16e: a write left the sharded fast tier")
    if h.searcher.search(new.content, k=K).results[0].doc_id != new.doc_id:
        raise AssertionError("phase16e: the appended doc is not its own top hit")
    h.delta.seal()
    t0 = time.perf_counter()
    compacted = h.index.compact()
    rec["compact_s"] = time.perf_counter() - t0
    if not isinstance(compacted.fast, ShardedDeviceVectorIndex) or compacted.mesh_shards != SHARD_OPEN \
            or compacted.fast.row_for(gone) is not None or compacted.fast.row_for(new.doc_id) is None:
        raise AssertionError("phase16e: compact() lost the mesh or the writes")
    h.close()
    t0 = time.perf_counter()
    h = open_hybrid(root, config=cfg)
    rec["reopen_s"] = time.perf_counter() - t0
    top = h.searcher.search(new.content, k=K).results
    hits = {r.doc_id for r in h.searcher.search(docs[5].content, k=K).results}
    if not isinstance(h.index.fast, ShardedDeviceVectorIndex) or top[0].doc_id != new.doc_id or gone in hits:
        raise AssertionError("phase16e: the reopened root lost the mesh or the writes")
    h.close()
    log(f"phase16e IndexBuilder(mesh_shards={SHARD_OPEN}) {rec['build_s']:.1f} s, open_hybrid on {n_shards} "
        f"shard(s): B={len(queries)} {ms:.2f} ms through the sharded fused lane, doc ids equal to the unsharded "
        f"open but {rec['library_reordered']} queries (lexical reorders within {LEX_REL_TOL:g}); append, delete, "
        f"seal, compact() {rec['compact_s']:.1f} s and reopen {rec['reopen_s']:.1f} s on the mesh")

    # the CLI over phase 12's root; where a reply's doc ids differ from the
    # unsharded reply's, the two lexical arms' candidates for its query must
    # be one ranking within LEX_REL_TOL
    arms = [open_hybrid(small, config=TwoTierConfig(mesh_shards=SHARD_CLI)), open_hybrid(small)]

    def reordered(q: str, got: list, want: list, what: str) -> int:
        got, want = [(r["doc_id"], r["score"]) for r in got], [(r["doc_id"], r["score"]) for r in want]
        if [d for d, _ in got] != [d for d, _ in want]:
            same_ranking(*[[(c.doc_id, c.score) for c in a.delta.sealed.search_candidates(q, 100)] for a in arms],
                         LEX_REL_TOL, f"phase16e {what} {q!r}")
            return 1
        if any(abs(x - y) > LEX_REL_TOL * abs(y) for (_, x), (_, y) in zip(got, want)):
            raise AssertionError(f"phase16e: {what} {q!r} scores differ")
        return 0

    sharded_cli, l = drive(lambda: [run_cli(["search", q, "--root", small, "-k", str(K), "--shards", str(SHARD_CLI)])
                                    for q in queries[:8]], shapes)
    add(l)
    plain_cli = [run_cli(["search", q, "--root", small, "-k", str(K)]) for q in queries[:8]]
    cli_reordered = sum(reordered(q, a["data"], b["data"], "search --shards")
                        for q, a, b in zip(queries[:8], sharded_cli, plain_cli))
    served, l = drive(lambda: serve_session(small, queries, queries[:4], argv=("--shards", str(SHARD_CLI)),
                                            full=False), shapes)
    add(l)
    need_launches("phase16e", launches)
    base = serve_session(small, queries, queries[:4], full=False)
    if not isinstance(served["handle"].index.fast, ShardedDeviceVectorIndex):
        raise AssertionError("phase16e: serve --shards did not open the sharded fast tier")
    asked = {"batch": queries, **{f"single{i}": [q] for i, q in enumerate(queries[:4])}}
    serve_reordered = 0
    for step, qs in asked.items():
        for q, a, b in zip(qs, served["replies"][step], base["replies"][step]):
            if not (a["ok"] and b["ok"]):
                raise AssertionError(f"phase16e: serve {step} failed: {a.get('error')} / {b.get('error')}")
            serve_reordered += reordered(q, a["data"], b["data"], f"serve --shards {step}")
    for a in arms:
        a.close()
    rec.update({"cli_reordered": cli_reordered, "serve_reordered": serve_reordered, "serve_ms": served["ms"],
                "phase_s": time.perf_counter() - t_phase})
    log(f"phase16e search --shards {SHARD_CLI} (8 queries) and serve --shards {SHARD_CLI} ({len(queries)} "
        f"pipelined, 4 singletons) over the {FED_DOCS}-doc root: doc ids equal to the unsharded replies but "
        f"{cli_reordered} / {serve_reordered} (lexical reorders within {LEX_REL_TOL:g}); {rec['phase_s']:.1f} s; "
        f"launches {launches}")
    return rec, launches, []


#: phase 17 (train-384): data/quality_encoder_384's recipe (tests/test_trained_quality_384.py)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_LR, TRAIN_SEED = 200, 16, 5e-4, 11
TRAIN_RESUME_AT = 100  # the checkpointed run stops here, the resumed one goes on to TRAIN_STEPS
TRAIN_T = 32  # finetune_quality_tier pads every text to 32 tokens
#: 17a: the (dp 2, tp 2) mesh step against the mesh of one and the CPU port's
#: step from the same state: f32 sums in other orders (row-parallel partial
#: sums, cuBLAS's GEMM by shape, the CPU's kernels), logits scaled by 1 / 0.05
TRAIN_LOSS_RTOL = 1e-5
#: each gradient within TRAIN_GRAD_REL of its leaf's largest entry, plus
#: TRAIN_GRAD_FLOOR of the largest entry of all: the key bias's gradient is
#: zero but for rounding (softmax ignores a shift shared by a row's logits)
TRAIN_GRAD_REL, TRAIN_GRAD_FLOOR = 1e-4, 1e-6
#: one AdamW update from the mesh of one's gradients on each mesh's master
#: copy (the same elementwise arithmetic; the CPU's and the card's kernels
#: may round a weight near 1 by one f32 ulp): within TRAIN_UPDATE_ATOL plus
#: TRAIN_UPDATE_RTOL of the weight. A wrong update moves a weight by about lr
TRAIN_UPDATE_ATOL, TRAIN_UPDATE_RTOL = 1e-7, 2.0**-23
PIPE_STAGES, PIPE_MICRO, PIPE_TOL = 3, 4, 2e-5  # 17d: 6 layers, 2 a stage
LIFT_RECORDED = (0.0613, 0.0406, 0.0845)  # data/quality_encoder_384's held-out lift and CI (the reference's run)


def phase17_train(dev, tmp: str) -> tuple[dict, dict, list[dict]]:
    """train-384: the training path on the card at data/quality_encoder_384's
    config (vocab 396, H 384, 6 layers, 12 heads, FFN 1536, max_position
    128) from the port's random init (seed 11), on the lift world's 90
    training pairs. 17a one step at batch 16 on a (dp 2, tp 2) mesh of four
    shards of the card (sequence parallelism and remat on) against the same
    step on a mesh of one and on the CPU (loss and gradients), and one AdamW
    update from identical gradients on each; 17b ``finetune_quality_tier`` with
    the recipe (200 steps, batch 16, lr 5e-4, seed 11) uninterrupted, then
    100 steps with a checkpoint and a resume to 200, bitwise the same; 17c
    the tuned encoder saved, loaded with its certificate verified and served
    as the quality tier of the held-out lift world, beside the untrained
    control; 17d the GPipe pipeline over three stages of the card; 17e
    ``graft_entry.dryrun_multichip(4)`` and ``entry()``. The training path
    has no kernel of its own (the encoder's products are cuBLAS's); the
    searches of 17c and 17e launch the scan kernels, counted in
    (rec, launches, kernels) and held to their twins at their shapes."""
    import dataclasses

    import numpy as np
    import torch

    from frankensearch_tpu_torch import graft_entry
    from frankensearch_tpu_torch.parallel.mesh import Mesh
    from frankensearch_tpu_torch.parallel.pipeline import (pipeline_embed_forward, pipeline_encoder_forward,
                                                           shard_stacked_layers, stack_layer_params)
    from frankensearch_tpu_torch.parallel.train import AdamW, encode_batch, finetune_quality_tier, make_train_step
    from frankensearch_tpu_torch.parallel.train import shard_params
    from frankensearch_tpu_torch.rerank.bert import BertConfig
    from frankensearch_tpu_torch.rerank.encoder import load_artifact, random_transformer_embedder, save_artifact
    from frankensearch_tpu_torch.utils.quality_harness import compare_systems

    t_phase = time.perf_counter()
    card = gpu_line()
    cpu = torch.device("cpu")
    torch.cuda.reset_peak_memory_stats()
    world = lift_world()
    pairs = world[4]
    untrained = random_transformer_embedder(world[3], device=dev, hidden=Q_DIM, layers=6, heads=12, seed=TRAIN_SEED)
    cfg, tok = untrained.cfg, untrained.tokenizer
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), QUALITY_ARTIFACT, "encoder.json")) as f:
        want_cfg = json.load(f)["cfg"]
    if cfg != BertConfig(**want_cfg):
        raise AssertionError(f"phase17: config {dataclasses.asdict(cfg)} is not {QUALITY_ARTIFACT}'s {want_cfg}")
    rec: dict = {"config": dataclasses.asdict(cfg), "card": card}

    # --- 17a: one step on the (2, 2) mesh, on a mesh of one, on the CPU ---
    t0 = time.perf_counter()
    idx = np.random.default_rng([TRAIN_SEED, 0]).choice(len(pairs), size=TRAIN_BATCH, replace=False)
    batch = (*encode_batch(tok, [pairs[i][0] for i in idx]), *encode_batch(tok, [pairs[i][1] for i in idx]))
    state = untrained.model.state_dict()
    meshes = {"mesh_2x2": Mesh(np.array([dev] * 4, dtype=object).reshape(2, 2), ("dp", "tp")),
              "mesh_1": Mesh(np.array([[dev]], dtype=object), ("dp", "tp")),
              "cpu": Mesh(np.array([[cpu]], dtype=object), ("dp", "tp"))}
    steps, out, updated = {}, {}, {}
    for name, mesh in meshes.items():
        optimizer = AdamW(TRAIN_LR)
        params = shard_params(state, mesh, cfg)
        opt_state = optimizer.init(params)
        steps[name] = (make_train_step(cfg, mesh, optimizer, sequence_parallel=True, remat=True), params, opt_state)
        _, _, loss = steps[name][0](params, opt_state, *batch)
        out[name] = (float(loss), {n: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
                                   for n, p in params.items()})
    base_loss, base_grads = out["mesh_1"]
    for name, mesh in meshes.items():  # one update from the mesh of one's gradients
        optimizer = AdamW(TRAIN_LR)
        params = shard_params(state, mesh, cfg)
        opt_state = optimizer.init(params)
        for n, p in params.items():
            p.grad = base_grads[n].to(p.device)
        optimizer.update(params, opt_state)
        updated[name] = {n: p.detach().cpu() for n, p in params.items()}
    diffs = {}
    for name in ("mesh_2x2", "cpu"):
        loss, grads = out[name]
        floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in base_grads.values())
        grad_rel = max(float((grads[n] - g).abs().max()) / (TRAIN_GRAD_REL * float(g.abs().max()) + floor)
                       for n, g in base_grads.items())  # 1 = at the tolerance
        update_rel = max(float(((updated[name][n] - w).abs() / (TRAIN_UPDATE_ATOL + TRAIN_UPDATE_RTOL * w.abs())).max())
                         for n, w in updated["mesh_1"].items())  # 1 = at the tolerance
        update_err = max(float((updated[name][n] - w).abs().max()) for n, w in updated["mesh_1"].items())
        loss_rel = abs(loss - base_loss) / abs(base_loss)
        diffs[name] = {"loss": loss, "loss_rel": loss_rel, "grad_err_over_tol": grad_rel,
                       "update_max_abs": update_err, "update_err_over_tol": update_rel}
        if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= 1.0 and update_rel <= 1.0):
            raise AssertionError(f"phase17a: the {name} step is off the mesh-of-one step: {diffs[name]}")
    step_ms = {}
    for name in ("mesh_2x2", "mesh_1"):
        fn, params, opt_state = steps[name]
        step_ms[name] = cuda_median_ms(lambda: fn(params, opt_state, *batch), warmup=2, iters=10)
    del steps, out, updated
    tokens = 2 * TRAIN_BATCH * TRAIN_T
    rec["mesh_step"] = {"mesh_1_loss": base_loss, "vs": diffs, "step_ms": step_ms,
                        "tokens_per_s": {k: tokens / (v / 1000.0) for k, v in step_ms.items()},
                        "s": time.perf_counter() - t0}
    log(f"phase17a [{card}] one step at B={TRAIN_BATCH} x T={TRAIN_T}: loss {base_loss:.6f} on a mesh of one; "
        f"(dp 2, tp 2) mesh of 4 shards (sequence parallel, remat) {json.dumps(diffs['mesh_2x2'])}; CPU "
        f"{json.dumps(diffs['cpu'])}; step by CUDA events " + ", ".join(
            f"{k} {v:.2f} ms ({tokens / (v / 1000.0):.0f} padded tokens/s)" for k, v in step_ms.items())
        + f"; {rec['mesh_step']['s']:.1f} s")

    # --- 17b: the recipe, uninterrupted, then checkpointed and resumed ---
    t0 = time.perf_counter()
    recipe = dict(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, seed=TRAIN_SEED)
    tuned, losses = finetune_quality_tier(untrained, pairs, **recipe)
    full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck = os.path.join(tmp, "train384-ck")
    finetune_quality_tier(untrained, pairs, **dict(recipe, steps=TRAIN_RESUME_AT), checkpoint_dir=ck,
                          checkpoint_every=TRAIN_RESUME_AT)
    resumed, tail = finetune_quality_tier(untrained, pairs, **recipe, checkpoint_dir=ck,
                                          checkpoint_every=TRAIN_RESUME_AT)
    resume_s = time.perf_counter() - t0
    if tail != losses[TRAIN_RESUME_AT:]:
        raise AssertionError(f"phase17b: the resumed losses differ from the uninterrupted run's "
                             f"({tail[:3]} vs {losses[TRAIN_RESUME_AT:TRAIN_RESUME_AT + 3]})")
    want_state, got_state = tuned.model.state_dict(), resumed.model.state_dict()
    if not all(torch.equal(v, got_state[n]) for n, v in want_state.items()):
        raise AssertionError("phase17b: the resumed weights differ from the uninterrupted run's")
    head, tail5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not tail5 < 0.9 * head:
        raise AssertionError(f"phase17b: the loss did not fall ({head:.4f} -> {tail5:.4f})")
    rec["finetune"] = {"losses": losses, "loss_head5": head, "loss_tail5": tail5, "s": full_s,
                       "step_ms_host": full_s * 1000.0 / TRAIN_STEPS, "resume_s": resume_s,
                       "resume_bitwise": True}
    log(f"phase17b [{card}] finetune_quality_tier {TRAIN_STEPS} steps (batch {TRAIN_BATCH}, lr {TRAIN_LR:g}, seed "
        f"{TRAIN_SEED}) in {full_s:.1f} s ({rec['finetune']['step_ms_host']:.2f} ms a step by the host clock, a "
        f"loss read each step); loss {head:.4f} -> {tail5:.4f} (first and last 5); {TRAIN_RESUME_AT} steps + "
        f"checkpoint + resume to {TRAIN_STEPS} in {resume_s:.1f} s: losses and weights bitwise the uninterrupted run's")

    # --- 17c: the artifact and the held-out lift, tuned against untrained ---
    t0 = time.perf_counter()
    art = os.path.join(tmp, "quality_encoder_384_tuned")
    save_artifact(tuned, art)
    loaded = load_artifact(art, device=dev)  # verify=True: the certificate, fail-closed
    lifts = {}
    reports, l17c, kernels = counted("train-384-lift", lambda: {
        label: lift_eval(dev, world, enc, os.path.join(tmp, f"lift17-{label}"), rescan=False)
        for label, enc in (("tuned", loaded), ("untrained", untrained))})
    for label, (init, refined, skips) in reports.items():
        if any(skips):
            raise AssertionError(f"phase17c {label}: phase-2 skips {sorted(set(skips) - {None})}")
        cmp = compare_systems(init, refined)
        i_n, r_n = ([rep.per_query[q]["ndcg"] for q in sorted(rep.per_query)] for rep in (init, refined))
        lifts[label] = {"initial": float(np.mean(i_n)), "refined": float(np.mean(r_n)),
                        "lift": float(np.mean(r_n) - np.mean(i_n)), "lo": cmp.lo, "hi": cmp.hi,
                        "significant": cmp.significant}
    if not (lifts["tuned"]["lo"] > 0 and lifts["tuned"]["lift"] > lifts["untrained"]["lift"]):
        raise AssertionError(f"phase17c: the tuned lift is not significant or not above the control's: {lifts}")
    rec["lift"] = dict(lifts, recorded={"lift": LIFT_RECORDED[0], "lo": LIFT_RECORDED[1], "hi": LIFT_RECORDED[2]},
                       launches=l17c, s=time.perf_counter() - t0)
    log(f"phase17c [{card}] artifact saved and loaded with its certificate verified; held-out lift (Refined - "
        f"Initial nDCG@10): tuned {lifts['tuned']['lift']:+.4f} [{lifts['tuned']['lo']:.4f}, "
        f"{lifts['tuned']['hi']:.4f}], untrained control {lifts['untrained']['lift']:+.4f} "
        f"[{lifts['untrained']['lo']:.4f}, {lifts['untrained']['hi']:.4f}]; the reference's recorded "
        f"{LIFT_RECORDED[0]:+.4f} [{LIFT_RECORDED[1]}, {LIFT_RECORDED[2]}]; launches {l17c}; "
        f"{rec['lift']['s']:.1f} s")

    # --- 17d: the pipeline over three stages of the card ---
    t0 = time.perf_counter()
    tuned_state = loaded.model.state_dict()
    pp = Mesh([dev] * PIPE_STAGES, ("pp",))
    stacked = shard_stacked_layers(stack_layer_params(tuned_state), pp)
    ids, mask = (torch.from_numpy(x).to(dev, torch.int64) for x in loaded.tokenize_batch(world[1][:8]))
    with torch.inference_mode():
        hidden = pipeline_encoder_forward(tuned_state, stacked, ids, mask, cfg=cfg, mesh=pp, microbatches=PIPE_MICRO,
                                          n_stages=PIPE_STAGES)
        enc_err = float((hidden - loaded.model.encoder_forward(ids, mask)).abs().max())
        pooled = pipeline_embed_forward(tuned_state, stacked, ids, mask, cfg=cfg, mesh=pp, microbatches=PIPE_MICRO)
        emb_err = float((pooled - loaded.model.embed_forward(ids, mask)).abs().max())
        pipe_ms = cuda_median_ms(lambda: pipeline_encoder_forward(
            tuned_state, stacked, ids, mask, cfg=cfg, mesh=pp, microbatches=PIPE_MICRO, n_stages=PIPE_STAGES),
            warmup=1, iters=5)
        try:
            pipeline_encoder_forward(tuned_state, stacked, ids[:5], mask[:5], cfg=cfg, mesh=pp,
                                     microbatches=PIPE_MICRO, n_stages=PIPE_STAGES)
            raise AssertionError("phase17d: a batch of 5 over 4 microbatches did not raise")
        except ValueError as e:
            if "divisible" not in str(e):
                raise
    if not (enc_err <= PIPE_TOL and emb_err <= PIPE_TOL):
        raise AssertionError(f"phase17d: the pipeline is {enc_err:.3e} / {emb_err:.3e} from the sequential encoder")
    rec["pipeline"] = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO, "encoder_max_abs_err": enc_err,
                       "embed_max_abs_err": emb_err, "ms": pipe_ms, "s": time.perf_counter() - t0}
    log(f"phase17d [{card}] pipeline over {PIPE_STAGES} stages of the card, {PIPE_MICRO} microbatches of "
        f"{len(ids) // PIPE_MICRO}: encoder {enc_err:.3e}, embedding {emb_err:.3e} from the sequential forwards "
        f"(tol {PIPE_TOL:g}); {pipe_ms:.2f} ms a forward; a batch of 5 raised")

    # --- 17e: the dry run and the entry on the card ---
    t0 = time.perf_counter()

    def dry_and_entry():
        dry = graft_entry.dryrun_multichip(4)
        fn, args = graft_entry.entry()
        return dry, fn, args, fn(*args)

    (dry, fn, args, res), l17e, more = counted("dryrun-4", dry_and_entry)
    need_launches("phase17e", l17e)
    kernels += more
    if tuple(res.scores.shape) != (8, 10) or not bool(torch.isfinite(res.scores).all()):
        raise AssertionError(f"phase17e: entry() gave {tuple(res.scores.shape)}")
    entry_ms = cuda_median_ms(lambda: fn(*args), warmup=1, iters=5)
    rec["dryrun"] = dict(dry, entry_ms=entry_ms, launches=l17e, s=time.perf_counter() - t0)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase17e [{card}] dryrun_multichip(4) on the card: {json.dumps(dry)}; launches {l17e} (the sharded "
        f"fused lane's K1 and K2 per shard); entry() {entry_ms:.2f} ms; peak device memory "
        f"{rec['peak_memory_bytes'] / 2**20:.1f} MiB; phase 17 {rec['phase_s']:.1f} s")
    del tuned, resumed, loaded, untrained
    torch.cuda.empty_cache()
    return rec, {name: l17c[name] + l17e[name] for name in l17c}, kernels


def counted(cell: str, fn):
    """Run ``fn`` with the launch counters zeroed (:func:`drive`), keeping
    every hierarchical scan's slab, mask and kernel shapes and every
    Model2Vec pool call; then hold K1 and K2 to their twins on each slab at
    its shapes, and each pool call bit for bit to its twin on the same
    inputs (:func:`check_pool_calls`). Any other kernel launched fails the
    phase. Returns (result, {kernel: launches}, kernel records)."""
    import torch

    from frankensearch_tpu_torch.ops import topk_scan as ts

    slabs: dict = {}  # (data pointer, shape) -> (slab, mask, shapes)

    def keep_scans(real):
        def kept(slab, queries, k, mask=None):
            held = mask if mask is not None else torch.zeros(slab.shape[0], dtype=torch.float32, device=slab.device)
            _, _, shapes = slabs.setdefault((slab.data_ptr(), tuple(slab.shape)), (slab, held, set()))
            b = queries.shape[0]
            shapes.update({("group_max", b, 0), ("gather_rescore", b, min(k, slab.shape[0] // ts.GROUP))})
            return real(slab, queries, k, mask)
        return kept

    pool_calls: list = []
    with spied((ts, "scan_topk_hierarchical", keep_scans)):
        out, launches = drive(fn, set(), pool_calls=pool_calls)
    unheld = {name: n for name, n in launches.items() if n and name not in ("K1", "K2", "pool")}
    if unheld or (launches["K1"] + launches["K2"] and not slabs):
        raise AssertionError(f"{cell}: kernels launched outside the hierarchical scans it checks: {launches}")
    check_pool_calls(cell, pool_calls, launches["pool"])
    del pool_calls
    kernels = []
    for i, (slab, mask, shapes) in enumerate(slabs.values()):
        kernels += check_kernels(f"{cell}-{i}", slab, mask, shapes)
    return out, launches, kernels


def main() -> int:
    # the port must reach neither jax nor the JAX package, even indirectly
    sys.modules["jax"] = None
    sys.modules["frankensearch_tpu"] = None
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from frankensearch_tpu_torch.device import resolve_device
        from frankensearch_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    t_main = time.perf_counter()
    card = gpu_line()
    log(f"phase0 card: {card}")
    log(f"phase0 torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    lib = _build.library_path()
    log(f"phase0 kernel build {time.perf_counter() - t0:.1f} s -> {os.path.relpath(lib)}")

    wall = {}
    with tempfile.TemporaryDirectory(prefix="fs_chip_smoke_") as tmp:
        t0 = time.perf_counter()
        sem, l2, k2, semantic = phase2_semantic(dev, tmp)
        wall["phase2_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        hyb, l3, k3 = phase3_hybrid(dev, tmp)
        wall["phase3_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        h1m, l4, k4, lexical = phase4_hybrid1m(dev, semantic)
        wall["phase4_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        modes, l5, k5 = phase5_scan_modes(dev, tmp, semantic, lexical)
        wall["phase5_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ab_rec, l6, k6 = phase6_ab_scan(dev, semantic)
        wall["phase6_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2v_rec, l7, k7, m2v_run = phase7_hybrid_m2v(dev, tmp, lexical)
        wall["phase7_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        quality_rec, l8, k8, quality = phase8_quality(dev, tmp, semantic, lexical)
        wall["phase8_s"] = time.perf_counter() - t0
        # phase 14 runs here, on phase 8's index: its appends make new tier
        # objects in its own TwoTierIndex, so phase 9's index (phase 2's)
        # is untouched, and no second 1M two-tier index is held
        t0 = time.perf_counter()
        refresh_rec, l14, k14 = phase14_refresh(
            dev, tmp, semantic, lexical, quality,
            {"fast": kernel_shapes(k2 + k4, ("semantic-1M", "hybrid-1M")),
             "quality": kernel_shapes(k8, ("hybrid-1M-quality",))})
        wall["phase14_s"] = time.perf_counter() - t0
        # phase 15 judges what phases 2, 4 and 8 left on the card
        t0 = time.perf_counter()
        gauntlet_rec, l15, k15 = phase15_gauntlet(
            dev, tmp, semantic, lexical, quality,
            {"fast": kernel_shapes(k2 + k4, ("semantic-1M", "hybrid-1M")),
             "quality": kernel_shapes(k8, ("hybrid-1M-quality",)),
             "flat": {(r["b"], r["t"]) for r in k4 if r["kernel"] == "flat_fused"}})
        wall["phase15_s"] = time.perf_counter() - t0
        del quality
        torch.cuda.empty_cache()
        # phase 16 shards phases 2 and 4's arms over the card before phase 9
        # writes into phase 2's index
        t0 = time.perf_counter()
        shard_rec, l16, k16 = phase16_sharded(dev, tmp, semantic, lexical)
        wall["phase16_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lanes_rec, l9, k9 = phase9_scan_lanes(dev, tmp, semantic)
        wall["phase9_s"] = time.perf_counter() - t0
        del semantic
        t0 = time.perf_counter()
        built_rec, l10, k10 = phase10_built_m2v(dev, tmp, lexical, m2v_run)
        wall["phase10_s"] = time.perf_counter() - t0
        del m2v_run, lexical["bm25"]
        t0 = time.perf_counter()
        cli_rec, l11, k11 = phase11_cli(dev, tmp, lexical)
        wall["phase11_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        live_rec, l12, k12 = phase12_live(dev, tmp, lexical)
        wall["phase12_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet_rec, l13, k13 = phase13_fleet(dev, tmp, lexical, live_rec["watch"][1]["doc_count"])
        wall["phase13_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        roots_rec, l16e, k16e = phase16_roots(dev, tmp)
        wall["phase16e_s"] = time.perf_counter() - t0
        del lexical
        t0 = time.perf_counter()
        train_rec, l17, k17 = phase17_train(dev, tmp)
        wall["phase17_s"] = time.perf_counter() - t0
        log("phase wall times: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    wall["total_s"] = time.perf_counter() - t_main
    log(f"chip_smoke wall time: {wall['total_s']:.1f} s (the kernel build, every phase and the cleanup)")

    records = k2 + k3 + k4 + k5 + k6 + k7 + k8 + k9 + k10 + k11 + k12 + k13 + k14 + k15 + k16 + k16e + k17
    kernels = []
    for name, key, src, replaces, cell in KERNELS:
        recs = [r for r in records if r["kernel"] == name]
        if name == "flat_fused":
            # headline: one launch (one class) at the widest batch tile, the
            # mean over the classes, the unit of its launch count
            top = max((r["b"], r["t"]) for r in recs)
            head = [r for r in recs if (r["b"], r["t"]) == top]
        else:
            # headline: a record marked so (K2-ivf's full probe), else the
            # 1M-doc cell's largest batch (and largest kk)
            head = [r for r in recs if r.get("headline")] or [
                max((r for r in recs if r["cell"] == cell), key=lambda r: (r["b"], r["kk"] or 0))]
        bound_ms = sum(r["bound"][0] for r in head) / len(head)
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(l.get(key, 0) for l in (l2, l3, l4, l5, l6, l7, l8, l9, l10, l11, l12, l13, l14, l15,
                                                    l16, l16e, l17)),
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": sum(r["ms"] for r in head) / len(head), "plain_ms": sum(r["plain_ms"] for r in head) / len(head),
            "bound_ms": bound_ms,
            "bound_by": max(head, key=lambda r: r["bound"][0])["bound"][1],
            # one PyTorch call computes only the full probe's scores (before
            # the mask and top-k): K2-ivf's yardstick; none computes the others
            "library_ms": head[0].get("library_ms"),
            "shapes": [{k: (v if k != "bound" else v[0]) for k, v in r.items() if k != "kernel"} for r in recs],
        })
    log(json.dumps({"semantic": sem, "hybrid": hyb, "hybrid_1m": h1m, "scan_modes": modes, "ab_scan": ab_rec,
                    "hybrid_1m_m2v": m2v_rec, "hybrid_1m_quality": quality_rec, "scan_lanes": lanes_rec,
                    "built_1m_m2v": built_rec, "cli_1m": cli_rec, "cli_live_1m": live_rec,
                    "cli_fleet_1m": fleet_rec, "refresh_1m_quality": refresh_rec, "gauntlet_1m": gauntlet_rec,
                    "sharded_1m": shard_rec, "sharded_roots": roots_rec, "train_384": train_rec, "wall_s": wall}))
    log(json.dumps({"kernels": kernels}))
    log(gpu_line())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
