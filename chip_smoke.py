#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``avenir_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package ``avenir_tpu``; the JAX
package's outputs it is held against are committed fixtures.  Phases, in
order — any failure exits non-zero before the result line:

  1. device   require torch.cuda.is_available(); print the card's name and
              power limit (nvidia-smi)
  2. build    build every CUDA kernel from csrc/ (one nvcc per source, all
              started together: vote.cu, histogram.cu, bin_counts.cu,
              topk.cu and threefry.cu; topk.cu, the slowest, is waited
              for just before phase 15, which first needs it) and, on a
              thread meanwhile, the native CSV reader (io/csv_native.cpp,
              g++) into build/avenir_tpu_torch/
  3. kernel   the ensemble-vote kernel against its plain PyTorch version on
              the card: random stacked forests (NaNs, negative and
              out-of-range codes, negative integer weights, ties, min_odds
              1.0 and 1.5) at the published forest's shape (T=9, P=17, F=4,
              C=4, K=3), which must select the table form and is also run
              in the scan form, and a wide one whose tables and predicates
              do not fit in shared memory (T=64, P=257, F=16, C=16, K=8),
              which must select the scan form, each at n = 1, 7, 513 and
              1,000,000 rows (262,144 at the wide shape); the int32 votes
              must be EXACTLY equal
  4. golden   the port's modelPredictor CLI over the golden rf forest
              (tests/golden/fixtures/rf) must reproduce its pred.csv byte for
              byte
  5. rafo9    the port's modelPredictor over the 9-tree fixture
              (tests/torch_fixtures/rafo9) and its predictionService
              (in-process) over a copy of the fixture's registry must
              reproduce pred.csv and served.csv byte for byte.  Phases 4-5
              are the main path: launch counts are zeroed before them and
              read after; the vote kernel must have launched, every launch
              in the table form, and the ledger must show
              ensemble.vote.cuda and never the torch or host vote
  6. times    median CUDA-event times of the kernel (table form; the scan
              form on the same forest as "old", in turns) and its plain
              version on the rafo9 forest over its requests tiled to
              1,000,000 rows (the reported numbers), then on random inputs
              at the published and the wide shape; each also on the card
              alone (device_ms: calls queued behind a spin kernel); and the
              bound: the larger of the bytes moved over 3.35 TB/s and the
              predicate tests the kernel's scan runs on this data over
              33.5 T tests/s (one per float32 lane per clock).  No single
              PyTorch call computes the vote, so library_ms is null
  7. b1       the level-histogram kernel against its plain PyTorch version
              on the card, in each form a shape takes: seeded inputs with
              node ids -1, -2 and N, classes -1 and C, branch codes -1 and
              B, zero weights and weight 255, bootstrap-drawn uint8 weights
              (the mma form, which level_form must select, and the forced
              atomic form) and float32 integer weights (the atomic form; a
              launch's weight mass below 2^24), at the rafo forest's level
              shape (T=9, N=1 and 8, S=19, B=2, C=2), the bench forest's
              (T=16, N=8) and a wide one that takes only the atomic form
              and whose accumulator does not fit in shared memory (T=64,
              N=128, S=64, B=4, C=4), each at n = 1, 7 and 1000 (also from
              row 3 on: slices off any 16-byte boundary), plus rafo at
              1,000,000 rows, bench at 8,000,000 and wide at 262,144; the
              float32 counts must be EXACTLY equal
  8. train    the training main path, launch counts zeroed before and read
              after: the port's randomForestBuilder CLI over the golden rf
              data (3 trees) and three decisionTreeBuilder levels over the
              golden dt data must reproduce tests/golden/fixtures/rf and dt
              byte for byte; randomForestBuilder over call_hangup_gen(5000,
              17) with rafo.properties and a registry must reproduce the
              rafo9 trees and the committed meta.json, and
              predictionService serving that freshly trained registry must
              reproduce served.csv.  The histogram kernel must have
              launched, every launch in the mma form
              (histogram.mma_launches), and the ledger must show
              forest.level.cuda, tree.level.cuda and their .form.mma and no
              torch or atomic form
  9. scale    a 1,000,000-row table in call_hangup.json's schema, drawn
              with numpy: the rafo forest trained on the card and, with
              device="cpu", through the plain version must give identical
              trees, every card launch in the mma form; prints the card's
              wall time, the median per-level layer times and the
              bootstrap weights' H2D bytes (the 4-bit wire: ceil(T/2) =
              5 bytes a row at T = 9, which it must be)
 10. b1 times median CUDA-event times of the histogram kernel (the mma
              form; the atomic form as "old", in turns, each also on the
              card alone) and its plain version at rafo 1,000,000 rows
              (N=8, the reported numbers; and N=1, the root level) and
              bench 8,000,000 rows (N=8), and the
              bound: the larger of the bytes moved over 3.35 TB/s and the
              active (row, tree, split) adds over 33.5 T adds/s (the
              float32 add rate used for the vote).  No single PyTorch call computes the histogram
              (building the flattened index is part of the work), so
              library_ms is null
 11. b3       the int8 vote kernel against its plain PyTorch version on the
              card: random int8 forests (thresholds and values with the
              -128 / 127 sentinels, pad paths q_lo = 127, codes of -1 and
              >= C) at the published shape (table and scan form) and the
              wide one (scan form, predicates from global memory), n = 1, 7,
              513 and 1,000,000 (262,144 at the wide shape), min_odds 1.0
              and 1.5; the votes must be EXACTLY equal
 12. b4       the bin-counts kernel against its plain PyTorch version: the
              rafo baseline (R=5, B=7), the default 32-bin shape (R=33,
              B=33) and a wide one whose per-warp accumulators do not fit
              in 48 KB (R=64, B=256: one block-wide accumulator in 64 KB of
              dynamic shared memory), codes in [-2, B+2), n = 1, 7,
              1000 and 1,000,000, mask None and partial; the float32
              counts must be EXACTLY equal
 13. sidecars the sidecar main path, launch counts zeroed before and read
              after: randomForestBuilder with dtb.model.quantize=true and
              dtb.baseline.publish=true over call_hangup_gen(5000, 17) must
              reproduce the rafo9 trees and the rafo9q fixture's meta.json,
              baseline.json and quantized.json bytes, its npz arrays and
              its counters (B2, B3 and B4 must each have launched by then,
              every vote launch in the table form);
              predictionService -Dps.quantized=true over the rafo9 requests
              must reproduce served_quantized.csv.  The ledger must show
              quantized.vote.cuda and baseline.absorb.cuda and no torch or
              host form
 14. b3 times median CUDA-event times of B3 and its plain version on
              the published int8 rafo9 forest over its requests quantized
              and tiled to 1,000,000 rows (table form; the scan form as
              "old", in turns); bound as in phase 6.  No single PyTorch
              call computes it, so library_ms is null (B4's times moved to
              phase 27)
 15. b5       the KNN distance + top-k kernel against its plain PyTorch
              version on the card: seeded rows in the e-learning (Fn=4,
              Fc=0), bench (Fn=2, Fc=7), all-categorical (Fn=0, Fc=10)
              and a wide schema (Fn=16, Fc=64: test rows read from global
              memory), the second half of the train rows duplicating the
              first (ties), both metrics, k = 1, 7, 10, 64 and 100 (above
              the largest register list: the list in global memory), each
              clamped to the train count, at n_test = 1, 513 x n_train
              = 5, 1000, 200,000, each with the planned train split count
              and the count forced to 1, 2 and 7, the tail skip on and off;
              distances and indices must be EXACTLY equal (at 200,000
              train rows against the prefix of the plain version's k = 100
              answer, the k smallest pairs being the first k of the 100
              smallest)
 16. knn      the KNN main path, launch counts zeroed before and read
              after: the port's sameTypeSimilarity + nearestNeighbor CLI
              over the golden knn data must reproduce
              tests/golden/fixtures/knn dist.csv and pred.csv byte for
              byte, and knnPipeline over tests/torch_fixtures/elearn_knn
              (inter- and intra-set, euclidean and manhattan) its four
              outputs and job counters.  B5 must have launched, and the
              ledger must show knn.topk.cuda and no torch or host form
 17. scale    knnPipeline's pairwise_topk at 20,000 test x 200,000 train
              rows drawn with numpy from elearn_gen's model, k = 10: the
              kernel's (d, i) must equal the plain version's on the card;
              B5 and split-merge launches zeroed before two pairwise_topk
              calls and read after: one scan and one split merge a chunk;
              prints the wall time and the layer times (encode, H2D,
              kernel, readback, classify)
 18. b5 times median CUDA-event times of the kernel (its three test-chunk
              scans and split merges, as pairwise_topk makes them; "old":
              one split and no tail skip, in turns; the split merges alone,
              through the stacked entry, the first port's merge as "old")
              and the plain version at that shape, euclidean (the reported
              numbers) and manhattan, and the bound: the larger of the
              bytes moved over 3.35 TB/s and the pair operations every
              implementation needs (Fn FMAs + 4 for euclidean, 3 Fn + 1
              for manhattan, 2 per one-hot word) over 33.5 T/s, beside the
              count with the divide and square root (Fn + 9, 3 Fn + 6).  No
              single PyTorch call computes the floored mixed distance with
              the lexicographic top-k, so library_ms is null; torch.cdist
              + torch.topk on the numeric part is timed as context
 19. b6       the partial-vote kernel (one tree shard's (n, K) float32
              tallies) against member_votes_torch, tallies EXACTLY equal in
              every form each slice selects (phase 3's published shape:
              table and scan; wide: scan), over the
              tree slices of S = 1, 2, 3 and 4 shards (zero-weight pad
              members as the sharded serve makes them), n = 1, 7, 513 and
              1,000,000 (262,144 at the wide shape, its plain tallies from
              one plain first-match pass); then the merge-finalize kernel
              against its plain version on those partials, min_odds 1.0
              and 1.5, and against B2 on the same rows: equal votes
 20. b7       the top-k merge kernel against topk_merge_torch, exactly,
              through the list entry and the stacked (S, nt, k) entry:
              S = 1, 2, 3, 4, 5, 8, 9, 16, 19, 33, 64, k = 1, 7, 10, 64,
              100, nt = 1, 7, 513, 20,000 (and the first port's merge at
              20,000), lists from B5 over shards shorter than k, empty
              shards and rows repeated across shards (ties); then
              topk_scan_sharded over cuda x 2/3/4/8 against single-device
              B5 at phase 15's schemas (n_train 5 and 1000), and at the pad
              probe (10 train rows over 4 shards, k = 2: d [[1, 2]], i
              [[0, 9]]); then the cross-process merge of 130 lists (20,000
              x 10, global indices, ties and dead slots) in rounds of 64
              (3 launches, then 1) against the plain version's stable sort
              of all 130, exactly
 21. sharded  the tree-sharded serving main path, launch counts zeroed
     serve    before and read after: PredictionService over a copy of the
              rafo9 registry and make_predictor over its requests, with
              serve_mesh of 2, 3 and 4 shards (cuda:0 repeated), must
              reproduce served.csv and pred.csv byte for byte; partial
              launches = S x batches, finalize launches = batches, no B2
              launch, serve.shard_merge = serve.predict in the ledger and
              only .cuda forms
 22. sharded  the train-sharded KNN main path, launch counts zeroed before
     knn      and read after: knnPipeline over the elearn_knn fixture
              under a runtime context of cuda:0 x 4 must reproduce its four
              outputs and counters, with at most 4 B5 launches and one
              merge a chunk and only knn.topk.cuda in the ledger; then the
              20,000 x 200,000 top-k over 4 train shards must equal phase
              17's (d, i).  With several GPUs, B6 and the merge-finalize
              (each tree slice on its own card), phases 21-22 and the
              bin-counts kernel at phase 24's layouts (each card's own
              shared-memory opt-in) run again over distinct devices; with
              one, a line says they were skipped
 23. times    median CUDA-event times of the partial-vote kernel (4 tree
              slices of the rafo9 forest over its requests tiled to
              1,000,000 rows; table form, the scan form as "old", in
              turns), the merge-finalize (4 x (1M, 3) tallies)
              and the top-k merge (4 x (20,000, 10) lists; the first port's
              merge as "old", in turns), each beside its
              plain version and its bound (the bytes moved over 3.35 TB/s,
              or the operations over 33.5 T/s, the larger); torch.sort
              over the concatenated lists as context; the sharded
              pairwise_topk wall beside the single-device one.  No single
              PyTorch call computes any of the three: library_ms is null

 24. b4 again the bin-counts kernel against its plain version in both
              forms, counts written (out None) and added into an out carry
              (every other carry above 2^24, where the float32 add
              rounds): phase 12's shapes at n = 1, 7, 64, 256, 1000, 2048,
              4096 (the drift monitor's blocks) and 1,000,000, slices from
              rows 0, 1 and 3 (off any 16-byte boundary), mask None and
              partial; R=8, B=8192 (counts in global memory) at n = 1,
              1000 and 100,000; all codes in one bin (skew); n = 0; two Python
              threads, each on its own stream, accumulating blocks at once
              (the per-(device, stream) workspace and ticket); every case
              EXACT
 25. drift    the drift monitor's main path, launch counts zeroed before
              and read after: driftMonitor and predictDriftScore
              (dm.pipeline.fuse=false) over tests/torch_fixtures/drift9's
              stream against a copy of the rafo9q registry must give the
              fixture's report rows (non-statistic fields equal,
              statistics within rtol 1e-5 / atol 1e-7; the six-decimal
              strings that differ are counted), alert records (value
              within the same tolerance), BadRecords / DriftMonitor /
              PredictDrift counters and predictions (bytes);
              histogram.bin_counts_launches must equal the absorbed blocks
              (the jobs' monitor.absorb dispatches), B2 must have
              launched, the ledger must show monitor.absorb.cuda and no
              torch or host form.  Then PredictionService with a
              ServingMonitor (async_flush=False) serves rafo9's requests:
              its reports must equal an offline StreamDriftMonitor's over
              the same rows and labels, RecordErrors 0
 25f. fused   predictDriftScore with the fuse default (pipeline.flows.
              PredictDriftFlow: B2, the class-row splice and B4 in one
              pipeline.chunk a window), counts and the ProgramCache zeroed
              before and read after: drift9/predict_fused (the JAX
              package's fused job) as in 25, its PredictDrift and
              ProgramCache counters, and the unfused job's bytes on the
              card; B2 = B4 = FusedWindows, KernelBackends exactly
              ensemble.vote.cuda and monitor.absorb.cuda, one a window
 26. scale    a 1,000,000-row drifted replay (numpy draws from
              call_hangup_gen's model; the second half with queue time
              shifted 600 s and the reason mix reweighted) through
              StreamDriftMonitor at 2,048-row windows against the rafo9q
              baseline: one bin-counts launch a window; rows/s and
              windows/s; per window, median ms of encode (host), the B4
              absorb call, the finalize read-back and the two scores (the
              window and its long window in one pass), each synchronised
 26f. fused   the middle 500,000 of those rows (the last quarter of the quiet
              half and the first of the drifted one) as a CSV through
              predictDriftScore,
              fused then unfused (drift9's thresholds, 2,048-row windows),
              counts zeroed around each: report, alerts and predictions
              byte-equal between the forms; fused B2 = B4 = windows, all
              fused; windows/s and ms a window of each job, and the fused
              flow's own median ms a window (run_window, synchronised)
 27. b4 times median CUDA-event call and device times of B4, its first
              port's design as "old" in the same turns, and its plain
              version, with the bound (bytes over 3.35 TB/s or adds over
              33.5 T/s): 1,000,000 rows at (R=5, B=7) over hangup monitor
              codes (the reported numbers), (33, 33) and (64, 256), and
              monitor blocks of 2,048 and 256 rows at (5, 7); an empty
              kernel launch (the yardstick at block size) and
              torch.bincount over a prebuilt flat index (context: the
              index and validity mask are the work), so library_ms is null
 28. stream   the streamed training main path, launch counts zeroed before
              and read after: randomForestBuilder with
              dtb.streaming.ingest=true and the fuse default (one rf-ingest
              pipeline.chunk a block: the branch encode and the baseline's
              B4) (777-row blocks, a checkpoint every
              2 blocks, badrecords.policy=quarantine, both sidecars) over
              tests/torch_fixtures/rafo9s/train.csv (5 malformed records)
              must reproduce the fixture (made by the JAX package's
              streamed job): trees, the registry's meta.json,
              baseline.json and quantized.json bytes and npz arrays (the
              baseline equals the monolithic one), part-q-00000 and the
              Random forest / BadRecords / ProgramCache counters, and the
              Dispatches of the JAX package's fused job plus the port's
              tree.reassign and quantized.vote.  Every B1 launch in the
              mma form; B4 launches equal the ingest blocks (the job's
              pipeline.chunk dispatches, and ceil(rows / 777)); 28u runs
              it again with dtb.pipeline.fuse=false (the ingest.encode and
              baseline.absorb dispatches a block, no ProgramCache); B2 and B3
              launched by the quantize publish; the ledger shows
              forest.level.cuda, baseline.absorb.cuda and no torch, host
              or atomic form, and every block (the quantize sample's too)
              read by the native reader (IngestReaders)
 29. resume   on each reader, the same job in a subprocess with a
              checkpoint every block and AVENIR_TPU_FAULTS set to crash at
              block 3 (chunk_read@3 on the native reader, chunk_encode@3
              on the Python reader; the other point armed too and never
              firing) must fail with the injected fault and leave an
              ingest-incomplete step 3; the job again with --resume on the
              same reader must give the fixture's trees, part-q-00000,
              meta.json and quantized sidecar, and a baseline of the
              re-read rows only (the reference's resume contract)
 30. scale    a 500,000-row CSV (numpy draws from call_hangup_gen's
              model), trained in four subprocesses (started up
              together, each let go alone in turn): streamed at
              262,144-row blocks (iter_csv_chunks -> prefetch_chunks ->
              build_forest_from_stream with a BaselineBuilder) on the
              native reader fused (the default) and unfused
              (fuse=False), on the Python reader, and monolithic
              (load_csv, native -> build_forest); trees and baseline
              counts identical, every B1 launch in the mma form, B4
              launches equal the blocks, and the ledger's IngestReaders
              show every block read by the reader asked for; prints each
              stream's parse_s, transfer_s, stage_wait_s, queue_wait_s,
              ingest_compute_s, ingest_wall_s and build_s, rows/s of all
              three and each child's host memory: the job's peak RSS
              (VmRSS sampled every 5 ms after a warm-up), its own
              ru_maxrss and RUSAGE_CHILDREN after it
 31. shard    the shard lane, each process a subprocess on the card with
     lane     its launch counts zeroed before its job and read after:
              randomForestBuilder with the rafo9s keys under
              AVENIR_TPU_SHARD=0/2 and 1/2 and one file transport
              (AVENIR_TPU_ALLREDUCE_DIR) must write the fixture's trees on
              both shards and, from shard 0, its registry version (JSON
              bytes, npz arrays); the two quarantine files concatenate to
              its part-q-00000 and the BadRecords counters sum to its; B1
              all mma on both, B4 3 + 4 launches (the shards' blocks), B2
              and B3 from shard 0's publish only; prints
              Collectives.AllReduces a process
 32. resume   on each reader, the same lane with a checkpoint every
              block and shard 1 crashing at its third block (chunk_read@2
              native, chunk_encode@2 Python): shard 0 must fail at its
              next collective within AVENIR_TPU_ALLREDUCE_TIMEOUT_S=5;
              --resume on both must give the fixture's trees, read by the
              same reader (the two readers' lanes side by side; the four
              resumes start up with the crashes and wait at a gate)
 33. scale    phase 30's 500,000-row CSV over two --shard-child
              processes (row-range shards, 262,144-row blocks, a teed
              baseline, the file transport), on the native reader, then
              on the Python reader (all four processes started together,
              each pair let go alone): trees and baseline counts
              identical to phase 30's streamed process; B1 all mma, B4
              launches sum to the 2 blocks, every block read by the
              reader asked for; prints rows/s against phase 30's on the
              same reader, each shard's parse_s and the all-reduce wall
              a level
 34. knn      knnPipeline nen.train.shard=true over 20,000 test x 200,000
              train e-learning rows (numpy draws from elearn_gen's model),
              k = 10, in two shard-lane processes: predictions byte-equal
              to the single-process job's (run in the main process); B5
              and B7's merge one launch a test chunk in each process
 35. joined   two torch.distributed ranks (gloo, torchrun's environment,
              one card), one --joined-child process a rank running two
              joined jobs in turn: the streamed rafo9s build gives the
              fixture's trees on both ranks and its meta.json, B1 all
              mma; then modelPredictor over two halves of the rafo9
              requests writes part-m-00000 and part-m-00001, which
              concatenate to pred.csv
 36. cards    with several GPUs visible, phases 31 and 35 again with each
              process on its own card (with one, a line says so)
 38-41        the joined run over per-process inputs, each process a
              --joined-child on the card running its jobs in order with
              the launch counts zeroed before each job and read after:
              one child runs one process's jobs, then two gloo ranks
              (torchrun's environment, one card; started up with it and
              held at a gate) run theirs; no rank may leave a gather
              spool in its TMPDIR
 38. joined   phase 30's CSV split 250,000 + 250,000 and 300,000 +
     mono     200,000 rows, randomForestBuilder monolithic with the rafo
              keys (withReplace), a published baseline and the int8
              sidecar, then dtb.streaming.shard=off over the halves at
              262,144-row blocks: every rank writes the trees of one
              process's job on the whole CSV (which are phase 30's), and
              rank 0's registry version is that job's (meta.json and
              baseline.json bytes; arrays, baseline and quantized npz
              arrays; quantized.json holds the mismatch on rank 0's rows);
              B1 all mma with launches = levels (the count all-reduces)
              on each rank, B4 1 a rank (2 streamed), B2 and B3 on rank 0
              only; prints rows/s against the one-process job, each
              rank's load_s and build_s and the all-reduce ms a level
 39. joined   four levels of the detr.sh rotation over the first 100,000
     dt       rows split in halves: every rank writes one process's
              decision paths at every level, the ranks' record parts
              concatenate to its part file, B1 one mma launch a level a
              rank
 40. joined   sameTypeSimilarity, nearestNeighbor and
     gather   groupedRecordSimilarity over distinct per-rank inputs
              (elearn rows, the golden knn distance lines split in two):
              every rank's output equals one process's job over a
              directory laid out as the spool (<basename>.p<rank>); then
              both ranks given one identical input: no spool, the same
              output
 41. joined   knnPipeline over phase 34's 20,000 test x 200,000 train rows
     knn      split between the ranks as distinct files: the two part
              files concatenate to phase 34's one-process predictions; B5
              one launch a test chunk on each rank
 37. cache    phase 30's CSV through the randomForestBuilder job in one
              --cache-child process, one job after another (streamed,
              262,144-row blocks, a published baseline): cold with
              dtb.streaming.cache.policy=build, then warm with use.  Both
              give phase 30's trees, B1 all mma and B4 one launch a block;
              the cold job reads every block natively and builds the
              sidecar (ColumnarCache Built=1), the warm one serves every
              block from it (Hit=1, BytesRead == the cold BytesWritten,
              IngestReaders all cache); prints both jobs' rows/s.  Then,
              in the same process, phase 30's streamed build over the
              sidecar (stream_cache): the same trees, every block from the
              sidecar; prints its parse_s (the sidecar read) beside
              phase 30's native parse

 42-46        Naive Bayes (no Pallas kernel is on its path: composed torch
              ops, held against the JAX package's committed outputs and
              against the port's own CPU runs); launch counts zeroed
              before phase 42 and read after phase 43
 42. nb       the port's bayesianDistribution and bayesianPredictor CLI on
              the card over telecom_churn_gen(400, 11) must reproduce
              tests/golden/fixtures/nb model.csv and pred.csv byte for
              byte
 43. nb9      the tests/torch_fixtures/nb9 jobs through the port's CLI on
              the card (nb9_flow): the model with its Gaussian lines, the
              predictor's argmax, cost, prob-diff-threshold and
              feature-prob outputs, the text-mode model and predictions,
              sameTypeSimilarity -> featureCondProbJoiner (its output's
              digest) -> class-conditional nearestNeighbor, knnPipeline
              over the same records and predictionService over a copy of
              the fixture's bayes version, byte for byte with the
              fixture's counters; the port's own publish of the library
              train gives the fixture's meta.json bytes and arrays.  The
              file pipeline's sameTypeSimilarity is the all-pairs
              distance, which launches no kernel; B5 must have launched
              (knnPipeline) and the ledger must show knn.topk.cuda and no
              torch or host form, and bayes.train / bayes.predict
              dispatches
 44. scale    bayes.train over 10,000,000 churn rows (numpy draws from
              telecom_churn_gen's model) on the card: two chunks, the
              4-bit wire (3 H2D bytes a row, which it must be); its model
              lines must equal the port's device="cpu" train of the same
              rows, and so must the train's over a mesh of cuda:0 x 4
              (each chunk's rows in four slices, the JAX package's
              ctx.shard_rows) at the same H2D bytes; prints rows/s and
              the layers (host wire pack, H2D, device counts, D2H, model
              write)
 45. scale    bayesianDistribution and bayesianPredictor (argmax, then the
              feature-prob mode) over a 200,000-row CSV of the same model,
              on the card and with -Dplatform=cpu: model, pred and
              feature-prob files byte-equal (the differing feature-prob
              strings are counted, target 0); prints each job's rows/s and
              the library predict's layers (host pack, table upload,
              scoring, read-back) and train's over the loaded rows
 46. joined   bayesianDistribution over that CSV split in halves and at
     nb       60/40 between two gloo ranks (--joined-child,
              one card): every rank's model equals phase 45's one-process
              model of the whole file; prints each rank's wall, join_s and
              the all-reduce ms


 47-50        serving over the RESP wire, launch counts zeroed before each
              path and read after
 47. wire     predictionService over 15,000 rafo9 records (the fixture's
     serve    requests tiled) from a copy of its registry: in-process, then
              ps.transport=resp with ps.wire.native=on and =off; both
              wire outputs byte-equal to the in-process one, and every
              label equal to modelPredictor's on the same records; prints
              each job's requests/s (wall of push, serve and read back)
              and serve.request p50/p99; ensemble_vote launches = batches
              + the 4 warm-up buckets, every one in the table form
 48. predictq the same records binned on the rafo9q grid as predictq lines
              (wire_encode_rows) through a RespPredictionLoop with
              ps.quantized: replies equal the in-process int8 serve; 3
              malformed lines and 5 lines sent to a model without a
              sidecar answer error and count as BadRequests;
              quantized_vote launches = the int8 batches, no float vote
 49. delta    a RespPredictionLoop on a thread serving 7,500 requests on
              v1 while publish_delta publishes v2 (trees 3 and 7 from
              wire9's v2), then reload and 7,500 more: DeltaSwaps 1, every
              reply after it equals a full load of v2 (and some differ
              from v1's), the H2D bytes moved printed, every vote launch
              after the patch in the table form; then the same reload
              onto a tree-sharded core (every visible card, or cuda:0
              twice): answers equal, B6 + merge-finalize after it
 50. durable  ps.broker.durable=commit with 5 s leases: 10,000 requests, a
              loop that acks 20 batches and dies holding a leased batch,
              the broker killed and restarted on its journal, a new loop:
              one reply a request, equal to the in-process serve; then
              driftMonitor dm.source=resp over drift9's stream pushed to
              a RespServer: report and alert bytes equal dm.source=file's,
              bin_counts launches = the windows


 51-55        the serving fleet, launch counts zeroed before each path and
              read after
 51. fleet    the fleet9 fixture's cases a (2 workers, 2 broker shards), e
              (2 workers, ps.quantized) and f (2 workers, queue depth 4)
              through predictionService on the card: a and e byte-equal
              with their counters, f answers every id (its class or busy);
              the same jobs over the 300 well-formed records: launches =
              the workers' batches + 4 warm-ups a worker, all table form
              (B3 for e, no B2)
 52. loop     10,000 rafo9 requests prefilled, drained by 1, 2 and 4
              workers over 1 and 2 broker shards, and by 2 workers on
              the default stream: requests/s, serve.batch p50/p99,
              OverlappedBatches, batches a worker, B2 launches = batches +
              warm-ups; replies equal the in-process serve
 53. router   fleet9 cases b-d byte-equal with their counters; a 2-worker
              fleet with device_map=sharded over the card twice: B6
              partial = 2 x batches, merge-finalize = batches, no B2
 54. swap     2 workers; the pin cleared (v2, a delta) and a wire reload
              under load: every id answered once, every worker on v2 by
              the patch (DeltaH2DBytes a worker), launches after it all
              table form; mark_degraded on one worker: its /healthz/<name>
              503 on a live MetricsServer, the peer serves the next load
 55. hosts    predictionService ps.autoscale=true, max 3 workers, with the
              Autoscaler counters; two fleet_host processes over 2 shards
              building nothing, /metrics scraped mid-run with host0's
              avenir_serving series, their served counts summing to the
              requests


 56-59        the retrain loop and logistic regression, launch counts
              zeroed before each phase and read after
 56. retrain9 the retrain9 fixture's retrainController cases a (forced),
              b (alerts.jsonl), c (probation replay, rolled back) and d
              (killed at registry_publish@2, resumed) through the port's
              CLI on the card: every kept file equal to the fixture's
              outside the journal's opened_unix and the pin's
              pinned_unix; per case every B1 launch in the mma form, B4 =
              the baseline's blocks + the 2 drift re-scores, B2 >= 2
 57. retrain  one cycle at the rafo forest's widths (9 trees): champion
     scale    phase 30's 1,000,000-row model with its baseline, a
              500,000-row drifted window drawn like phase 26's, a
              2-worker fleet answering live requests throughout; the
              seconds of the build, validate, publish and swap stages, the
              requests answered during the swap (every request answered,
              none error or busy), the fleet converged on v2 by a delta
              (DeltaSwaps 1 a worker) of at most the changed trees
 58. drill    the same cycle killed at registry_publish@2 and resumed:
              exactly one new version, PublishDeduped 1, phase 57's
              candidate
 59. logistic lr9 on the card: the coefficient history within 1e-5 of
              the JAX package's fixture (per line, relative to its
              largest coefficient), predictor labels equal, the served
              lines byte-equal; then logisticRegression (10 iterations)
              and logisticRegressionPredictor over a 500,000-row churn
              CSV: ms an iteration and rows/s, the card's history within
              1e-4 of the CPU's over the same rows

 60-66        the threefry twin of jax.random and its consumers; the
              threefry count is zeroed before each of 61-66 (their main
              paths, launched through the port's CLI and entry points)
              and read after, and each must have launched the kernel
 60. threefry the threefry2x32 kernel (csrc/threefry.cu) bit-equal to its
              plain version over 2^24 explicit and flat-index counters
              under three keys, both output modes; every threefry9 case
              (jax.random's draws, made on the CPU) reproduced on the
              card; random_bits and normal over 2^24 values: call and
              device ms, the plain version's, the bound (the larger of 4
              bytes written a value over 3.35 TB/s and the 41 operations
              a value that only the integer ALU pipe issues, 20 rotates
              and 21 xors, at its 64 lanes a clock an SM, 16.75 T/s)
 61. mlp      mlp9 on the card: init_params and the first permutations
              bit-equal, 5 batch iterations and the short incr and
              minibatch runs (3 epochs over 48 and 120 rows) within 1e-4
              of the JAX package's, cases a-c on the
              JAX package's grid (model strings apart counted: the
              1,000-iteration descent is chaotic), d (resumed) == a,
              neuralNetworkPredictor over the JAX models (labels equal
              wherever the top two logits are 1e-4 apart), the mlp
              version's served lines byte-equal; neuralNetwork over
              500,000 churn rows (batch, 300 iterations) and its
              predictor, ms an iteration and rows/s, the card's weights
              after 50 iterations against the CPU's; one minibatch epoch
              (batch 64) over 250,000 rows and one incr epoch over 5,000
              rows, ms a step
 62. optimize golden sa and every opt9 case byte-equal (lines and
              counters; the two 2-process cases over two gloo ranks on
              the card); SA with 8,192 chains over a 64 x 32
              task_sched_gen domain, 500 iterations + 100 of local
              descent: chain-steps/s and threefry launches a step; the
              same at 20 iterations byte-equal to the port's CPU run; GA
              64 islands x 256, 120 generations
 63. bandits  golden bandit and price, every mab9 round and the mab9
              VectorBandits selections byte-equal; VectorBandits at
              50,000 groups x 4 actions, every algorithm, 3 calls,
              each call's selections equal to the port's CPU twin's;
              selections/s
 64. online9  every online9 case (ucb1, softMax, sampsonSampler, the
              logistic and MLP heads, the supervised wire run with a
              rollback, its resume after a kill at online_snapshot, an
              evicting pending table) through onlineLearner on the card:
              replies, counters, journals and every registry snapshot
              byte-equal to the JAX fixture (the pin's clock aside); the
              MLP head's parameters within 1e-5, its differing labels
              counted
 65. online   an ad server's stream (8,000 predicts x 32 features, 8
              arms, 80% rewarded 1-3 windows late, 1% orphans) in windows
              of 256 through the plane on the card: ucb1/bandit,
              softMax/logistic, and sampsonSampler/MLP (hidden 64) over
              the RESP wire with a supervisor snapshotting every 32
              windows; windows/s, requests/s, ms a window (parse, join,
              upload, device, read-back), threefry launches a window, each
              run alone on the card (in this process, after phase 64; only
              the CPU reference's child shares the host); the first run's
              replies byte-equal to the CPU port's (that child)
 66. samplers MetropolisSampler with 1,000,000 chains x 100 transitions
              and weighted_indices with 1,000,000 draws over 1,000
              weights on the card, bit-equal to the CPU port on the first
              65,536 chains and 20,000 draws; seconds and threefry
              launches a transition
 67. sequence the golden markov, conv, buyhist, sup, visit and apriori
              flows (tests/golden/flows.py's generator calls and keys) and
              every seq9 case (tests/torch_fixtures/seq9: PST, GSP,
              positional clusters, sequenceGenerator, CTMC stats, event
              time, HMM and Viterbi with unknown symbols and ties, the
              classifier at padded lengths 33-64, Apriori levels 1-3, the
              infrequent-item marker, wordCounter, temporalFilter,
              ruleEvaluator) through the port's CLI on the card, byte for
              byte (seq9's counters too); each job's wall; no kernel
              launch (counts zeroed before, read after)
 68. seq scale the Markov model and classifier over 125,000 event
              sequences, the HMM over 10,000 tagged and Viterbi over
              50,000 plain loyalty sequences, Apriori levels 1-3 over
              250,000 transactions and the event-time histogram over
              500,000 visits of 2,000 users (drawn vectorised from the
              generators' models), each job on the card (its registered
              function with a LayerProfile: parse, encode, h2d, device,
              readback, write) and in a child with -Dplatform=cpu, the
              children started as their inputs are drawn and waited for
              before the card's runs, which are timed alone: every
              output byte-equal; sequences/s, transactions/s a level,
              events/s
 69. tail9    the golden carm, disease, hica, mi and svm flows and every
              tail9 case (tests/torch_fixtures/tail9) through the port's
              CLI on the card: byte for byte, save the five cases the
              maker holds to a tolerance (its ``compare``; their
              differing lines counted); the card's batched SVM model
              predicts the fixture's predictions; no kernel launch
 70. tail scale kmeansCluster over 1,000,000 cust_seg customers (3
              groups), mutualInformation and numericalCorrelation over
              1,000,000 hosp_readmit rows, the batched SVM over 100 groups
              of 1,000 churn_svm rows at C = 0.001 and over 100 groups of
              100 at svm.properties' C = 1.0 (to its step cap), SMOTE over
              10,000 minority rows of 125,000 machine_failure rows; five
              ``--tail-cpu-child`` processes (one a group) draw the inputs
              and run the jobs
              with -Dplatform=cpu, started before phase 63 and waited for
              before the card's runs (the registered functions with a
              LayerProfile): every output byte-equal; rows/s and layers
 71. profile  the device profile capture: rafo9's randomForestBuilder and
              modelPredictor through cli.run with -Dprofile.trace.dir
              (launch counts zeroed before each, read after) and
              untraced: byte-equal outputs, exactly one Chrome trace a
              job that loads with traceEvents, whose kernel events of
              level_counts_mma_kernel (B1) and vote_kernel (B2) equal the
              wrappers' counts; then phase 30's CSV trained monolithic
              untraced, under the capture (byte-equal) and untraced
              again: the card's busy share (the union of the trace's
              kernel, memcpy and memset intervals) over the traced job
              step and over the untraced ones (Profiling/job.timeMs),
              and its top five kernels by total time.  The profiler's
              first start in the process (CUPTI's set-up, ~10-15 s)
              falls in the first traced job's call, outside its job
              step; every capture starts within seconds of it

The line before the last is one JSON object with the kernel numbers (the
votes' and B1's ``form``, B5's planned ``splits`` a chunk, each redesigned
kernel's ``old_ms`` and ``old_device_ms``, B1's root and bench device
times, B4's 2,048-row block and empty-launch times, and each kernel's
launches a process on the multi-process paths: ``joined_mono_*``,
``joined_unequal_*``, ``joined_stream_off_*``, ``joined_dt_*`` and
``joined_knn_*`` are phases 38-41's, one entry a rank; B5's
``nb_pipeline_launches`` is phase 43's; B2's ``wire_*`` and ``delta_*``,
B3's ``predictq_*`` and B4's ``drift_resp_*`` are phases 47-50's) and,
under ``bayes``, phases 42-46's launch counts, rows/s and layer times,
under ``wire`` phases 47-50's rates and counts, and under ``fleet`` phases
51-55's (B2's, B3's and B6's ``fleet_*`` launches are theirs too),
under ``retrain`` phases 56-58's (B1's, B2's and B4's ``retrain*``
launches are theirs too), under ``logistic`` phase 59's, under ``mlp``,
``optimize`` and ``bandits`` phases 61-63's, under ``online`` phases
64-66's (the ``threefry2x32`` entry's launches are those of 61-66), under
``sequence`` phases 67-68's and under ``long_tail`` phases 69-70's (job
walls, rates, layers, launch counts: 0), under ``profile`` phase 71's
(launches, trace kernel counts, busy shares, top kernels), and under
``phase_seconds`` each phase's wall seconds; the last line is
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --trace-probe`` measures instead whether the
capture keeps every kernel launch as a process ages: eight processes on
the first card, each (some after an early warm-up capture) training rafo9
untraced until its age, then six traced jobs, train and predict in turn;
one JSON line a capture (B1 and B2 counts from the wrappers and from the
trace, each B1 launch's host time and traced kernel start) on standard
output and in ``chiprun_out/trace_probe.jsonl``.
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
RES = os.path.join(ROOT, "resource")
RF_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "rf")
DT_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "dt")
RAFO9 = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9")
RAFO9Q = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9q")
RAFO9S = os.path.join(ROOT, "tests", "torch_fixtures", "rafo9s")
# the rafo9s fixture's job keys (tests/torch_fixtures/rafo9s/make.py)
STREAM_BLOCK_ROWS = 777
STREAM_KEYS = ("-Ddtb.streaming.ingest=true",
               f"-Ddtb.streaming.block.rows={STREAM_BLOCK_ROWS}",
               "-Ddtb.streaming.checkpoint.blocks=2",
               "-Dbadrecords.policy=quarantine",
               "-Ddtb.model.quantize=true", "-Ddtb.baseline.publish=true")
STREAM_SCALE_ROWS = 500_000
STREAM_SCALE_BLOCK = 262_144

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
# H100 SXM float32 outside the tensor cores is 67 TFLOP/s counting a fused
# multiply-add as two operations; a compare is one instruction, issued at
# most at the FMA instruction rate
TESTS_PER_S = 67e12 / 2
RAFO_SHAPE = (9, 17, 4, 4, 3)    # T, P, F, C, K
WIDE_SHAPE = (64, 257, 16, 16, 8)
ROW_COUNTS = (1, 7, 513, 1_000_000)
# the wide shape's largest check (its scan is ~100x the published one's)
WIDE_BIG_ROWS = 262_144


def row_counts(shape):
    """ROW_COUNTS for ``shape``; the wide shape's largest is
    WIDE_BIG_ROWS."""
    return ROW_COUNTS if shape != WIDE_SHAPE else \
        ROW_COUNTS[:-1] + (WIDE_BIG_ROWS,)
# level-histogram shapes (T, N, S, B, C) and the row counts each is held
# at against its plain version
B1_SHAPES = {"rafo": (9, 8, 19, 2, 2), "rafo_root": (9, 1, 19, 2, 2),
             "bench": (16, 8, 19, 2, 2), "wide": (64, 128, 64, 4, 4)}
B1_BIG_ROWS = {"rafo": 1_000_000, "rafo_root": 1_000_000,
               "bench": 8_000_000, "wide": 262_144}
# bin-counts shapes (R, B) held against the plain version
B4_SHAPES = {"rafo": (5, 7), "default": (33, 33), "wide": (64, 256)}
B4_ROWS = (1, 7, 1000, 1_000_000)
# the drift monitor's absorbed block sizes (its buckets' edges), and a
# shape whose counts fit no shared memory (65,536 cells)
B4_BLOCK_ROWS = (64, 256, 2048, 4096)
B4_GLOBAL_SHAPE = (8, 8192)
DRIFT9 = os.path.join(ROOT, "tests", "torch_fixtures", "drift9")
DRIFT_SCALE_ROWS = 1_000_000
# phase 26f's rows: the middle of phase 26's replay, quiet then drifted
DRIFT_FUSED_ROWS = (250_000, 750_000)
DRIFT_WINDOW_ROWS = 2048
KNN_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "knn")
ELEARN_KNN = os.path.join(ROOT, "tests", "torch_fixtures", "elearn_knn")
# B5 schemas: numeric width Fn and categorical cardinalities (one-hot width
# Fc = their sum); the wide one's rows exceed the kernel's register path
B5_SCHEMAS = {"elearn": (4, ()), "bench": (2, (3, 4)),
              "allcat": (0, (3, 5, 2)), "wide": (16, (16, 16, 16, 16))}
B5_KS = (1, 7, 10, 64, 100)
B5_TEST_ROWS = (1, 513)
B5_TRAIN_ROWS = (5, 1000, 200_000)
KNN_SCALE = (20_000, 200_000, 10)         # test rows, train rows, k
# list counts the top-k merge is held at (lane groups of 1 to 32 lanes, and
# two lists a lane past 32)
MERGE_LISTS = (1, 2, 3, 4, 5, 8, 9, 16, 19, 33, 64)
# lists of the cross-process merge past one launch's 64 (two full rounds
# and a short one, then the final merge)
ROUND_LISTS = 130
# phase 19 runs the plain partial tallies slice by slice up to this many
# (row, predicate slot) pairs, and from one shared first-match pass above
B6_DIRECT_PAIRS = 1e10
# call_hangup_gen's generative model (resource/gen/call_hangup_gen.py)
REASON_P = (0.35, 0.2, 0.25, 0.2)
PATIENCE = (500.0, 900.0, 420.0, 380.0)
NB_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "nb")
NB9 = os.path.join(ROOT, "tests", "torch_fixtures", "nb9")
WIRE9 = os.path.join(ROOT, "tests", "torch_fixtures", "wire9")
# phases 47-50: records served over the wire, the delta reload's rows before
# and after the patch, the changed trees (from wire9's v2), and the durable
# drill's records and acked batches before the kill
WIRE_ROWS = 15_000
DELTA_ROWS = 7_500
DELTA_TREES = (3, 7)
DURABLE_ROWS = 10_000
DURABLE_ACKED_POLLS = 20
FLEET9 = os.path.join(ROOT, "tests", "torch_fixtures", "fleet9")
# phases 51-55: the fleet loop's requests (phase 52), its worker counts and
# broker shard counts, the hot-swap drill's requests a step (phase 54), and
# the autoscaled job's and the fleet_host processes' requests (phase 55)
FLEET_ROWS = 30_000
# phase 52 drains the first FLEET_LOOP_ROWS of them (54-55 use the rest)
FLEET_LOOP_ROWS = 10_000
FLEET_WORKERS = (1, 2, 4)
FLEET_SHARDS = (1, 2)
SWAP_ROWS = 10_000
HOST_ROWS = 20_000
NB_TRAIN_ROWS = 10_000_000     # the library train: two chunks
NB_CLI_ROWS = 200_000
# telecom_churn_gen's generative model (resource/gen/telecom_churn_gen.py)
CHURN_PLAN_P = (0.25, 0.4, 0.2, 0.15)
CHURN_USAGE = ((250, 1200), (600, 3000), (900, 5000), (1300, 7000))
CHURN_PAY_P = (0.2, 0.4, 0.4)


# every process a Children started, for fail() to stop
_CHILD_PROCS = []


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    for p in _CHILD_PROCS:             # gated children still waiting
        if p.poll() is None:
            p.kill()
    sys.exit(1)


def _try(fn):
    """``[]`` when ``fn()`` returns, else ``[the exception]``."""
    try:
        fn()
    except Exception as exc:
        return [exc]
    return []


# phase label -> wall seconds, in the order the phases ran
PHASE_SECONDS = {}
_PHASE_OPEN = []


def phase(name=None):
    """Close the running phase (printing its wall seconds) and open
    ``name``; ``phase()`` only closes."""
    now = time.perf_counter()
    if _PHASE_OPEN:
        label, t0 = _PHASE_OPEN.pop()
        PHASE_SECONDS[label] = round(now - t0, 1)
        print(f"-- {label}: {now - t0:.1f} s", flush=True)
    if name is not None:
        print(f"== {name}", flush=True)
        _PHASE_OPEN.append((name.split(" ", 1)[0], now))


def random_forest_inputs(rng, shape, n):
    """A random stacked forest in EnsembleModel.stacked_host's layout plus
    n request rows.  Each tree has some real paths, the always-match
    sentinel and never-match pad paths; about 1.5 features a path are
    restricted so that real paths do match."""
    T, P, F, C, K = shape
    p_restrict = min(1.0, 1.5 / F)
    lo = rng.integers(-6, 6, (T, P, F)).astype(np.float32)
    hi = lo + rng.integers(0, 8, (T, P, F)).astype(np.float32)
    lo[rng.random((T, P, F)) < 0.1] = -np.inf
    hi[rng.random((T, P, F)) < 0.1] = np.inf
    num_r = rng.random((T, P, F)) < p_restrict
    cat_m = rng.random((T, P, F, C)) < 0.6
    cat_r = rng.random((T, P, F)) < p_restrict
    cls_oh = np.zeros((T, P, K), np.float32)
    cls_oh[np.arange(T)[:, None], np.arange(P)[None, :],
           rng.integers(0, K, (T, P))] = 1.0
    for t in range(T):
        real = int(rng.integers(1, P))          # sentinel at index `real`
        lo[t, real], hi[t, real] = -np.inf, np.inf
        num_r[t, real] = cat_r[t, real] = False
        lo[t, real + 1:], hi[t, real + 1:] = np.inf, -np.inf
        num_r[t, real + 1:], cat_r[t, real + 1:] = True, False
        cls_oh[t, real + 1:] = 0.0
    wvec = rng.integers(-3, 6, T).astype(np.float32)
    vals = rng.integers(-8, 14, (n, F)).astype(np.float32)
    vals[rng.random((n, F)) < 0.05] = np.nan
    codes = rng.integers(-2, C + 3, (n, F)).astype(np.int32)
    return (lo, hi, num_r, cat_m, cat_r, cls_oh, wvec), vals, codes


def random_quantized_inputs(rng, shape, n):
    """A random int8 forest in QuantizedForest's layout and n int8 request
    rows: random_forest_inputs' forest with its thresholds on the int8 grid
    (-inf -> -128, +inf -> 127, so pad paths get q_lo = 127), values with
    the -128 (NaN) and 127 (+inf) sentinels, codes of -1 and >= C."""
    (lo, hi, num_r, cat_m, cat_r, cls_oh, wvec), vals, codes = \
        random_forest_inputs(rng, shape, n)

    def grid(a):
        return np.where(np.isneginf(a), -128,
                        np.where(np.isposinf(a), 127, a)).astype(np.int8)
    qv = np.where(np.isnan(vals), -128, vals).astype(np.int8)
    qv[rng.random(qv.shape) < 0.03] = 127
    qc = np.clip(codes, -1, 127).astype(np.int8)
    return (grid(lo), grid(hi), num_r, cat_m, cat_r,
            cls_oh.astype(np.uint8), wvec), qv, qc


def scan_form(model):
    """The same prepared forest without its path-mask tables: the kernel
    runs its path scan (the design before the tables) on it."""
    return dataclasses.replace(model, u=None, ntab=None, ctab=None)


def vote_forms(model, want):
    """[(form, model)] of every vote form the kernel can run on ``model``:
    the form its shape selects, which must be ``want``, and, where that is
    the table form, the path scan on the same forest."""
    from avenir_tpu_torch.kernels import vote
    got = vote.vote_form(model)
    if got != want:
        fail(f"vote form of a {model.shape} (T,P,F,C,K) forest is {got!r}, "
             f"expected {want!r}")
    return [("table", model), ("scan", scan_form(model))] \
        if got == "table" else [("scan", model)]


def cuda_ms(fn, reps, warm=True):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs
    (after one warm-up run, unless ``warm`` is False: a call of seconds
    whose operations earlier phases already ran)."""
    import torch
    if warm:
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
    return float(np.median(times))


def device_ms(fn, reps=20):
    """Median ms of one ``fn()`` on the card alone: ``reps`` calls enqueued
    behind a spin kernel (``torch.cuda._sleep``, longer than the host takes
    to enqueue them), so the card runs them back to back and the wrapper's
    host work (checks, allocations, the ctypes call) falls outside the
    event window that ``cuda_ms`` measures; median of 5 such windows."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(40_000_000)          # ~20 ms at 1.98 GHz
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def predicate_tests(v, c, model):
    """Predicate tests the kernel's scan runs on these rows (csrc/vote.cu):
    in each tree every path up to the first that matches (all P when none
    does); in each such path every slot up to the first that fails; in
    each such slot 2 compares where the numeric flag is set, and 1 test
    where the categorical flag is set and the numeric test passed."""
    import torch
    lo, hi, num_r, cat_m, cat_r = model.stacked()[:5]
    T, P, F, C, _ = model.shape
    by_code = cat_m.permute(2, 3, 0, 1)                  # (F, C, T, P)
    feat = torch.arange(F, device=v.device)
    paths = torch.arange(P, device=v.device)
    num_tests = 2 * num_r.to(torch.int32)
    step = max(1, (1 << 26) // (T * P * F))
    total = 0
    for s in range(0, v.shape[0], step):
        x = v[s:s + step, None, None, :]
        cc = c[s:s + step]
        num_pass = ((x > lo) & (x <= hi)) | ~num_r      # (n, T, P, F)
        mask = by_code[feat[None, :], cc.clamp(0, C - 1).long()]
        cat_pass = (mask.permute(0, 2, 3, 1)
                    & (cc >= 0)[:, None, None, :]) | ~cat_r
        fail = ~(num_pass & cat_pass)
        first_fail = torch.where(fail.any(3), fail.to(torch.uint8).argmax(3),
                                 F)                      # F: path matched
        ran = feat <= first_fail[..., None]
        tests = ((num_tests + (cat_r & num_pass)) * ran).sum(3)  # (n, T, P)
        matched = first_fail == F
        first = torch.where(matched.any(2),
                            matched.to(torch.uint8).argmax(2), P - 1)
        total += int((tests * (paths <= first[..., None])).sum().item())
    return total


def time_vote(model, vals, codes, plain, old=None):
    """Kernel (and, with ``plain``, plain-version) median ms on host arrays
    uploaded to the card, in turns kernel, [old,] plain, kernel[, old] —
    ``old``: the same forest in the scan form, timed as ``old_ms``; and the
    bound: each input read once and the output written once at the HBM
    rate, or the predicate tests this data makes the scan run at the test
    rate — the larger of the two.  The float or the int8 vote, as
    ``model`` is."""
    import torch
    from avenir_tpu_torch.kernels import vote
    dev = model.device
    if model.quantized:
        kernel, plain_fn = vote.quantized_vote, vote.quantized_vote_torch
        vdt, cdt = np.int8, np.int8
    else:
        kernel, plain_fn = vote.ensemble_vote, vote.ensemble_vote_torch
        vdt, cdt = np.float32, np.int32
    v = torch.from_numpy(np.ascontiguousarray(vals, vdt)).to(dev)
    c = torch.from_numpy(np.ascontiguousarray(codes, cdt)).to(dev)
    n, F = v.shape
    res = {"form": vote.vote_form(model),
           "ms": cuda_ms(lambda: kernel(v, c, model, 1.5), 50)}
    if old is not None:
        res["old_form"] = vote.vote_form(old)
        res["old_ms"] = cuda_ms(lambda: kernel(v, c, old, 1.5), 50)
    if plain:
        res["plain_ms"] = cuda_ms(lambda: plain_fn(
            v, c, *model.stacked(), 1.5), 10)
        res["ms_again"] = cuda_ms(lambda: kernel(v, c, model, 1.5), 50)
    if old is not None:
        res["old_ms_again"] = cuda_ms(lambda: kernel(v, c, old, 1.5), 50)
    res["device_ms"] = device_ms(lambda: kernel(v, c, model, 1.5))
    if old is not None:
        res["old_device_ms"] = device_ms(lambda: kernel(v, c, old, 1.5))
    kernel_form = (model.lo, model.hi, model.flags, model.catw, model.cls,
                   model.wvec)
    nbytes = v.nbytes + c.nbytes + n * 4 + sum(t.nbytes for t in kernel_form)
    tests = predicate_tests(v, c, model)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tests_ms = tests / TESTS_PER_S * 1e3
    res.update(bound_ms=max(bytes_ms, tests_ms), bytes=nbytes,
               bytes_ms=bytes_ms, tests=tests, tests_ms=tests_ms,
               bound_by="bytes" if bytes_ms >= tests_ms else "operations")
    return res


def serving_layers(path_lists, fs, requests, dev, reps=30):
    """Where one served batch's time goes, per bucket size: host encode
    (prepare_rows), feature build + H2D + kernel launch up to a synchronize
    (dispatch_prepared), label readback (readback_dispatched) on the host
    clock, and the kernel alone on CUDA events."""
    import torch
    from avenir_tpu_torch.kernels import vote
    from avenir_tpu_torch.models.tree import FeatureCache
    from avenir_tpu_torch.serving.predictor import ForestPredictor
    pred = ForestPredictor(path_lists, fs, device=dev).warm()
    with open(requests) as fh:
        lines = fh.read().splitlines()
    out = {}
    for b in pred.buckets:
        rows = [line.split(",") for line in lines[:b]]
        enc, disp, back = [], [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            prepared = pred.prepare_rows(rows)
            t1 = time.perf_counter()
            staged = pred.dispatch_prepared(prepared)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pred.readback_dispatched(staged)
            t3 = time.perf_counter()
            enc.append(t1 - t0)
            disp.append(t2 - t1)
            back.append(t3 - t2)
        table = prepared[0][0]
        d_vals, d_codes = pred.ensemble.device_inputs(table, FeatureCache())
        kernel = cuda_ms(lambda: vote.ensemble_vote(
            d_vals, d_codes, pred.ensemble._stacked, 1.0), reps)
        out[b] = {k: round(float(np.median(v)) * 1e3, 4) for k, v in
                  (("encode", enc), ("dispatch", disp), ("readback", back))}
        out[b]["kernel"] = round(kernel, 4)
    return out


def level_inputs(rng, shape, n, edges=True):
    """Seeded level-histogram inputs: node ids (n,T) in [0,N) — with
    ``edges``, also -1, -2 and N —, branch codes (n,S) in [0,B) (with
    ``edges`` also -1 and B), classes (n,) in [0,C) (with ``edges`` also -1
    and C), and per-tree bootstrap weights (bincount of 0.9n uniform draws,
    so zero weights occur and a tree's mass is 0.9n < 2^24; with ``edges``
    one (row, tree) pair in 2000 weighs 255)."""
    T, N, S, B, C = shape
    lo = -2 if edges else 0
    hi = N + 1 if edges else N
    nid = rng.integers(lo, hi, (n, T), dtype=np.int32)
    br = rng.integers(-1 if edges else 0, B + 1 if edges else B, (n, S),
                      dtype=np.int32)
    cls = rng.integers(-1 if edges else 0, C + 1 if edges else C, (n,),
                       dtype=np.int32)
    w = np.empty((n, T), np.uint8)
    for t in range(T):
        draws = rng.integers(0, n, int(0.9 * n)) if n > 1 else \
            rng.integers(0, 2, n)
        w[:, t] = np.bincount(draws, minlength=n)[:n]
    if edges:
        w[rng.random((n, T)) < 0.0005] = 255
    return nid, br, cls, w


def b1_bound(nid, br, cls, w, shape):
    """The least time the card could take for one level histogram: each
    input read once and the counts written once at 3.35 TB/s, or the
    active (row, tree, split) adds these inputs need at the float32 add
    rate — the larger of the two."""
    import torch
    T, N, S, B, C = shape
    nbytes = sum(t.nbytes for t in (nid, br, cls, w)) + T * N * S * B * C * 4
    trees = ((nid >= 0) & (nid < N) & (w != 0)).sum(dim=1, dtype=torch.int64)
    splits = ((br >= 0) & (br < B)).sum(dim=1, dtype=torch.int64)
    row_ok = (cls >= 0) & (cls < C)
    adds = int((trees * splits * row_ok).sum().item())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    adds_ms = adds / TESTS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, adds_ms), "bytes": nbytes,
            "bytes_ms": bytes_ms, "adds": adds, "adds_ms": adds_ms,
            "bound_by": "bytes" if bytes_ms >= adds_ms else "operations"}


def time_b1(rng, shape, n, dev):
    """Kernel and plain-version median ms at one level shape, in turns
    new (the form ``level_form`` picks: the mma form for uint8 weights),
    old (the atomic form), plain, new, old, on a level with every row
    active (bootstrap weights, so about 41% of the (row, tree) pairs weigh
    0); each form also on the card alone (``device_ms``)."""
    import torch
    from avenir_tpu_torch.kernels import histogram
    host = level_inputs(rng, shape, n, edges=False)
    nid, br, cls, w = (torch.from_numpy(a).to(dev) for a in host)
    N, B, C = shape[1], shape[3], shape[4]

    def run(form=None):
        return histogram.forest_level_counts(nid, br, cls, w, N, B, C,
                                             form=form)
    res = {"form": histogram.level_form(*shape, w.dtype),
           "ms": cuda_ms(run, 20)}
    res["old_ms"] = cuda_ms(lambda: run("atomic"), 20)
    res["plain_ms"] = cuda_ms(lambda: histogram.forest_level_counts_torch(
        nid, br, cls, w, N, B, C), 5)
    res["ms_again"] = cuda_ms(run, 20)
    res["old_ms_again"] = cuda_ms(lambda: run("atomic"), 20)
    res["device_ms"] = device_ms(run)
    res["old_device_ms"] = device_ms(lambda: run("atomic"))
    if not torch.equal(run(), run("atomic")):
        fail(f"histogram forms differ on the timed inputs at {shape}")
    res.update(b1_bound(nid, br, cls, w, shape))
    return res


def b4_bound(c, B):
    """The least time the card could take for one bin-counts call on the
    (n, R) codes ``c``: the codes read once and the counts written once at
    3.35 TB/s, or one add per valid code at the float32 add rate — the
    larger of the two."""
    n, R = c.shape
    nbytes = c.nbytes + R * B * 4
    adds = int(((c >= 0) & (c < B)).sum().item())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    adds_ms = adds / TESTS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, adds_ms), "bytes": nbytes,
            "bytes_ms": bytes_ms, "adds": adds, "adds_ms": adds_ms,
            "bound_by": "bytes" if bytes_ms >= adds_ms else "operations"}


def time_b4(codes, B, dev):
    """Median ms of the bin-counts kernel (call: cuda_ms; device: the card
    alone, device_ms), the first port's design as "old" in the same turns
    (new, old, plain, new again), the plain version, and b4_bound.  At a
    monitor block's size the yardstick is one launch: callers time
    ``histogram.empty_launch`` beside it."""
    import torch
    from avenir_tpu_torch.kernels import histogram
    c = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(dev)
    reps = 50 if c.shape[0] >= 100_000 else 200
    res = {"ms": cuda_ms(lambda: histogram.bin_counts(c, B), reps)}
    res["old_ms"] = cuda_ms(lambda: histogram.bin_counts(c, B, old=True),
                            reps)
    res["plain_ms"] = cuda_ms(lambda: histogram.bin_counts_torch(c, B), 10)
    res["ms_again"] = cuda_ms(lambda: histogram.bin_counts(c, B), reps)
    res["device_ms"] = device_ms(lambda: histogram.bin_counts(c, B))
    res["old_device_ms"] = device_ms(
        lambda: histogram.bin_counts(c, B, old=True))
    res.update(b4_bound(c, B))
    return res


def hangup_table(rng, n, fs, reason_p=REASON_P, queue_shift=0):
    """n rows in call_hangup.json's schema drawn vectorised from
    call_hangup_gen's model (call-reason mix, exponential queue time,
    Poisson transfers and prior calls, logistic hang-up); a drifted stream
    passes another reason mix and a queue-time shift in seconds."""
    from avenir_tpu_torch.core.table import ColumnarTable
    reason = rng.choice(4, n, p=reason_p)
    queue = np.clip(rng.exponential(420, n) + queue_shift, 0,
                    1800).astype(np.int64)
    transfers = np.clip(rng.poisson(0.7, n), 0, 4)
    prior = np.clip(rng.poisson(1.0, n), 0, 9)
    annoy = queue / np.asarray(PATIENCE)[reason] + 0.5 * transfers \
        + 0.3 * prior
    hung = rng.random(n) < 1.0 / (1.0 + np.exp(-3.5 * (annoy - 1.1)))
    return ColumnarTable(schema=fs, n_rows=n, columns={
        1: reason.astype(np.int32), 2: queue.astype(np.float64),
        3: transfers.astype(np.float64), 4: prior.astype(np.float64),
        5: hung.astype(np.int32)})


def b5_inputs(rng, name, n, dup=False):
    """n seeded rows of B5 schema ``name``: numeric features in [0, 3)
    float32 (the e-learning schema: elearn_gen's model over its ranges) and
    one one-hot block per categorical field, some rows unknown (an empty
    block); with ``dup`` the second half repeats the first (ties)."""
    Fn, cards = B5_SCHEMAS[name]
    if name == "elearn":         # DistanceComputer.encode's ranges
        num = (elearn_columns(rng, n)[:, :4]
               / np.array([1.0, 1.0, 49.0, 20.0])).astype(np.float32)
    else:
        num = (rng.random((n, Fn)) * 3).astype(np.float32)
    oh = np.zeros((n, sum(cards)), np.int8)
    off = 0
    for card in cards:
        code = rng.integers(-1, card, n)
        hit = code >= 0
        oh[np.nonzero(hit)[0], off + code[hit]] = 1
        off += card
    if dup:
        h = n // 2
        num[h:2 * h] = num[:h]
        oh[h:2 * h] = oh[:h]
    return num, oh


def elearn_columns(rng, n):
    """(n, 5) float64 rows of elearn_gen's model, vectorised: video hours,
    quiz score (to elearn_gen's printed precision), forum posts,
    assignments done, and the outcome code (0 fail, 1 pass)."""
    dil = rng.beta(2.2, 2.2, n)
    video = np.round(np.maximum(0.0, rng.normal(18 * dil, 3.0)), 2)
    quiz = np.round(np.clip(rng.normal(35 + 60 * dil, 8.0), 0, 100), 1)
    posts = np.clip(rng.poisson(8 * dil), 0, 49)
    assign = np.clip(rng.binomial(20, 0.3 + 0.65 * dil), 0, 20)
    p_pass = 1.0 / (1.0 + np.exp(-(quiz / 10.0 + assign / 4.0 - 8.5)))
    passed = rng.random(n) < p_pass
    return np.stack([video, quiz, posts, assign, passed], axis=1)


def elearn_table(rng, n, fs):
    """n rows in elearn.json's schema drawn from elearn_gen's model."""
    from avenir_tpu_torch.core.table import ColumnarTable
    cols = elearn_columns(rng, n)
    return ColumnarTable(schema=fs, n_rows=n, columns={
        1: cols[:, 0], 2: cols[:, 1], 3: cols[:, 2], 4: cols[:, 3],
        5: cols[:, 4].astype(np.int32)})


def b5_bound(nt, nr, Fn, Fc, k, metric):
    """The least time the card could take for one top-k scan: the test and
    train rows read once and the (nt, k) results written once at 3.35
    TB/s, or the pair operations every implementation must do at the
    float32 rate — the larger of the two.  Per pair: Fn FMAs and the
    numerator's add, subtract, max and add for euclidean; a subtract,
    absolute value and add per feature and one add for manhattan; an AND
    and a popcount per 32-bit one-hot word.  The divide and square root
    are not counted: a pair that cannot enter the list needs neither.
    ``bound_ms_with_tail`` is the bound that counts them too (Fn + 9 and
    3 Fn + 6 ops a pair)."""
    words = -(-Fc // 32)
    per_pair = (Fn + 4 if metric == "euclidean" else 3 * Fn + 1) + 2 * words
    old_pair = (Fn + 9 if metric == "euclidean" else 3 * Fn + 6) + 2 * words
    ops = float(nt) * nr * per_pair
    nbytes = (nt + nr) * (4 * Fn + Fc) + nt * k * 8
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / TESTS_PER_S * 1e3
    old_ms = float(nt) * nr * old_pair / TESTS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes,
            "bytes_ms": bytes_ms, "ops": ops, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_ms_with_tail": max(bytes_ms, old_ms)}


class python_reader:
    """Within this context every ``core.table.iter_csv_chunks`` call (the
    streamed job's and its quantize sample's) reads with the Python
    reader, ``use_native=False``: the other reader of phases 29-33."""

    def __enter__(self):
        from avenir_tpu_torch.core import table
        self._orig = orig = table.iter_csv_chunks

        def python_chunks(*args, **kw):
            kw["use_native"] = False
            return orig(*args, **kw)
        table.iter_csv_chunks = python_chunks
        return self

    def __exit__(self, *exc):
        from avenir_tpu_torch.core import table
        table.iter_csv_chunks = self._orig


def run_cli(args):
    from avenir_tpu_torch.cli import run as cli_run
    rc = cli_run.main(args)
    if rc != 0:
        fail(f"cli run {args[0]} returned {rc}")


def same_bytes(got, want, what):
    with open(got, "rb") as a, open(want, "rb") as b:
        if a.read() != b.read():
            fail(f"{what}: {got} differs from {want}")
    print(f"{what}: byte-identical to {os.path.relpath(want, ROOT)}",
          flush=True)


def same_arrays(got, want, what):
    """Two .npz files hold the same arrays with the same dtypes (their
    bytes differ: np.savez stamps the write time into each zip entry)."""
    with np.load(got) as a, np.load(want) as b:
        if sorted(a.files) != sorted(b.files):
            fail(f"{what}: arrays {sorted(a.files)} != {sorted(b.files)}")
        for k in a.files:
            if a[k].dtype != b[k].dtype or a[k].shape != b[k].shape or \
                    not np.array_equal(a[k], b[k], equal_nan=True):
                fail(f"{what}: array {k!r} of {got} differs from {want}")
    print(f"{what}: arrays equal to {os.path.relpath(want, ROOT)}",
          flush=True)


def knn_phases(dev, rng):
    """Phases 15-18: B5 against its plain version, the KNN main path, the
    20k x 200k scale run and B5's times.  Returns (max_abs_err, launches on
    the main path, {metric: times})."""
    import torch
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    if RES not in sys.path:
        sys.path.insert(0, RES)

    phase("15 B5 top-k kernel vs plain version")
    from avenir_tpu_torch.kernels import topk
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b5_err = 0.0
    for name, (Fn, cards) in B5_SCHEMAS.items():
        n_cat = float(len(cards))
        denom = float(max(Fn + len(cards), 1))
        for n_train in B5_TRAIN_ROWS:
            rn, roh = (torch.from_numpy(a).to(dev) for a in
                       b5_inputs(rng, name, n_train, dup=True))
            for n_test in B5_TEST_ROWS:
                tn, toh = (torch.from_numpy(a).to(dev) for a in
                           b5_inputs(rng, name, n_test))
                ks = sorted({min(k, n_train) for k in B5_KS})
                for metric in ("euclidean", "manhattan"):
                    big = n_train > 1000
                    if big:
                        want_all = topk.topk_scan_torch(
                            tn, toh, rn, roh, ks[-1], metric, n_cat, denom,
                            1000.0)
                    for k in ks:
                        want = tuple(w[:, :k] for w in want_all) if big \
                            else topk.topk_scan_torch(
                                tn, toh, rn, roh, k, metric, n_cat, denom,
                                1000.0)
                        # the planned split count, forced counts and the
                        # tail skip on and off: one answer
                        for splits in (None, 1, 2, 7):
                            for skip in (True, False):
                                got = topk.topk_scan(
                                    tn, toh, rn, roh, k, metric, n_cat,
                                    denom, 1000.0, splits=splits, skip=skip)
                                torch.cuda.synchronize()
                                if got[0].shape != (n_test, k) or \
                                        got[1].dtype != torch.int32:
                                    fail(f"topk output {tuple(got[0].shape)}"
                                         f" {got[1].dtype}")
                                err = float((got[0] - want[0]).abs().max()
                                            .item())
                                b5_err = max(b5_err, err)
                                if not (torch.equal(got[0], want[0])
                                        and torch.equal(got[1], want[1])):
                                    fail(
                                        f"topk kernel != plain version at "
                                        f"{name} {metric} n_test={n_test} "
                                        f"n_train={n_train} k={k} "
                                        f"splits={splits} skip={skip}: "
                                        f"{int((got[0] != want[0]).sum())} "
                                        f"distances and "
                                        f"{int((got[1] != want[1]).sum())} "
                                        f"indices differ")
                plans = [len(topk.split_ranges(n_test, n_train, k, sms))
                         for k in ks]
                print(f"{name} (Fn={Fn}, Fc={sum(cards)}) n_test={n_test} "
                      f"n_train={n_train} k={ks}: exact for both metrics at "
                      f"splits planned {plans}, 1, 2, 7, skip on and off "
                      f"(register rows="
                      f"{topk.register_rows(Fn, sum(cards))}, lists "
                      f"{[topk.list_size(k) or 'global' for k in ks]})",
                      flush=True)
            del rn, roh, tn, toh

    # ---- the KNN main path: counts zeroed just before, read just after ----
    from avenir_tpu_torch.cli.jobs import resolve
    knn_props = os.path.join(RES, "knn.properties")
    elearn_schema = os.path.join(RES, "elearn.json")
    topk.launches = topk.split_merge_launches = 0
    with transfer_ledger() as knn_ledger:
        phase("16 knn main path")
        from gen.elearn_gen import generate as elearn_generate
        knn_data = os.path.join(WORK, "knn_data")
        os.makedirs(knn_data, exist_ok=True)
        rows = elearn_generate(130, 14)
        with open(os.path.join(knn_data, "tr_part"), "w") as fh:
            fh.write("\n".join(rows[:100]))
        with open(os.path.join(knn_data, "test_part"), "w") as fh:
            fh.write("\n".join(rows[100:]))
        run_cli(["org.sifarish.feature.SameTypeSimilarity",
                 f"-Dconf.path={knn_props}",
                 f"-Dsts.same.schema.file.path={elearn_schema}",
                 knn_data, os.path.join(WORK, "knn_dist")])
        same_bytes(os.path.join(WORK, "knn_dist", "part-r-00000"),
                   os.path.join(KNN_GOLDEN, "dist.csv"),
                   "golden knn sameTypeSimilarity")
        run_cli(["org.avenir.knn.NearestNeighbor", f"-Dconf.path={knn_props}",
                 os.path.join(WORK, "knn_dist"),
                 os.path.join(WORK, "knn_pred")])
        same_bytes(os.path.join(WORK, "knn_pred", "part-r-00000"),
                   os.path.join(KNN_GOLDEN, "pred.csv"),
                   "golden knn nearestNeighbor")
        with open(os.path.join(ELEARN_KNN, "counters.json")) as fh:
            knn_counters = json.load(fh)
        fixture_data = os.path.join(ELEARN_KNN, "data")
        knn_wall = {}
        for mode in ("inter", "intra"):
            for metric in ("euclidean", "manhattan"):
                run = f"{mode}_{metric}"
                src = fixture_data if mode == "inter" else \
                    os.path.join(fixture_data, "tr_part")
                out = os.path.join(WORK, f"knn_{run}")
                t0 = time.perf_counter()
                run_cli(["org.avenir.knn.KnnPipeline",
                         f"-Dconf.path={knn_props}",
                         f"-Dsts.same.schema.file.path={elearn_schema}",
                         f"-Dsts.distance.metric={metric}", src, out])
                knn_wall[run] = round(time.perf_counter() - t0, 4)
                same_bytes(os.path.join(out, "part-r-00000"),
                           os.path.join(ELEARN_KNN, f"{run}.csv"),
                           f"elearn_knn knnPipeline {run}")
                with open(out + ".counters.json") as fh:
                    got = json.load(fh)
                got = {g: got[g] for g in knn_counters[run]}
                if got != knn_counters[run]:
                    fail(f"knnPipeline {run} counters {got} != "
                         f"{knn_counters[run]}")
    b5_launches = topk.launches
    knn_backends = knn_ledger.backend_snapshot()
    print(f"knn main path: topk_scan launches={b5_launches}, split merges="
          f"{topk.split_merge_launches} (these train sets are below "
          f"{2 * topk.MIN_SPLIT_ROWS} rows: one split); "
          f"KernelBackends={knn_backends}; knnPipeline wall s {knn_wall}; "
          f"counters equal the fixture's", flush=True)
    if b5_launches <= 0:
        fail("the KNN main path never launched the top-k kernel")
    if not knn_backends.get("knn.topk.cuda"):
        fail("knn ledger shows no knn.topk.cuda")
    wrong = [k for k in knn_backends if k.endswith((".torch", ".host"))]
    if wrong:
        fail(f"ledger shows non-kernel forms on the KNN path: {wrong}")
    if resolve("knnInProcess") is not resolve("org.avenir.knn.KnnPipeline"):
        fail("knnPipeline aliases resolve to different jobs")

    phase("17 scale: knnPipeline top-k at 20,000 x 200,000 rows")
    from avenir_tpu_torch.models.knn import KnnParams, classify_topk
    from avenir_tpu_torch.ops.distance import DistanceComputer
    from avenir_tpu_torch.utils.tracing import fetch
    n_test, n_train, k = KNN_SCALE
    efs = FeatureSchema.load(elearn_schema)
    knn_rng = np.random.default_rng(20261019)
    test_t = elearn_table(knn_rng, n_test, efs)
    train_t = elearn_table(knn_rng, n_train, efs)
    comp = DistanceComputer(efs, metric="euclidean", scale=1000, device=dev)
    torch.cuda.synchronize()
    # launch counts zeroed just before the two calls, read just after
    topk.launches = topk.split_merge_launches = 0
    t0 = time.perf_counter()
    nd, nidx = comp.pairwise_topk(test_t, train_t, k)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nd2, nidx2 = comp.pairwise_topk(test_t, train_t, k)
    warm_s = time.perf_counter() - t0
    scale_launches = (topk.launches, topk.split_merge_launches)
    chunk_rows = [min(8192, n_test - s) for s in range(0, n_test, 8192)]
    splits = [len(topk.split_ranges(r, n_train, k, sms)) for r in chunk_rows]
    want_launches = (2 * len(chunk_rows), 2 * sum(s > 1 for s in splits))
    print(f"pairwise_topk x 2: topk_scan launches={scale_launches[0]}, split "
          f"merges={scale_launches[1]}; planned splits a chunk {splits} "
          f"({sms} SMs)", flush=True)
    if scale_launches != want_launches:
        fail(f"20k x 200k launches {scale_launches} != {want_launches}")
    # the same work layer by layer, synchronised between layers
    layers = {}
    t0 = time.perf_counter()
    tn_h, toh_h = comp.encode(test_t)
    rn_h, roh_h = comp.encode(train_t)
    layers["encode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rn_d, roh_d = (torch.from_numpy(a).to(dev) for a in (rn_h, roh_h))
    chunks = [(torch.from_numpy(tn_h[s:s + 8192]).to(dev),
               torch.from_numpy(toh_h[s:s + 8192]).to(dev))
              for s in range(0, n_test, 8192)]
    torch.cuda.synchronize()
    layers["h2d"] = time.perf_counter() - t0
    consts = (comp._n_cat, comp._denom, comp._fscale)

    def chunked(metric, splits=None, skip=True):
        outs = [topk.topk_scan(tc, oc, rn_d, roh_d, k, metric, *consts,
                               splits=splits, skip=skip)
                for tc, oc in chunks]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    t0 = time.perf_counter()
    kd, ki = chunked("euclidean")
    torch.cuda.synchronize()
    layers["kernel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kd_h, ki_h = fetch(kd).astype(np.int32), fetch(ki)
    layers["readback"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    codes = train_t.class_codes()
    res = classify_topk(kd_h, codes[ki_h], ["fail", "pass"],
                        KnnParams(top_match_count=k))
    layers["classify"] = time.perf_counter() - t0
    tn_d = torch.from_numpy(tn_h).to(dev)
    toh_d = torch.from_numpy(toh_h).to(dev)
    t0 = time.perf_counter()
    pd, pi = topk.topk_scan_torch(tn_d, toh_d, rn_d, roh_d, k, "euclidean",
                                  *consts)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if not (np.array_equal(nd, fetch(pd).astype(np.int32))
            and np.array_equal(nidx, fetch(pi))
            and torch.equal(kd, pd) and torch.equal(ki, pi)
            and np.array_equal(nd, nd2) and np.array_equal(nidx, nidx2)):
        fail("20k x 200k top-k: the kernel's (d, i) differ from the plain "
             "version's")
    if len(res.pred_class) != n_test or not np.isfinite(kd_h).all():
        fail("20k x 200k top-k: bad classify output")
    print(f"{n_test} x {n_train} elearn rows, k={k}: kernel (d, i) equal to "
          f"the plain version's; pairwise_topk wall {cold_s:.4f} s cold "
          f"(train encode + upload), {warm_s:.4f} s warm; plain version "
          f"{plain_s:.3f} s; test rows/s warm {n_test / warm_s:.1f}",
          flush=True)
    print(f"  layer ms: {json.dumps({a: b * 1e3 for a, b in layers.items()})}",
          flush=True)

    phase("18 B5 top-k kernel times")
    # new: the planned splits + merge, skip on; old: one split, skip off
    # (the design before both), in turns new, old, plain, new, old
    b5_t = {}
    for metric in ("euclidean", "manhattan"):
        res_t = {"splits": splits,
                 "ms": cuda_ms(lambda: chunked(metric), 5)}
        res_t["old_ms"] = cuda_ms(lambda: chunked(metric, 1, False), 3)
        res_t["plain_ms"] = cuda_ms(lambda: topk.topk_scan_torch(
            tn_d, toh_d, rn_d, roh_d, k, metric, *consts), 1, warm=False)
        res_t["ms_again"] = cuda_ms(lambda: chunked(metric), 5)
        res_t["old_ms_again"] = cuda_ms(lambda: chunked(metric, 1, False), 3)
        res_t["skip_off_ms"] = cuda_ms(lambda: chunked(metric, None, False),
                                       3)
        res_t["one_split_ms"] = cuda_ms(lambda: chunked(metric, 1, True), 3)
        res_t["one_launch_ms"] = cuda_ms(lambda: topk.topk_scan(
            tn_d, toh_d, rn_d, roh_d, k, metric, *consts), 3)
        # the split merges alone, over the splits' own lists
        # the split merges alone, over the splits' own lists stacked as
        # the scan writes them; new (the warp tournament) and old (the
        # first port's thread-per-row merge), in turns
        merges = []
        for tc, oc in chunks:
            ranges = topk.split_ranges(tc.shape[0], n_train, k, sms)
            lists = [topk.topk_scan(tc, oc, rn_d[a:b], roh_d[a:b], k, metric,
                                    *consts, splits=1) for a, b in ranges]
            merges.append((torch.stack([d for d, _ in lists]),
                           torch.stack([i for _, i in lists]),
                           ranges[0][1]))

        def split_merges(old=False):
            return [topk.topk_merge_stacked(d, i, step, k, old=old)
                    for d, i, step in merges]
        res_t["split_merge_ms"] = cuda_ms(split_merges, 20)
        res_t["split_merge_old_ms"] = cuda_ms(lambda: split_merges(True), 20)
        res_t["split_merge_device_ms"] = device_ms(split_merges)
        res_t["split_merge_old_device_ms"] = device_ms(
            lambda: split_merges(True))
        # their bound: each list read once, each merged list written once
        merge_bytes = sum(d.numel() * 8 + d.shape[1] * k * 8
                          for d, _, _ in merges)
        res_t["split_merge_bytes"] = merge_bytes
        res_t["split_merge_bound_ms"] = merge_bytes / HBM_BYTES_PER_S * 1e3
        res_t["device_ms"] = device_ms(lambda: chunked(metric), 3)
        whole = chunked(metric)
        for old in (False, True):
            merged = split_merges(old)
            if not (torch.equal(torch.cat([m[0] for m in merged]), whole[0])
                    and torch.equal(torch.cat([m[1] for m in merged]),
                                    whole[1])):
                fail(f"{metric}: the split lists merged (old={old}) differ "
                     f"from the scan")
        res_t.update(b5_bound(n_test, n_train, tn_h.shape[1],
                              toh_h.shape[1], k, metric))
        b5_t[metric] = res_t
        print(f"{metric} {n_test} x {n_train} k={k} ({len(chunks)} "
              f"test-chunk launches): {res_t}", flush=True)
        print(f"  bound: {res_t['bound_ms']:.4f} ms restated (no divide or "
              f"square root counted) vs "
              f"{res_t['bound_ms_with_tail']:.4f} ms counting them",
              flush=True)
    tn_f, rn_f = tn_d.contiguous(), rn_d.contiguous()
    cdist_ms = cuda_ms(lambda: torch.topk(torch.cdist(tn_f, rn_f), k, dim=1,
                                          largest=False), 3)
    print(f"context: torch.cdist + torch.topk on the numeric part at that "
          f"shape (a {n_test * n_train * 4 / 1e9:.0f} GB distance matrix, "
          f"another order and no floor): {cdist_ms:.3f} ms; no single "
          f"PyTorch call computes the floored mixed distance with the "
          f"lexicographic top-k: library_ms is null", flush=True)
    del tn_d, toh_d, rn_d, roh_d, chunks, kd, ki, pd, pi

    return b5_err, b5_launches, scale_launches, b5_t, (
        efs, test_t, train_t, nd, nidx, warm_s)


def mesh_of(devices, S):
    """A mesh of S shards over ``devices``, round robin (one device
    repeated S times on a one-card machine)."""
    from avenir_tpu_torch.parallel.mesh import DeviceMesh
    return DeviceMesh([devices[s % len(devices)] for s in range(S)])


def b6_phase(dev, rng):
    """Phase 19: B6 and the merge-finalize against their plain versions.
    Returns the largest tally difference seen (0.0 when exact)."""
    import torch
    from avenir_tpu_torch.kernels import vote
    phase("19 B6 partial-vote and merge-finalize kernels vs plain versions")
    err = 0.0
    for shape, want_form in ((RAFO_SHAPE, "table"), (WIDE_SHAPE, "scan")):
        T, P, F, C, K = shape
        for n in row_counts(shape):
            stacked, vals, codes = random_forest_inputs(rng, shape, n)
            v = torch.from_numpy(vals).to(dev)
            c = torch.from_numpy(codes).to(dev)
            whole = vote.prepare_vote_model(*stacked, dev)
            # above B6_DIRECT_PAIRS (row, predicate slot) pairs the plain
            # tallies come from one plain first-match pass over the whole
            # forest, each slice's the weighted one-hot of its trees'
            # matches summed (a tree's first match does not depend on the
            # other trees)
            shared = n * T * P * F > B6_DIRECT_PAIRS
            if shared:
                first = vote.first_match_torch(v, c, *whole.stacked()[:5])
                voted = whole.cls_oh[torch.arange(T, device=dev)[None, :],
                                     first] * whole.wvec[None, :, None]
                del first
            vetoes = 0
            for S in (1, 2, 3, 4):
                slices = vote.shard_stacked_arrays(stacked, S)
                models = [vote.prepare_vote_model(*a, dev) for a in slices]
                forms = [vote_forms(m, want_form) for m in models]
                parts = [vote.ensemble_partial_votes(v, c, m) for m in models]
                # every other form of each slice: the same tallies
                others = [[vote.ensemble_partial_votes(v, c, m2)
                           for _, m2 in f[1:]] for f in forms]
                step = models[0].shape[0]
                if shared:
                    want = [voted[:, s * step:min((s + 1) * step, T)].sum(1)
                            if s * step < T else
                            torch.zeros((n, K), device=dev)
                            for s in range(S)]
                else:
                    want = [vote.member_votes_torch(v, c, *m.stacked())
                            for m in models]
                torch.cuda.synchronize()
                for s, (got, w) in enumerate(zip(parts, want)):
                    for got_f in [got] + others[s]:
                        if got_f.shape != (n, K) or \
                                got_f.dtype != torch.float32:
                            fail(f"partial votes output "
                                 f"{tuple(got_f.shape)} {got_f.dtype}")
                        if n:
                            err = max(err, float((got_f - w).abs().max()
                                                 .item()))
                        if not torch.equal(got_f, w):
                            fail(f"partial-vote kernel != plain version at "
                                 f"shape {shape}, n={n}, S={S}, shard {s}: "
                                 f"{int((got_f != w).sum().item())} tallies "
                                 f"differ")
                for mo in (1.0, 1.5):
                    merged = vote.vote_merge_finalize(parts, mo)
                    plain = vote.vote_merge_finalize_torch(parts, mo) if n \
                        else merged
                    b2 = vote.ensemble_vote(v, c, whole, mo)
                    torch.cuda.synchronize()
                    if merged.shape != (n,) or merged.dtype != torch.int32:
                        fail(f"merge-finalize output {tuple(merged.shape)} "
                             f"{merged.dtype}")
                    if not (torch.equal(merged, plain)
                            and torch.equal(merged, b2)):
                        fail(f"merge-finalize at shape {shape}, n={n}, S={S}, "
                             f"min_odds={mo}: "
                             f"{int((merged != plain).sum().item())} rows "
                             f"differ from the plain version, "
                             f"{int((merged != b2).sum().item())} from B2")
                    vetoes = int((merged == K).sum().item())
            if shared:
                del voted
            print(f"shape T,P,F,C,K={shape} n={n} S=1..4: partial tallies "
                  f"in forms {[f for f, _ in forms[0]]} and merged votes "
                  f"exact (plain tallies "
                  f"{'from one first-match pass' if shared else 'direct'}; "
                  f"merged = B2; vetoes at 1.5: {vetoes})", flush=True)
    return err


def b7_phase(dev, rng):
    """Phase 20: the B7 merge against its plain version, then the sharded
    scan against single-device B5.  Returns the largest distance
    difference seen (0.0 when exact)."""
    import torch
    from avenir_tpu_torch.kernels import topk
    phase("20 B7 top-k merge kernel vs plain version; sharded scan vs B5")
    err = 0.0
    pool = rng.integers(0, 4, (48, 2)).astype(np.float32)   # ties
    for S in MERGE_LISTS:
        for k in B5_KS:
            # shards shorter and longer than k, one empty when S > 1; rows
            # drawn from a small pool, so equal rows sit in several shards
            sizes = rng.integers(0, 2 * k + 2, S)
            if S > 1:
                sizes[rng.integers(S)] = 0
            if sizes.sum() < k:
                sizes[0] += k
            shards = [torch.from_numpy(pool[rng.integers(0, 48, n_s)]).to(dev)
                      for n_s in sizes]
            bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
            step = 2 * k + 2
            for nt in (1, 7, 513, 20_000):
                tn = torch.from_numpy(
                    (rng.random((nt, 2)) * 4).astype(np.float32)).to(dev)
                toh = torch.zeros((nt, 0), dtype=torch.int8, device=dev)
                lists = [topk.topk_scan(
                    tn, toh, rn, torch.zeros((rn.shape[0], 0),
                                             dtype=torch.int8, device=dev),
                    k, "euclidean", 0.0, 2.0, 1000.0) for rn in shards]
                ds, is_ = [d for d, _ in lists], [i for _, i in lists]
                # the list entry (separate tensors, the shards' bases) and
                # the stacked entry (one (S, nt, k) pair, bases s * step)
                checks = [("list", topk.topk_merge(ds, is_, bases, k),
                           topk.topk_merge_torch(ds, is_, bases, k)),
                          ("stacked", topk.topk_merge_stacked(
                              torch.stack(ds), torch.stack(is_), step, k),
                           topk.topk_merge_torch(
                               ds, is_, [s * step for s in range(S)], k))]
                if nt == 20_000:
                    checks.append(("old", topk.topk_merge(
                        ds, is_, bases, k, old=True), checks[0][2]))
                torch.cuda.synchronize()
                for entry, got, want in checks:
                    live = torch.isfinite(want[0])
                    if live.any():
                        err = max(err, float((got[0][live] - want[0][live])
                                             .abs().max().item()))
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        fail(f"top-k merge kernel ({entry} entry) != plain "
                             f"version at S={S}, k={k}, nt={nt}, shard "
                             f"rows {sizes.tolist()}")
        print(f"merge S={S} k={B5_KS}: exact through the list and the "
              f"stacked entry at nt = 1, 7, 513, 20000 (last shard rows "
              f"{sizes.tolist()})", flush=True)
    for name, (Fn, cards) in B5_SCHEMAS.items():
        n_cat, denom = float(len(cards)), float(max(Fn + len(cards), 1))
        for n_train in (5, 1000):
            rn, roh = (torch.from_numpy(a).to(dev) for a in
                       b5_inputs(rng, name, n_train, dup=True))
            tn, toh = (torch.from_numpy(a).to(dev) for a in
                       b5_inputs(rng, name, 513))
            ks = sorted({min(k, n_train) for k in B5_KS})
            for metric in ("euclidean", "manhattan"):
                for k in ks:
                    want = topk.topk_scan(tn, toh, rn, roh, k, metric, n_cat,
                                          denom, 1000.0)
                    for S in (2, 3, 4, 8):
                        shards = [(rn[a:b], roh[a:b]) for a, b in
                                  topk.shard_ranges(n_train, S)]
                        got = topk.topk_scan_sharded(
                            tn, toh, shards, k, metric, n_cat, denom, 1000.0,
                            mesh_of([dev], S))
                        if not (torch.equal(got[0], want[0])
                                and torch.equal(got[1], want[1])):
                            fail(f"sharded scan != B5 at {name} {metric} "
                                 f"n_train={n_train} k={k} S={S}")
            print(f"{name} n_train={n_train} n_test=513 k={ks}: sharded scan "
                  f"over cuda x 2/3/4/8 == single-device B5, both metrics",
                  flush=True)
    # the pad probe: a shard must never hold a pad row
    tn = torch.zeros((1, 2), device=dev)
    rn = torch.full((10, 2), 5.0, device=dev)
    rn[0] = torch.tensor([1.0, 0.0])
    rn[9] = torch.tensor([2.0, 0.0])
    toh = torch.zeros((1, 0), dtype=torch.int8, device=dev)
    roh = torch.zeros((10, 0), dtype=torch.int8, device=dev)
    single = topk.topk_scan(tn, toh, rn, roh, 2, "euclidean", 0.0, 1.0, 1.0)
    sharded = topk.topk_scan_sharded(
        tn, toh, [(rn[a:b], roh[a:b]) for a, b in topk.shard_ranges(10, 4)],
        2, "euclidean", 0.0, 1.0, 1.0, mesh_of([dev], 4))
    if single[0].tolist() != [[1.0, 2.0]] or single[1].tolist() != [[0, 9]] \
            or not (torch.equal(sharded[0], single[0])
                    and torch.equal(sharded[1], single[1])):
        fail(f"pad probe: single {single}, sharded {sharded}")
    print("pad probe (10 train rows over 4 shards, k=2): sharded == single "
          "== d [[1, 2]], i [[0, 9]]", flush=True)
    return err


def merge_rounds_check(dev, rng, P=ROUND_LISTS, nt=20_000, k=10):
    """The end of phase 20: the cross-process merge over more lists than
    one launch takes, ``topk_merge_rounds`` on the card (ceil(P / 64)
    launches, then one) against the plain version's one stable sort of all
    P lists: each list k train rows of its own range, ascending by
    (distance, global index), distances from a pool of 6 (ties across
    lists), every seventh list with dead (+inf, -1) tails.  Returns the
    largest distance difference and the launches."""
    import torch
    from avenir_tpu_torch.kernels import topk
    ds, is_ = [], []
    for s in range(P):
        d = np.sort(rng.integers(0, 6, (nt, k)), axis=1).astype(np.float32)
        i = np.tile(np.arange(s * 2 * k, s * 2 * k + k, dtype=np.int32),
                    (nt, 1))
        if s % 7 == 3:
            d[:, k // 2:], i[:, k // 2:] = np.inf, -1
        ds.append(torch.from_numpy(np.ascontiguousarray(d)).to(dev))
        is_.append(torch.from_numpy(np.ascontiguousarray(i)).to(dev))
    topk.merge_launches = 0
    got = topk.topk_merge_rounds(ds, is_, k)
    launches = topk.merge_launches
    want = topk.topk_merge_torch(ds, is_, [0] * P, k)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail(f"{P}-list merge in rounds != the plain version's stable sort")
    rounds = -(-P // topk.MAX_SHARDS) + 1
    if launches != rounds:
        fail(f"{P}-list merge: {launches} launches, want {rounds}")
    print(f"merge of {P} lists (nt={nt:,}, k={k}) in rounds of 64: "
          f"{launches} launches, exact against the plain version's stable "
          f"sort of all {P}", flush=True)
    live = torch.isfinite(want[0])
    err = float((got[0][live] - want[0][live]).abs().max().item()) \
        if live.any() else 0.0
    return err, launches


def sharded_serving(devices, label):
    """Phase 21: PredictionService and make_predictor over copies of the
    rafo9 registry with serve_mesh of 2, 3 and 4 shards.  Counts zeroed
    just before, read just after.  Returns the partial and finalize
    launches."""
    from avenir_tpu_torch.kernels import vote
    from avenir_tpu_torch.serving.predictor import make_predictor
    from avenir_tpu_torch.serving.registry import ModelRegistry
    from avenir_tpu_torch.serving.service import PredictionService
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()]
    with open(os.path.join(RAFO9, "served.csv")) as fh:
        served_want = fh.read()
    with open(os.path.join(RAFO9, "pred.csv")) as fh:
        pred_want = fh.read()
    want_partial = want_final = 0
    walls = {}
    vote.launches = vote.partial_launches = vote.finalize_launches = 0
    with transfer_ledger() as led:
        for S in (2, 3, 4):
            mesh = mesh_of(devices, S)
            reg = os.path.join(WORK, f"sharded_registry_{label}_{S}")
            shutil.copytree(os.path.join(RAFO9, "registry"), reg)
            with transfer_ledger() as one:
                t0 = time.perf_counter()
                svc = PredictionService(registry=ModelRegistry(reg),
                                        model_name="rafo9", serve_mesh=mesh)
                svc.start()
                futures = [svc.submit(r) for r in rows]
                served = [f.result(timeout=120) for f in futures]
                svc.stop()
                walls[S] = round(time.perf_counter() - t0, 4)
                labels = make_predictor(ModelRegistry(reg).load("rafo9"),
                                        serve_mesh=mesh).predict_rows(rows)
            if "".join(f"{i},{r}\n" for i, r in enumerate(served)) \
                    != served_want:
                fail(f"serve_mesh of {S} ({label}): served replies differ "
                     f"from rafo9/served.csv")
            if "".join(",".join(r) + f",{lab}\n"
                       for r, lab in zip(rows, labels)) != pred_want:
                fail(f"serve_mesh of {S} ({label}): make_predictor labels "
                     f"differ from rafo9/pred.csv")
            batches = one.site_snapshot().get("serve.predict", 0)
            want_partial += S * batches
            want_final += batches
            print(f"serve_mesh {[str(d) for d in mesh.devices]}: served.csv "
                  f"and pred.csv byte-identical; {batches} sharded batches "
                  f"(incl. warm-up), service wall {walls[S]} s", flush=True)
    got = (vote.partial_launches, vote.finalize_launches, vote.launches)
    sites, backends = led.site_snapshot(), led.backend_snapshot()
    print(f"sharded serving main path ({label}): partial launches={got[0]}, "
          f"finalize launches={got[1]}, ensemble_vote launches={got[2]}; "
          f"Dispatches={sites}; KernelBackends={backends}; gathers="
          f"{led.gathers} ({led.gather_bytes} bytes)", flush=True)
    if got != (want_partial, want_final, 0) or want_final <= 0:
        fail(f"sharded serving launches {got} != (S x batches "
             f"{want_partial}, batches {want_final}, no B2)")
    if sites.get("serve.shard_merge") != sites.get("serve.predict") \
            or "ensemble.vote" in sites:
        fail(f"sharded serving ledger sites {sites}")
    if not backends.get("serve.predict.cuda") or \
            any(not k.endswith(".cuda") for k in backends):
        fail(f"sharded serving ledger shows non-kernel forms: {backends}")
    return got[0], got[1]


def sharded_knn(devices, label, scale):
    """Phase 22: knnPipeline over the elearn_knn fixture under a runtime
    context of 4 shards, then 20,000 x 200,000 rows sharded 4 ways against
    phase 17's single-device answer.  Counts zeroed just before the
    pipeline, read just after.  Returns (B5 launches, merge launches, warm
    wall s)."""
    from avenir_tpu_torch.kernels import topk
    from avenir_tpu_torch.ops.distance import DistanceComputer
    from avenir_tpu_torch.parallel.mesh import MeshContext, set_runtime_context
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    efs, test_t, train_t, nd, nidx, _ = scale
    mesh = mesh_of(devices, 4)
    knn_props = os.path.join(RES, "knn.properties")
    with open(os.path.join(ELEARN_KNN, "counters.json")) as fh:
        knn_counters = json.load(fh)
    data = os.path.join(ELEARN_KNN, "data")
    topk.launches = topk.merge_launches = 0
    set_runtime_context(MeshContext(mesh))
    try:
        with transfer_ledger() as led:
            for mode in ("inter", "intra"):
                for metric in ("euclidean", "manhattan"):
                    run = f"{mode}_{metric}"
                    out = os.path.join(WORK, f"knn_sharded_{label}_{run}")
                    run_cli(["org.avenir.knn.KnnPipeline",
                             f"-Dconf.path={knn_props}",
                             f"-Dsts.same.schema.file.path="
                             f"{os.path.join(RES, 'elearn.json')}",
                             f"-Dsts.distance.metric={metric}",
                             data if mode == "inter"
                             else os.path.join(data, "tr_part"), out])
                    same_bytes(os.path.join(out, "part-r-00000"),
                               os.path.join(ELEARN_KNN, f"{run}.csv"),
                               f"knnPipeline {run} over 4 shards ({label})")
                    with open(out + ".counters.json") as fh:
                        got = json.load(fh)
                    if {g: got[g] for g in knn_counters[run]} \
                            != knn_counters[run]:
                        fail(f"sharded knnPipeline {run} counters differ")
    finally:
        set_runtime_context(None)
    b5, merges = topk.launches, topk.merge_launches
    sites, backends = led.site_snapshot(), led.backend_snapshot()
    chunks = sites.get("knn.topk", 0)
    print(f"sharded knn main path ({label}, {[str(d) for d in mesh.devices]})"
          f": topk_scan launches={b5}, topk_merge launches={merges}, "
          f"chunks={chunks}; Dispatches={sites}; KernelBackends={backends}; "
          f"gathers={led.gathers} ({led.gather_bytes} bytes)", flush=True)
    if chunks <= 0 or b5 <= 0 or b5 > 4 * chunks or merges != chunks \
            or sites.get("knn.shard_merge") != chunks:
        fail(f"sharded knn launches: B5 {b5}, merge {merges}, chunks "
             f"{chunks}, sites {sites}")
    if set(backends) != {"knn.topk.cuda"}:
        fail(f"sharded knn ledger shows {backends}, not only knn.topk.cuda")
    comp = DistanceComputer(efs, metric="euclidean", scale=1000, mesh=mesh)
    t0 = time.perf_counter()
    d4, i4 = comp.pairwise_topk(test_t, train_t, KNN_SCALE[2])
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d4w, i4w = comp.pairwise_topk(test_t, train_t, KNN_SCALE[2])
    warm_s = time.perf_counter() - t0
    if not (np.array_equal(d4, nd) and np.array_equal(i4, nidx)
            and np.array_equal(d4w, nd) and np.array_equal(i4w, nidx)):
        fail(f"20k x 200k sharded 4 ways ({label}): (d, i) differ from the "
             f"single-device answer")
    print(f"20000 x 200000 elearn rows, k=10, train sharded 4 ways "
          f"({label}): (d, i) equal to phase 17's; pairwise_topk wall "
          f"{cold_s:.4f} s cold, {warm_s:.4f} s warm", flush=True)
    return b5, merges, warm_s, comp


def sharded_times(dev, ens, requests, fs, comp, scale, knn_warm_4):
    """Phase 23: median CUDA-event times of the partial-vote kernel (4 tree
    slices of the rafo9 forest over its requests tiled to 1M rows), the
    merge-finalize (4 shards, 1M rows) and the top-k merge (4 shards,
    20,000 test rows, k = 10), each beside its plain version and its bytes
    bound; the sharded pairwise_topk wall beside the single-device one."""
    import torch
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.kernels import topk, vote
    phase("23 B6 / merge-finalize / B7 merge times")
    n, S = 1_000_000, 4
    vals, codes = ens.models[0].matrix.feature_arrays(load_csv(requests, fs))
    reps = -(-n // len(vals))
    v = torch.from_numpy(np.ascontiguousarray(
        np.tile(vals, (reps, 1))[:n], np.float32)).to(dev)
    c = torch.from_numpy(np.ascontiguousarray(
        np.tile(codes, (reps, 1))[:n], np.int32)).to(dev)
    slices = vote.shard_stacked_arrays(
        (*ens.stacked_host(), np.asarray(ens.weights, np.float32)), S)
    models = [vote.prepare_vote_model(*a, dev) for a in slices]
    olds = [scan_form(m) for m in models]
    K = models[0].shape[4]

    def partials(ms):
        return [vote.ensemble_partial_votes(v, c, m) for m in ms]
    b6 = {"form": [vote.vote_form(m) for m in models],
          "ms": cuda_ms(lambda: partials(models), 50)}
    b6["old_ms"] = cuda_ms(lambda: partials(olds), 50)
    b6["plain_ms"] = cuda_ms(lambda: [vote.member_votes_torch(
        v, c, *m.stacked()) for m in models], 10)
    b6["ms_again"] = cuda_ms(lambda: partials(models), 50)
    b6["old_ms_again"] = cuda_ms(lambda: partials(olds), 50)
    b6["slice_ms"] = [cuda_ms(lambda m=m: vote.ensemble_partial_votes(
        v, c, m), 50) for m in models]
    b6["device_ms"] = device_ms(lambda: partials(models))
    b6["old_device_ms"] = device_ms(lambda: partials(olds))
    nbytes = S * (v.nbytes + c.nbytes + n * K * 4)
    tests = sum(predicate_tests(v, c, m) for m in models)
    b6.update(bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
              tests=tests, tests_ms=tests / TESTS_PER_S * 1e3)
    b6["bound_ms"] = max(b6["bytes_ms"], b6["tests_ms"])
    b6["bound_by"] = "bytes" if b6["bytes_ms"] >= b6["tests_ms"] \
        else "operations"
    print(f"B6 partial votes, rafo9 forest (T,P,F,C,K={ens._stacked.shape}) "
          f"in {S} tree slices of {models[0].shape[0]}, n={n}: {b6}",
          flush=True)
    parts = [vote.ensemble_partial_votes(v, c, m) for m in models]
    fin = {"ms": cuda_ms(lambda: vote.vote_merge_finalize(parts, 1.5), 50)}
    fin["plain_ms"] = cuda_ms(lambda: vote.vote_merge_finalize_torch(
        parts, 1.5), 10)
    fin["ms_again"] = cuda_ms(lambda: vote.vote_merge_finalize(parts, 1.5),
                              50)
    fin["device_ms"] = device_ms(lambda: vote.vote_merge_finalize(parts,
                                                                  1.5))
    nbytes = S * n * K * 4 + n * 4
    adds = n * K * (S - 1) + 2 * n * K
    fin.update(bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               ops=adds, ops_ms=adds / TESTS_PER_S * 1e3)
    fin["bound_ms"] = max(fin["bytes_ms"], fin["ops_ms"])
    fin["bound_by"] = "bytes" if fin["bytes_ms"] >= fin["ops_ms"] \
        else "operations"
    print(f"merge-finalize, {S} shards x ({n}, {K}) tallies: {fin}",
          flush=True)
    efs, test_t, train_t, nd, nidx, single_warm = scale
    k = KNN_SCALE[2]
    tn_h, toh_h = comp.encode(test_t)
    tn, toh = (torch.from_numpy(a).to(dev) for a in (tn_h, toh_h))
    shards = comp.train_shards()
    lists = [topk.topk_scan(tn, toh, rn, roh, k, "euclidean", comp._n_cat,
                            comp._denom, comp._fscale) for rn, roh in shards]
    ds, is_ = [d for d, _ in lists], [i for _, i in lists]
    bases = np.concatenate([[0], np.cumsum([rn.shape[0] for rn, _ in shards])
                            [:-1]]).tolist()
    nt = tn.shape[0]
    # new (the warp tournament) and old (the first port's merge), in turns
    b7 = {"ms": cuda_ms(lambda: topk.topk_merge(ds, is_, bases, k), 50)}
    b7["old_ms"] = cuda_ms(lambda: topk.topk_merge(ds, is_, bases, k,
                                                   old=True), 50)
    b7["plain_ms"] = cuda_ms(lambda: topk.topk_merge_torch(ds, is_, bases, k),
                             10)
    b7["ms_again"] = cuda_ms(lambda: topk.topk_merge(ds, is_, bases, k), 50)
    b7["old_ms_again"] = cuda_ms(lambda: topk.topk_merge(ds, is_, bases, k,
                                                         old=True), 50)
    b7["device_ms"] = device_ms(lambda: topk.topk_merge(ds, is_, bases, k))
    b7["old_device_ms"] = device_ms(lambda: topk.topk_merge(
        ds, is_, bases, k, old=True))
    cat_d = torch.cat(ds, dim=1)
    b7["sort_context_ms"] = cuda_ms(
        lambda: torch.sort(cat_d, dim=1, stable=True), 20)
    nbytes = S * nt * k * 8 + nt * k * 8
    cmps = nt * k * S
    b7.update(bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
              ops=cmps, ops_ms=cmps / TESTS_PER_S * 1e3)
    b7["bound_ms"] = max(b7["bytes_ms"], b7["ops_ms"])
    b7["bound_by"] = "bytes" if b7["bytes_ms"] >= b7["ops_ms"] \
        else "operations"
    b7["scan_ms"] = cuda_ms(lambda: [topk.topk_scan(
        tn, toh, rn, roh, k, "euclidean", comp._n_cat, comp._denom,
        comp._fscale) for rn, roh in shards], 3)
    got = topk.topk_merge(ds, is_, bases, k)
    torch.cuda.synchronize()
    if not (np.array_equal(got[0].cpu().numpy().astype(np.int32), nd)
            and np.array_equal(got[1].cpu().numpy(), nidx)):
        fail("timed top-k merge differs from the single-device answer")
    print(f"B7 merge, {S} shards x ({nt}, {k}) lists: {b7} (sort_context_ms: "
          f"torch.sort over the concatenated lists, context only)",
          flush=True)
    print(f"pairwise_topk 20000 x 200000 k=10 warm wall: {knn_warm_4:.4f} s "
          f"sharded 4 ways on one card vs {single_warm:.4f} s single-device "
          f"(phase 17); on one card the shards run one after another",
          flush=True)
    print("no single PyTorch call computes the partial tallies, the merged "
          "vote or the lexicographic merge: library_ms is null", flush=True)
    return b6, fin, b7


def distinct_b6(cards):
    """Phase 19 again over distinct GPUs: B6 with each tree slice on its
    own card, the partials gathered to the first card, the merge-finalize
    there against B2 on the first card."""
    import torch
    from avenir_tpu_torch.kernels import vote
    from avenir_tpu_torch.parallel.collectives import gather_to
    rng = np.random.default_rng(20261020)
    for shape in (RAFO_SHAPE, WIDE_SHAPE):
        stacked, vals, codes = random_forest_inputs(rng, shape, 100_000)
        v0, c0 = (torch.from_numpy(a).to(cards[0]) for a in (vals, codes))
        b2 = vote.ensemble_vote(v0, c0, vote.prepare_vote_model(
            *stacked, cards[0]), 1.5)
        for S in range(2, len(cards) + 1):
            mesh = mesh_of(cards, S)
            models = [vote.prepare_vote_model(*a, d) for a, d in
                      zip(vote.shard_stacked_arrays(stacked, S), mesh.devices)]
            parts = [vote.ensemble_partial_votes(v0.to(m.device),
                                                 c0.to(m.device), m)
                     for m in models]
            plain = [vote.member_votes_torch(v0.to(m.device), c0.to(m.device),
                                             *m.stacked()) for m in models]
            merged = vote.vote_merge_finalize(gather_to(parts, cards[0]), 1.5)
            for d in cards:
                torch.cuda.synchronize(d)
            if not all(torch.equal(a, b) for a, b in zip(parts, plain)):
                fail(f"partial tallies over {mesh} != plain version")
            if not torch.equal(merged, b2):
                fail(f"merged votes over {mesh} != B2 on {cards[0]}")
            print(f"shape {shape} n=100000 over {[str(d) for d in mesh.devices]}"
                  f": partial tallies exact, merged votes == B2", flush=True)


def distinct_b4(cards):
    """Phase 24's layouts again on every card, the first card first: the
    block-wide form's opt-in above 48 KB of shared memory (the ``wide``
    layout) and the SM count are each card's own."""
    import torch
    from avenir_tpu_torch.kernels import histogram
    rng = np.random.default_rng(20261017)
    for name, (R, B) in B4_SHAPES.items():
        codes = rng.integers(-2, B + 2, (100_000, R), dtype=np.int32)
        mask = rng.random(100_000) < 0.6
        for d in cards:
            c = torch.from_numpy(codes).to(d)
            m = torch.from_numpy(mask).to(d)
            carry = torch.full((R, B), 7.0, device=d)
            got = histogram.bin_counts(c, B, m)
            added = histogram.bin_counts(c, B, m, out=carry.clone())
            want = histogram.bin_counts_torch(c, B, m)
            torch.cuda.synchronize(d)
            if not torch.equal(got, want) or not torch.equal(added,
                                                             carry + want):
                fail(f"bin-counts kernel != plain version on {d}: {name} "
                     f"R={R} B={B}")
        print(f"bin counts {name} R,B=({R},{B}) n=100000 masked, out None "
              f"and an out carry: exact on {[str(d) for d in cards]}",
              flush=True)


def b4_phase(dev, rng):
    """Phase 24: B4 against its plain version in both forms (counts written,
    counts added into an ``out`` carry, one above 2^24 among them) at the
    phase-12 shapes and the drift monitor's block sizes, unaligned slices,
    one skewed case, and two threads launching on two streams at once.
    Returns the largest absolute difference (0: every case exact)."""
    import threading
    import torch
    from avenir_tpu_torch.kernels import histogram
    phase("24 bin-counts kernel vs plain version: out= carries, monitor "
          "blocks, skew, two streams")
    cases = 0

    def check(codes, B, mask, what):
        nonlocal cases
        R = codes.shape[1]
        carry = torch.from_numpy(
            (2.0 ** 24 + rng.integers(0, 64, (R, B))
             + rng.integers(0, 2, (R, B)) * 2.0 ** 25).astype(np.float32)
            if cases % 2 else rng.integers(0, 5000, (R, B)).astype(
                np.float32)).to(dev)
        want = histogram.bin_counts_torch(codes, B, mask)
        got = histogram.bin_counts(codes, B, mask)
        added = histogram.bin_counts(codes, B, mask, out=carry.clone())
        want_added = histogram.bin_counts_torch(codes, B, mask,
                                                out=carry.clone())
        torch.cuda.synchronize()
        if not torch.equal(got, want) or not torch.equal(added, want_added) \
                or not torch.equal(want_added, carry + want):
            fail(f"bin-counts kernel != plain version: {what}")
        cases += 1

    rows = sorted(set(B4_ROWS) | set(B4_BLOCK_ROWS))
    for name, (R, B) in B4_SHAPES.items():
        for n in rows:
            codes = torch.from_numpy(rng.integers(
                -2, B + 2, (n + 3, R), dtype=np.int32)).to(dev)
            part = torch.from_numpy(rng.random(n + 3) < 0.6).to(dev)
            for off in ((0, 1, 3) if n <= 4096 else (0,)):
                c, m = codes[off:off + n], part[off:off + n]
                for mask in (None, m):
                    check(c, B, mask, f"{name} R={R} B={B} n={n} from row "
                          f"{off}, mask {'part' if mask is not None else None}")
        print(f"{name} R,B=({R},{B}): exact at n={rows}, slices from rows "
              f"0/1/3, mask None and partial, out None and an out carry "
              f"(every other one above 2^24)", flush=True)
    # past the block-wide accumulator's 200 KB of shared memory: lanes add
    # straight into the global accumulator
    R, B = B4_GLOBAL_SHAPE
    for n in (1, 1000, 100_000):
        codes = torch.from_numpy(rng.integers(-2, B + 2, (n, R),
                                              dtype=np.int32)).to(dev)
        check(codes, B, None, f"global accumulator R={R} B={B} n={n}")
    print(f"global-accumulator shape R,B={B4_GLOBAL_SHAPE}: exact at n = 1, "
          f"1000, 100,000", flush=True)
    skew = torch.full((1_000_000, 5), 3, dtype=torch.int32, device=dev)
    check(skew, 7, None, "skewed: every code in one bin")
    empty = torch.zeros((0, 5), dtype=torch.int32, device=dev)
    check(empty, 7, None, "n = 0")
    errs = []

    def worker(seed):
        r = np.random.default_rng(seed)
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            for _ in range(40):
                n = int(r.choice(B4_BLOCK_ROWS))
                c = torch.from_numpy(r.integers(-1, 8, (n, 5),
                                                dtype=np.int32)).to(dev)
                out = torch.zeros((5, 7), device=dev)
                for _ in range(3):
                    histogram.bin_counts(c, 7, out=out)
                want = histogram.bin_counts_torch(c, 7) * 3
                stream.synchronize()
                if not torch.equal(out, want):
                    errs.append(seed)
    threads = [threading.Thread(target=worker, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        fail(f"bin counts launched from two threads on two streams "
             f"differ from the plain version (threads {sorted(set(errs))})")
    print(f"skewed 1M x 5 codes in one bin, n = 0, and two threads x 40 "
          f"blocks x 3 accumulating calls on two streams: exact "
          f"({cases} cases in all; workspaces keyed by (device, stream): "
          f"{len(histogram._workspaces)})", flush=True)
    return 0.0


def fixture_module(name):
    """tests/torch_fixtures/<name>/make.py as a module (its job keys,
    constants and case runners; it imports the JAX package only inside
    ``make``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_make",
        os.path.join(ROOT, "tests", "torch_fixtures", name, "make.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_report(got, want, what):
    """Drift report CSVs: non-statistic fields equal, statistics within
    rtol 1e-5 / atol 1e-7; returns the count of differing six-decimal
    strings."""
    with open(got) as a, open(want) as b:
        g_lines, w_lines = a.read().splitlines(), b.read().splitlines()
    if len(g_lines) != len(w_lines):
        fail(f"{what}: {len(g_lines)} report rows, fixture {len(w_lines)}")
    strings = 0
    for g, w in zip(g_lines, w_lines):
        gf, wf = g.split(","), w.split(",")
        if gf[:5] + gf[10:] != wf[:5] + wf[10:]:
            fail(f"{what}: row {g!r} != fixture {w!r}")
        for x, y in zip(gf[5:10], wf[5:10]):
            if abs(float(x) - float(y)) > 1e-7 + 1e-5 * abs(float(y)):
                fail(f"{what}: statistic {x} vs fixture {y} in {g!r}")
            strings += x != y
    return strings


def same_alerts(got, want, what):
    with open(got) as a, open(want) as b:
        g_recs = [json.loads(line) for line in a]
        w_recs = [json.loads(line) for line in b]
    if len(g_recs) != len(w_recs):
        fail(f"{what}: {len(g_recs)} alert records, fixture {len(w_recs)}")
    for g, w in zip(g_recs, w_recs):
        gv, wv = g.pop("value"), w.pop("value")
        if g != w or abs(gv - wv) > 1e-7 + 1e-5 * abs(wv):
            fail(f"{what}: record {g} ({gv}) != fixture {w} ({wv})")


def drift_main_path(dev):
    """Phase 25: the drift monitor's main path on the card, counts zeroed
    just before and read just after: driftMonitor and predictDriftScore
    (dm.pipeline.fuse=false) over the drift9 fixture's stream against a
    copy of the rafo9q registry; then (25f) predictDriftScore with the
    fuse default, its counts zeroed around it alone; then the serving
    hook.  Returns (B4 launches, B2 launches, six-decimal strings that
    differ, the fused job's launches and windows)."""
    import torch
    from avenir_tpu_torch.core.table import encode_rows
    from avenir_tpu_torch.kernels import histogram, vote
    from avenir_tpu_torch.monitor.accumulator import (ServingMonitor,
                                                      StreamDriftMonitor)
    from avenir_tpu_torch.monitor.baseline import load_baseline
    from avenir_tpu_torch.serving.registry import ModelRegistry
    from avenir_tpu_torch.serving.service import BatchPolicy, \
        PredictionService
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    mk = fixture_module("drift9")
    reg = os.path.join(WORK, "drift9_registry")
    shutil.copytree(os.path.join(RAFO9Q, "registry"), reg)
    stream = os.path.join(DRIFT9, "stream.csv")
    outs = {}
    histogram.bin_counts_launches = 0
    vote.launches = vote.table_launches = 0
    with transfer_ledger() as ledger:
        phase("25 drift main path: driftMonitor, predictDriftScore "
              "(dm.pipeline.fuse=false) == the drift9 fixture")
        for job, sub, extra in (("driftMonitor", "drift", ()),
                                ("predictDriftScore", "predict",
                                 ("-Ddm.pipeline.fuse=false",))):
            out = os.path.join(WORK, f"drift9_{sub}")
            t0 = time.perf_counter()
            run_cli([job, f"-Ddm.model.registry.dir={reg}",
                     f"-Ddm.model.name={mk.MODEL_NAME}", *mk.KEYS, *extra,
                     stream, out])
            outs[sub] = (out, time.perf_counter() - t0)
    b4_launches = histogram.bin_counts_launches
    b2_launches = vote.launches
    backends = ledger.backend_snapshot()
    strings = absorbed = 0
    for sub, (out, wall) in outs.items():
        want = os.path.join(DRIFT9, sub)
        n_diff = same_report(os.path.join(out, "part-r-00000"),
                             os.path.join(want, "part-r-00000"),
                             f"drift9 {sub} report")
        strings += n_diff
        same_alerts(os.path.join(out, "alerts.jsonl"),
                    os.path.join(want, "alerts.jsonl"), f"drift9 {sub}")
        with open(out + ".counters.json") as fh:
            counters = json.load(fh)
        got_c = {g: counters[g] for g in mk.COUNTER_GROUPS if g in counters}
        with open(os.path.join(DRIFT9, f"{sub}_counters.json")) as fh:
            if got_c != json.load(fh):
                fail(f"drift9 {sub} counters {got_c} != the fixture's")
        absorbed += counters["Dispatches"]["monitor.absorb"]
        print(f"drift9 {sub}: report rows and alert records equal to the "
              f"fixture's ({n_diff} six-decimal statistics differ), "
              f"counters {got_c}; wall {wall:.2f} s", flush=True)
    same_bytes(os.path.join(outs["predict"][0], "predictions",
                            "part-m-00000"),
               os.path.join(DRIFT9, "predict", "predictions", "part-m-00000"),
               "drift9 predictDriftScore predictions")
    fused = drift_fused_job(reg, mk, stream, outs["predict"][0])
    print(f"drift main path: bin_counts launches={b4_launches} (absorbed "
          f"blocks {absorbed}), ensemble_vote launches={b2_launches} (table "
          f"form {vote.table_launches}); KernelBackends={backends}",
          flush=True)
    if b4_launches != absorbed:
        fail(f"drift main path: {b4_launches} bin-counts launches for "
             f"{absorbed} absorbed blocks")
    if b2_launches <= 0:
        fail("drift main path never launched the ensemble-vote kernel")
    if not backends.get("monitor.absorb.cuda"):
        fail("drift ledger shows no monitor.absorb.cuda")
    wrong = [k for k in backends if k.endswith((".torch", ".host"))]
    if wrong:
        fail(f"ledger shows non-kernel forms on the drift path: {wrong}")

    # the serving hook against an offline monitor over the same rows
    registry = ModelRegistry(reg)
    baseline = load_baseline(registry, mk.MODEL_NAME)
    schema = registry.load(mk.MODEL_NAME).schema
    mon = ServingMonitor(baseline, schema, window_rows=512, flush_rows=128,
                         async_flush=False, device=dev)
    svc = PredictionService(registry=registry, model_name=mk.MODEL_NAME,
                            monitor=mon, device=dev,
                            policy=BatchPolicy(max_batch=64))
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()]
    svc.start()
    labels = [f.result(timeout=120) for f in [svc.submit(r) for r in rows]]
    svc.stop()
    mon.close()
    offline = StreamDriftMonitor(baseline, window_rows=512, device=dev)
    offline.observe_table(encode_rows(rows, schema),
                          class_codes=baseline.class_codes_for_labels(labels))
    offline.close_window()

    def key(r):
        return (r.index, r.kind, r.n_rows,
                [(x.scope, x.kind, x.stats) for x in r.rows])
    if [key(r) for r in mon.reports] != [key(r) for r in offline.reports]:
        fail("the serving hook's drift reports differ from an offline "
             "StreamDriftMonitor's over the same rows and labels")
    errors = mon.counters.get("DriftMonitor", "RecordErrors")
    if errors:
        fail(f"the serving hook dropped {errors} rows (RecordErrors)")
    print(f"serving hook: {len(rows)} rafo9 requests served on the card "
          f"with a ServingMonitor; its {len(mon.reports)} reports equal an "
          f"offline StreamDriftMonitor's; RecordErrors=0", flush=True)
    torch.cuda.synchronize()
    return b4_launches, b2_launches, strings, fused


def drift_fused_job(reg, mk, stream, unfused_out):
    """Phase 25f: predictDriftScore with the fuse default over the drift9
    stream, its counts and the ProgramCache zeroed just before and read
    just after: the drift9 predict_fused files and counters (the JAX
    package's fused job's), the unfused job's bytes, and B2 = B4 = fused
    windows, every one a kernel launch."""
    from avenir_tpu_torch.kernels import histogram, vote
    from avenir_tpu_torch.pipeline import program_cache
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    out = os.path.join(WORK, "drift9_predict_fused")
    program_cache().clear()
    histogram.bin_counts_launches = 0
    vote.launches = vote.table_launches = 0
    with transfer_ledger() as ledger:
        phase("25f drift fused main path: predictDriftScore (fuse default) "
              "== drift9/predict_fused")
        t0 = time.perf_counter()
        run_cli(["predictDriftScore", f"-Ddm.model.registry.dir={reg}",
                 f"-Ddm.model.name={mk.MODEL_NAME}", *mk.KEYS, stream, out])
        wall = time.perf_counter() - t0
    got = {"b2": vote.launches, "b4": histogram.bin_counts_launches,
           "b2_table": vote.table_launches}
    backends = ledger.backend_snapshot()
    want = os.path.join(DRIFT9, "predict_fused")
    n_diff = same_report(os.path.join(out, "part-r-00000"),
                         os.path.join(want, "part-r-00000"),
                         "drift9 fused report")
    same_alerts(os.path.join(out, "alerts.jsonl"),
                os.path.join(want, "alerts.jsonl"), "drift9 fused")
    same_bytes(os.path.join(out, "predictions", "part-m-00000"),
               os.path.join(want, "predictions", "part-m-00000"),
               "drift9 fused predictDriftScore predictions")
    for f in ("part-r-00000", "alerts.jsonl",
              os.path.join("predictions", "part-m-00000")):
        same_bytes(os.path.join(out, f), os.path.join(unfused_out, f),
                   f"drift9 fused {f} vs the unfused job's on the card")
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)
    got_c = {g: counters[g] for g in mk.COUNTER_GROUPS if g in counters}
    with open(os.path.join(DRIFT9, "predict_fused_counters.json")) as fh:
        if got_c != json.load(fh):
            fail(f"drift9 fused counters {got_c} != the fixture's")
    windows = counters["PredictDrift"]["FusedWindows"]
    got["windows"] = windows
    print(f"drift9 fused: files equal to the JAX package's fused job's "
          f"({n_diff} six-decimal statistics differ) and to the unfused "
          f"job's on the card; counters {got_c}; launches {got}; "
          f"KernelBackends={backends}; wall {wall:.2f} s", flush=True)
    if not (got["b2"] == got["b4"] == windows > 0) \
            or counters["PredictDrift"]["UnfusedWindows"]:
        fail(f"drift fused main path: B2 {got['b2']} and B4 {got['b4']} "
             f"launches for {windows} fused windows")
    if backends != {"ensemble.vote.cuda": windows,
                    "monitor.absorb.cuda": windows}:
        fail(f"drift fused main path: KernelBackends {backends}; every "
             f"fused window must launch B2 and B4")
    return got


def drift_scale(dev, fs):
    """Phase 26: a 1,000,000-row drifted replay (numpy draws from
    call_hangup_gen's model; the second half with queue time shifted and
    the reason mix reweighted) through StreamDriftMonitor at 2,048-row
    windows against the rafo9q baseline; rows/s and windows/s end to end,
    then the per-window layers with each one synchronised."""
    import torch
    from avenir_tpu_torch.core.table import ColumnarTable
    from avenir_tpu_torch.kernels import histogram
    from avenir_tpu_torch.monitor.accumulator import StreamDriftMonitor
    from avenir_tpu_torch.monitor.baseline import (encode_monitor_codes,
                                                   load_baseline)
    from avenir_tpu_torch.serving.registry import ModelRegistry
    phase("26 scale: a 1,000,000-row drifted replay at 2,048-row windows")
    baseline = load_baseline(ModelRegistry(os.path.join(RAFO9Q, "registry")),
                             "rafo9")
    rng = np.random.default_rng(20261026)
    half = DRIFT_SCALE_ROWS // 2
    quiet = hangup_table(rng, half, fs)
    drifted = hangup_table(rng, DRIFT_SCALE_ROWS - half, fs,
                           reason_p=(0.1, 0.1, 0.1, 0.7), queue_shift=600)
    table = ColumnarTable(schema=fs, n_rows=DRIFT_SCALE_ROWS, columns={
        k: np.concatenate([quiet.columns[k], drifted.columns[k]])
        for k in quiet.columns})
    w = DRIFT_WINDOW_ROWS
    mon = StreamDriftMonitor(baseline, window_rows=w, device=dev).warm()
    histogram.bin_counts_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, table.n_rows, w):
        mon.observe_codes(encode_monitor_codes(
            table.take_rows(lo, min(lo + w, table.n_rows)), baseline.specs))
    mon.close_window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    windows = mon.counters.get("DriftMonitor", "WindowsScored")
    launches = histogram.bin_counts_launches
    if launches != windows:
        fail(f"drift replay: {launches} bin-counts launches for {windows} "
             f"windows of {w} rows")
    last = [r for r in mon.reports if r.kind == "window"][-1]
    if last.row("queueTimeSec").stats["psi"] < 0.25:
        fail("drift replay: the shifted queue time did not score as drift")
    print(f"replay: {table.n_rows} rows in {windows} windows, {wall:.3f} s "
          f"wall: {table.n_rows / wall:,.0f} rows/s, {windows / wall:,.1f} "
          f"windows/s; bin_counts launches={launches}", flush=True)
    # per-layer: each step of a window synchronised, medians over windows
    layers = {k: [] for k in ("encode", "absorb", "finalize", "score")}
    scorer, acc = mon.scorer, mon.acc
    for lo in range(0, table.n_rows, w):
        t = time.perf_counter()
        codes = encode_monitor_codes(
            table.take_rows(lo, min(lo + w, table.n_rows)), baseline.specs)
        layers["encode"].append(time.perf_counter() - t)
        t = time.perf_counter()
        acc.absorb_codes(codes)
        torch.cuda.synchronize()
        layers["absorb"].append(time.perf_counter() - t)
        t = time.perf_counter()
        counts, n = acc.finalize()
        layers["finalize"].append(time.perf_counter() - t)
        t = time.perf_counter()
        # the window and a long-window twin in one pass, as _close scores
        scorer.score_many([(counts, n, 0, "window"),
                           (counts * 0.9, n, 0, "longterm")])
        layers["score"].append(time.perf_counter() - t)
    med = {k: float(np.median(v)) * 1e3 for k, v in layers.items()}
    print(f"per window, median ms (each layer synchronised): encode (host) "
          f"{med['encode']:.4f}, B4 absorb call {med['absorb']:.4f}, "
          f"finalize read-back {med['finalize']:.4f}, the two scores (one "
          f"pass) {med['score']:.4f}", flush=True)
    return {"rows_per_s": table.n_rows / wall, "windows_per_s": windows / wall,
            "wall_s": wall, "windows": windows, "launches": launches,
            "layers_ms": med, "fused_job": drift_fused_scale(dev, table)}


# the drifted replay's job keys: drift9's thresholds at 2,048-row windows
DRIFT_SCALE_KEYS = (f"-Ddm.window.rows={DRIFT_WINDOW_ROWS}",
                    "-Ddm.score.predictions=true", "-Ddm.warn.psi=0.2",
                    "-Ddm.warn.chi2=0.18", "-Ddm.accuracy.warn=62",
                    "-Ddm.accuracy.alert=55")


def drift_fused_scale(dev, table):
    """Phase 26f: the middle of phase 26's rows (``DRIFT_FUSED_ROWS``) as a
    CSV through predictDriftScore on the card, fused (the default) then
    unfused, each with its counts zeroed just before and read just after:
    the report, alerts and predictions byte-equal between the two,
    windows/s and ms a window of each, and the fused flow's own ms a
    window (run_window over the same windows' tables, synchronised)."""
    import torch
    from avenir_tpu_torch.kernels import histogram, vote
    from avenir_tpu_torch.models.forest import EnsembleModel
    from avenir_tpu_torch.models.tree import DecisionTreeModel
    from avenir_tpu_torch.monitor.baseline import load_baseline
    from avenir_tpu_torch.pipeline.flows import PredictDriftFlow
    from avenir_tpu_torch.serving.registry import ModelRegistry
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    lo, hi = DRIFT_FUSED_ROWS
    phase(f"26f scale: predictDriftScore fused vs unfused over rows {lo:,} "
          f"to {hi:,} of the replay")
    table = table.take_rows(lo, hi)
    csv = os.path.join(WORK, "drift_scale.csv")
    write_hangup_csv(table, csv)
    reg = os.path.join(WORK, "drift_scale_registry")
    shutil.copytree(os.path.join(RAFO9Q, "registry"), reg)
    res = {}
    for form, extra in (("fused", ()),
                        ("unfused", ("-Ddm.pipeline.fuse=false",))):
        out = os.path.join(WORK, f"drift_scale_{form}")
        histogram.bin_counts_launches = 0
        vote.launches = 0
        with transfer_ledger() as ledger:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_cli(["predictDriftScore", f"-Ddm.model.registry.dir={reg}",
                     "-Ddm.model.name=rafo9", *DRIFT_SCALE_KEYS, *extra,
                     csv, out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        with open(out + ".counters.json") as fh:
            counters = json.load(fh)
        pd = counters["PredictDrift"]
        windows = pd["FusedWindows"] + pd["UnfusedWindows"]
        res[form] = {"wall_s": wall, "windows": windows,
                     "fused_windows": pd["FusedWindows"],
                     "windows_per_s": windows / wall,
                     "ms_per_window": wall * 1e3 / windows,
                     "b2": vote.launches,
                     "b4": histogram.bin_counts_launches,
                     "absorbed": counters["Dispatches"].get(
                         "monitor.absorb", 0),
                     "backends": ledger.backend_snapshot(), "out": out}
        print(f"predictDriftScore {form}: {windows} windows in {wall:.3f} s "
              f"wall: {windows / wall:,.1f} windows/s, "
              f"{wall * 1e3 / windows:.4f} ms a window; B2 launches "
              f"{vote.launches}, B4 launches "
              f"{histogram.bin_counts_launches}; KernelBackends="
              f"{res[form]['backends']}", flush=True)
    fz, uf = res["fused"], res["unfused"]
    for f in ("part-r-00000", "alerts.jsonl",
              os.path.join("predictions", "part-m-00000")):
        same_bytes(os.path.join(fz["out"], f), os.path.join(uf["out"], f),
                   f"drift replay fused {f} vs unfused")
    if os.path.getsize(os.path.join(fz["out"], "alerts.jsonl")) == 0:
        fail("drift replay: the drifted half raised no alert")
    if not (fz["b2"] == fz["b4"] == fz["fused_windows"] == fz["windows"]):
        fail(f"drift replay fused: B2 {fz['b2']}, B4 {fz['b4']} for "
             f"{fz['windows']} windows ({fz['fused_windows']} fused)")
    if uf["fused_windows"] or uf["b4"] != uf["absorbed"] or uf["b2"] <= 0:
        fail(f"drift replay unfused: {uf['b4']} B4 launches for "
             f"{uf['absorbed']} absorbed blocks, {uf['b2']} B2 launches, "
             f"{uf['fused_windows']} fused windows")
    if fz["backends"] != {"ensemble.vote.cuda": fz["windows"],
                          "monitor.absorb.cuda": fz["windows"]}:
        fail(f"drift replay fused: KernelBackends {fz['backends']}")
    # the fused flow alone: run_window over the replay's windows,
    # each synchronised (the job's host work around it excluded)
    registry = ModelRegistry(reg)
    loaded = registry.load("rafo9")
    ens = EnsembleModel([DecisionTreeModel(pl, loaded.schema, device=dev)
                         for pl in loaded.model], device=dev)
    flow = PredictDriftFlow(ens, load_baseline(registry, "rafo9"),
                            loaded.schema, DRIFT_WINDOW_ROWS)
    w = DRIFT_WINDOW_ROWS
    tables = [table.take_rows(lo, min(lo + w, table.n_rows))
              for lo in range(0, table.n_rows, w)]
    per = []
    for t in tables:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if flow.run_window(t) is None:
            fail("drift replay: the fused flow refused a window")
        per.append(time.perf_counter() - t0)
    fz["flow_ms_per_window"] = float(np.median(per)) * 1e3
    print(f"the fused flow alone (host encode, staging copy, B2, splice, "
          f"B4, read-back; synchronised): median "
          f"{fz['flow_ms_per_window']:.4f} ms a window over {len(per)} "
          f"windows", flush=True)
    for r in res.values():
        del r["out"], r["backends"]
    return res


def b4_times(dev, fs):
    """Phase 27: B4 call and device times, new and old form in the same
    turns, with the plain version and the bound: 1M rows at the rafo
    baseline's (5, 7) (hangup monitor codes), (33, 33) and (64, 256)
    (random codes), and monitor blocks of 2,048 and 256 rows at (5, 7);
    an empty kernel launch and torch.bincount over a prebuilt flat index
    as context."""
    import torch
    from avenir_tpu_torch.kernels import histogram
    from avenir_tpu_torch.monitor.baseline import (encode_monitor_codes,
                                                   monitor_specs)
    phase("27 bin-counts kernel times: new and old form")
    specs = monitor_specs(fs)
    hangup = encode_monitor_codes(
        hangup_table(np.random.default_rng(20261018), 1_000_000, fs), specs)
    B = max(s.n_bins for s in specs)
    rng = np.random.default_rng(20261027)
    res = {}
    for name, codes, b in (
            ("rafo_1m", hangup, B),
            ("default_1m", rng.integers(0, 33, (1_000_000, 33),
                                        dtype=np.int32), 33),
            ("wide_1m", rng.integers(0, 256, (1_000_000, 64),
                                     dtype=np.int32), 256),
            ("rafo_2048", hangup[:2048], B), ("rafo_256", hangup[:256], B)):
        res[name] = time_b4(codes, b, dev)
        print(f"bin counts {name} R,B=({codes.shape[1]},{b}) "
              f"n={codes.shape[0]}: {res[name]}", flush=True)
    res["empty_ms"] = cuda_ms(lambda: histogram.empty_launch(dev), 200)
    res["empty_device_ms"] = device_ms(lambda: histogram.empty_launch(dev))
    c = torch.from_numpy(hangup).to(dev)
    flat = (c.long() + B * torch.arange(c.shape[1], device=dev)[None, :]
            ).reshape(-1)
    res["bincount_prebuilt_ms"] = cuda_ms(
        lambda: torch.bincount(flat, minlength=c.shape[1] * B), 20)
    print(f"empty kernel launch: {res['empty_ms']:.5f} ms call, "
          f"{res['empty_device_ms']:.5f} ms device; torch.bincount over a "
          f"prebuilt flat index (context, not the function: the index and "
          f"validity mask are the work) {res['bincount_prebuilt_ms']:.5f} "
          f"ms; no single PyTorch call computes the bin counts: library_ms "
          f"is null", flush=True)
    return res


def rafo9s_job(reg, ck, out, extra=()):
    """The rafo9s fixture's randomForestBuilder arguments."""
    return ["org.avenir.tree.RandomForestBuilder",
            f"-Dconf.path={os.path.join(RES, 'rafo.properties')}",
            f"-Ddtb.feature.schema.file.path="
            f"{os.path.join(RES, 'call_hangup.json')}",
            f"-Ddtb.model.registry.dir={reg}", "-Ddtb.model.name=rafo9s",
            f"-Ddtb.streaming.checkpoint.dir={ck}", *STREAM_KEYS, *extra,
            os.path.join(RAFO9S, "train.csv"), out]


def same_rafo9s(out, reg, what, files=("meta.json", "baseline.json",
                                       "quantized.json"),
                arrays=("arrays.npz", "baseline.npz", "quantized.npz")):
    """Trees, quarantine part file and published files equal the rafo9s
    fixture's."""
    for i in range(9):
        same_bytes(os.path.join(out, f"tree_{i}.json"),
                   os.path.join(RAFO9S, f"tree_{i}.json"),
                   f"{what} tree {i}")
    same_bytes(os.path.join(out, "_quarantine", "part-q-00000"),
               os.path.join(RAFO9S, "part-q-00000"), f"{what} quarantine")
    version = os.path.join("rafo9s", "v_000001")
    for f in files:
        same_bytes(os.path.join(reg, version, f),
                   os.path.join(RAFO9S, "registry", version, f),
                   f"{what} published {f}")
    for f in arrays:
        same_arrays(os.path.join(reg, version, f),
                    os.path.join(RAFO9S, "registry", version, f),
                    f"{what} published {f}")


# the rafo9s job's Dispatches in a fresh one-device JAX process (fused
# default) and the two sites only the port records (the forest's reassign,
# which XLA fuses into its level program, and the int8 publish's sample
# vote); tests/test_torch_pipeline_flows.py holds both against the JAX job
RAFO9S_JAX_DISPATCHES = {"ensemble.vote": 1, "forest.level": 4,
                         "pipeline.chunk": 7}
RAFO9S_PORT_ONLY_DISPATCHES = {"tree.reassign": 3, "quantized.vote": 1}


def stream_main_path(dev):
    """Phase 28: the streamed training job over the rafo9s fixture's CSV
    with the fuse default (one rf-ingest chunk a block: the branch encode
    and the baseline's B4), then (28u) with dtb.pipeline.fuse=false, each
    with its counts zeroed just before and read just after.  Returns the
    fused run's launches of B1 (and in the mma form), B4, B2 and B3, the
    ingest blocks, and the unfused run's launches."""
    got = stream_job(dev, fused=True)
    got["unfused"] = stream_job(dev, fused=False)
    return got


def stream_job(dev, fused):
    from avenir_tpu_torch.kernels import histogram, vote
    from avenir_tpu_torch.pipeline import program_cache
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    tag = "" if fused else "_unfused"
    out = os.path.join(WORK, f"rafo9s_model{tag}")
    reg = os.path.join(WORK, f"rafo9s_registry{tag}")
    ck = os.path.join(WORK, f"rafo9s_ck{tag}")
    program_cache().clear()
    histogram.launches = histogram.mma_launches = 0
    histogram.bin_counts_launches = 0
    vote.launches = vote.quantized_launches = vote.table_launches = 0
    with transfer_ledger() as ledger:
        if fused:
            phase("28 streamed training main path: randomForestBuilder "
                  "dtb.streaming.ingest=true (fused) == the rafo9s fixture")
        else:
            phase("28u streamed training, dtb.pipeline.fuse=false == the "
                  "rafo9s fixture")
        t0 = time.perf_counter()
        run_cli(rafo9s_job(reg, ck, out,
                           () if fused else ("-Ddtb.pipeline.fuse=false",)))
        wall = time.perf_counter() - t0
    got = {"b1": histogram.launches, "b1_mma": histogram.mma_launches,
           "b4": histogram.bin_counts_launches, "b2": vote.launches,
           "b3": vote.quantized_launches}
    backends = ledger.backend_snapshot()
    same_rafo9s(out, reg, "rafo9s streamed randomForestBuilder")
    with open(out + ".counters.json") as fh:
        counters = json.load(fh)
    with open(os.path.join(RAFO9S, "train_counters.json")) as fh:
        want = json.load(fh)
    if not fused:
        # the per-stage form runs no chunk pipeline
        want.pop("ProgramCache")
        if "ProgramCache" in counters:
            fail(f"rafo9s unfused: a ProgramCache group "
                 f"{counters['ProgramCache']}")
    for group, values in want.items():
        if counters.get(group) != values:
            fail(f"rafo9s counters {group}: {counters.get(group)} != "
                 f"{values}")
    print(f"rafo9s counters equal the fixture's: {want}", flush=True)
    rows = want["Random forest"]["BaselineRows"]
    blocks = -(-rows // STREAM_BLOCK_ROWS)
    got["blocks"] = blocks
    disp = counters["Dispatches"]
    site = "pipeline.chunk" if fused else "ingest.encode"
    encodes = disp.get(site)
    print(f"streamed main path ({'fused' if fused else 'unfused'}): "
          f"{wall:.2f} s wall; launches {got}; {rows} rows in {blocks} "
          f"ingest blocks ({site} dispatches {encodes}); Dispatches={disp}; "
          f"KernelBackends={backends}", flush=True)
    if got["b1"] <= 0 or got["b1_mma"] != got["b1"]:
        fail(f"streamed main path: {got['b1']} B1 launches, "
             f"{got['b1_mma']} in the mma form; all must be")
    if got["b4"] != blocks or encodes != blocks:
        fail(f"streamed main path: {got['b4']} B4 launches and {encodes} "
             f"{site} dispatches for {blocks} ingest blocks")
    if fused and disp != {**RAFO9S_JAX_DISPATCHES,
                          **RAFO9S_PORT_ONLY_DISPATCHES}:
        fail(f"rafo9s fused Dispatches {disp}: the JAX job's "
             f"{RAFO9S_JAX_DISPATCHES} and the port's "
             f"{RAFO9S_PORT_ONLY_DISPATCHES}")
    if not fused and disp.get("baseline.absorb") != blocks:
        fail(f"rafo9s unfused: {disp.get('baseline.absorb')} teed absorbs "
             f"for {blocks} blocks")
    if got["b2"] <= 0 or got["b3"] <= 0:
        fail("the streamed quantize publish never launched B2 or B3")
    for site in ("forest.level.cuda", "forest.level.form.mma",
                 "baseline.absorb.cuda", "quantized.vote.cuda"):
        if not backends.get(site):
            fail(f"streamed ledger shows no {site}")
    readers = ledger.ingest_snapshot()
    # the ingest blocks and the quantize publish's head sample
    if readers != {"native.blocks": blocks + 1,
                   "native.rows": 2 * rows}:
        fail(f"streamed main path: IngestReaders {readers}; every block "
             f"must be read by the native reader")
    print(f"IngestReaders {readers}: every block native", flush=True)
    wrong = [k for k in backends
             if k.endswith((".torch", ".host", ".atomic"))]
    if wrong:
        fail(f"ledger shows non-kernel or atomic forms on the streamed "
             f"path: {wrong}")
    return got


def crash_plan():
    """Phase 29's two crashing subprocesses, one a reader."""
    lanes, cmds = [], []
    for reader, point, other in (("native", "chunk_read", "chunk_encode"),
                                 ("python", "chunk_encode", "chunk_read")):
        out = os.path.join(WORK, f"rafo9s_resumed_{reader}")
        reg = os.path.join(WORK, f"rafo9s_resumed_registry_{reader}")
        ck = os.path.join(WORK, f"rafo9s_resumed_ck_{reader}")
        # a checkpoint every block: the resume re-reads no block whose bad
        # records were already quarantined
        args = rafo9s_job(reg, ck, out,
                          ("-Ddtb.streaming.checkpoint.blocks=1",))
        flag = ["--python-reader"] if reader == "python" else []
        env = dict(os.environ, AVENIR_TPU_FAULTS=f"{point}@3=raise:"
                   f"RuntimeError,{other}@*=raise:RuntimeError")
        cmds.append((cli_cmd(os.path.join(WORK, f"crash_{reader}.json"),
                             flag + args), env))
        lanes.append((reader, point, out, reg, ck, args))
    return {"lanes": lanes, "cmds": cmds,
            "gates": [os.path.join(WORK, f"gate_crash_{reader}")
                      for reader, *_ in lanes]}


def stream_resume(plan, stage):
    """Phase 29, on each reader: a crash at block 3 in a subprocess (the
    native reader's ``chunk_read``, the Python reader's ``chunk_encode``;
    the other point armed too, so it must never fire; the two readers'
    subprocesses side by side, :func:`crash_plan`), then --resume on the
    same reader, against the rafo9s fixture."""
    from avenir_tpu_torch.core.checkpoint import CheckpointManager
    from avenir_tpu_torch.monitor.baseline import load_baseline
    from avenir_tpu_torch.serving.registry import ModelRegistry
    phase("29 streamed crash (chunk_read@3 native, chunk_encode@3 python) "
          "and --resume == rafo9s")
    with open(os.path.join(RAFO9S, "train_counters.json")) as fh:
        total = json.load(fh)["Random forest"]["BaselineRows"]
    lanes = plan["lanes"]
    # the two readers' crashing subprocesses run side by side
    crashes = stage.run()
    for (reader, point, out, reg, ck, args), crash in zip(lanes, crashes):
        rc, _, stderr, crash_s = crash
        if rc == 0 or f"injected fault: {point}@3" not in stderr:
            fail(f"the faulted {reader} run did not crash at {point}@3 (rc "
                 f"{rc}): {stderr[-2000:]}")
        step, _, meta = CheckpointManager(ck).restore()
        if meta["ingest_complete"] or step != 3:
            fail(f"the crashed {reader} run's newest checkpoint is step "
                 f"{step}, {meta}; want step 3, ingest incomplete")
        t0 = time.perf_counter()
        if reader == "python":
            with python_reader():
                run_cli(args[:-2] + ["--resume"] + args[-2:])
        else:
            run_cli(args[:-2] + ["--resume"] + args[-2:])
        resume_s = time.perf_counter() - t0
        same_rafo9s(out, reg, f"rafo9s crash + --resume ({reader} reader)",
                    files=("meta.json", "quantized.json"),
                    arrays=("arrays.npz", "quantized.npz"))
        with open(out + ".counters.json") as fh:
            counters = json.load(fh)
        tail = total - int(meta["n_rows"])
        base = load_baseline(ModelRegistry(reg), "rafo9s", 1)
        if counters["Checkpoint"] != {"ResumedFromStep": 3,
                                      "ResumedSourceRows":
                                          meta["source_rows_done"]} \
                or base.n_rows != tail:
            fail(f"resumed {reader} run: Checkpoint counters "
                 f"{counters['Checkpoint']}, baseline rows {base.n_rows}; "
                 f"want step 3 and {tail} rows")
        readers = counters["IngestReaders"]
        if reader == "native" and any(k.startswith("python") for k in
                                      readers) or \
                reader == "python" and any(k.startswith("native") for k in
                                           readers):
            fail(f"resumed {reader} run read with another reader: "
                 f"{readers}")
        print(f"{reader} reader: crashed subprocess {crash_s:.2f} s wall "
              f"(rc {rc}, newest step 3, {meta['n_rows']} "
              f"rows); resumed run {resume_s:.2f} s wall from source row "
              f"{meta['source_rows_done']}; baseline of the {tail} re-read "
              f"rows; IngestReaders {readers}", flush=True)


def write_hangup_csv(table, path):
    """A call_hangup.json CSV of a hangup_table."""
    issues = np.asarray(["billing", "outage", "upgrade", "other"])
    cols = table.columns
    ids = np.char.add("K", np.char.zfill(
        np.arange(table.n_rows).astype(str), 7))
    text = [ids, issues[cols[1]]] + [cols[o].astype(np.int64).astype(str)
                                     for o in (2, 3, 4)] \
        + [np.asarray(["F", "T"])[cols[5]]]
    rows = text[0]
    for c in text[1:]:
        rows = np.char.add(np.char.add(rows, ","), c)
    with open(path, "w") as fh:
        fh.write("\n".join(rows.tolist()) + "\n")


def proc_status_kb(key):
    """A ``/proc/self/status`` size field in kB (VmRSS)."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return None


def scale_child(mode, csv, out):
    """One phase-30 training run in its own process (phase 37's
    ``stream_cache`` too: the stream served from the columnar sidecar):
    prints one JSON line (stats, wall, launches, peak RSS, the ledger's
    IngestReaders) and writes the trees and baseline counts under
    ``out``."""
    import resource
    import torch
    from avenir_tpu_torch.cli.jobs import _tree_params
    from avenir_tpu_torch.core.config import load_config
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import (iter_csv_chunks, load_csv,
                                             prefetch_chunks)
    from avenir_tpu_torch.io.colcache import CachePolicy
    from avenir_tpu_torch.kernels import histogram
    from avenir_tpu_torch.models.forest import (ForestParams, build_forest,
                                                build_forest_from_stream)
    from avenir_tpu_torch.monitor.baseline import BaselineBuilder
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    cfg = load_config(os.path.join(RES, "rafo.properties"))
    params = ForestParams(tree=_tree_params(cfg),
                          num_trees=cfg.get_int("dtb.num.trees"),
                          seed=cfg.get_int("dtb.random.seed"))
    fs = FeatureSchema.load(os.path.join(RES, "call_hangup.json"))
    dev = torch.device("cuda", 0)
    # warm-up: CUDA context and kernel libraries before the timed run
    warm = hangup_table(np.random.default_rng(1), 4096, fs)
    build_forest(warm, params, device=dev)
    BaselineBuilder(fs, device=dev).update(warm).finalize()
    torch.cuda.synchronize()
    await_gate()
    rss_before = proc_status_kb("VmRSS")
    # the job's peak RSS, sampled every 5 ms (ru_maxrss is the CUDA
    # start-up's peak, the same in both children)
    peak = [rss_before]
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], proc_status_kb("VmRSS"))
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    histogram.launches = histogram.mma_launches = 0
    histogram.bin_counts_launches = 0
    stats = {}
    t0 = time.perf_counter()
    base = BaselineBuilder(fs, device=dev)
    with transfer_ledger() as led:
        if mode.startswith("stream"):
            cache = CachePolicy("use", stats=stats) \
                if mode == "stream_cache" else None
            blocks = prefetch_chunks(iter_csv_chunks(
                csv, fs, chunk_rows=STREAM_SCALE_BLOCK,
                use_native=mode != "stream_python", cache=cache),
                stats=stats, consumer_wait_key=None)
            trees = build_forest_from_stream(blocks, fs, params, device=dev,
                                             stats=stats, baseline=base,
                                             fuse=mode != "stream_unfused")
        else:
            table = load_csv(csv, fs)
            base.update(table)
            t1 = time.perf_counter()
            trees = build_forest(table, params, device=dev)
            stats = {"load_s": t1 - t0, "build_s": time.perf_counter() - t1}
        counts = base.finalize().counts
        torch.cuda.synchronize()
    stats["wall_s"] = time.perf_counter() - t0
    done.set()
    sampler.join()
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "trees.json"), "w") as fh:
        json.dump([t.to_json() for t in trees], fh)
    np.save(os.path.join(out, "baseline_counts.npy"), counts)
    print(json.dumps({"mode": mode, **stats,
                      "ingest": led.ingest_snapshot(),
                      "b1": histogram.launches,
                      "b1_mma": histogram.mma_launches,
                      "b4": histogram.bin_counts_launches,
                      "rss_before_kb": rss_before,
                      "job_peak_rss_kb": peak[0],
                      "max_rss_kb": resource.getrusage(
                          resource.RUSAGE_SELF).ru_maxrss}), flush=True)


STREAM_SCALE_MODES = ("stream", "stream_unfused", "stream_python", "mono")


def scale_plan(csv):
    """Phase 30's three ``--scale-child`` processes over ``csv``."""
    outs = {mode: os.path.join(WORK, f"stream_scale_{mode}")
            for mode in STREAM_SCALE_MODES}
    return {"csv": csv, "outs": outs,
            "cmds": [([sys.executable, os.path.abspath(__file__),
                       "--scale-child", mode, csv, outs[mode]],
                      dict(os.environ)) for mode in STREAM_SCALE_MODES],
            "gates": [os.path.join(WORK, f"gate_scale_{mode}")
                      for mode in STREAM_SCALE_MODES]}


def stream_scale(fs, plan, stage):
    """Phase 30: one STREAM_SCALE_ROWS-row CSV trained streamed on the native
    reader (fused and unfused), streamed on the Python reader and
    monolithic (the native
    whole-file load), each in its own process (:func:`scale_plan`), one
    after another.  Returns the printed numbers, the trees, the baseline
    counts and the CSV's path."""
    import resource
    phase(f"30 scale: streamed (native and Python reader) vs monolithic "
          f"rafo forest over a {STREAM_SCALE_ROWS:,}-row CSV")
    csv = plan["csv"]
    t0 = time.perf_counter()
    write_hangup_csv(hangup_table(np.random.default_rng(20261018),
                                  STREAM_SCALE_ROWS, fs), csv)
    print(f"wrote {STREAM_SCALE_ROWS:,} rows "
          f"({os.path.getsize(csv) / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs = {}
    for j, mode in enumerate(STREAM_SCALE_MODES):
        out = plan["outs"][mode]
        rc, so, se, _ = stage.run([j])[0]
        if rc != 0:
            fail(f"phase 30 {mode} child failed (rc {rc}): {se[-3000:]}")
        runs[mode] = json.loads(so.strip().splitlines()[-1])
        runs[mode]["children_max_rss_kb"] = resource.getrusage(
            resource.RUSAGE_CHILDREN).ru_maxrss
        runs[mode]["rows_per_s"] = STREAM_SCALE_ROWS / runs[mode]["wall_s"]
        with open(os.path.join(out, "trees.json")) as fh:
            runs[mode]["trees"] = fh.read()
        runs[mode]["counts"] = np.load(os.path.join(out,
                                                    "baseline_counts.npy"))
    st = runs["stream"]
    trees, counts = st.pop("trees"), st.pop("counts")
    for mode in ("stream_unfused", "stream_python", "mono"):
        if runs[mode].pop("trees") != trees:
            fail(f"phase 30: {mode} trees differ from the native stream's")
        if not np.array_equal(runs[mode].pop("counts"), counts):
            fail(f"phase 30: {mode} baseline differs from the native "
                 f"stream's")
    blocks = -(-STREAM_SCALE_ROWS // STREAM_SCALE_BLOCK)
    for name, r in runs.items():
        if r["b1"] <= 0 or r["b1_mma"] != r["b1"]:
            fail(f"phase 30 {name}: {r['b1']} B1 launches, {r['b1_mma']} "
                 f"in the mma form; all must be")
    want_b4 = {"stream": blocks, "stream_unfused": blocks,
               "stream_python": blocks, "mono": 1}
    native = {"native.blocks": blocks, "native.rows": STREAM_SCALE_ROWS}
    want_ingest = {
        "stream": native, "stream_unfused": native,
        "stream_python": {"python.blocks": blocks,
                          "python.rows": STREAM_SCALE_ROWS,
                          "python.asked": blocks},
        "mono": {"native.blocks": 1, "native.rows": STREAM_SCALE_ROWS}}
    for name, r in runs.items():
        if r["b4"] != want_b4[name]:
            fail(f"phase 30 {name}: {r['b4']} B4 launches, want "
                 f"{want_b4[name]}")
        if r["ingest"] != want_ingest[name]:
            fail(f"phase 30 {name}: IngestReaders {r['ingest']}, want "
                 f"{want_ingest[name]}")
    print("streamed (both readers) and monolithic trees and baselines "
          "identical; every block read by the reader asked for", flush=True)
    for name in ("stream", "stream_unfused", "stream_python"):
        r = runs[name]
        print(f"{name}: {r['rows_per_s']:,.0f} rows/s, parse_s "
              f"{r['parse_s']:.3f}, transfer_s {r['transfer_s']:.3f}, "
              f"ingest_compute_s {r['ingest_compute_s']:.3f} of "
              f"ingest_wall_s {r['ingest_wall_s']:.3f}, build_s "
              f"{r['build_s']:.3f}", flush=True)
    print(json.dumps({"stream_scale": runs}), flush=True)
    return runs, trees, counts, csv


# --------------------------------------------------------------------------
# phases 31-36: the multi-process lanes (each process a subprocess)
# --------------------------------------------------------------------------

GATE_KEY = "CHIP_SMOKE_GATE"
LANE_KEYS = ("AVENIR_TPU_SHARD", "AVENIR_TPU_ALLREDUCE_DIR",
             "AVENIR_TPU_FAULTS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
             "MASTER_ADDR", "MASTER_PORT", GATE_KEY)


def lane_env(extra, one_card):
    """A child's environment: none of the parent's lane keys, the given
    ones, and with ``one_card`` only the first visible card."""
    env = {k: v for k, v in os.environ.items() if k not in LANE_KEYS}
    env.setdefault("AVENIR_TPU_ALLREDUCE_TIMEOUT_S", "120")
    if one_card:
        first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        env["CUDA_VISIBLE_DEVICES"] = first or "0"
    env.update(extra)
    return env


def cli_child(counts_path, *args):
    """One CLI job in its own process (``--cli-child``): the launch counts
    zeroed just before ``cli.run.main`` and written to ``counts_path``
    just after; exits with the job's code (a raised job exits non-zero).
    A first argument ``--python-reader`` runs the job on the Python
    reader (:class:`python_reader`)."""
    from avenir_tpu_torch.cli import run as cli_run
    args = list(args)
    python = args[:1] == ["--python-reader"]
    if python:
        args = args[1:]
    await_gate(cuda=True)
    zero_launches()
    t0 = time.perf_counter()
    if python:
        with python_reader():
            rc = cli_run.main(args)
    else:
        rc = cli_run.main(args)
    wall = time.perf_counter() - t0
    with open(counts_path, "w") as fh:
        json.dump({**launch_counts(), "wall_s": wall}, fh)
    sys.exit(rc)


def zero_launches():
    """Every kernel wrapper's launch count set to 0."""
    from avenir_tpu_torch.kernels import histogram, topk, vote
    from avenir_tpu_torch.utils import threefry
    threefry.launches = 0
    histogram.launches = histogram.mma_launches = 0
    histogram.bin_counts_launches = 0
    vote.launches = vote.quantized_launches = vote.table_launches = 0
    topk.launches = topk.merge_launches = topk.split_merge_launches = 0


def launch_counts():
    """The kernel wrappers' launch counts since :func:`zero_launches`."""
    from avenir_tpu_torch.kernels import histogram, topk, vote
    from avenir_tpu_torch.utils import threefry
    return {"threefry": threefry.launches,
            "b1": histogram.launches, "b1_mma": histogram.mma_launches,
            "b4": histogram.bin_counts_launches,
            "b2": vote.launches, "b3": vote.quantized_launches,
            "b5": topk.launches, "b7_merge": topk.merge_launches,
            "b5_split_merge": topk.split_merge_launches}


def await_gate(cuda=False):
    """In a child started with a gate (``CHIP_SMOKE_GATE=<path>``, see
    :class:`Children`): with ``cuda`` the card's context made first; then
    ``<path>.ready`` written and the parent's ``<path>.go`` waited for, so
    that what the child does next runs beside no other process's start-up.
    The child exits if its parent goes away first.  Without a gate it
    returns at once."""
    gate = os.environ.get(GATE_KEY)
    if not gate:
        return
    if cuda:
        import torch
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
    parent = os.getppid()
    open(gate + ".ready", "w").close()
    deadline = time.monotonic() + 900
    while not os.path.exists(gate + ".go"):
        if os.getppid() != parent or time.monotonic() > deadline:
            sys.exit(f"no go at {gate}")
        time.sleep(0.005)


class Children:
    """Processes started at once, each waited for on its own thread.  A
    process given a gate (a path; the child calls :func:`await_gate` once
    it has started up) holds there until :meth:`release` lets it go: a
    phase starts the processes of all its stages together and lets each
    stage go when the one before it has exited, so a stage pays no
    start-up of its own and runs beside no other process's start-up."""

    def __init__(self, cmds, timeout=300, gates=None):
        self.gates = list(gates) if gates else [None] * len(cmds)
        self.t0 = time.perf_counter()
        self.procs = []
        for (argv, env), gate in zip(cmds, self.gates):
            if gate is not None:
                for f in (gate + ".ready", gate + ".go"):
                    if os.path.exists(f):
                        os.remove(f)
                env = {**env, GATE_KEY: gate}
            self.procs.append(subprocess.Popen(
                argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        _CHILD_PROCS.extend(self.procs)
        self.out = [None] * len(self.procs)
        self.waiters = [threading.Thread(target=self._wait, args=(i, timeout),
                                         daemon=True)
                        for i in range(len(self.procs))]
        for w in self.waiters:
            w.start()

    def _wait(self, i, timeout):
        p = self.procs[i]
        try:
            so, se = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            se += f"\n[killed after {timeout} s]"
        self.out[i] = (p.returncode, so, se, time.perf_counter())

    def release(self, idx):
        """Once every gated process is ready (or has exited), let the
        processes ``idx`` go; returns the moment they went."""
        deadline = time.monotonic() + 600
        while not all(g is None or os.path.exists(g + ".ready")
                      or p.poll() is not None
                      for g, p in zip(self.gates, self.procs)):
            if time.monotonic() > deadline:
                fail("a gated child process never became ready")
            time.sleep(0.005)
        t = time.perf_counter()
        for i in idx:
            open(self.gates[i] + ".go", "w").close()
        return t

    def wait(self, idx=None, since=None):
        """(returncode, stdout, stderr, seconds from ``since`` — the start
        unless given — to the exit) of the processes ``idx`` (all unless
        given), once they have exited."""
        idx = range(len(self.procs)) if idx is None else idx
        for i in idx:
            self.waiters[i].join()
        base = self.t0 if since is None else since
        return [(*self.out[i][:3], self.out[i][3] - base) for i in idx]


def run_children(cmds, timeout=300):
    """Start every (argv, env) at once and wait for all, each on its own
    thread; returns their (returncode, stdout, stderr, seconds from the
    start to that process's exit).  A process still running after
    ``timeout`` seconds is killed and reported with a non-zero code."""
    return Children(cmds, timeout).wait()


class Stage:
    """Some of a :class:`Children`'s gated processes: one phase's."""

    def __init__(self, kids, idx):
        self.kids, self.idx = kids, idx

    def run(self, sub=None):
        """Let the processes go (all, or those at the positions ``sub``)
        and wait for them: their (returncode, stdout, stderr, seconds from
        the go to the exit)."""
        idx = self.idx if sub is None else [self.idx[j] for j in sub]
        went = self.kids.release(idx)
        return self.kids.wait(idx, since=went)


def held(stage, what):
    """Wait until every process of ``stage``'s group is at its gate and
    print how many there are and the host memory still available."""
    stage.kids.release([])
    with open("/proc/meminfo") as fh:
        avail = next(int(ln.split()[1]) for ln in fh
                     if ln.startswith("MemAvailable:"))
    print(f"{what}: {len(stage.kids.procs)} processes at their gates, "
          f"{avail / 2 ** 20:.1f} GiB of host memory available", flush=True)


def start_stages(plans, timeout=900):
    """Start every plan's processes (a plan: a dict with ``cmds`` and
    their ``gates``) at once, each held at its gate; one :class:`Stage` a
    plan."""
    kids = Children([c for p in plans for c in p["cmds"]], timeout,
                    [g for p in plans for g in p["gates"]])
    stages, at = [], 0
    for p in plans:
        stages.append(Stage(kids, list(range(at, at + len(p["cmds"])))))
        at += len(p["cmds"])
    return stages


def cli_cmd(counts, args):
    return [sys.executable, os.path.abspath(__file__), "--cli-child", counts,
            *args]


def counter_dump(stdout):
    """A job's printed Hadoop-style counter dump as {group: {name: v}}."""
    groups, cur = {}, None
    for line in stdout.splitlines():
        if line.startswith("\t") and cur is not None and "=" in line:
            k, _, v = line.strip().partition("=")
            groups[cur][k] = int(v)
        elif line and not line.startswith(("\t", "[", "{")):
            cur = line.strip()
            groups.setdefault(cur, {})
    return groups


def read_json(path):
    with open(path) as fh:
        return json.load(fh)


def all_ok(res, what):
    for i, (rc, _, se, _) in enumerate(res):
        if rc != 0:
            fail(f"{what}: process {i} exited {rc}: {se[-3000:]}")


def same_trees(out, what):
    for t in range(9):
        same_bytes(os.path.join(out, f"tree_{t}.json"),
                   os.path.join(RAFO9S, f"tree_{t}.json"), f"{what} tree {t}")


def lane_plan(layout, one_card):
    """Phase 31's two processes: the rafo9s job over AVENIR_TPU_SHARD=i/2
    and a file transport."""
    base = os.path.join(WORK, f"lane_{layout.replace(' ', '_')}")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg, ck, rdir = (os.path.join(base, d) for d in ("reg", "ck", "reduce"))
    outs = [os.path.join(base, f"out{i}") for i in range(2)]
    counts = [os.path.join(base, f"counts{i}.json") for i in range(2)]
    return {"layout": layout, "reg": reg, "outs": outs, "counts": counts,
            "cmds": [(cli_cmd(counts[i], rafo9s_job(reg, ck, outs[i])),
                      lane_env({"AVENIR_TPU_SHARD": f"{i}/2",
                                "AVENIR_TPU_ALLREDUCE_DIR": rdir},
                               one_card)) for i in range(2)],
            "gates": [os.path.join(base, f"gate{i}") for i in range(2)]}


def shard_lane(plan, stage):
    """Phase 31: the rafo9s job over two AVENIR_TPU_SHARD processes on the
    card and a file transport (:func:`lane_plan`).  Returns the
    per-process launch counts."""
    layout, reg, outs, counts = (plan[k] for k in ("layout", "reg", "outs",
                                                   "counts"))
    res = stage.run()
    all_ok(res, "shard lane")
    got = [read_json(c) for c in counts]
    dumps = [counter_dump(so) for _, so, _, _ in res]
    for i in range(2):
        same_trees(outs[i], f"shard lane {i}/2")
    version = os.path.join("rafo9s", "v_000001")
    for f in ("meta.json", "baseline.json", "quantized.json"):
        same_bytes(os.path.join(reg, version, f),
                   os.path.join(RAFO9S, "registry", version, f),
                   f"shard lane published {f}")
    for f in ("arrays.npz", "baseline.npz", "quantized.npz"):
        same_arrays(os.path.join(reg, version, f),
                    os.path.join(RAFO9S, "registry", version, f),
                    f"shard lane published {f}")
    q = b"".join(open(os.path.join(o, "_quarantine", "part-q-00000"),
                      "rb").read() for o in outs)
    if q != open(os.path.join(RAFO9S, "part-q-00000"), "rb").read():
        fail("shard lane: the shards' quarantine files do not add up to "
             "the fixture's part-q-00000")
    want = read_json(os.path.join(RAFO9S, "train_counters.json"))
    for name, total in want["BadRecords"].items():
        if sum(d["BadRecords"][name] for d in dumps) != total:
            fail(f"shard lane BadRecords {name}: "
                 f"{[d['BadRecords'] for d in dumps]} do not sum to {total}")
    if dumps[0]["Random forest"] != want["Random forest"]:
        fail(f"shard lane Random forest counters {dumps[0]['Random forest']}"
             f" != {want['Random forest']}")
    for i, g in enumerate(got):
        if g["b1"] <= 0 or g["b1_mma"] != g["b1"]:
            fail(f"shard lane {i}: {g['b1']} B1 launches, {g['b1_mma']} in "
                 f"the mma form; all must be")
    blocks = [3, 4]      # 777-row blocks 0-2 and 3-6 of 5,000 source rows
    if [g["b4"] for g in got] != blocks:
        fail(f"shard lane B4 launches {[g['b4'] for g in got]} != {blocks}")
    if got[0]["b2"] <= 0 or got[0]["b3"] <= 0 or got[1]["b2"] or got[1]["b3"]:
        fail(f"shard lane: B2/B3 must launch in shard 0's quantize publish "
             f"only: {got}")
    allreduces = [d["Collectives"]["AllReduces"] for d in dumps]
    print(f"shard lane ({layout}): walls {[round(r[3], 2) for r in res]} s; "
          f"B1 launches {[g['b1'] for g in got]} (all mma), B4 "
          f"{[g['b4'] for g in got]}, B2 {[g['b2'] for g in got]}, B3 "
          f"{[g['b3'] for g in got]}; Collectives.AllReduces {allreduces}; "
          f"BadRecords {[d['BadRecords'] for d in dumps]}", flush=True)
    return {"launches": got, "allreduces": allreduces,
            "wall_s": [r[3] for r in res]}


def resume_plan():
    """Phase 32's eight processes (:func:`shard_resume`): each reader's
    two crashing shards, then its two resumed ones."""
    lanes = []
    for reader, point in (("native", "chunk_read"),
                          ("python", "chunk_encode")):
        base = os.path.join(WORK, f"lane_resume_{reader}")
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        reg, ck, rdir = (os.path.join(base, d)
                         for d in ("reg", "ck", "reduce"))
        outs = [os.path.join(base, f"out{i}") for i in range(2)]
        counts = [os.path.join(base, f"counts{i}.json") for i in range(2)]
        flag = ["--python-reader"] if reader == "python" else []
        lanes.append((reader, point, reg, ck, rdir, outs, counts, flag))
    every = ("-Ddtb.streaming.checkpoint.blocks=1",)
    cmds, gates = [], []
    for reader, point, reg, ck, rdir, outs, counts, flag in lanes:
        envs = [{"AVENIR_TPU_SHARD": f"{i}/2",
                 "AVENIR_TPU_ALLREDUCE_DIR": rdir,
                 "AVENIR_TPU_ALLREDUCE_TIMEOUT_S": "5"} for i in range(2)]
        envs[1]["AVENIR_TPU_FAULTS"] = f"{point}@2=raise:RuntimeError"
        cmds += [(cli_cmd(counts[i], flag + rafo9s_job(reg, ck, outs[i],
                                                        every)),
                  lane_env(envs[i], True)) for i in range(2)]
        gates += [os.path.join(WORK, f"lane_resume_{reader}", f"gate_crash{i}")
                  for i in range(2)]
    for reader, point, reg, ck, rdir, outs, counts, flag in lanes:
        cmds += [(cli_cmd(counts[i], flag + rafo9s_job(
            reg, ck, outs[i], every + ("--resume",))),
            lane_env({"AVENIR_TPU_SHARD": f"{i}/2",
                      "AVENIR_TPU_ALLREDUCE_DIR": rdir}, True))
            for i in range(2)]
        gates += [os.path.join(WORK, f"lane_resume_{reader}",
                               f"gate_resume{i}") for i in range(2)]
    return {"lanes": lanes, "cmds": cmds, "gates": gates}


def shard_resume(plan, stage):
    """Phase 32, on each reader: shard 1 crashes at its third block (the
    native reader's ``chunk_read@2``, the Python reader's
    ``chunk_encode@2``); shard 0 fails at the next collective within a 5 s
    deadline; --resume on both gives the fixture's trees.  The two
    readers' lanes run side by side (their own directories and reduce
    dirs): four processes for the crashes, then four for the resumes
    (:func:`resume_plan`)."""
    phase("32 shard lane crash (shard 1 at chunk_read@2 native, "
          "chunk_encode@2 python) and --resume")
    lanes = plan["lanes"]
    res = stage.run(range(2 * len(lanes)))
    for j, (reader, point, *_rest) in enumerate(lanes):
        (rc0, _, se0, t0_s), (rc1, _, se1, t1_s) = res[2 * j:2 * j + 2]
        if rc1 == 0 or f"injected fault: {point}@2" not in se1:
            fail(f"shard 1 ({reader}) did not crash at {point}@2 (rc "
                 f"{rc1}): {se1[-2000:]}")
        if rc0 == 0 or "within 5.0s" not in se0:
            fail(f"shard 0 ({reader}) did not fail at its collective within "
                 f"the 5 s deadline (rc {rc0}): {se0[-2000:]}")
        print(f"{reader} crash: shard 1 exited {rc1} {t1_s:.2f} s after its "
              f"go (injected fault), shard 0 exited {rc0} "
              f"{t0_s - t1_s:.2f} s after it (missing peer past the 5 s "
              f"deadline)", flush=True)
    res_all = stage.run(range(2 * len(lanes), 4 * len(lanes)))
    for j, (reader, point, reg, ck, rdir, outs, counts, flag) in \
            enumerate(lanes):
        res = res_all[2 * j:2 * j + 2]
        all_ok(res, f"shard lane --resume ({reader})")
        for i in range(2):
            same_trees(outs[i], f"resumed shard {i}/2 ({reader})")
        dumps = [counter_dump(so) for _, so, _, _ in res]
        other = "python" if reader == "native" else "native"
        for d in dumps:
            if any(k.startswith(other) for k in d.get("IngestReaders", {})):
                fail(f"resumed {reader} shard read with the {other} reader: "
                     f"{d['IngestReaders']}")
        print(f"{reader} --resume on both: walls "
              f"{[round(r[3], 2) for r in res]} s; Checkpoint counters "
              f"{[d.get('Checkpoint') for d in dumps]}; B4 launches "
              f"{[read_json(c)['b4'] for c in counts]} (re-read blocks); "
              f"IngestReaders {[d.get('IngestReaders') for d in dumps]}",
              flush=True)


def shard_child(index, count, csv, out, rdir, reader="native"):
    """One process of phase 33 (``--shard-child``): the scale CSV's
    row-range shard trained streamed on ``reader`` (native or python) with
    a teed baseline, the counts summed with the peer through the file
    transport.  Prints one JSON line and writes the trees and baseline
    counts under ``out``."""
    import torch
    from avenir_tpu_torch.cli.jobs import _tree_params
    from avenir_tpu_torch.core.config import load_config
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import iter_csv_chunks, prefetch_chunks
    from avenir_tpu_torch.kernels import histogram
    from avenir_tpu_torch.models.forest import (ForestParams, build_forest,
                                                build_forest_from_stream)
    from avenir_tpu_torch.monitor.baseline import (BaselineBuilder,
                                                   allreduce_partials)
    from avenir_tpu_torch.parallel.collectives import AllReducer
    from avenir_tpu_torch.parallel.distributed import ShardSpec
    from avenir_tpu_torch.utils.tracing import LayerProfile, transfer_ledger
    index, count = int(index), int(count)
    cfg = load_config(os.path.join(RES, "rafo.properties"))
    params = ForestParams(tree=_tree_params(cfg),
                          num_trees=cfg.get_int("dtb.num.trees"),
                          seed=cfg.get_int("dtb.random.seed"))
    fs = FeatureSchema.load(os.path.join(RES, "call_hangup.json"))
    dev = torch.device("cuda", 0)
    warm = hangup_table(np.random.default_rng(1), 4096, fs)
    build_forest(warm, params, device=dev)
    BaselineBuilder(fs, device=dev).update(warm).finalize()
    torch.cuda.synchronize()
    await_gate()
    histogram.launches = histogram.mma_launches = 0
    histogram.bin_counts_launches = 0
    stats = {}
    profile = LayerProfile(device=dev)
    red = AllReducer(spec=ShardSpec(index, count), name="scale",
                     transport_dir=rdir, timeout_s=300)
    t0 = time.perf_counter()
    base = BaselineBuilder(fs, device=dev)
    with transfer_ledger() as led:
        blocks = prefetch_chunks(iter_csv_chunks(
            csv, fs, chunk_rows=STREAM_SCALE_BLOCK, shard=(index, count),
            use_native=reader == "native"),
            stats=stats, consumer_wait_key=None)
        trees = build_forest_from_stream(blocks, fs, params, device=dev,
                                         stats=stats, baseline=base,
                                         reducer=red, profile=profile)
        counts = allreduce_partials(base, reducer=red).finalize().counts
    torch.cuda.synchronize()
    stats["wall_s"] = time.perf_counter() - t0
    allreduce = [lv.get("allreduce", 0.0) * 1e3 for lv in profile.levels]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "trees.json"), "w") as fh:
        json.dump([t.to_json() for t in trees], fh)
    np.save(os.path.join(out, "baseline_counts.npy"), counts)
    print(json.dumps({"shard": index, "reader": reader, **stats,
                      "ingest": led.ingest_snapshot(),
                      "b1": histogram.launches,
                      "b1_mma": histogram.mma_launches,
                      "b4": histogram.bin_counts_launches,
                      "allreduces": led.allreduces,
                      "allreduce_bytes": led.allreduce_bytes,
                      "allreduce_ms_per_level": allreduce,
                      "levels": len(profile.levels)}), flush=True)


def scale2_plan(csv):
    """Phase 33's four processes: on each reader two row-range shards of
    the scale CSV (``--shard-child``)."""
    cmds, gates = [], []
    for reader in ("native", "python"):
        base = os.path.join(WORK, f"shard_scale_{reader}")
        shutil.rmtree(base, ignore_errors=True)
        os.makedirs(base)
        rdir = os.path.join(base, "reduce")
        cmds += [([sys.executable, os.path.abspath(__file__), "--shard-child",
                   str(i), "2", csv, os.path.join(base, f"out{i}"), rdir,
                   reader], lane_env({}, True)) for i in range(2)]
        gates += [os.path.join(base, f"gate{i}") for i in range(2)]
    return {"cmds": cmds, "gates": gates}


def shard_scale(single, trees, counts, stage):
    """Phase 33: phase 30's CSV over two processes on the card, on the
    native reader and then on the Python reader, against phase 30's one
    streamed process on the same reader; each reader's pair is let go
    alone (:func:`scale2_plan`)."""
    phase(f"33 scale: the {STREAM_SCALE_ROWS:,}-row CSV over 2 processes "
          f"(row-range shards, {STREAM_SCALE_BLOCK:,}-row blocks), native "
          f"and Python reader")
    held(stage, "phases 33-35 and 37-41")
    blocks = -(-STREAM_SCALE_ROWS // STREAM_SCALE_BLOCK)
    summary = {}
    lanes = (("native", single["stream"]), ("python", single["stream_python"]))
    for j, (reader, one) in enumerate(lanes):
        base = os.path.join(WORK, f"shard_scale_{reader}")
        res = stage.run([2 * j, 2 * j + 1])
        all_ok(res, f"phase 33 ({reader})")
        runs = [json.loads(so.strip().splitlines()[-1])
                for _, so, _, _ in res]
        for i, r in enumerate(runs):
            with open(os.path.join(base, f"out{i}", "trees.json")) as fh:
                if fh.read() != trees:
                    fail(f"phase 33 {reader} shard {i}: trees differ from "
                         f"one process's")
            if not np.array_equal(np.load(os.path.join(
                    base, f"out{i}", "baseline_counts.npy")), counts):
                fail(f"phase 33 {reader} shard {i}: baseline differs from "
                     f"one process's")
            if r["b1"] <= 0 or r["b1_mma"] != r["b1"]:
                fail(f"phase 33 {reader} shard {i}: {r['b1']} B1 launches, "
                     f"{r['b1_mma']} mma")
            if r["ingest"].get(f"{reader}.blocks") != r["b4"] or \
                    any(not k.startswith(reader) for k in r["ingest"]):
                fail(f"phase 33 {reader} shard {i}: IngestReaders "
                     f"{r['ingest']} for {r['b4']} blocks")
        if sum(r["b4"] for r in runs) != blocks:
            fail(f"phase 33 ({reader}): B4 launches {[r['b4'] for r in runs]}"
                 f" do not sum to the {blocks} blocks")
        wall = max(r["wall_s"] for r in runs)
        summary[reader] = {"rows_per_s": STREAM_SCALE_ROWS / wall,
                           "one_process_rows_per_s": one["rows_per_s"],
                           "one_process_parse_s": one["parse_s"],
                           "shards": runs}
        print(f"{reader} reader: 2 processes {STREAM_SCALE_ROWS / wall:,.0f} "
              f"rows/s against one process's {one['rows_per_s']:,.0f}; "
              f"shards' parse_s {[round(r['parse_s'], 3) for r in runs]} "
              f"(one process {one['parse_s']:.3f}); trees and baseline "
              f"identical to one process's", flush=True)
    print(json.dumps({"shard_scale": summary}), flush=True)
    return summary


def cache_child(steps, csv, out):
    """Phase 37's jobs in one process (``--cache-child``), one after
    another, ``steps`` a comma list: each policy (after a warm-up) the
    randomForestBuilder CLI over phase 30's CSV, streamed at 262,144-row
    blocks with a published baseline (B4 every block) and
    ``dtb.streaming.cache.policy=<policy>`` into ``<out>_<policy>``,
    launch counts zeroed just before and read just after; the step
    ``stream_cache`` phase 30's streamed build over the sidecar
    (:func:`scale_child`, into ``<out>_stream``).  Prints one JSON line a
    step: wall, launches and the job's counters."""
    import torch
    from avenir_tpu_torch.cli import run as cli_run
    from avenir_tpu_torch.cli.jobs import _tree_params
    from avenir_tpu_torch.core.config import load_config
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.kernels import histogram
    from avenir_tpu_torch.models.forest import ForestParams, build_forest
    from avenir_tpu_torch.monitor.baseline import BaselineBuilder
    cfg = load_config(os.path.join(RES, "rafo.properties"))
    params = ForestParams(tree=_tree_params(cfg),
                          num_trees=cfg.get_int("dtb.num.trees"),
                          seed=cfg.get_int("dtb.random.seed"))
    fs = FeatureSchema.load(os.path.join(RES, "call_hangup.json"))
    dev = torch.device("cuda", 0)
    warm = hangup_table(np.random.default_rng(1), 4096, fs)
    build_forest(warm, params, device=dev)
    BaselineBuilder(fs, device=dev).update(warm).finalize()
    torch.cuda.synchronize()
    await_gate()
    for policy in steps.split(","):
        if policy == "stream_cache":
            scale_child(policy, csv, out + "_stream")
            continue
        dest = f"{out}_{policy}"
        histogram.launches = histogram.mma_launches = 0
        histogram.bin_counts_launches = 0
        t0 = time.perf_counter()
        rc = cli_run.main([
            "randomForestBuilder",
            f"-Dconf.path={os.path.join(RES, 'rafo.properties')}",
            f"-Ddtb.feature.schema.file.path="
            f"{os.path.join(RES, 'call_hangup.json')}",
            "-Ddtb.streaming.ingest=true",
            f"-Ddtb.streaming.block.rows={STREAM_SCALE_BLOCK}",
            f"-Ddtb.streaming.cache.policy={policy}",
            f"-Ddtb.model.registry.dir={dest}_registry",
            "-Ddtb.baseline.publish=true", csv, dest])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            sys.exit(rc)
        with open(dest + ".counters.json") as fh:
            counters = json.load(fh)
        print(json.dumps({"policy": policy, "wall_s": wall,
                          "b1": histogram.launches,
                          "b1_mma": histogram.mma_launches,
                          "b4": histogram.bin_counts_launches,
                          "counters": {g: counters.get(g) for g in (
                              "ColumnarCache", "IngestReaders",
                              "Random forest")}}), flush=True)


def cache_plan(csv):
    """Phase 37's one ``--cache-child`` process."""
    base = os.path.join(WORK, "cache")
    return {"base": base,
            "cmds": [([sys.executable, os.path.abspath(__file__),
                       "--cache-child", "build,use,stream_cache", csv, base],
                      dict(os.environ))],
            "gates": [base + "_gate"]}


def cache_scale(csv, single, trees, plan, stage):
    """Phase 37: phase 30's CSV trained through the job cold with
    ``dtb.streaming.cache.policy=build``, then warm with ``use``, then
    phase 30's streamed build over the sidecar, one after another in one
    child process (:func:`cache_plan`)."""
    phase(f"37 columnar cache: the {STREAM_SCALE_ROWS:,}-row CSV cold "
          f"(cache.policy=build) then warm (cache.policy=use)")
    drop = csv + ".avtc"
    shutil.rmtree(drop, ignore_errors=True)
    blocks = -(-STREAM_SCALE_ROWS // STREAM_SCALE_BLOCK)
    want_trees = json.loads(trees)
    runs = {}
    base = plan["base"]
    rc, so, se, _ = stage.run()[0]
    if rc != 0:
        fail(f"phase 37 child failed (rc {rc}): {se[-3000:]}")
    steps = [json.loads(ln) for ln in so.splitlines()
             if ln.startswith(('{"policy"', '{"mode"'))]
    if len(steps) != 3:
        fail(f"phase 37 child printed {len(steps)} results, want 3")
    for policy, run in zip(("build", "use"), steps):
        out = f"{base}_{policy}"
        got = [open(os.path.join(out, f"tree_{i}.json")).read()
               for i in range(len(want_trees))]
        if got != want_trees:
            fail(f"phase 37 {policy}: trees differ from phase 30's")
        if run["b1"] <= 0 or run["b1_mma"] != run["b1"]:
            fail(f"phase 37 {policy}: {run['b1']} B1 launches, "
                 f"{run['b1_mma']} in the mma form; all must be")
        if run["b4"] != blocks:
            fail(f"phase 37 {policy}: {run['b4']} B4 launches for "
                 f"{blocks} blocks")
        reader = "native" if policy == "build" else "cache"
        want = {f"{reader}.blocks": blocks,
                f"{reader}.rows": STREAM_SCALE_ROWS}
        if run["counters"]["IngestReaders"] != want:
            fail(f"phase 37 {policy}: IngestReaders "
                 f"{run['counters']['IngestReaders']}, want {want}")
        run["rows_per_s"] = STREAM_SCALE_ROWS / run["wall_s"]
        runs[policy] = run
    cold = runs["build"]["counters"]["ColumnarCache"]
    warm = runs["use"]["counters"]["ColumnarCache"]
    if cold.get("Built") != 1 or warm.get("Hit") != 1 or \
            warm.get("BytesRead") != cold.get("BytesWritten") or \
            not warm.get("BytesRead"):
        fail(f"phase 37: ColumnarCache cold {cold}, warm {warm}; want "
             f"Built=1, then Hit=1 with BytesRead == BytesWritten")
    print(f"cold job (parse + sidecar build): {runs['build']['wall_s']:.3f} "
          f"s, {runs['build']['rows_per_s']:,.0f} rows/s; warm job (served "
          f"from the sidecar): {runs['use']['wall_s']:.3f} s, "
          f"{runs['use']['rows_per_s']:,.0f} rows/s; ColumnarCache cold "
          f"{cold}, warm {warm}; trees identical to phase 30's; B1 all mma, "
          f"B4 {blocks} launches a job", flush=True)
    # phase 30's streamed build over the sidecar: its parse_s is the
    # sidecar read, beside phase 30's native parse
    stream = steps[2]
    with open(os.path.join(base + "_stream", "trees.json")) as fh:
        if fh.read() != trees:
            fail("phase 37: the stream over the sidecar gave other trees")
    if stream["ingest"] != {"cache.blocks": blocks,
                            "cache.rows": STREAM_SCALE_ROWS} or \
            stream["b4"] != blocks or stream["b1_mma"] != stream["b1"]:
        fail(f"phase 37 stream_cache: IngestReaders {stream['ingest']}, "
             f"B4 {stream['b4']}, B1 {stream['b1']} ({stream['b1_mma']} mma)")
    stream["rows_per_s"] = STREAM_SCALE_ROWS / stream["wall_s"]
    runs["stream_cache"] = stream
    print(f"phase 30's stream over the sidecar: {stream['rows_per_s']:,.0f} "
          f"rows/s, parse_s (the sidecar read) {stream['parse_s']:.3f} of "
          f"ingest_wall_s {stream['ingest_wall_s']:.3f}, build_s "
          f"{stream['build_s']:.3f}; native parse: "
          f"{single['rows_per_s']:,.0f} rows/s, parse_s "
          f"{single['parse_s']:.3f}", flush=True)
    print(json.dumps({"cache_scale": runs}), flush=True)
    return runs


def write_elearn_csv(cols, prefix, path):
    """elearn.json rows (id, videoHours, quizScore, forumPosts,
    assignmentsDone, outcome) from elearn_columns."""
    n = cols.shape[0]
    ids = np.char.add(prefix, np.char.zfill(np.arange(n).astype(str), 6))
    fields = [ids, np.char.mod("%.2f", cols[:, 0]),
              np.char.mod("%.1f", cols[:, 1]),
              cols[:, 2].astype(np.int64).astype(str),
              cols[:, 3].astype(np.int64).astype(str),
              np.asarray(["fail", "pass"])[cols[:, 4].astype(np.int64)]]
    rows = fields[0]
    for c in fields[1:]:
        rows = np.char.add(np.char.add(rows, ","), c)
    with open(path, "w") as fh:
        fh.write("\n".join(rows.tolist()) + "\n")


def knn2_plan():
    """Phase 34's inputs (20,000 test x 200,000 train e-learning rows) and
    its two nen.train.shard=true processes."""
    n_test, n_train, k = KNN_SCALE
    base = os.path.join(WORK, "knn_2p")
    shutil.rmtree(base, ignore_errors=True)
    data = os.path.join(base, "data")
    os.makedirs(data)
    rng = np.random.default_rng(20261020)
    write_elearn_csv(elearn_columns(rng, n_train), "S",
                     os.path.join(data, "tr_train.csv"))
    write_elearn_csv(elearn_columns(rng, n_test), "T",
                     os.path.join(data, "test.csv"))
    job = ["knnPipeline", f"-Dconf.path={os.path.join(RES, 'knn.properties')}",
           f"-Dsts.same.schema.file.path={os.path.join(RES, 'elearn.json')}",
           f"-Dnen.top.match.count={k}"]
    rdir = os.path.join(base, "reduce")
    return {"base": base, "data": data, "job": job,
            "cmds": [(cli_cmd(os.path.join(base, f"c{i}.json"),
                              job + ["-Dnen.train.shard=true", data,
                                     os.path.join(base, f"out{i}")]),
                      lane_env({"AVENIR_TPU_SHARD": f"{i}/2",
                                "AVENIR_TPU_ALLREDUCE_DIR": rdir}, True))
                     for i in range(2)],
            "gates": [os.path.join(base, f"gate{i}") for i in range(2)]}


def knn_two_process(plan, stage):
    """Phase 34: knnPipeline nen.train.shard=true at 20,000 x 200,000, k =
    10, over two processes (:func:`knn2_plan`), against the
    single-process job (run in this process)."""
    n_test, n_train, k = KNN_SCALE
    phase(f"34 knnPipeline nen.train.shard=true at {n_test:,} x "
          f"{n_train:,}, k = {k}, over 2 processes")
    base, data, job = plan["base"], plan["data"], plan["job"]
    # the single-process job in this process, its launches counted alone
    zero_launches()
    t0 = time.perf_counter()
    run_cli(job + [data, os.path.join(base, "one")])
    one = {**launch_counts(), "wall_s": time.perf_counter() - t0}
    res = stage.run()
    all_ok(res, "2-process knnPipeline")
    for i in range(2):
        same_bytes(os.path.join(base, f"out{i}", "part-r-00000"),
                   os.path.join(base, "one", "part-r-00000"),
                   f"knnPipeline shard {i}/2 predictions vs one process")
    got = [read_json(os.path.join(base, f"c{i}.json")) for i in range(2)]
    chunks = -(-n_test // 8192)
    for i, g in enumerate(got):
        if g["b5"] != chunks or g["b7_merge"] != chunks:
            fail(f"knn shard {i}: B5 launches {g['b5']}, B7 merges "
                 f"{g['b7_merge']}; want {chunks} each (one a test chunk)")
    dumps = [counter_dump(so) for _, so, _, _ in res]
    print(f"2-process knnPipeline == one process byte for byte; walls "
          f"{[round(g['wall_s'], 2) for g in got]} s (one process "
          f"{one['wall_s']:.2f} s); B5 launches {[g['b5'] for g in got]}, "
          f"B7 merge launches {[g['b7_merge'] for g in got]} ({chunks} test "
          f"chunks); Collectives.AllReduces "
          f"{[d['Collectives']['AllReduces'] for d in dumps]}", flush=True)
    return {"launches": got, "one_process": one}


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def joined_plan(layout, one_card):
    """Phase 35's two gloo ranks, each one ``--joined-child`` process with
    its spec of two joined jobs."""
    base = os.path.join(WORK, f"joined_{layout.replace(' ', '_')}")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    reg, ck = os.path.join(base, "reg"), os.path.join(base, "ck")
    outs = [os.path.join(base, f"out{i}") for i in range(2)]
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        requests = fh.read().splitlines(True)
    for i, part in enumerate((requests[:1000], requests[1000:])):
        with open(os.path.join(base, f"req{i}.csv"), "w") as fh:
            fh.write("".join(part))
    pred = os.path.join(base, "pred")
    ports = [free_port(), free_port()]
    cmds = []
    for i in range(2):
        spec = os.path.join(base, f"spec{i}.json")
        with open(spec, "w") as fh:
            json.dump({"runs": [
                {"name": "rf", "argv": rafo9s_job(reg, ck, outs[i]),
                 "port": ports[0]},
                {"name": "mp", "argv": [
                    "modelPredictor",
                    f"-Dconf.path={os.path.join(RES, 'rafo.properties')}",
                    f"-Dmop.model.dir.path={RAFO9}",
                    f"-Dmop.feature.schema.file.path="
                    f"{os.path.join(RES, 'call_hangup.json')}",
                    os.path.join(base, f"req{i}.csv"), pred],
                 "port": ports[1]}]}, fh)
        cmds.append(([sys.executable, os.path.abspath(__file__),
                      "--joined-child", spec,
                      os.path.join(base, f"result{i}.json")],
                     lane_env({"RANK": str(i), "WORLD_SIZE": "2",
                               "LOCAL_RANK": str(i),
                               "MASTER_ADDR": "127.0.0.1"}, one_card)))
    return {"layout": layout, "base": base, "reg": reg, "outs": outs,
            "pred": pred, "cmds": cmds,
            "gates": [os.path.join(base, f"gate{i}") for i in range(2)]}


def joined_lane(plan, stage):
    """Phase 35: two gloo ranks from torchrun's environment, each one
    ``--joined-child`` process running two joined jobs in turn
    (:func:`joined_plan`): the streamed sharded rafo9s build, then
    modelPredictor over two halves of the rafo9 requests."""
    layout, base, reg, outs, pred = (plan[k] for k in (
        "layout", "base", "reg", "outs", "pred"))
    phase(f"35 torch.distributed lane ({layout}): gloo, 2 ranks")
    res = stage.run()
    all_ok(res, "joined rafo9s build and modelPredictor")
    results = [read_json(os.path.join(base, f"result{i}.json"))
               for i in range(2)]
    for r in (r for rank in results for r in rank):
        if r["rc"] != 0:
            fail(f"joined lane: job {r['name']} exited {r['rc']}")
    rf = [rank[0] for rank in results]
    mp = [rank[1] for rank in results]
    for i in range(2):
        same_trees(outs[i], f"joined rank {i}")
    same_bytes(os.path.join(reg, "rafo9s", "v_000001", "meta.json"),
               os.path.join(RAFO9S, "registry", "rafo9s", "v_000001",
                            "meta.json"), "joined published meta.json")
    for i, g in enumerate(rf):
        if g["b1"] <= 0 or g["b1_mma"] != g["b1"]:
            fail(f"joined rank {i}: {g['b1']} B1 launches, {g['b1_mma']} mma")
    # rank 0 prints the summed counters of each job; the build's come
    # first, and only the build all-reduces
    dump = counter_dump(res[0][1])
    if sorted(os.listdir(pred)) != ["part-m-00000", "part-m-00001"]:
        fail(f"joined modelPredictor wrote {sorted(os.listdir(pred))}")
    parts = b"".join(open(os.path.join(pred, p), "rb").read()
                     for p in ("part-m-00000", "part-m-00001"))
    if parts != open(os.path.join(RAFO9, "pred.csv"), "rb").read():
        fail("joined modelPredictor: part-m-00000 + part-m-00001 != the "
             "single-process pred.csv")
    if any(g["b2"] <= 0 for g in mp):
        fail(f"joined modelPredictor: a rank never launched B2: {mp}")
    print(f"joined lane ({layout}): trees == rafo9s on both ranks, B1 "
          f"launches {[g['b1'] for g in rf]} (all mma), B4 "
          f"{[g['b4'] for g in rf]}; summed Collectives.AllReduces "
          f"{dump['Collectives']['AllReduces']}; modelPredictor parts "
          f"concatenate to pred.csv, B2 launches {[g['b2'] for g in mp]}",
          flush=True)
    return {"rf": rf, "mp": mp,
            "allreduces": dump["Collectives"]["AllReduces"]}


# --------------------------------------------------------------------------
# phases 38-41: the joined run over per-process inputs
# --------------------------------------------------------------------------

JOINED_DT_ROWS = 100_000
JOINED_DT_LEVELS = 4
JOINED_MONO_KEYS = ("-Ddtb.model.name=hangup", "-Ddtb.baseline.publish=true",
                    "-Ddtb.model.quantize=true")


def joined_child(spec_path, result_path):
    """One process of phases 38-41 (``--joined-child``): after a warm-up,
    the spec's jobs in order, each through ``cli.run.main`` with its own
    ``MASTER_PORT`` in a joined run (torchrun's other keys in the
    environment), the launch counts zeroed just before each job and read
    just after.  The job's load and build times come from wrappers around
    ``load_csv``, ``build_forest`` and ``build_forest_from_stream``, each
    count all-reduce's wall from one around ``AllReducer.sum``, and the
    joined run's set-up and tear-down (``join_s``, ``leave_s``) from ones
    around ``distributed.initialize`` and ``distributed.leave``.  Writes
    one JSON record a job to ``result_path``."""
    import torch
    from avenir_tpu_torch.cli import jobs as cli_jobs
    from avenir_tpu_torch.cli import run as cli_run
    from avenir_tpu_torch.cli.jobs import _tree_params
    from avenir_tpu_torch.core.config import load_config
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.models import forest
    from avenir_tpu_torch.monitor.baseline import BaselineBuilder
    from avenir_tpu_torch.parallel import collectives, distributed
    cfg = load_config(os.path.join(RES, "rafo.properties"))
    params = forest.ForestParams(tree=_tree_params(cfg),
                                 num_trees=cfg.get_int("dtb.num.trees"),
                                 seed=cfg.get_int("dtb.random.seed"))
    fs = FeatureSchema.load(os.path.join(RES, "call_hangup.json"))
    dev = torch.device("cuda", 0)
    warm = hangup_table(np.random.default_rng(1), 4096, fs)
    forest.build_forest(warm, params, device=dev)
    BaselineBuilder(fs, device=dev).update(warm).finalize()
    torch.cuda.synchronize()
    await_gate()
    times = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                times[key] = times.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    def streamed(fn):
        def wrapper(*args, **kwargs):
            stats = kwargs.setdefault("stats", {})
            out = fn(*args, **kwargs)
            times["load_s"] = stats["ingest_wall_s"]
            times["build_s"] = stats["build_s"]
            return out
        return wrapper
    sums = []
    reduce_sum = collectives.AllReducer.sum

    def timed_sum(self, arr):
        t0 = time.perf_counter()
        out = reduce_sum(self, arr)
        sums.append(time.perf_counter() - t0)
        return out
    distributed.initialize = timed("join_s", distributed.initialize)
    distributed.leave = timed("leave_s", distributed.leave)
    cli_jobs.load_csv = timed("load_s", cli_jobs.load_csv)
    from avenir_tpu_torch.cli import bayes_jobs
    bayes_jobs.load_csv = timed("load_s", bayes_jobs.load_csv)
    forest.build_forest = timed("build_s", forest.build_forest)
    forest.build_forest_from_stream = streamed(
        forest.build_forest_from_stream)
    collectives.AllReducer.sum = timed_sum
    results = []
    for run in read_json(spec_path)["runs"]:
        if run["port"] is not None:
            os.environ["MASTER_PORT"] = str(run["port"])
        times.clear()
        sums.clear()
        zero_launches()
        t0 = time.perf_counter()
        rc = cli_run.main(run["argv"])
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        results.append({"name": run["name"], "rc": rc, "wall_s": wall,
                        **launch_counts(), **times,
                        "allreduce_ms": [t * 1e3 for t in sums]})
    with open(result_path, "w") as fh:
        json.dump(results, fh)


def split_lines(src, cuts, dests):
    """Write the lines of ``src`` between consecutive ``cuts`` to
    ``dests``, one file each."""
    with open(src, "rb") as fh:
        lines = fh.read().splitlines(True)
    for lo, hi, dest in zip(cuts, cuts[1:], dests):
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as fh:
            fh.write(b"".join(lines[lo:hi]))


def spool_layout(dest, per_rank):
    """A directory laid out as the gather spool: each file of rank r's
    input (a file, or a directory's files) as ``<basename>.p<r>``."""
    from avenir_tpu_torch.parallel.distributed import spool_name
    os.makedirs(dest)
    for rank, src in enumerate(per_rank):
        files = [os.path.join(src, b) for b in sorted(os.listdir(src))] \
            if os.path.isdir(src) else [src]
        for f in files:
            shutil.copy(f, os.path.join(
                dest, spool_name(os.path.basename(f), rank)))
    return dest


def joined_inputs_plan(scale_csv, knn_base):
    """Phases 38-41's per-process inputs (phase 30's CSV split, e-learning
    rows, the golden distances split, phase 34's KNN inputs split, the
    spool layouts) and their three ``--joined-child`` processes: one
    process's jobs, then the two gloo ranks' (one card)."""
    base = os.path.join(WORK, "joined_inputs")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    n = STREAM_SCALE_ROWS
    half = [os.path.join(base, f"half{i}.csv") for i in range(2)]
    uneq = [os.path.join(base, f"uneq{i}.csv") for i in range(2)]
    split_lines(scale_csv, [0, n // 2, n], half)
    split_lines(scale_csv, [0, 6 * n // 10, n], uneq)
    dt_src = os.path.join(base, "dt.csv")
    dt = [os.path.join(base, f"dt{i}.csv") for i in range(2)]
    split_lines(scale_csv, [0, JOINED_DT_ROWS], [dt_src])
    split_lines(scale_csv, [0, JOINED_DT_ROWS // 2, JOINED_DT_ROWS], dt)
    rng = np.random.default_rng(20261021)
    sim, grs = [], []
    for i in range(2):
        sim.append(os.path.join(base, f"sim{i}"))
        os.makedirs(sim[i])
        write_elearn_csv(elearn_columns(rng, 300), f"S{i}",
                         os.path.join(sim[i], "tr_part"))
        write_elearn_csv(elearn_columns(rng, 100), f"T{i}",
                         os.path.join(sim[i], "test_part"))
        grs.append(os.path.join(base, f"grs{i}.csv"))
        write_elearn_csv(elearn_columns(rng, 400), f"G{i}", grs[i])
    with open(os.path.join(KNN_GOLDEN, "dist.csv"), "rb") as fh:
        n_dist = len(fh.read().splitlines())
    nn = [os.path.join(base, f"nn{i}", "dist.csv") for i in range(2)]
    split_lines(os.path.join(KNN_GOLDEN, "dist.csv"),
                [0, n_dist // 2, n_dist], nn)
    n_test, n_train, k = KNN_SCALE
    knn_data = os.path.join(knn_base, "data")
    kn = [os.path.join(base, f"knn{i}") for i in range(2)]
    split_lines(os.path.join(knn_data, "tr_train.csv"),
                [0, n_train // 2, n_train],
                [os.path.join(d, "tr_train.csv") for d in kn])
    split_lines(os.path.join(knn_data, "test.csv"),
                [0, n_test // 2, n_test],
                [os.path.join(d, "test.csv") for d in kn])
    spools = {name: spool_layout(os.path.join(base, f"spool_{name}"), src)
              for name, src in (("sts", sim), ("nn", nn), ("grs", grs))}

    hangup = ("-Ddtb.feature.schema.file.path="
              f"{os.path.join(RES, 'call_hangup.json')}")
    rafo = f"-Dconf.path={os.path.join(RES, 'rafo.properties')}"
    detr = f"-Dconf.path={os.path.join(RES, 'detr.properties')}"
    knn = f"-Dconf.path={os.path.join(RES, 'knn.properties')}"
    elearn = f"-Dsts.same.schema.file.path={os.path.join(RES, 'elearn.json')}"
    out = os.path.join(WORK, "joined_out")
    shutil.rmtree(out, ignore_errors=True)

    def rf(src, dest, extra=()):
        return ["randomForestBuilder", rafo, hangup, *extra, src, dest]

    def dtb(src, dest, dec, lv):
        return (["decisionTreeBuilder", detr, hangup,
                 f"-Ddtb.decision.file.path.out={dec}{lv}.json"]
                + ([f"-Ddtb.decision.file.path.in={dec}{lv - 1}.json"]
                   if lv else []) + [src, f"{dest}{lv}"])

    def gather(name, src, dest):
        job = {"sts": ["sameTypeSimilarity", knn, elearn],
               "nn": ["nearestNeighbor", knn],
               "grs": ["groupedRecordSimilarity", knn, elearn,
                       "-Dgrs.group.field.ordinals=5"]}[name]
        return job + [src, dest]
    stream_off = ("-Ddtb.streaming.ingest=true", "-Ddtb.streaming.shard=off",
                  f"-Ddtb.streaming.block.rows={STREAM_SCALE_BLOCK}",
                  *JOINED_MONO_KEYS)
    one = [("mono", rf(scale_csv, f"{out}/one_mono", JOINED_MONO_KEYS + (
        f"-Ddtb.model.registry.dir={out}/reg_one",)))]
    one += [(f"dt{lv}", dtb(dt_src, f"{out}/one_dt", f"{out}/one_dec", lv))
            for lv in range(JOINED_DT_LEVELS)]
    one += [(name, gather(name, spools[name], f"{out}/one_{name}"))
            for name in spools]
    ranks = []
    for i in range(2):
        runs = [("mono", rf(half[i], f"{out}/mono{i}", JOINED_MONO_KEYS + (
                    f"-Ddtb.model.registry.dir={out}/reg_mono",))),
                ("unequal", rf(uneq[i], f"{out}/uneq{i}", JOINED_MONO_KEYS + (
                    f"-Ddtb.model.registry.dir={out}/reg_uneq",))),
                ("soff", rf(half[i], f"{out}/soff{i}", stream_off + (
                    f"-Ddtb.model.registry.dir={out}/reg_soff",)))]
        runs += [(f"dt{lv}", dtb(dt[i], f"{out}/dt", f"{out}/dec{i}_", lv))
                 for lv in range(JOINED_DT_LEVELS)]
        runs += [(name, gather(name, src[i], f"{out}/{name}{i}"))
                 for name, src in (("sts", sim), ("nn", nn), ("grs", grs))]
        runs += [("same", gather("sts", spools["sts"], f"{out}/same{i}")),
                 ("knn", ["knnPipeline", knn, elearn,
                          f"-Dnen.top.match.count={k}", kn[i],
                          f"{out}/knn"])]
        ranks.append(runs)
    ports = [free_port() for _ in ranks[0]]

    def child(name, runs, env):
        spec = os.path.join(base, f"spec_{name}.json")
        with open(spec, "w") as fh:
            json.dump({"runs": [{"name": r, "argv": a,
                                 "port": p if env else None}
                                for (r, a), p in zip(runs, ports)]}, fh)
        tmp = os.path.join(base, f"tmp_{name}")
        os.makedirs(tmp)
        return ([sys.executable, os.path.abspath(__file__), "--joined-child",
                 spec, os.path.join(base, f"result_{name}.json")],
                lane_env({"TMPDIR": tmp, **env}, True))
    return {"base": base, "out": out,
            "cmds": [child("one", one, {})] + [child(f"rank{i}", ranks[i], {
                "RANK": str(i), "WORLD_SIZE": "2", "LOCAL_RANK": str(i),
                "MASTER_ADDR": "127.0.0.1"}) for i in range(2)],
            "gates": [os.path.join(base, f"gate_{name}")
                      for name in ("one", "rank0", "rank1")]}


def joined_phases(plan, stage, single_trees, knn_base):
    """Phases 38-41: jobs over per-process inputs on two gloo ranks (one
    card), each held against one process's job on the concatenated input
    or on a directory laid out as the spool (:func:`joined_inputs_plan`);
    one child runs every single-process job, then the two joined children
    run the ranks' jobs.  Returns their launch counts for the kernels
    line."""
    phase("38-41 joined run over per-process inputs: one process's jobs, "
          "then two ranks'")
    t_start = time.perf_counter()
    base, out = plan["base"], plan["out"]
    n = STREAM_SCALE_ROWS
    n_test, n_train, _ = KNN_SCALE
    all_ok(stage.run([0]), "phases 38-41: one process's jobs")
    res = stage.run([1, 2])
    all_ok(res, "phases 38-41: the joined ranks' jobs")
    single = {r["name"]: r for r in read_json(
        os.path.join(base, "result_one.json"))}
    got = [{r["name"]: r for r in read_json(
        os.path.join(base, f"result_rank{i}.json"))} for i in range(2)]
    for r in list(single.values()) + [g for rk in got for g in rk.values()]:
        if r["rc"] != 0:
            fail(f"phases 38-41: job {r['name']} exited {r['rc']}")
    for name in ("one", "rank0", "rank1"):
        left = [f for f in os.listdir(os.path.join(base, f"tmp_{name}"))
                if f.startswith("avenir_dist_gather_")]
        if left:
            fail(f"phases 38-41: {name} left spools behind: {left}")

    phase(f"38 joined-mono: randomForestBuilder over {n // 2:,} + "
          f"{n // 2:,} and {6 * n // 10:,} + {4 * n // 10:,} rows on two "
          f"ranks == one process over the {n:,}-row CSV; then "
          f"dtb.streaming.shard=off")
    for t, want in enumerate(json.loads(single_trees)):
        with open(os.path.join(out, "one_mono", f"tree_{t}.json")) as fh:
            if fh.read() != want:
                fail(f"phase 38: the one-process job's tree {t} differs "
                     f"from phase 30's build")
    for name in ("mono", "unequal", "soff"):
        tag = {"mono": "mono", "unequal": "uneq", "soff": "soff"}[name]
        for i in range(2):
            same_trees_as(os.path.join(out, f"{tag}{i}"),
                          os.path.join(out, "one_mono"),
                          f"phase 38 {name} rank {i}")
        reg = os.path.join(out, f"reg_{tag}", "hangup")
        if os.listdir(reg) != ["v_000001"]:
            fail(f"phase 38 {name}: registry holds {os.listdir(reg)}")
        want = os.path.join(out, "reg_one", "hangup", "v_000001")
        for f in ("meta.json", "baseline.json"):
            same_bytes(os.path.join(reg, "v_000001", f),
                       os.path.join(want, f), f"phase 38 {name} {f}")
        # the int8 sidecar's quantized.json holds the mismatch on rank 0's
        # own rows (its budget sample), not on the whole CSV
        for f in ("arrays.npz", "baseline.npz", "quantized.npz"):
            same_arrays(os.path.join(reg, "v_000001", f),
                        os.path.join(want, f), f"phase 38 {name} {f}")
        for i in range(2):
            g = got[i][name]
            levels = len(g["allreduce_ms"])
            if g["b1"] != levels or g["b1_mma"] != levels:
                fail(f"phase 38 {name} rank {i}: {g['b1']} B1 launches, "
                     f"{g['b1_mma']} mma, {levels} level all-reduces")
            want_b4 = 1 if name != "soff" else -(-n // 2 // STREAM_SCALE_BLOCK)
            if g["b4"] != want_b4:
                fail(f"phase 38 {name} rank {i}: {g['b4']} B4 launches, "
                     f"want {want_b4}")
            if (g["b2"] > 0, g["b3"] > 0) != (i == 0, i == 0):
                fail(f"phase 38 {name} rank {i}: B2 {g['b2']}, B3 "
                     f"{g['b3']} launches; the quantize publish is rank "
                     f"0's alone")
    one_wall = single["mono"]["wall_s"]
    report = {}
    for name in ("mono", "unequal", "soff"):
        wall = max(got[i][name]["wall_s"] for i in range(2))
        report[name] = {
            "rows_per_s": n / wall, "one_process_rows_per_s": n / one_wall,
            **{key: [got[i][name][key] for i in range(2)]
               for key in ("wall_s", "join_s", "leave_s", "load_s",
                           "build_s", "allreduce_ms")}}
        print(f"{name}: 2 ranks {n / wall:,.0f} rows/s against one "
              f"process's {n / one_wall:,.0f} (one process wall "
              f"{one_wall:.3f} s, load_s {single['mono']['load_s']:.3f}, "
              f"build_s {single['mono']['build_s']:.3f}); ranks' wall "
              f"{[round(x, 3) for x in report[name]['wall_s']]}, join_s "
              f"{[round(x, 3) for x in report[name]['join_s']]}, leave_s "
              f"{[round(x, 3) for x in report[name]['leave_s']]}, load_s "
              f"{[round(x, 3) for x in report[name]['load_s']]}, build_s "
              f"{[round(x, 3) for x in report[name]['build_s']]}; "
              f"all-reduce ms a level "
              f"{[[round(x, 2) for x in r] for r in report[name]['allreduce_ms']]};"
              f" B1 {[got[i][name]['b1'] for i in range(2)]} (all mma), B4 "
              f"{[got[i][name]['b4'] for i in range(2)]}, B2 "
              f"{[got[i][name]['b2'] for i in range(2)]}, B3 "
              f"{[got[i][name]['b3'] for i in range(2)]}", flush=True)

    phase(f"39 joined-dt: {JOINED_DT_LEVELS} levels of the detr.sh rotation "
          f"over {JOINED_DT_ROWS // 2:,} + {JOINED_DT_ROWS // 2:,} rows")
    for lv in range(JOINED_DT_LEVELS):
        for i in range(2):
            same_bytes(os.path.join(out, f"dec{i}_{lv}.json"),
                       os.path.join(out, f"one_dec{lv}.json"),
                       f"phase 39 level {lv} rank {i} decision paths")
            g = got[i][f"dt{lv}"]
            if g["b1"] != 1 or g["b1_mma"] != 1:
                fail(f"phase 39 level {lv} rank {i}: {g['b1']} B1 launches "
                     f"({g['b1_mma']} mma), want 1")
        parts = b"".join(open(os.path.join(out, f"dt{lv}", p), "rb").read()
                         for p in ("part-r-00000", "part-r-00001"))
        if parts != open(os.path.join(out, f"one_dt{lv}", "part-r-00000"),
                         "rb").read():
            fail(f"phase 39 level {lv}: the ranks' record parts do not "
                 f"concatenate to one process's")
    dt_walls = {who: [round(r[f"dt{lv}"]["wall_s"], 3)
                      for lv in range(JOINED_DT_LEVELS)]
                for who, r in (("one", single), ("rank0", got[0]),
                               ("rank1", got[1]))}
    report["dt_wall_s"] = dt_walls
    print(f"decision paths == one process's at every level on both ranks; "
          f"B1 one mma launch a level a rank; walls a level (s) {dt_walls}",
          flush=True)

    phase("40 joined-gather: sameTypeSimilarity, nearestNeighbor and "
          "groupedRecordSimilarity over distinct inputs == one process over "
          "the spool layout; an identical input makes no spool")
    for name in ("sts", "nn", "grs"):
        for i in range(2):
            same_bytes(os.path.join(out, f"{name}{i}", "part-r-00000"),
                       os.path.join(out, f"one_{name}", "part-r-00000"),
                       f"phase 40 {name} rank {i}")
    for i in range(2):
        same_bytes(os.path.join(out, f"same{i}", "part-r-00000"),
                   os.path.join(out, "one_sts", "part-r-00000"),
                   f"phase 40 identical input rank {i}")
    notes = res[0][2]
    if notes.count("using it as-is (no gather)") != 1 or \
            notes.count("gathered") != 4:
        fail(f"phase 40: rank 0 spooled wrongly: {notes[-2000:]}")
    print("gather outputs == one process's over the spool layout on both "
          "ranks; the identical input used as it is; every spool removed",
          flush=True)

    phase(f"41 joined-knn: knnPipeline over {n_test:,} test x {n_train:,} "
          f"train rows given to the ranks as distinct files")
    parts = b"".join(open(os.path.join(out, "knn", f"part-r-0000{i}"),
                          "rb").read() for i in range(2))
    if parts != open(os.path.join(knn_base, "one", "part-r-00000"),
                     "rb").read():
        fail("phase 41: the ranks' parts do not concatenate to phase 34's "
             "single-process predictions")
    chunks = -(-(n_test // 2) // 8192)
    for i in range(2):
        if got[i]["knn"]["b5"] != chunks:
            fail(f"phase 41 rank {i}: {got[i]['knn']['b5']} B5 launches, "
                 f"want {chunks} (one a test chunk)")
    report["knn_wall_s"] = [got[i]["knn"]["wall_s"] for i in range(2)]
    print(f"parts == phase 34's one-process predictions; B5 launches "
          f"{[got[i]['knn']['b5'] for i in range(2)]} ({chunks} test chunks "
          f"a rank); walls {[round(w, 3) for w in report['knn_wall_s']]} s",
          flush=True)
    report["phases_s"] = time.perf_counter() - t_start
    print(f"phases 38-41: {report['phases_s']:.1f} s", flush=True)
    print(json.dumps({"joined_scale": report}), flush=True)
    return {"ranks": got, "report": report}


def same_trees_as(out, want, what):
    for t in range(9):
        same_bytes(os.path.join(out, f"tree_{t}.json"),
                   os.path.join(want, f"tree_{t}.json"), f"{what} tree {t}")


def multi_process_phases(scale_csv, single, trees, counts):
    """Phases 31-41.  The processes of phases 31-32 (ten) start up
    together at phase 31, and those of phases 33-35 and 37-41 (twelve) at
    phase 33, each held at its gate until its own phase lets it go: those
    phases pay two start-ups between them, and no timed run shares the
    host with another process's start-up.  Returns the launch counts for
    the kernels line."""
    import torch
    phase("31 shard lane (one card): randomForestBuilder over "
          "AVENIR_TPU_SHARD=i/2 == the rafo9s fixture")
    plans = [lane_plan("one card", True), resume_plan()]
    stages = start_stages(plans)
    held(stages[0], "phases 31-32")
    lane = shard_lane(plans[0], stages[0])
    shard_resume(plans[1], stages[1])
    knn_base = os.path.join(WORK, "knn_2p")
    plans += [scale2_plan(scale_csv), knn2_plan(),
              joined_plan("one card", True),
              joined_inputs_plan(scale_csv, knn_base), cache_plan(scale_csv)]
    stages += start_stages(plans[2:])
    scale2 = shard_scale(single, trees, counts, stages[2])
    knn2 = knn_two_process(plans[3], stages[3])
    joined = joined_lane(plans[4], stages[4])
    joined_inputs = joined_phases(plans[5], stages[5], trees, knn_base)
    if torch.cuda.device_count() > 1:
        phase("36 phases 31 and 35 again, each process on its own card")
        for plan, fn in ((lane_plan("distinct cards", False), shard_lane),
                         (joined_plan("distinct cards", False),
                          joined_lane)):
            fn(plan, start_stages([plan])[0])
    else:
        print("phase 36 (31 and 35 over distinct cards) skipped: one device "
              "visible", flush=True)
    cached = cache_scale(scale_csv, single["stream"], trees, plans[6],
                         stages[6])
    return {"lane": lane, "scale2": scale2, "knn2": knn2, "joined": joined,
            "joined_inputs": joined_inputs, "cache": cached}


# --------------------------------------------------------------------------
# Naive Bayes (phases 42-46)
# --------------------------------------------------------------------------

def nb9_flow(work, plat=()):
    """The nb9 fixture's jobs through the port's CLI into ``work`` (``plat``
    e.g. ``["-Dplatform=cpu"]``; none: the card): bayesianDistribution,
    bayesianPredictor in its four output modes, sameTypeSimilarity ->
    featureCondProbJoiner -> nearestNeighbor (class-conditional),
    knnPipeline, the text mode, and predictionService over a copy of the
    fixture's registry.  Returns ({name: output file}, {name: the
    fixture's counter groups of its counters.json})."""
    mk = fixture_module("nb9")
    schema = os.path.join(NB9, "schema.json")
    data = os.path.join(NB9, "data")
    train, test = os.path.join(data, "tr_part"), os.path.join(data,
                                                             "test_part")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    outs, counters = {}, {}

    def run(job, args, inp, name, part):
        out = os.path.join(work, name)
        run_cli([job, *plat, *args, inp, out])
        got = read_json(out + ".counters.json")
        counters[name] = {g: got[g] for g in mk.COUNTER_GROUPS if g in got}
        outs[name] = os.path.join(out, part)
        return outs[name]
    model = run("bayesianDistribution",
                [f"-Dbad.feature.schema.file.path={schema}"], train, "model",
                "part-r-00000")
    bap = [f"-Dbap.feature.schema.file.path={schema}",
           f"-Dbap.bayesian.model.file.path={model}"]
    for name, extra, inp in (
            ("pred", [], test),
            ("pred_cost", [f"-Dbap.predict.class.cost={mk.COSTS}"], test),
            ("pred_diff", [f"-Dbap.class.prob.diff.threshold={mk.DIFF}"],
             test),
            ("cond_prob", ["-Dbap.output.feature.prob.only=true"], train)):
        run("bayesianPredictor", bap + extra, inp, name, "part-m-00000")
    dist = run("sameTypeSimilarity", [f"-Dsts.same.schema.file.path={schema}"],
               data, "dist", "part-r-00000")
    join_in = os.path.join(work, "join_in")
    os.makedirs(join_in)
    shutil.copyfile(outs["cond_prob"], os.path.join(join_in, "condProb_part"))
    shutil.copyfile(dist, os.path.join(join_in, "neighbors"))
    joined = run("featureCondProbJoiner", [], join_in, "joined",
                 "part-r-00000")
    run("nearestNeighbor", [*mk.KNN_KEYS, mk.WEIGHTED],
        os.path.dirname(joined), "nn", "part-r-00000")
    run("knnPipeline", [f"-Dsts.same.schema.file.path={schema}",
                        *mk.KNN_KEYS], data, "knn", "part-r-00000")
    text_model = run("bayesianDistribution", [],
                     os.path.join(NB9, "text", "train.txt"), "text_model",
                     "part-r-00000")
    run("bayesianPredictor",
        [f"-Dbap.bayesian.model.file.path={text_model}"],
        os.path.join(NB9, "text", "test.txt"), "text_pred", "part-m-00000")
    reg = os.path.join(work, "registry")
    shutil.copytree(os.path.join(NB9, "registry"), reg)
    run("predictionService", [f"-Dps.model.registry.dir={reg}",
                              f"-Dps.model.name={mk.MODEL_NAME}",
                              "-Dps.transport=inprocess"], test, "served",
        "part-m-00000")
    return outs, counters


# nb9_flow's outputs and the fixture file each must equal
NB9_FILES = {"model": "model.csv", "pred": "pred.csv",
             "pred_cost": "pred_cost.csv", "pred_diff": "pred_diff.csv",
             "cond_prob": "cond_prob.csv", "nn": "nn_pred.csv",
             "knn": "knn_pred.csv", "text_model": "text/model.csv",
             "text_pred": "text/pred.csv", "served": "served.csv"}


def nb9_check(outs, counters, what):
    """nb9_flow's outputs byte-equal to the fixture's, the joiner's by its
    digest and line count, and the counter groups equal."""
    import hashlib
    for name, rel in NB9_FILES.items():
        same_bytes(outs[name], os.path.join(NB9, rel), f"{what} {name}")
    with open(outs["joined"], "rb") as fh:
        data = fh.read()
    got = f"{hashlib.sha256(data).hexdigest()} {data.count(b'\n')}\n"
    with open(os.path.join(NB9, "joined.sha256")) as fh:
        if got != fh.read():
            fail(f"{what} featureCondProbJoiner output {got.strip()} != "
                 f"the fixture's joined.sha256")
    print(f"{what} joined: digest equal to joined.sha256", flush=True)
    want = read_json(os.path.join(NB9, "counters.json"))
    if counters != want:
        fail(f"{what} counters {counters} != the fixture's {want}")


def churn_columns(rng, n):
    """``n`` records of telecom_churn_gen's model drawn with numpy at once:
    {field: array} in resource/churn.json's codes (plan, paymentHistory
    and status as category codes)."""
    plan = rng.choice(len(CHURN_PLAN_P), n, p=CHURN_PLAN_P)
    usage = rng.lognormal(0.0, 0.5, n)
    minutes = np.clip(np.array([m for m, _ in CHURN_USAGE])[plan] * usage,
                      0, 1999).astype(np.int64)
    data = np.clip(np.array([d for _, d in CHURN_USAGE])[plan] * usage
                   * rng.lognormal(0, 0.3, n), 0, 9999).astype(np.int64)
    pay = rng.choice(3, n, p=CHURN_PAY_P)
    calls = np.clip(rng.poisson(1.2, n), 0, 9)
    risk = 0.15 + 0.25 * (usage < 0.6) + 0.25 * (pay == 0) \
        + 0.25 * (calls >= 4)
    churned = rng.random(n) < risk
    return {"plan": plan, "minutes": minutes, "data": data, "calls": calls,
            "pay": pay, "status": churned.astype(np.int64)}


def churn_table(cols, fs):
    """The columns as a port ColumnarTable (category codes int32, numbers
    float64, as the CSV reader encodes them)."""
    from avenir_tpu_torch.core.table import ColumnarTable
    n = len(cols["plan"])
    return ColumnarTable(schema=fs, n_rows=n, columns={
        1: cols["plan"].astype(np.int32),
        2: cols["minutes"].astype(np.float64),
        3: cols["data"].astype(np.float64),
        4: cols["calls"].astype(np.float64),
        5: cols["pay"].astype(np.int32),
        6: cols["status"].astype(np.int32)})


def write_churn_csv(cols, path):
    plans = np.array(["prepaid", "standard", "family", "business"])
    pays = np.array(["poor", "average", "good"])
    status = np.array(["active", "churned"])
    rows = zip(plans[cols["plan"]], cols["minutes"], cols["data"],
               cols["calls"], pays[cols["pay"]], status[cols["status"]])
    with open(path, "w") as fh:
        fh.write("\n".join(f"C{i:07d},{p},{m},{d},{c},{y},{s}"
                           for i, (p, m, d, c, y, s) in enumerate(rows)))
        fh.write("\n")


def bayes_main_path():
    """Phases 42-43: the Naive Bayes main path on the card, every launch
    count zeroed just before and read just after.  Returns the launch
    counts and the ledger's backends."""
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.models import bayes
    from avenir_tpu_torch.serving.registry import ModelRegistry
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    from gen.telecom_churn_gen import generate as churn_generate
    work = os.path.join(WORK, "nb")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    props = f"-Dconf.path={os.path.join(RES, 'churn.properties')}"
    churn = os.path.join(RES, "churn.json")
    t0 = time.perf_counter()
    zero_launches()
    with transfer_ledger() as ledger:
        phase("42 golden nb: bayesianDistribution + bayesianPredictor")
        train = os.path.join(work, "train.csv")
        with open(train, "w") as fh:
            fh.write("\n".join(churn_generate(400, 11)))
        run_cli(["org.avenir.bayesian.BayesianDistribution", props,
                 f"-Dbad.feature.schema.file.path={churn}", train,
                 os.path.join(work, "model")])
        model = os.path.join(work, "model", "part-r-00000")
        run_cli(["org.avenir.bayesian.BayesianPredictor", props,
                 f"-Dbap.feature.schema.file.path={churn}",
                 f"-Dbap.bayesian.model.file.path={model}", train,
                 os.path.join(work, "pred")])
        same_bytes(model, os.path.join(NB_GOLDEN, "model.csv"),
                   "golden nb model")
        same_bytes(os.path.join(work, "pred", "part-m-00000"),
                   os.path.join(NB_GOLDEN, "pred.csv"), "golden nb pred")
        phase("43 nb9 fixture: every predictor mode, the text mode, the "
              "knn.sh class-conditional pipeline, knnPipeline and "
              "predictionService over a bayes version")
        outs, counters = nb9_flow(os.path.join(work, "nb9"))
        nb9_check(outs, counters, "nb9")
        # the port's own publish of the same model: the JAX package's
        # version, meta.json byte for byte and arrays.npz array for array
        fs = FeatureSchema.load(os.path.join(NB9, "schema.json"))
        m = bayes.train(load_csv(os.path.join(NB9, "data", "tr_part"), fs))
        reg = ModelRegistry(os.path.join(work, "nb9_publish"))
        v = reg.publish(fixture_module("nb9").MODEL_NAME, m, schema=fs)
        want = os.path.join(NB9, "registry", "nb9", "v_000001")
        same_bytes(os.path.join(reg.version_dir("nb9", v), "meta.json"),
                   os.path.join(want, "meta.json"), "nb9 port publish")
        same_arrays(os.path.join(reg.version_dir("nb9", v), "arrays.npz"),
                    os.path.join(want, "arrays.npz"), "nb9 port publish")
    counts = launch_counts()
    backends = ledger.backend_snapshot()
    sites = ledger.site_snapshot()
    print(f"bayes main path: launches {counts}; KernelBackends={backends}; "
          f"dispatch sites bayes.train={sites.get('bayes.train', 0)} "
          f"bayes.predict={sites.get('bayes.predict', 0)}; phases 42-43 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if counts["b5"] <= 0:
        fail("phase 43 never launched the top-k kernel (knnPipeline)")
    if not backends.get("knn.topk.cuda"):
        fail("phase 43 ledger shows no knn.topk.cuda")
    wrong = [k for k in backends if k.endswith((".torch", ".host"))]
    if wrong:
        fail(f"phase 43 ledger shows non-kernel forms: {wrong}")
    if not sites.get("bayes.train") or not sites.get("bayes.predict"):
        fail(f"phases 42-43 dispatched no bayes train or predict: {sites}")
    return counts, backends


def bayes_scale(dev):
    """Phases 44-45: the 10,000,000-row library train on the card against
    the port's CPU train, then the 1,000,000-row CLI pair on the card
    against -Dplatform=cpu runs.  Returns the numbers for the kernels
    line and the CSV phase 46 splits."""
    import torch
    from avenir_tpu_torch.core.artifacts import read_text_input
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.models import bayes
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    fs = FeatureSchema.load(os.path.join(RES, "churn.json"))
    rng = np.random.default_rng(20261017)
    n = NB_TRAIN_ROWS
    t_phase = time.perf_counter()
    phase(f"44 scale: bayes.train over {n:,} churn rows on the card == "
          f"device='cpu'")
    table = churn_table(churn_columns(rng, n), fs)
    warm = churn_table(churn_columns(rng, 4096), fs)
    bayes.train(warm, device=dev)
    torch.cuda.synchronize()
    stats = {}
    with transfer_ledger() as ledger:
        t0 = time.perf_counter()
        m_dev = bayes.train(table, device=dev, stats=stats)
        wall = time.perf_counter() - t0
    chunks = ledger.site_snapshot().get("bayes.train", 0)
    h2d = ledger.h2d_bytes
    # the 4-bit wire: the class and five bin codes, two a byte
    if h2d != n * 3:
        fail(f"bayes.train over {n:,} rows moved {h2d:,} H2D bytes, not "
             f"the 4-bit wire's {n * 3:,}")
    t0 = time.perf_counter()
    lines = m_dev.to_lines()
    path = os.path.join(WORK, "nb_scale_model.csv")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu = bayes.train(table, device="cpu")
    cpu_wall = time.perf_counter() - t0
    if m_cpu.to_lines() != lines:
        fail(f"bayes.train over {n:,} rows: the card's model lines differ "
             f"from device='cpu'")
    if chunks != -(-n // bayes.CHUNK_ROWS):
        fail(f"bayes.train over {n:,} rows ran {chunks} chunks")
    # the row split over an in-process mesh, the JAX package's
    # ctx.shard_rows: four slices of cuda:0 a chunk, summed on the host
    from avenir_tpu_torch.parallel.mesh import DeviceMesh
    mesh_n = 4
    mesh = DeviceMesh([str(dev)] * mesh_n)
    with transfer_ledger() as ledger:
        t0 = time.perf_counter()
        m_mesh = bayes.train(table, mesh=mesh)
        mesh_wall = time.perf_counter() - t0
    if m_mesh.to_lines() != lines:
        fail(f"bayes.train over {n:,} rows on {mesh}: the model lines "
             f"differ from the one-device train's")
    if ledger.h2d_bytes != h2d:
        fail(f"bayes.train on the mesh moved {ledger.h2d_bytes:,} H2D "
             f"bytes, the one-device train {h2d:,}")
    print(f"bayes.train {n:,} rows on {mesh} (each chunk's rows in "
          f"{mesh_n} slices): {mesh_wall:.4f} s = "
          f"{n / mesh_wall:,.0f} rows/s; model lines equal the one-device "
          f"train's", flush=True)
    train = {"rows": n, "wall_s": wall, "rows_per_s": n / wall,
             "chunks": chunks, "h2d_bytes": h2d, "model_write_s": write_s,
             "cpu_wall_s": cpu_wall, "mesh_devices": mesh_n,
             "mesh_wall_s": mesh_wall,
             **{k: v for k, v in stats.items()}}
    print(f"bayes.train {n:,} rows: card {wall:.4f} s = "
          f"{n / wall:,.0f} rows/s ({chunks} chunks, H2D {h2d:,} bytes: "
          f"the 4-bit wire), layers {json.dumps(stats)}, model write "
          f"{write_s:.4f} s; device='cpu' {cpu_wall:.4f} s; model lines "
          f"equal; phase 44 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    train["phase_s"] = time.perf_counter() - t_phase

    n = NB_CLI_ROWS
    t_phase = time.perf_counter()
    phase(f"45 scale: bayesianDistribution + bayesianPredictor over a "
          f"{n:,}-row CSV on the card == -Dplatform=cpu")
    base = os.path.join(WORK, "nb_cli")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    csv = os.path.join(base, "churn.csv")
    cols = churn_columns(rng, n)
    write_churn_csv(cols, csv)
    props = f"-Dconf.path={os.path.join(RES, 'churn.properties')}"
    churn = os.path.join(RES, "churn.json")
    walls = {}
    for plat in ("cuda", "cpu"):
        model = os.path.join(base, f"model_{plat}")
        keys = [props, f"-Dplatform={plat}"]
        t0 = time.perf_counter()
        run_cli(["bayesianDistribution", *keys,
                 f"-Dbad.feature.schema.file.path={churn}", csv, model])
        walls[f"train_{plat}_s"] = time.perf_counter() - t0
        bap = keys + [f"-Dbap.feature.schema.file.path={churn}",
                      "-Dbap.bayesian.model.file.path="
                      f"{os.path.join(base, 'model_cuda', 'part-r-00000')}"]
        t0 = time.perf_counter()
        run_cli(["bayesianPredictor", *bap, csv,
                 os.path.join(base, f"pred_{plat}")])
        walls[f"predict_{plat}_s"] = time.perf_counter() - t0
        run_cli(["bayesianPredictor", *bap,
                 "-Dbap.output.feature.prob.only=true", csv,
                 os.path.join(base, f"prob_{plat}")])
    same_bytes(os.path.join(base, "model_cuda", "part-r-00000"),
               os.path.join(base, "model_cpu", "part-r-00000"),
               f"{n:,}-row model, card vs cpu")
    same_bytes(os.path.join(base, "pred_cuda", "part-m-00000"),
               os.path.join(base, "pred_cpu", "part-m-00000"),
               f"{n:,}-row pred, card vs cpu")
    with open(os.path.join(base, "prob_cuda", "part-m-00000")) as a, \
            open(os.path.join(base, "prob_cpu", "part-m-00000")) as b:
        got, want = a.read().splitlines(), b.read().splitlines()
    if len(got) != len(want):
        fail(f"feature-prob runs: {len(got)} lines on the card, "
             f"{len(want)} on the cpu")
    strings = sum(x != y for g, w in zip(got, want)
                  for x, y in zip(g.split(","), w.split(",")))
    print(f"feature-prob strings that differ, card vs cpu: {strings} of "
          f"{len(got) * 3:,} (target 0)", flush=True)
    if strings:
        fail(f"{strings} feature-prob strings differ between the card and "
             f"the cpu")
    # the predict layers of the library call over the same rows
    tab = load_csv(csv, fs)
    model = bayes.NaiveBayesModel.from_lines(read_text_input(os.path.join(
        base, "model_cuda", "part-r-00000")), fs)
    bayes.predict(model, tab, device=dev)
    torch.cuda.synchronize()
    pstats, tstats = {}, {}
    t0 = time.perf_counter()
    bayes.predict(model, tab, device=dev, stats=pstats)
    pwall = time.perf_counter() - t0
    t0 = time.perf_counter()
    bayes.train(tab, device=dev, stats=tstats)
    twall = time.perf_counter() - t0
    cli = {"rows": n, **walls,
           "train_rows_per_s": n / walls["train_cuda_s"],
           "predict_rows_per_s": n / walls["predict_cuda_s"],
           "feature_prob_string_diffs": strings,
           "library_predict_s": pwall,
           "library_predict_rows_per_s": n / pwall,
           "predict_layers": pstats, "library_train_s": twall,
           "library_train_rows_per_s": n / twall, "train_layers": tstats,
           "phase_s": time.perf_counter() - t_phase}
    print(f"{n:,}-row CLI pair: {json.dumps(cli)}", flush=True)
    return train, cli, csv


def bayes_joined(csv):
    """Phase 46: bayesianDistribution over per-process files on two gloo
    ranks on the card (--joined-child), phase 45's CSV split in halves and
    at 60/40 between the ranks: every rank's model equals phase 45's
    one-process model of the whole file."""
    n = NB_CLI_ROWS
    t_phase = time.perf_counter()
    phase(f"46 joined-nb: bayesianDistribution over {n // 2:,} + "
          f"{n // 2:,} and {6 * n // 10:,} + {4 * n // 10:,} rows on two "
          f"ranks == one process over the {n:,}-row CSV")
    base = os.path.join(WORK, "nb_joined")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    props = f"-Dconf.path={os.path.join(RES, 'churn.properties')}"
    churn = (f"-Dbad.feature.schema.file.path="
             f"{os.path.join(RES, 'churn.json')}")
    layouts = {"half": [0, n // 2, n], "uneq": [0, 6 * n // 10, n]}
    ranks = [[], []]
    for name, cuts in layouts.items():
        parts = [os.path.join(base, f"{name}{i}.csv") for i in range(2)]
        split_lines(csv, cuts, parts)
        for i in range(2):
            ranks[i].append((name, ["bayesianDistribution", props, churn,
                                    parts[i], f"{base}/{name}_out{i}"]))
    ports = [free_port() for _ in ranks[0]]
    cmds = []
    for i, runs in enumerate(ranks):
        spec = os.path.join(base, f"spec{i}.json")
        with open(spec, "w") as fh:
            json.dump({"runs": [{"name": r, "argv": a, "port": p}
                                for (r, a), p in zip(runs, ports)]}, fh)
        tmp = os.path.join(base, f"tmp{i}")
        os.makedirs(tmp)
        cmds.append(([sys.executable, os.path.abspath(__file__),
                      "--joined-child", spec,
                      os.path.join(base, f"result{i}.json")],
                     lane_env({"TMPDIR": tmp, "RANK": str(i),
                               "WORLD_SIZE": "2", "LOCAL_RANK": str(i),
                               "MASTER_ADDR": "127.0.0.1"}, True)))
    res = run_children(cmds, timeout=300)
    all_ok(res, "phase 46")
    want = os.path.join(WORK, "nb_cli", "model_cuda", "part-r-00000")
    out = {}
    for i in range(2):
        for r in read_json(os.path.join(base, f"result{i}.json")):
            if r["rc"] != 0:
                fail(f"phase 46: rank {i} job {r['name']} exited {r['rc']}")
            out.setdefault(r["name"], []).append(
                {k: r[k] for k in ("wall_s", "join_s", "allreduce_ms")
                 if k in r})
            same_bytes(os.path.join(base, f"{r['name']}_out{i}",
                                    "part-r-00000"), want,
                       f"joined nb {r['name']} rank {i}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 46 ranks: {json.dumps(out)}", flush=True)
    return out


# --------------------------------------------------------------------------
# serving over the RESP wire (phases 47-50)
# --------------------------------------------------------------------------

def _wire_loop(svc, server, msgs, lease_s=0.0):
    """Push ``msgs`` (ending in ``stop``) to ``server``'s request queue,
    run one RespPredictionLoop over ``svc`` to the stop; returns (the
    replies in prediction-queue order, the loop's wall seconds)."""
    from avenir_tpu_torch.io import respq
    from avenir_tpu_torch.serving.service import RespPredictionLoop
    feeder = respq.RespClient(port=server.port)
    for s in range(0, len(msgs), 10_000):
        feeder.lpush_many("requestQueue", msgs[s:s + 10_000])
    loop = RespPredictionLoop(svc, {"redis.server.port": server.port,
                                    "redis.lease.timeout.s": lease_s})
    t0 = time.perf_counter()
    loop.run(max_idle_s=30.0)
    wall = time.perf_counter() - t0
    loop.close()
    replies = _drain(feeder)
    feeder.close()
    return replies, wall


def _drain(client, queue="predictionQueue"):
    out = []
    while True:
        got = client.rpop_many(queue, 10_000)
        if not got:
            return out
        out.extend(got)


def _reply_labels(replies, n, what):
    from avenir_tpu_torch.io.respq import dedup_replies
    by_id, dups = dedup_replies(replies)
    if dups:
        fail(f"{what}: {dups} duplicate replies")
    missing = [i for i in range(n) if str(i) not in by_id]
    if missing:
        fail(f"{what}: no reply for {len(missing)} requests "
             f"(first {missing[:5]})")
    return by_id


def wire_phases(dev):
    """Phases 47-50: predictionService over the RESP wire on the card
    (both data planes), the int8 predictq form, a delta reload under a
    running loop, a durable leased broker with a loop and the broker
    killed mid-batch, and driftMonitor dm.source=resp.  Launch counts are
    zeroed just before each path and read just after."""
    import torch
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import encode_rows
    from avenir_tpu_torch.io import native_wire, respq
    from avenir_tpu_torch.kernels import histogram, vote
    from avenir_tpu_torch.models.tree import DecisionTreeModel, FeatureCache
    from avenir_tpu_torch.serving.predictor import DEFAULT_BUCKETS, \
        make_predictor
    from avenir_tpu_torch.serving.quantized import load_quantized, \
        wire_encode_rows
    from avenir_tpu_torch.serving.registry import ModelRegistry
    from avenir_tpu_torch.serving.service import BatchPolicy, \
        PredictionService, RespPredictionLoop
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    props = os.path.join(RES, "rafo.properties")
    fs = FeatureSchema.load(os.path.join(RES, "call_hangup.json"))
    warm = len(DEFAULT_BUCKETS)
    out = {}
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        base = fh.read().splitlines()
    n = WIRE_ROWS
    records = (base * -(-n // len(base)))[:n]
    rec_path = os.path.join(WORK, "wire_records.csv")
    with open(rec_path, "w") as fh:
        fh.write("\n".join(records) + "\n")
    reg = os.path.join(WORK, "wire_registry")
    shutil.copytree(os.path.join(RAFO9, "registry"), reg)

    phase(f"47 wire serve: predictionService ps.transport=resp over "
          f"{n:,} rafo9 records, native and Python planes")
    jobs = {}
    for name, extra in (("inprocess", ("-Dps.transport=inprocess",)),
                        ("native", ("-Dps.transport=resp",
                                    "-Dps.wire.native=on")),
                        ("python", ("-Dps.transport=resp",
                                    "-Dps.wire.native=off"))):
        dest = os.path.join(WORK, f"wire_{name}")
        zero_launches()
        with transfer_ledger() as ledger:
            t0 = time.perf_counter()
            run_cli(["org.avenir.serving.PredictionService",
                     f"-Dconf.path={props}", f"-Dps.model.registry.dir={reg}",
                     "-Dps.model.name=rafo9", *extra, rec_path, dest])
            wall = time.perf_counter() - t0
        counts = launch_counts()
        table = vote.table_launches
        sc = read_json(dest + ".counters.json")["Serving"]
        jobs[name] = {"wall_s": wall, "requests_per_s": n / wall,
                      "p50_us": sc["serve.request.p50Us"],
                      "p99_us": sc["serve.request.p99Us"],
                      "batches": sc["Batches"], "b2_launches": counts["b2"],
                      "b2_table_launches": table,
                      "backends": ledger.backend_snapshot()}
        print(f"predictionService {name}: {sc['Requests']} requests in "
              f"{sc['Batches']} batches, wall {wall:.2f} s "
              f"({n / wall:,.0f} requests/s, push + serve + read back), "
              f"serve.request p50/p99 {sc['serve.request.p50Us']}/"
              f"{sc['serve.request.p99Us']} us, ensemble_vote launches "
              f"{counts['b2']} (table form {table}, {warm} warm-up)",
              flush=True)
        if counts["b2"] != sc["Batches"] + warm or table != counts["b2"]:
            fail(f"wire serve {name}: {counts['b2']} vote launches "
                 f"({table} table form) for {sc['Batches']} batches + "
                 f"{warm} warm-up")
    native_wire.set_mode("auto")
    inproc = os.path.join(WORK, "wire_inprocess", "part-m-00000")
    for name in ("native", "python"):
        same_bytes(os.path.join(WORK, f"wire_{name}", "part-m-00000"),
                   inproc, f"resp {name} plane vs inprocess")
    run_cli(["org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
             f"-Dmop.model.dir.path={RAFO9}",
             f"-Dmop.feature.schema.file.path="
             f"{os.path.join(RES, 'call_hangup.json')}",
             rec_path, os.path.join(WORK, "wire_mop")])
    with open(os.path.join(WORK, "wire_mop", "part-m-00000")) as fh:
        mop = [line.rsplit(",", 1)[1] for line in fh.read().splitlines()]
    with open(inproc) as fh:
        served = [line.split(",", 1)[1] for line in fh.read().splitlines()]
    if mop != served:
        fail(f"wire serve: {sum(a != b for a, b in zip(mop, served))} "
             f"labels differ from modelPredictor's")
    print(f"the {n:,} labels of both planes equal modelPredictor's on the "
          f"same records", flush=True)
    # the loop alone (the job's wall is mostly its one-LPUSH-a-record push
    # and one-RPOP-a-reply read-back): each plane over the same messages
    msgs = [f"predict,{i},{r}" for i, r in enumerate(records)]
    for plane, name in (("on", "native"), ("off", "python")):
        svc = PredictionService(registry=ModelRegistry(reg),
                                model_name="rafo9", device=dev,
                                wire_native=plane,
                                policy=BatchPolicy(max_batch=64))
        server = respq.RespServer().start()
        try:
            replies, wall = _wire_loop(svc, server, msgs + ["stop"])
        finally:
            server.stop()
        by_id = _reply_labels(replies, n, f"{name} loop")
        if [by_id[str(i)] for i in range(n)] != served:
            fail(f"the {name} loop's replies differ from the in-process "
                 f"serve")
        jobs[name].update(
            loop_s=wall, loop_requests_per_s=n / wall,
            loop_batch_p50_us=svc.timer.percentile_ms("serve.batch", 50) * 1e3,
            loop_batch_p99_us=svc.timer.percentile_ms("serve.batch", 99) * 1e3)
        print(f"{name} plane, the loop alone: {n:,} requests in {wall:.2f} s "
              f"({n / wall:,.0f} requests/s), serve.batch p50/p99 "
              f"{jobs[name]['loop_batch_p50_us']:.0f}/"
              f"{jobs[name]['loop_batch_p99_us']:.0f} us", flush=True)
    out["serve"] = jobs

    phase(f"48 predictq: {n:,} records binned on the rafo9q grid as "
          f"predictq lines, ps.quantized, plus malformed and unservable "
          f"lines")
    qreg = os.path.join(WORK, "wire_qregistry")
    shutil.copytree(os.path.join(RAFO9Q, "registry"), qreg)
    registry = ModelRegistry(qreg)
    qf = load_quantized(registry, "rafo9", 1)
    trees = registry.load("rafo9", 1).model
    vals, codes = FeatureCache().host(
        DecisionTreeModel(trees[0], fs, device="cpu").matrix,
        encode_rows([r.split(",") for r in records], fs))
    qv, qc = qf.quantize_rows(vals, codes)
    qlines = wire_encode_rows(range(n), qv, qc)
    bad = ["predictq,m1,3,1,2,3,4,5,6", "predictq,m2,4,+1,0,0,0,0,0,0,0",
           "predictq,m3,4,1,2"]
    qdest = os.path.join(WORK, "wire_q_inprocess")
    run_cli(["org.avenir.serving.PredictionService", f"-Dconf.path={props}",
             f"-Dps.model.registry.dir={qreg}", "-Dps.model.name=rafo9",
             "-Dps.quantized=true", "-Dps.transport=inprocess", rec_path,
             qdest])
    with open(os.path.join(qdest, "part-m-00000")) as fh:
        q_inproc = [line.split(",", 1)[1] for line in fh.read().splitlines()]
    svc = PredictionService(registry=registry, model_name="rafo9",
                            quantized=True, device=dev,
                            policy=BatchPolicy(max_batch=64))
    server = respq.RespServer().start()
    try:
        zero_launches()
        replies, wall = _wire_loop(svc, server, qlines + bad + ["stop"])
        counts = launch_counts()
    finally:
        server.stop()
    by_id = _reply_labels(replies, n, "predictq")
    if [by_id[str(i)] for i in range(n)] != q_inproc:
        fail("predictq replies differ from the in-process int8 serve")
    if [by_id.get(m) for m in ("m1", "m2", "m3")] != ["error"] * 3 or \
            svc.counters.get("Serving", "BadRequests") != 3:
        fail(f"predictq: malformed lines answered "
             f"{[by_id.get(m) for m in ('m1', 'm2', 'm3')]}, BadRequests "
             f"{svc.counters.get('Serving', 'BadRequests')}")
    fsvc = PredictionService(registry=ModelRegistry(reg), model_name="rafo9",
                             device=dev)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        unserved = fsvc.process_batch(qlines[:5])
    if unserved != [f"{i},error" for i in range(5)] or \
            fsvc.counters.get("Serving", "BadRequests") != 5:
        fail(f"predictq on a model without a sidecar answered {unserved}")
    q_batches = svc.counters.get("Serving", "Batches")
    print(f"predictq: {n:,} replies equal the in-process int8 serve; 3 "
          f"malformed and 5 unservable lines answered error and counted; "
          f"loop {wall:.2f} s ({n / wall:,.0f} requests/s), "
          f"quantized_vote launches {counts['b3']} for {q_batches} batches "
          f"(the service warmed before the count), ensemble_vote "
          f"{counts['b2']}", flush=True)
    if counts["b3"] != q_batches or counts["b2"]:
        fail(f"predictq: {counts['b3']} int8 launches for {q_batches} "
             f"batches, {counts['b2']} float")
    out["predictq"] = {"b3_launches": counts["b3"], "batches": q_batches,
                       "loop_s": wall, "requests_per_s": n / wall}

    phase("49 delta reload on the card: publish_delta v2 (two trees) while "
          "the wire loop serves, then reload")
    dreg_dir = os.path.join(WORK, "wire_dregistry")
    shutil.copytree(os.path.join(RAFO9, "registry"), dreg_dir)
    dreg = ModelRegistry(dreg_dir)
    v1 = dreg.load("rafo9", 1)
    swapped = ModelRegistry(os.path.join(WIRE9, "registry")).load(
        "rafo9", 2).model
    child = list(v1.model)
    for i in DELTA_TREES:
        child[i] = swapped[i]
    msgs = [f"predict,{i},{r}" for i, r in enumerate(records[:2 * DELTA_ROWS])]
    a, b = msgs[:DELTA_ROWS], msgs[DELTA_ROWS:]
    svc = PredictionService(registry=dreg, model_name="rafo9", device=dev,
                            policy=BatchPolicy(max_batch=64))
    server = respq.RespServer().start()
    feeder = respq.RespClient(port=server.port)
    loop = RespPredictionLoop(svc, {"redis.server.port": server.port})
    runner = threading.Thread(target=loop.run, kwargs={"max_idle_s": 60.0})
    try:
        runner.start()
        feeder.lpush_many("requestQueue", a)
        dreg.publish_delta("rafo9", child, parent_version=1,
                           schema=v1.schema)
        feeder.lpush("requestQueue", "reload")
        deadline = time.monotonic() + 120.0
        while svc.version != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        if svc.version != 2:
            fail("delta reload: the loop never reached v2")
        zero_launches()
        with transfer_ledger() as ledger:
            feeder.lpush_many("requestQueue", b + ["stop"])
            runner.join(timeout=300.0)
        counts = launch_counts()
        table = vote.table_launches
        replies = _drain(feeder)
    finally:
        loop.stopped = True
        runner.join(timeout=30.0)
        feeder.close()
        server.stop()
    by_id = _reply_labels(replies, 2 * DELTA_ROWS, "delta reload")
    fresh = make_predictor(dreg.load("rafo9", 2), device=dev)
    want = fresh.predict_rows([r.split(",") for r in
                               records[DELTA_ROWS:2 * DELTA_ROWS]])
    got = [by_id[str(i)] for i in range(DELTA_ROWS, 2 * DELTA_ROWS)]
    if got != want:
        fail(f"delta reload: {sum(x != y for x, y in zip(got, want))} "
             f"replies after the patch differ from a full load of v2")
    v1_labels = [by_id[str(i)] for i in range(DELTA_ROWS)]
    changed = sum(x != y for x, y in zip(
        make_predictor(v1, device=dev).predict_rows(
            [r.split(",") for r in records[DELTA_ROWS:2 * DELTA_ROWS]]),
        want))
    sc = svc.counters
    h2d = sc.get("Serving", "DeltaH2DBytes")
    form = vote.vote_form(svc.predictor.ensemble._stacked)
    print(f"delta reload: DeltaSwaps {sc.get('Serving', 'DeltaSwaps')}, "
          f"HotSwaps {sc.get('Serving', 'HotSwaps')}, H2D bytes moved "
          f"{h2d} (the resident stacked form is "
          f"{sum(x.nbytes for x in svc.predictor.ensemble._host)} bytes); "
          f"the {DELTA_ROWS:,} replies after it equal a full load of v2 "
          f"({changed} of them differ from v1's answer; {len(v1_labels)} "
          f"served before); ensemble_vote launches after the patch "
          f"{counts['b2']}, table form {table}, model form {form}; "
          f"KernelBackends {ledger.backend_snapshot()}", flush=True)
    if sc.get("Serving", "DeltaSwaps") != 1 or sc.get("Serving",
                                                      "DeltaSwapTorn"):
        fail("delta reload did not patch exactly once")
    if counts["b2"] <= 0 or table != counts["b2"] or form != "table":
        fail(f"delta reload: {counts['b2']} launches after the patch, "
             f"{table} in the table form (model form {form})")
    if not changed:
        fail("delta reload: v2 answers every row as v1 does; the check "
             "cannot tell the patch from no patch")
    # the same reload onto a tree-sharded core: every shard's slice
    # patched, B6 + merge-finalize after it (distinct cards where several
    # are visible, else the card repeated, as phase 21 does)
    from avenir_tpu_torch.parallel.mesh import DeviceMesh
    n_cards = torch.cuda.device_count()
    mesh = DeviceMesh([f"cuda:{i}" for i in range(n_cards)] if n_cards > 1
                      else [dev] * 2)
    dreg.pin_version("rafo9", 1)
    sharded = PredictionService(registry=dreg, model_name="rafo9",
                                serve_mesh=mesh)
    dreg.clear_pin("rafo9")
    if not sharded.refresh() or \
            sharded.counters.get("Serving", "DeltaSwaps") != 1:
        fail("delta reload onto the sharded core did not patch")
    vote.partial_launches = vote.finalize_launches = 0
    got_s = sharded.predictor.predict_rows(
        [r.split(",") for r in records[DELTA_ROWS:2 * DELTA_ROWS]])
    parts, fins = vote.partial_launches, vote.finalize_launches
    if got_s != want or fins <= 0 or parts != fins * mesh.size:
        fail(f"delta reload onto the sharded core: answers equal "
             f"{got_s == want}, {parts} partial and {fins} merge-finalize "
             f"launches over {mesh.size} shards")
    print(f"delta reload onto a {mesh.size}-shard core "
          f"({[str(d) for d in mesh.devices]}): DeltaSwaps 1, H2D bytes "
          f"{sharded.counters.get('Serving', 'DeltaH2DBytes')}, answers "
          f"equal a full load of v2; {parts} partial-vote and {fins} "
          f"merge-finalize launches", flush=True)
    out["delta"] = {"h2d_bytes": h2d, "b2_launches": counts["b2"],
                    "b2_table_launches": table, "rows_changed": changed,
                    "sharded_partial_launches": parts,
                    "sharded_finalize_launches": fins}

    phase("50 durable leased broker: a loop and the broker killed "
          "mid-batch; driftMonitor dm.source=resp")
    jdir = os.path.join(WORK, "wire_journal")
    msgs = [f"predict,{i},{r}" for i, r in enumerate(records[:DURABLE_ROWS])]
    cfg = {"redis.lease.timeout.s": 5.0}
    server = respq.RespServer(durable="commit", journal_dir=jdir).start()
    feeder = respq.RespClient(port=server.port)
    feeder.lpush_many("requestQueue", msgs + ["stop"])
    feeder.close()
    svc = PredictionService(registry=ModelRegistry(reg), model_name="rafo9",
                            device=dev, policy=BatchPolicy(max_batch=64))
    dead = RespPredictionLoop(svc, {**cfg, "redis.server.port": server.port})
    for _ in range(DURABLE_ACKED_POLLS):
        dead.poll_once()
    taken = dead.client.lease_many("requestQueue", 64, 5.0)
    dead.close()                   # the loop dies holding a leased batch
    server.kill()                  # and the broker dies with it
    again = respq.RespServer(durable="commit", journal_dir=jdir).start()
    try:
        svc2 = PredictionService(registry=ModelRegistry(reg),
                                 model_name="rafo9", device=dev,
                                 policy=BatchPolicy(max_batch=64))
        replies, _ = _wire_loop(svc2, again, [], lease_s=5.0)
        restored = again.journal_replayed
    finally:
        again.stop()
    by_id = _reply_labels(replies, DURABLE_ROWS, "durable broker")
    if [by_id[str(i)] for i in range(DURABLE_ROWS)] != \
            served[:DURABLE_ROWS]:
        fail("durable broker: the reply set differs from the in-process "
             "serve")
    print(f"durable broker: {DURABLE_ACKED_POLLS} batches acked, a leased "
          f"batch of {len(taken)} held by the killed loop, the broker "
          f"killed and restarted: {restored} values replayed from the "
          f"journal, {len(replies)} replies, one a request, equal to the "
          f"in-process serve", flush=True)

    mk = fixture_module("drift9")
    dreg9 = os.path.join(WORK, "wire_drift_registry")
    shutil.copytree(os.path.join(RAFO9Q, "registry"), dreg9)
    stream = os.path.join(DRIFT9, "stream.csv")
    with open(stream) as fh:
        lines = fh.read().splitlines()
    server = respq.RespServer().start()
    try:
        feeder = respq.RespClient(port=server.port)
        feeder.lpush_many("driftQueue", lines + ["stop"])
        feeder.close()
        reports = {}
        for source, extra in (
                ("file", ()),
                ("resp", ("-Ddm.source=resp",
                          f"-Dredis.server.port={server.port}",
                          "-Dredis.request.queue=driftQueue"))):
            dest = os.path.join(WORK, f"wire_drift_{source}")
            histogram.bin_counts_launches = 0
            run_cli(["driftMonitor", f"-Ddm.model.registry.dir={dreg9}",
                     f"-Ddm.model.name={mk.MODEL_NAME}", *mk.KEYS, *extra,
                     stream, dest])
            reports[source] = (dest, histogram.bin_counts_launches,
                               read_json(dest + ".counters.json"))
    finally:
        server.stop()
    for f in ("part-r-00000", "alerts.jsonl"):
        same_bytes(os.path.join(reports["resp"][0], f),
                   os.path.join(reports["file"][0], f),
                   f"driftMonitor dm.source=resp {f} vs dm.source=file")
    dest, b4, counters = reports["resp"]
    windows = counters["Dispatches"]["monitor.absorb"]
    print(f"driftMonitor dm.source=resp: bin_counts launches {b4} for "
          f"{windows} windows (dm.source=file: {reports['file'][1]})",
          flush=True)
    if b4 != windows or b4 <= 0:
        fail(f"drift over resp: {b4} bin-counts launches for {windows} "
             f"windows")
    out["durable"] = {"restored": restored, "leased_batch": len(taken),
                      "replies": len(replies)}
    out["drift"] = {"b4_launches": b4, "windows": windows}
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# the serving fleet (phases 51-55)
# --------------------------------------------------------------------------

def fleet_job(mk, case, records, dest, *extra):
    """predictionService of fleet9 ``case`` through the port's CLI on the
    card over ``records``; returns the job's counters."""
    reg = mk.case_registry(os.path.join(FLEET9, "registry"),
                           dest + "_registry", case)
    run_cli(["org.avenir.serving.PredictionService",
             f"-Dconf.path={mk.PROPS}", f"-Dps.model.registry.dir={reg}",
             f"-Dps.model.name={mk.MODEL_NAME}", "-Dps.transport=resp",
             *mk.CASES[case][0], *extra, records, dest])
    return read_json(dest + ".counters.json")


def reference_labels(registry, version, records, dev):
    """One full load of ``version`` on the card: the labels of
    ``records`` (the oracle the fleet's replies are held to)."""
    from avenir_tpu_torch.serving.predictor import make_predictor
    pred = make_predictor(registry.load("rafo9", version), device=dev)
    rows = [r.split(",") for r in records]
    out = []
    for s in range(0, len(rows), 512):
        out.extend(pred.predict_rows(rows[s:s + 512]))
    return out


def fleet_drain(reg_dir, msgs, workers, shards, own_stream=True):
    """Prefill ``msgs`` and a ``stop`` on ``shards`` broker shards, then
    drain them with a ``workers``-worker ServingFleet; launch counts zeroed
    before the fleet starts (its warm-ups counted).  Returns the replies,
    the drain's wall seconds (from the drain threads' start to the last
    worker's exit), the counts and the fleet (stopped)."""
    from avenir_tpu_torch.io import respq
    from avenir_tpu_torch.kernels import vote
    from avenir_tpu_torch.serving import BatchPolicy, ModelRegistry, \
        ServingFleet
    servers = [respq.RespServer().start() for _ in range(shards)]
    cfg = {"redis.server.endpoints": [f"127.0.0.1:{s.port}"
                                      for s in servers]}
    feeder = respq.make_queue_client(cfg)
    fleet = None
    try:
        for s in range(0, len(msgs), 10_000):
            feeder.lpush_many("requestQueue", msgs[s:s + 10_000])
        feeder.lpush("requestQueue", "stop")
        fleet = ServingFleet(ModelRegistry(reg_dir), "rafo9",
                             n_workers=workers, config=cfg,
                             policy=BatchPolicy(max_batch=64),
                             own_stream=own_stream)
        zero_launches()
        fleet.start()
        t0 = time.perf_counter()
        if not fleet.wait(timeout_s=300.0):
            fail(f"fleet drain ({workers} workers, {shards} shards): "
                 f"workers still draining after 300 s")
        wall = time.perf_counter() - t0
        counts = launch_counts()
        counts["table"] = vote.table_launches
        replies = _drain(feeder)
    finally:
        if fleet is not None:
            fleet.stop(drain_s=1.0)
        feeder.close()
        for srv in servers:
            srv.stop()
    return replies, wall, counts, fleet


def _scrape(url, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url + path, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def fleet_phases(dev):
    """Phases 51-55: the fleet tier of predictionService on the card —
    fleet9's cases through the CLI, the fleet loop alone at 10,000
    requests over 1, 2 and 4 workers and 1 and 2 broker shards (and the
    default-stream comparison), the router's cases and a tree-sharded
    fleet, a delta hot-swap and degraded parking under load, the
    autoscaled job and two fleet_host processes.  Launch counts are zeroed
    just before each path and read just after."""
    from avenir_tpu_torch.cli import run as cli_run
    from avenir_tpu_torch.io import respq
    from avenir_tpu_torch.kernels import vote
    from avenir_tpu_torch.parallel.mesh import (DeviceMesh, MeshContext,
                                                set_runtime_context)
    from avenir_tpu_torch.serving import BatchPolicy, ModelRegistry, \
        ServingFleet
    from avenir_tpu_torch.serving.predictor import DEFAULT_BUCKETS
    from avenir_tpu_torch.telemetry import MetricsRegistry, MetricsServer
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    mk = fixture_module("fleet9")
    warm = len(DEFAULT_BUCKETS)
    fx_reg = os.path.join(FLEET9, "registry")
    want = read_json(os.path.join(FLEET9, "counters.json"))
    work = os.path.join(WORK, "fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(mk.RECORDS) as fh:
        f9_records = fh.read().splitlines()
    valid = os.path.join(work, "valid.csv")
    with open(valid, "w") as fh:
        fh.write("\n".join(f9_records[:300]) + "\n")
    with open(os.path.join(FLEET9, "a.csv")) as fh:
        a_lines = fh.read().splitlines()
    out = {}

    phase("51 fleet main path: fleet9 cases a (2 workers, 2 shards), e "
          "(2 workers, ps.quantized) and f (2 workers, depth 4) through "
          "predictionService on the card")
    main = {}
    for case in ("a", "e", "f"):
        text, counters = mk.run_case(cli_run, fx_reg, work, case)
        if case == "f":
            if not mk.answered_or_busy(text, "\n".join(a_lines) + "\n"):
                fail("fleet9 f: an id unanswered, or answered neither its "
                     "class nor busy")
        else:
            with open(os.path.join(FLEET9, f"{case}.csv")) as fh:
                if fh.read() != text:
                    fail(f"fleet9 {case}: part file differs from "
                         f"tests/torch_fixtures/fleet9/{case}.csv")
            if counters != want[case]:
                fail(f"fleet9 {case}: counters {counters} != {want[case]}")
        # the exact launch count, over the 300 well-formed records (a
        # malformed record sends its batch through per-row isolation)
        zero_launches()
        with transfer_ledger() as ledger:
            c = fleet_job(mk, case, valid, os.path.join(work, f"n_{case}"))
        counts = launch_counts()
        table = vote.table_launches
        sc = c["Serving"]
        workers = sc["Workers"]
        kernel, other = ("b3", "b2") if case == "e" else ("b2", "b3")
        main[case] = {"workers": workers, "batches": sc["Batches"],
                      "rejected": sc.get("Rejected", 0),
                      "launches": counts[kernel], "table_launches": table,
                      "backends": ledger.backend_snapshot()}
        said = f"every id answered ({text.count(',busy')} busy)" \
            if case == "f" else "bytes and counters equal the fixture"
        print(f"fleet9 {case}: {said}; over the 300 well-formed records: "
              f"{workers} workers, "
              f"{sc['Batches']} batches, {sc.get('Rejected', 0)} rejected, "
              f"{'quantized_vote' if case == 'e' else 'ensemble_vote'} "
              f"launches {counts[kernel]} (table form {table}), "
              f"KernelBackends {ledger.backend_snapshot()}", flush=True)
        if counts[kernel] != sc["Batches"] + warm * workers \
                or table != counts[kernel] or counts[other]:
            fail(f"fleet9 {case}: {counts[kernel]} {kernel} launches "
                 f"({table} table form, {counts[other]} {other}) for "
                 f"{sc['Batches']} batches + {warm} warm-ups x {workers} "
                 f"workers")
    out["main"] = main

    n = FLEET_ROWS
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        base = fh.read().splitlines()
    records = (base * -(-n // len(base)))[:n]
    reg_dir = os.path.join(work, "registry52")
    shutil.copytree(fx_reg, reg_dir)
    ref = reference_labels(ModelRegistry(reg_dir), 1, records, dev)
    msgs = [f"predict,{i},{r}" for i, r in enumerate(records)]
    n = FLEET_LOOP_ROWS
    loop_msgs, loop_ref = msgs[:n], ref[:n]

    phase(f"52 the fleet loop alone: {n:,} rafo9 requests prefilled, then "
          f"drained by {', '.join(map(str, FLEET_WORKERS))} workers over "
          f"{' and '.join(map(str, FLEET_SHARDS))} broker shard(s); and "
          f"2 workers on the default stream")
    runs = []
    plan = [(w, s, True) for s in FLEET_SHARDS for w in FLEET_WORKERS] + \
        [(2, 1, False)]
    for workers, shards, own in plan:
        replies, wall, counts, fleet = fleet_drain(reg_dir, loop_msgs,
                                                   workers, shards, own)
        by_id = _reply_labels(replies, n, f"fleet {workers}x{shards}")
        if [by_id[str(i)] for i in range(n)] != loop_ref:
            fail(f"fleet {workers} workers x {shards} shards: replies "
                 f"differ from the in-process serve")
        merged = fleet.merged_counters()
        timer = fleet.merged_timer()
        per_worker = [w.service.counters.get("Serving", "Batches")
                      for w in fleet.workers]
        batches = merged.get("Serving", "Batches")
        row = {"workers": workers, "shards": shards, "own_stream": own,
               "wall_s": wall, "requests_per_s": n / wall,
               "batch_p50_us": timer.percentile_ms("serve.batch", 50) * 1e3,
               "batch_p99_us": timer.percentile_ms("serve.batch", 99) * 1e3,
               "overlapped": merged.get("Serving", "OverlappedBatches"),
               "batches": batches, "per_worker_batches": per_worker,
               "b2_launches": counts["b2"], "table_launches": counts["table"]}
        runs.append(row)
        print(f"fleet {workers} worker(s) x {shards} shard(s)"
              f"{'' if own else ', default stream'}: {n:,} requests in "
              f"{wall:.3f} s ({n / wall:,.0f} requests/s), serve.batch "
              f"p50/p99 {row['batch_p50_us']:.0f}/{row['batch_p99_us']:.0f}"
              f" us, OverlappedBatches {row['overlapped']}, batches a "
              f"worker {per_worker}, ensemble_vote launches {counts['b2']} "
              f"(table form {counts['table']}); replies equal the "
              f"in-process serve", flush=True)
        if counts["b2"] != batches + warm * workers \
                or counts["table"] != counts["b2"]:
            fail(f"fleet {workers}x{shards}: {counts['b2']} launches "
                 f"({counts['table']} table form) for {batches} batches + "
                 f"{warm} warm-ups x {workers} workers")
    out["loop"] = runs

    phase("53 router: fleet9 cases b (ps.client.model=backup), c (canary "
          "v1 at 25% while v2 serves) and d (shadow v1) on the card; a "
          "2-worker fleet with device_map=sharded over cuda:0 twice")
    for case in ("b", "c", "d"):
        text, counters = mk.run_case(cli_run, fx_reg, work, case)
        with open(os.path.join(FLEET9, f"{case}.csv")) as fh:
            if fh.read() != text:
                fail(f"fleet9 {case}: part file differs from the fixture")
        if counters != want[case]:
            fail(f"fleet9 {case}: counters {counters} != {want[case]}")
        print(f"fleet9 {case}: bytes and counters {counters} equal the "
              f"fixture", flush=True)
    reg53 = os.path.join(work, "registry53")
    shutil.copytree(fx_reg, reg53)
    mesh = DeviceMesh([dev, dev])
    set_runtime_context(MeshContext(mesh))
    server = respq.RespServer().start()
    feeder = respq.RespClient(port=server.port)
    fleet = None
    try:
        fleet = ServingFleet(ModelRegistry(reg53), "rafo9", n_workers=2,
                             device_map="sharded",
                             config={"redis.server.port": server.port},
                             policy=BatchPolicy(max_batch=64))
        fleet.start()
        zero_launches()
        vote.partial_launches = vote.finalize_launches = 0
        feeder.lpush_many("requestQueue",
                          [f"predict,{i},{r}" for i, r in
                           enumerate(f9_records[:300])] + ["stop"])
        if not fleet.wait(timeout_s=120.0):
            fail("sharded fleet: workers still draining after 120 s")
        counts = launch_counts()
        parts, fins = vote.partial_launches, vote.finalize_launches
        replies = _drain(feeder)
        batches = fleet.merged_counters().get("Serving", "Batches")
    finally:
        if fleet is not None:
            fleet.stop(drain_s=1.0)
        feeder.close()
        server.stop()
        set_runtime_context(None)
    by_id = _reply_labels(replies, 300, "sharded fleet")
    if [f"{i},{by_id[str(i)]}" for i in range(300)] != a_lines[:300]:
        fail("sharded fleet: replies differ from fleet9 a.csv")
    print(f"sharded fleet ({mesh.size} shards on {dev} repeated, 2 workers):"
          f" 300 replies equal fleet9 a.csv; {batches} batches, "
          f"partial-vote launches {parts}, merge-finalize {fins}, "
          f"ensemble_vote {counts['b2']}", flush=True)
    if parts != mesh.size * batches or fins != batches or counts["b2"]:
        fail(f"sharded fleet: {parts} partial and {fins} merge-finalize "
             f"launches, {counts['b2']} float votes, for {batches} batches "
             f"over {mesh.size} shards")
    out["sharded"] = {"batches": batches, "partial_launches": parts,
                      "finalize_launches": fins}

    phase(f"54 hot-swap and degraded parking under load: 2 workers, "
          f"{SWAP_ROWS:,} requests on v1, the pin cleared (v2, a delta of "
          f"v1) and a wire reload, {SWAP_ROWS:,} more; then mark_degraded "
          f"on one worker")
    reg54 = os.path.join(work, "registry54")
    shutil.copytree(fx_reg, reg54)
    registry = ModelRegistry(reg54)
    ref2 = reference_labels(registry, 2, records[:3 * SWAP_ROWS], dev)
    mreg = MetricsRegistry()
    msrv = MetricsServer(mreg, port=0).start()
    server = respq.RespServer().start()
    feeder = respq.RespClient(port=server.port)
    fleet = ServingFleet(registry, "rafo9", n_workers=2, metrics=mreg,
                         config={"redis.server.port": server.port},
                         policy=BatchPolicy(max_batch=64))
    try:
        fleet.start()
        feeder.lpush_many("requestQueue", msgs[:SWAP_ROWS])
        registry.clear_pin("rafo9")
        feeder.lpush("requestQueue", "reload")
        feeder.lpush_many("requestQueue", msgs[SWAP_ROWS:2 * SWAP_ROWS])
        got = {}
        deadline = time.monotonic() + 120.0
        while len(got) < 2 * SWAP_ROWS and time.monotonic() < deadline:
            vs = feeder.rpop_many("predictionQueue", 10_000)
            if not vs:
                time.sleep(0.005)
            for v in vs:
                rid, lab = v.split(",", 1)
                if rid in got:
                    fail(f"hot-swap: request {rid} answered twice")
                got[rid] = lab
        if len(got) != 2 * SWAP_ROWS:
            fail(f"hot-swap: {len(got)} of {2 * SWAP_ROWS} answered")
        if any(got[str(i)] not in (ref[i], ref2[i])
               for i in range(2 * SWAP_ROWS)):
            fail("hot-swap: a reply is neither v1's nor v2's class")
        while fleet.converged_version() != 2 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        if fleet.converged_version() != 2:
            fail("hot-swap: the workers never converged on v2")
        delta = [w.service.counters.get("Serving", "DeltaH2DBytes")
                 for w in fleet.workers]
        swaps = [w.service.counters.get("Serving", "DeltaSwaps")
                 for w in fleet.workers]
        zero_launches()
        feeder.lpush_many("requestQueue", msgs[2 * SWAP_ROWS:3 * SWAP_ROWS])
        after = _collect_replies(feeder, SWAP_ROWS, "hot-swap after")
        counts = launch_counts()
        table = vote.table_launches
        if [after[str(i)] for i in range(2 * SWAP_ROWS, 3 * SWAP_ROWS)] != \
                ref2[2 * SWAP_ROWS:]:
            fail("hot-swap: replies after the swap differ from a full "
                 "load of v2")
        print(f"hot-swap: {2 * SWAP_ROWS:,} ids answered once each across "
              f"the reload; every worker on v2 by the delta patch "
              f"(DeltaSwaps {swaps}, DeltaH2DBytes a worker {delta}); "
              f"{SWAP_ROWS:,} replies after it equal a full load of v2, "
              f"ensemble_vote launches {counts['b2']}, table form {table}",
              flush=True)
        if swaps != [1, 1] or counts["b2"] <= 0 or table != counts["b2"]:
            fail(f"hot-swap: DeltaSwaps {swaps}, {counts['b2']} launches "
                 f"after it, {table} in the table form")
        w0, w1 = (w.service for w in fleet.workers)
        w0.mark_degraded("drift: psi over threshold")
        code0, _ = _scrape(msrv.url, "/healthz/rafo9-w0")
        code1, _ = _scrape(msrv.url, "/healthz/rafo9-w1")
        deadline = time.monotonic() + 30.0
        while w0.counters.get("Serving", "ParkedPolls") == 0 and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        served0 = w0.counters.get("Serving", "Requests")
        served1 = w1.counters.get("Serving", "Requests")
        feeder.lpush_many("requestQueue",
                          [f"predict,p{i},{records[i]}"
                           for i in range(SWAP_ROWS)])
        parked = _collect_replies(feeder, SWAP_ROWS, "degraded parking")
        if [parked[f"p{i}"] for i in range(SWAP_ROWS)] != ref2[:SWAP_ROWS]:
            fail("degraded parking: the peer's replies differ from v2's")
        moved0 = w0.counters.get("Serving", "Requests") - served0
        moved1 = w1.counters.get("Serving", "Requests") - served1
        print(f"degraded parking: /healthz/rafo9-w0 {code0}, "
              f"/healthz/rafo9-w1 {code1} (live MetricsServer); "
              f"ParkedPolls {w0.counters.get('Serving', 'ParkedPolls')}; "
              f"the next {SWAP_ROWS:,} requests served {moved1} by the peer "
              f"and {moved0} by the degraded worker", flush=True)
        if code0 != 503 or code1 != 200 or moved0 or moved1 != SWAP_ROWS:
            fail(f"degraded parking: healthz {code0}/{code1}, degraded "
                 f"worker served {moved0}, peer {moved1}")
        out["swap"] = {"delta_h2d_bytes": delta, "b2_after": counts["b2"],
                       "table_after": table}
    finally:
        fleet.stop(drain_s=1.0)
        feeder.close()
        server.stop()
        msrv.stop()

    phase(f"55 autoscale and fleet_host: predictionService ps.autoscale="
          f"true (max 3 workers) over {HOST_ROWS:,} records; then two "
          f"fleet_host processes over 2 shards")
    rec55 = os.path.join(work, "records55.csv")
    with open(rec55, "w") as fh:
        fh.write("\n".join(records[:HOST_ROWS]) + "\n")
    dest = os.path.join(work, "autoscale")
    reg55 = mk.case_registry(fx_reg, dest + "_registry", "a")
    zero_launches()
    run_cli(["org.avenir.serving.PredictionService",
             f"-Dconf.path={mk.PROPS}", f"-Dps.model.registry.dir={reg55}",
             "-Dps.model.name=rafo9", "-Dps.transport=resp",
             "-Dps.autoscale=true", "-Dps.autoscale.max.workers=3",
             "-Dps.autoscale.interval.ms=50", rec55, dest])
    counts = launch_counts()
    c = read_json(dest + ".counters.json")
    with open(os.path.join(dest, "part-m-00000")) as fh:
        labels = [line.split(",", 1)[1] for line in fh.read().splitlines()]
    if labels != ref[:HOST_ROWS]:
        fail("autoscaled job: labels differ from the in-process serve")
    sc = c["Serving"]
    print(f"autoscaled job: Autoscaler {c.get('Autoscaler')}, workers "
          f"started {sc['Workers']}, {sc['Batches']} batches, "
          f"ensemble_vote launches {counts['b2']}", flush=True)
    if counts["b2"] != sc["Batches"] + warm * sc["Workers"] or \
            c.get("Autoscaler", {}).get("Ticks", 0) <= 0:
        fail(f"autoscaled job: {counts['b2']} launches for {sc['Batches']}"
             f" batches + {warm} x {sc['Workers']} warm-ups, Autoscaler "
             f"{c.get('Autoscaler')}")
    out["autoscale"] = {"counters": c.get("Autoscaler"),
                        "workers": sc["Workers"], "b2": counts["b2"],
                        "batches": sc["Batches"]}
    out["hosts"] = fleet_hosts(reg55, records[:HOST_ROWS], ref[:HOST_ROWS])
    return out


def _collect_replies(feeder, n, what, timeout_s=120.0):
    """{id: label} of ``n`` replies, each id once."""
    got = {}
    deadline = time.monotonic() + timeout_s
    while len(got) < n and time.monotonic() < deadline:
        vs = feeder.rpop_many("predictionQueue", 10_000)
        if not vs:
            time.sleep(0.005)
        for v in vs:
            rid, lab = v.split(",", 1)
            if rid in got:
                fail(f"{what}: request {rid} answered twice")
            got[rid] = lab
    if len(got) != n:
        fail(f"{what}: {len(got)} of {n} requests answered")
    return got


def fleet_hosts(reg_dir, records, ref):
    """Phase 55's second half: two fleet_host OS processes (2 workers
    each, on the card) against 2 broker shards, building nothing; /metrics
    of one scraped while they serve; each prints one JSON stats line."""
    from avenir_tpu_torch.io import respq
    build_dir = os.path.join(ROOT, "build", "avenir_tpu_torch")

    def listing():
        return sorted((f, os.stat(os.path.join(build_dir, f)).st_mtime_ns)
                      for f in os.listdir(build_dir))
    before = listing()
    servers = [respq.RespServer().start() for _ in range(2)]
    eps = ",".join(f"127.0.0.1:{s.port}" for s in servers)
    work = os.path.join(WORK, "fleet")
    procs, errs, urls = [], [], {}
    feeder = None
    try:
        for k in range(2):
            ready = os.path.join(work, f"host{k}.ready")
            p = subprocess.Popen(
                [sys.executable, "-W", "ignore", "-m",
                 "avenir_tpu_torch.serving.fleet_host", "--registry",
                 reg_dir, "--model", "rafo9", "--endpoints", eps,
                 "--workers", "2", "--host-label", f"host{k}",
                 "--buckets", ",".join(map(str, (1, 8, 64, 512))),
                 "--metrics-port", "0", "--max-idle-s", "120",
                 "--ready-file", ready],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
            procs.append((p, ready))
            lines = []
            errs.append(lines)

            def read_err(p=p, lines=lines, k=k):
                for line in p.stderr:
                    lines.append(line)
                    if "/metrics on " in line:
                        urls[k] = line.rsplit(" ", 1)[1].strip()
            threading.Thread(target=read_err, daemon=True).start()
        deadline = time.monotonic() + 180.0
        while not all(os.path.exists(r) for _, r in procs):
            if time.monotonic() > deadline or \
                    any(p.poll() is not None for p, _ in procs):
                fail(f"fleet_host processes did not come up: "
                     f"{[''.join(e)[-1500:] for e in errs]}")
            time.sleep(0.05)
        feeder = respq.ShardedRespClient(eps.split(","))
        n = len(records)
        t0 = time.perf_counter()
        feeder.lpush_many("requestQueue", [f"predict,{i},{r}"
                                           for i, r in enumerate(records)])
        code, text = _scrape(urls[0], "/metrics")
        got = _collect_replies(feeder, n, "fleet_host")
        wall = time.perf_counter() - t0
        if [got[str(i)] for i in range(n)] != ref:
            fail("fleet_host: replies differ from the in-process serve")
        feeder.lpush_many("requestQueue", ["stop", "stop"])
        stats = []
        for p, _ in procs:
            so, _ = p.communicate(timeout=120)
            if p.returncode != 0:
                fail(f"fleet_host exited {p.returncode}: "
                     f"{''.join(errs[len(stats)])[-1500:]}")
            stats.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
        if feeder is not None:
            feeder.close()
        for srv in servers:
            srv.stop()
    served = [s["served"] for s in stats]
    series = 'avenir_serving{host="host0",service="rafo9-w0",model="rafo9",'
    print(f"fleet_host x2: {n:,} requests answered in {wall:.2f} s "
          f"({n / wall:,.0f} requests/s, push to last reply), served "
          f"{served} (sum {sum(served)}), hosts "
          f"{[s['host'] for s in stats]}; /metrics mid-run {code}, "
          f"{text.count(chr(10))} lines, host0 series "
          f"{series in text}; build/avenir_tpu_torch unchanged "
          f"{listing() == before}", flush=True)
    if sum(served) != n or code != 200 or series not in text or \
            listing() != before:
        fail(f"fleet_host: served {served} for {n}, /metrics {code} "
             f"(host0 series {series in text}), build dir unchanged "
             f"{listing() == before}")
    return {"served": served, "wall_s": wall, "requests_per_s": n / wall}


# --------------------------------------------------------------------------
# phases 56-59: the retrain loop and logistic regression
# --------------------------------------------------------------------------

RETRAIN9 = os.path.join(ROOT, "tests", "torch_fixtures", "retrain9")
LR9 = os.path.join(ROOT, "tests", "torch_fixtures", "lr9")
RETRAIN_SCALE_ROWS = 500_000
LR_SCALE_ROWS = 500_000
LR_SCALE_ITERS = 10
# a coefficient history line against another: max |a - b| over max |b|
LR9_RTOL = 1e-5          # the card's lr9 history against the JAX fixture
LR_CPU_RTOL = 1e-4       # the card's 1M-row history against the CPU's
LR_PROBA_ATOL = 1e-6
# the wall-clock fields left out of the byte comparisons
CLOCK_FIELDS = re.compile(rb'"(opened_unix|pinned_unix)": [0-9.e+-]+')


def same_files(got_root, want_root, what, versions=True):
    """Every file under ``want_root`` equals ``got_root``'s: bytes outside
    the CLOCK_FIELDS, ``.npz`` files array for array; with
    ``versions=False`` the registry's version directories are left out."""
    def rels(root):
        out = (os.path.relpath(os.path.join(d, f), root)
               for d, _, fs in os.walk(root) for f in fs)
        return sorted(r for r in out
                      if versions or not r.startswith("registry/v_"))
    if rels(got_root) != rels(want_root):
        fail(f"{what}: files {rels(got_root)} != {rels(want_root)}")
    for rel in rels(want_root):
        got, want = os.path.join(got_root, rel), os.path.join(want_root, rel)
        if rel.endswith(".npz"):
            with np.load(got) as a, np.load(want) as b:
                if sorted(a.files) != sorted(b.files) or any(
                        a[k].dtype != b[k].dtype or not np.array_equal(
                            a[k], b[k], equal_nan=a[k].dtype.kind in "fc")
                        for k in a.files):
                    fail(f"{what}: {rel} arrays differ")
            continue
        with open(got, "rb") as a, open(want, "rb") as b:
            if CLOCK_FIELDS.sub(rb'"\1": T', a.read()) != \
                    CLOCK_FIELDS.sub(rb'"\1": T', b.read()):
                fail(f"{what}: {rel} differs from the fixture's")


def history_rel(got, want):
    """Largest per-line relative difference of two coefficient
    histories (lists of arrays) and the count of differing .9g strings."""
    if len(got) != len(want):
        fail(f"histories of {len(got)} and {len(want)} lines")
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = float((np.abs(a - b).max(axis=1) / np.abs(b).max(axis=1)).max())
    strings = sum(f"{x:.9g}" != f"{y:.9g}"
                  for x, y in zip(a.ravel(), b.ravel()))
    return rel, strings


def retrain9_phase():
    """Phase 56: retrain9 cases a-d through the port's CLI on the card,
    every kept file equal to the JAX package's fixture; per case the
    launches of B1 (all in the mma form), B4 (the baseline's blocks plus
    the two drift re-scores of a validation) and B2 (at least two a
    validation)."""
    from avenir_tpu_torch.cli import run as cli_run
    from avenir_tpu_torch.core import faults
    mk = fixture_module("retrain9")
    with open(mk.STREAM) as fh:
        blocks = -(-sum(1 for line in fh if line.strip()) // mk.BLOCK_ROWS)
    phase("56 retrain9 on the card: retrainController cases a (forced), b "
          "(alerts.jsonl), c (probation rollback) and d (registry_publish@2 "
          "then a resume) == the JAX package's fixture")
    zero_launches()
    total = {}
    for case in mk.CASES:
        work = os.path.join(WORK, f"retrain9_{case}")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        before = launch_counts()
        t0 = time.perf_counter()
        mk.run_case(cli_run.main, faults, case, work)
        wall = time.perf_counter() - t0
        got = os.path.join(work, "kept")
        mk.keep(work, got, versions=True)
        same_files(os.path.join(got, "registry", "v_000002"),
                   os.path.join(RETRAIN9, "a", "registry", "v_000002"),
                   f"retrain9 {case} v2")
        same_files(got, os.path.join(RETRAIN9, case), f"retrain9 {case}",
                   versions=False)
        c = {k: v - before[k] for k, v in launch_counts().items()}
        # every case validates once (d in its killed run), c replays its
        # probation input once more through B2
        want_b4 = blocks + 2
        if c["b1"] <= 0 or c["b1_mma"] != c["b1"] or c["b4"] != want_b4 \
                or c["b2"] < 2:
            fail(f"retrain9 {case}: launches {c}; want every B1 in the mma "
                 f"form, B4 = {blocks} blocks + 2 re-scores, B2 >= 2")
        print(f"retrain9 {case}: equal to the fixture outside "
              f"opened_unix/pinned_unix ({wall:.2f} s); launches B1 "
              f"{c['b1']} (mma {c['b1_mma']}), B4 {c['b4']}, B2 {c['b2']}",
              flush=True)
        total[case] = {k: c[k] for k in ("b1", "b1_mma", "b4", "b2")}
    return total


def timed_stages(ctl, stage_at):
    """Wrap the controller's stage methods so each records its start and
    end on the host clock (the device synchronised) into ``stage_at``."""
    import torch
    for name in ("_stage_build", "_stage_validate", "_stage_publish",
                 "_stage_swap"):
        def run(*a, _fn=getattr(ctl, name), _name=name[7:], **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                stage_at[_name] = (t0, time.perf_counter())
        setattr(ctl, name, run)


class LiveFeed:
    """A thread pushing rafo request batches onto a fleet's queue and one
    collecting the replies, each reply stamped with its arrival time."""

    def __init__(self, port, records, batch=64, pause_s=0.005):
        from avenir_tpu_torch.io import respq
        self.push = respq.RespClient(port=port)
        self.pull = respq.RespClient(port=port)
        self.records, self.batch, self.pause_s = records, batch, pause_s
        self.sent = 0
        self.replies = {}
        self.stop_ev = threading.Event()
        self.threads = [threading.Thread(target=self._feed, daemon=True),
                        threading.Thread(target=self._collect, daemon=True)]

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def _feed(self):
        n = len(self.records)
        while not self.stop_ev.is_set():
            msgs = [f"predict,q{self.sent + i},"
                    f"{self.records[(self.sent + i) % n]}"
                    for i in range(self.batch)]
            self.push.lpush_many("requestQueue", msgs)
            self.sent += self.batch
            time.sleep(self.pause_s)

    def _collect(self):
        while not self.stop_ev.is_set() or len(self.replies) < self.sent:
            vs = self.pull.rpop_many("predictionQueue", 4096)
            now = time.perf_counter()
            for v in vs:
                rid, label = v.split(",", 1)
                if rid in self.replies:
                    fail(f"live feed: request {rid} answered twice")
                self.replies[rid] = (label, now)
            if not vs:
                if self.stop_ev.is_set() and \
                        time.perf_counter() > self.deadline:
                    return
                time.sleep(0.002)

    def finish(self, timeout_s=60.0):
        self.deadline = time.perf_counter() + timeout_s
        self.stop_ev.set()
        for t in self.threads:
            t.join(timeout_s + 5.0)
        self.push.close()
        self.pull.close()
        if len(self.replies) != self.sent:
            fail(f"live feed: {len(self.replies)} of {self.sent} requests "
                 f"answered")
        bad = [r for r, (lab, _) in self.replies.items()
               if lab in ("error", "busy")]
        if bad:
            fail(f"live feed: {len(bad)} requests answered error or busy")


def retrain_scale(dev, fs, scale_csv, scale_trees):
    """Phase 57: one cycle at the rafo forest's full width over a
    500,000-row drifted window while a 2-worker fleet answers live
    requests; phase 58: the same cycle killed after its publish committed
    and resumed.  Returns the printed numbers."""
    import torch
    from avenir_tpu_torch.cli.jobs import _tree_params
    from avenir_tpu_torch.control import RetrainController, RetrainPolicy
    from avenir_tpu_torch.core import faults
    from avenir_tpu_torch.core.config import load_config
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.io import respq
    from avenir_tpu_torch.models.forest import ForestParams
    from avenir_tpu_torch.models.tree import DecisionPathList
    from avenir_tpu_torch.monitor.baseline import (compute_baseline,
                                                   publish_baseline)
    from avenir_tpu_torch.serving import (BatchPolicy, ModelRegistry,
                                          ServingFleet)
    cfg = load_config(os.path.join(RES, "rafo.properties"))
    params = ForestParams(tree=_tree_params(cfg),
                          num_trees=cfg.get_int("dtb.num.trees"),
                          seed=cfg.get_int("dtb.random.seed"))
    window = os.path.join(WORK, "retrain_window.csv")
    write_hangup_csv(hangup_table(np.random.default_rng(20261057),
                                  RETRAIN_SCALE_ROWS, fs,
                                  reason_p=(0.1, 0.1, 0.1, 0.7),
                                  queue_shift=600), window)
    champion = os.path.join(WORK, "retrain_champion")
    shutil.rmtree(champion, ignore_errors=True)
    reg = ModelRegistry(champion)
    trees = [DecisionPathList.from_json(t) for t in json.loads(scale_trees)]
    reg.publish("rafo", trees, schema=fs)
    publish_baseline(reg, "rafo", 1, compute_baseline(
        load_csv(scale_csv, fs), device=dev))
    with open(os.path.join(RAFO9, "requests.csv")) as fh:
        records = fh.read().splitlines()
    out = {}

    def controller(registry, state, fleet=None):
        return RetrainController(
            registry, "rafo", fs, state_dir=state, train_source=window,
            forest_params=params, fleet=fleet,
            policy=RetrainPolicy(chunk_rows=STREAM_SCALE_BLOCK,
                                 swap_ack_timeout_s=60.0))

    phase(f"57 scale: one retrain cycle of the rafo forest (9 trees) over "
          f"a {RETRAIN_SCALE_ROWS:,}-row drifted window, champion phase "
          f"30's {STREAM_SCALE_ROWS:,}-row model, while a 2-worker fleet "
          f"answers")
    reg57 = os.path.join(WORK, "retrain_registry57")
    shutil.rmtree(reg57, ignore_errors=True)
    shutil.copytree(champion, reg57)
    registry = ModelRegistry(reg57)
    server = respq.RespServer().start()
    fleet = ServingFleet(registry, "rafo", n_workers=2,
                         config={"redis.server.port": server.port},
                         policy=BatchPolicy(max_batch=64))
    feed = None
    try:
        fleet.start()
        feed = LiveFeed(server.port, records).start()
        ctl = controller(registry, os.path.join(WORK, "retrain_state57"),
                         fleet)
        stage_at = {}
        timed_stages(ctl, stage_at)
        zero_launches()
        t0 = time.perf_counter()
        summary = ctl.force_cycle()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        stage_s = {k: b - a for k, (a, b) in stage_at.items()}
        swap_start, swap_end = stage_at["swap"]
        time.sleep(0.5)
        feed.finish()
        during = sum(1 for _, at in feed.replies.values()
                     if swap_start <= at <= swap_end)
        stats = fleet.stats()
        swaps = [w.service.counters.get("Serving", "DeltaSwaps")
                 for w in fleet.workers]
    finally:
        if feed is not None and not feed.stop_ev.is_set():
            feed.finish()
        fleet.stop(drain_s=1.0)
        server.stop()
    delta = registry.delta_info("rafo", 2)
    changed = len(delta.get("changed", [])) if delta else None
    print(f"cycle: {summary}; wall {wall:.2f} s; stage seconds "
          f"{ {k: round(v, 3) for k, v in stage_s.items()} }; "
          f"{feed.sent:,} requests answered by the fleet, {during} of them "
          f"during the swap stage; fleet errors {stats['errors']}, model "
          f"versions {stats['model_versions']}, DeltaSwaps {swaps}; delta "
          f"of {changed} of {params.num_trees} trees; launches B1 "
          f"{counts['b1']} (mma {counts['b1_mma']}), B4 {counts['b4']}, "
          f"B2 {counts['b2']} (validation and the fleet's batches)",
          flush=True)
    blocks = -(-RETRAIN_SCALE_ROWS // STREAM_SCALE_BLOCK)
    if summary.get("outcome") != "published" \
            or set(stats["model_versions"].values()) != {2} \
            or stats["errors"] or during <= 0 or swaps != [1, 1] \
            or changed is None or changed > params.num_trees:
        fail("phase 57: the cycle did not publish and swap the live fleet "
             "onto v2 by a delta while it answered")
    if counts["b1"] <= 0 or counts["b1_mma"] != counts["b1"] \
            or counts["b4"] != blocks + 2 or counts["b2"] < 2:
        fail(f"phase 57: launches {counts}; want every B1 in the mma "
             f"form, B4 = {blocks} blocks + 2 re-scores, B2 >= 2")
    out["scale"] = {"stage_s": stage_s, "wall_s": wall,
                    "requests": feed.sent, "during_swap": during,
                    "changed_trees": changed,
                    "launches": {k: counts[k] for k in
                                 ("b1", "b1_mma", "b4", "b2")},
                    "candidate_sha": ctl.journal["candidate_sha"]}

    phase("58 crash drill on the card: the phase-57 cycle killed at "
          "registry_publish@2 (after the commit), then resumed")
    reg58 = os.path.join(WORK, "retrain_registry58")
    shutil.rmtree(reg58, ignore_errors=True)
    shutil.copytree(champion, reg58)
    registry = ModelRegistry(reg58)
    state = os.path.join(WORK, "retrain_state58")
    shutil.rmtree(state, ignore_errors=True)
    faults.install(faults.FaultInjector.parse(
        "registry_publish@2=raise:RuntimeError"))
    try:
        controller(registry, state).force_cycle()
    except RuntimeError as exc:
        if "injected fault" not in str(exc):
            raise
    else:
        fail("phase 58: the injected publish fault did not fire")
    finally:
        faults.uninstall()
    ctl = controller(registry, state)
    summary = ctl.run_pending()
    dedup = ctl.counters.get("Controller", "PublishDeduped")
    print(f"killed after the commit, resumed: {summary}; versions "
          f"{registry.versions('rafo')}, PublishDeduped {dedup}; candidate "
          f"sha equal to phase 57's: "
          f"{ctl.journal['candidate_sha'] == out['scale']['candidate_sha']}",
          flush=True)
    if summary.get("outcome") != "published" or \
            registry.versions("rafo") != [1, 2] or dedup != 1 or \
            ctl.journal["candidate_sha"] != out["scale"]["candidate_sha"]:
        fail("phase 58: the resumed cycle did not adopt exactly one new "
             "version, phase 57's")
    return out


def churn_svm_csv(rng, n, path):
    """n rows of resource/gen/churn_svm_gen.py's model under
    churn_svm.json, drawn vectorised."""
    minutes = np.clip(rng.normal(90, 40, n), 0, 199).astype(np.int64)
    data_gb = np.clip(rng.normal(40, 20, n), 0, 99).astype(np.int64)
    calls = np.clip(rng.poisson(2.0, n), 0, 9)
    score = 1.2 * calls - 0.03 * minutes - 0.05 * data_gb + 1.5 \
        + rng.normal(0, 1.0, n)
    plans = np.asarray(["prepaid", "standard", "family", "business"])
    pays = np.asarray(["poor", "average", "good"])
    cols = [np.char.add("C", np.char.zfill(np.arange(n).astype(str), 7)),
            plans[rng.integers(0, 4, n)], minutes.astype(str),
            data_gb.astype(str), calls.astype(str),
            pays[rng.integers(0, 3, n)],
            np.where(score > 0, "churned", "active")]
    rows = cols[0]
    for c in cols[1:]:
        rows = np.char.add(np.char.add(rows, ","), c)
    with open(path, "w") as fh:
        fh.write("\n".join(rows.tolist()) + "\n")


def logistic_phase(dev):
    """Phase 59: lr9 on the card against the JAX package's fixture, then
    logisticRegression and its predictor over a 1,000,000-row churn CSV,
    the card's history against the CPU's over the same rows."""
    import torch
    from avenir_tpu_torch.cli import run as cli_run
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.regress import logistic as LR
    mk = fixture_module("lr9")
    phase(f"59 logistic: lr9 on the card == the JAX package's fixture "
          f"within {LR9_RTOL:g}; logisticRegression ({LR_SCALE_ITERS} "
          f"iterations) and logisticRegressionPredictor over "
          f"{LR_SCALE_ROWS:,} churn rows, the card against the CPU")
    work = os.path.join(WORK, "lr9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    coeff = os.path.join(work, "coeff.txt")
    run_cli(["logisticRegression", *mk.KEYS, f"-Dcoeff.file.path={coeff}",
             os.path.join(LR9, "train.csv"), os.path.join(work, "train")])
    with open(coeff) as fh:
        got = LR.parse_history(fh.read().splitlines())
    with open(os.path.join(LR9, "coeff.txt")) as fh:
        want = LR.parse_history(fh.read().splitlines())
    rel, strings = history_rel(got, want)
    if rel > LR9_RTOL:
        fail(f"lr9 history on the card: relative difference {rel:.3g} "
             f"over {LR9_RTOL:g}")
    pred = os.path.join(work, "pred")
    run_cli(["logisticRegressionPredictor", *mk.KEYS,
             f"-Dcoeff.file.path={os.path.join(LR9, 'coeff.txt')}",
             "-Dvalidation.mode=true", os.path.join(LR9, "test.csv"), pred])
    with open(os.path.join(pred, "part-m-00000")) as a, \
            open(os.path.join(LR9, "pred", "part-m-00000")) as b:
        gl = [ln.split(",") for ln in a.read().splitlines()]
        wl = [ln.split(",") for ln in b.read().splitlines()]
    probs = sum(g[-1] != w[-1] for g, w in zip(gl, wl))
    labels = sum(g[-2] != w[-2] for g, w in zip(gl, wl)
                 if abs(float(w[-1]) - 0.5) > LR_PROBA_ATOL)
    if len(gl) != len(wl) or labels or \
            any(abs(float(g[-1]) - float(w[-1])) > 1e-3 + LR_PROBA_ATOL
                for g, w in zip(gl, wl)):
        fail(f"lr9 predictor on the card: {labels} labels apart")
    reg = os.path.join(work, "registry")
    shutil.copytree(os.path.join(LR9, "registry"), reg)
    served = os.path.join(work, "served")
    run_cli(["org.avenir.serving.PredictionService",
             f"-Dps.model.registry.dir={reg}",
             f"-Dps.model.name={mk.MODEL_NAME}", "-Dps.transport=inprocess",
             os.path.join(LR9, "test.csv"), served])
    same_bytes(os.path.join(served, "part-m-00000"),
               os.path.join(LR9, "served", "part-m-00000"),
               "lr9 served on the card")
    print(f"lr9 on the card: history of {len(got)} lines within {rel:.3g} "
          f"of the JAX package's ({strings} of {4 * len(got)} .9g strings "
          f"differ); predictor labels equal, {probs} of {len(gl)} .3f "
          f"probabilities differ", flush=True)

    csv = os.path.join(WORK, "churn_scale.csv")
    churn_svm_csv(np.random.default_rng(20261059), LR_SCALE_ROWS, csv)
    keys = [f"-Dfeature.schema.file.path={mk.SCHEMA}",
            f"-Dpositive.class.value={mk.POSITIVE}", "-Dlearning.rate=0.001",
            "-Dconvergence.criteria=iterLimit",
            f"-Diteration.limit={LR_SCALE_ITERS}"]
    scale_coeff = os.path.join(WORK, "churn_scale_coeff.txt")
    if os.path.exists(scale_coeff):
        os.remove(scale_coeff)
    t0 = time.perf_counter()
    run_cli(["logisticRegression", *keys,
             f"-Dcoeff.file.path={scale_coeff}", csv,
             os.path.join(WORK, "churn_scale_train")])
    job_s = time.perf_counter() - t0
    with open(scale_coeff) as fh:
        card_hist = LR.parse_history(fh.read().splitlines())
    schema = FeatureSchema.load(mk.SCHEMA)
    table = load_csv(csv, schema)
    params = LR.LogisticParams(mk.POSITIVE, learning_rate=0.001,
                               iteration_limit=LR_SCALE_ITERS)
    LR.train(table, schema, params, device=dev)       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LR.train(table, schema, params, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, cpu_hist, _ = LR.train(table, schema, params, device="cpu")
    cpu_s = time.perf_counter() - t0
    rel_cpu, strings_cpu = history_rel(card_hist, cpu_hist)
    if rel_cpu > LR_CPU_RTOL:
        fail(f"1M-row history: the card's within {rel_cpu:.3g} of the "
             f"CPU's, over {LR_CPU_RTOL:g}")
    t0 = time.perf_counter()
    run_cli(["logisticRegressionPredictor", *keys,
             f"-Dcoeff.file.path={scale_coeff}", "-Dvalidation.mode=true",
             csv, os.path.join(WORK, "churn_scale_pred")])
    pred_s = time.perf_counter() - t0
    acc = read_json(os.path.join(WORK, "churn_scale_pred") +
                    ".counters.json")["Validation"]["Accuracy"]
    ms_iter = train_s / LR_SCALE_ITERS * 1e3
    print(f"logisticRegression over {LR_SCALE_ROWS:,} rows: job {job_s:.2f}"
          f" s (CSV load included); the training loop {ms_iter:.3f} ms an "
          f"iteration, {LR_SCALE_ROWS * LR_SCALE_ITERS / train_s:,.0f} "
          f"rows/s (the CPU's {cpu_s / LR_SCALE_ITERS * 1e3:.1f} ms an "
          f"iteration); history within {rel_cpu:.3g} of the CPU's "
          f"({strings_cpu} of {4 * len(card_hist)} .9g strings differ); "
          f"predictor {pred_s:.2f} s ({LR_SCALE_ROWS / pred_s:,.0f} rows/s, "
          f"validation accuracy {acc})", flush=True)
    return {"lr9_rel": rel, "lr9_strings": strings, "lr9_prob_strings": probs,
            "job_s": job_s, "ms_per_iter": ms_iter,
            "rows_per_s": LR_SCALE_ROWS * LR_SCALE_ITERS / train_s,
            "cpu_ms_per_iter": cpu_s / LR_SCALE_ITERS * 1e3,
            "cpu_rel": rel_cpu, "cpu_strings": strings_cpu,
            "predict_s": pred_s, "accuracy": acc}


# --------------------------------------------------------------------------
# phases 60-63: the threefry twin and its consumers (the MLP, simulated
# annealing and the genetic algorithm, the batch bandits)
# --------------------------------------------------------------------------

THREEFRY_N = 1 << 24
# the operations of a value that only Hopper's integer ALU pipe issues:
# 20 rotates (SHF.L.W) and 20 xors plus the final one (LOP3); the adds
# may issue as IMAD on the FMA pipe and overlap them.  That pipe has half
# the FMA pipe's 128 lanes a clock an SM, so a quarter of the float32
# FLOP/s, which counts an FMA as two
THREEFRY_ALU_OPS = 20 + 21
INT_ALU_PER_S = 67e12 / 4
THREEFRY_KEYS = (0, 11, 2 ** 32 - 1)
MLP9 = os.path.join(ROOT, "tests", "torch_fixtures", "mlp9")
OPT9 = os.path.join(ROOT, "tests", "torch_fixtures", "opt9")
MAB9 = os.path.join(ROOT, "tests", "torch_fixtures", "mab9")
SA_GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures", "sa")
MLP_A5_RTOL = 1e-4       # mlp9's first iterations on the card (as the CPU)
MLP_LOGIT_ATOL = 1e-4    # a predictor label may differ below this gap
MLP_SCALE_ROWS = 500_000
MLP_SCALE_ITERS = 300      # the 1M-row neuralNetwork job's batch iterations
MLP_INCR_ROWS = 5_000
MLP_GAP_ITERS = 50       # the card's batch run against the CPU's
MLP_MINIBATCH_ROWS = 250_000     # the timed minibatch epoch's rows
SA_SCALE = (64, 32, 8192, 500)     # tasks, employees, chains, iterations
SA_CPU_ITERS = 20
GA_SCALE = (64, 256, 120)           # islands, population, generations
VB_GROUPS = 50_000
VB_REWARD_EVENTS = 10_000


def threefry_phase(dev):
    """Phase 60: the threefry kernel against its plain version (bit-equal
    over 2^24 counters under three keys, both output modes), every
    threefry9 case on the card, and the draw times."""
    import torch
    from avenir_tpu_torch.utils import threefry as tf
    mk = fixture_module("threefry9")
    phase(f"60 threefry: kernel == plain over {THREEFRY_N:,} counters x "
          f"{len(THREEFRY_KEYS)} keys; the {len(mk.CASES)} threefry9 cases "
          f"on the card == jax.random's")
    rng = np.random.default_rng(20261060)
    for seed in THREEFRY_KEYS:
        keys = tf.PRNGKey(seed, dev).reshape(1, 2)
        c0 = torch.from_numpy(rng.integers(0, 2 ** 32, THREEFRY_N)).to(dev)
        c1 = torch.from_numpy(rng.integers(0, 2 ** 32, THREEFRY_N)).to(dev)
        for mode, counters in ((1, (c0, c1)), (0, (None, None)),
                               (1, (None, None))):
            got = tf.threefry_hash(keys, THREEFRY_N, mode, *counters)
            want = tf._hash_torch(keys, *counters, THREEFRY_N, mode)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"threefry kernel != plain version (key seed {seed}, "
                     f"mode {mode}): {int((got != want).sum())} words")
    print(f"threefry kernel: bit-equal to the plain version over "
          f"{THREEFRY_N:,} explicit and flat-index counters under seeds "
          f"{THREEFRY_KEYS}", flush=True)
    for case in mk.CASES:
        bad = mk.held(case, mk.twin_case(case, dev))
        if bad:
            fail(f"threefry9 on the card: {bad}")
    print(f"threefry9: all {len(mk.CASES)} cases equal on the card",
          flush=True)
    key = tf.PRNGKey(7, dev)
    keys = key.reshape(1, 2)
    t = {"ms": cuda_ms(lambda: tf.threefry_hash(keys, THREEFRY_N, 0), 20),
         "device_ms": device_ms(lambda: tf.threefry_hash(keys, THREEFRY_N,
                                                         0)),
         "plain_ms": cuda_ms(lambda: tf._hash_torch(keys, None, None,
                                                    THREEFRY_N, 0), 5),
         "normal_ms": cuda_ms(lambda: tf.normal(key, (THREEFRY_N,)), 10),
         "normal_device_ms": device_ms(lambda: tf.normal(key,
                                                         (THREEFRY_N,))),
         "n": THREEFRY_N}
    # the bound: 4 bytes written a value, or its ALU-pipe operations,
    # whichever is larger
    by = {"bytes": 4 * THREEFRY_N / HBM_BYTES_PER_S * 1e3,
          "operations": THREEFRY_ALU_OPS * THREEFRY_N / INT_ALU_PER_S
          * 1e3}
    t["bound_by"] = max(by, key=by.get)
    t["bound_ms"] = by[t["bound_by"]]
    print(f"threefry over {THREEFRY_N:,} values: random_bits {t['ms']:.4f} "
          f"ms call, {t['device_ms']:.4f} device (bound {t['bound_ms']:.4f}"
          f" by {t['bound_by']}: {by}); plain version {t['plain_ms']:.2f};"
          f" normal {t['normal_ms']:.3f} call, {t['normal_device_ms']:.3f} "
          f"device", flush=True)
    return t


def _mlp_model_rel(got_lines, want_lines):
    from avenir_tpu_torch.nn import mlp
    g = mlp.from_lines(got_lines, device="cpu")
    w = mlp.from_lines(want_lines, device="cpu")
    return max(float((g[k] - w[k]).abs().max() / w[k].abs().max().clamp(
        min=1e-30)) for k in mlp.NAMES)


def mlp_phase(dev):
    """Phase 61: mlp9 on the card through the port's CLI (draws
    bit-equal, the first batch iterations and the short incr and
    minibatch runs within MLP_A5_RTOL, the chaotic
    1,000-iteration cases on the JAX grid, the resumed run equal to the
    unchunked one, the predictor and the served version over the JAX
    package's models), then the scale runs."""
    import torch
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.nn import mlp
    from avenir_tpu_torch.utils import threefry as tf
    mk = fixture_module("mlp9")
    phase(f"61 mlp: mlp9 a-d through the port's CLI on the card; "
          f"neuralNetwork over {MLP_SCALE_ROWS:,} churn rows (batch, "
          f"{MLP_SCALE_ITERS:,} iterations) and its predictor; minibatch and "
          f"incr epochs")
    schema = FeatureSchema.load(mk.SCHEMA)

    def xy(path):
        t = load_csv(path, schema)
        X = t.feature_matrix(dtype=np.float32)
        y = np.asarray(t.class_codes()).astype(np.int64)
        return X[y >= 0], y[y >= 0]
    with np.load(os.path.join(MLP9, "draws.npz")) as z:
        draws = {k: z[k] for k in z.files}
    X, y = xy(mk.TRAIN)
    tf.launches = 0
    p = mlp.init_params(X.shape[1], mlp.MLPConfig(), device=dev)
    for k in mlp.NAMES:
        if not np.array_equal(p[k].cpu().numpy().view(np.int32),
                              draws[f"init_{k}"].view(np.int32)):
            fail(f"mlp9 init_params {k} on the card != the JAX package's")
    key = tf.PRNGKey(1, dev)
    for e in range(2):
        key, sub = tf.split(key, 2)
        if not np.array_equal(tf.permutation(sub, len(y)).cpu().numpy(),
                              draws[f"perm_{e}"]):
            fail(f"mlp9 epoch {e} permutation on the card differs")
    a5, _ = mlp.train(X, y, mlp.MLPConfig(iterations=mk.A5_ITERS),
                      device=dev)
    a5_rel = max(float(np.abs(a5[k].cpu().numpy() - draws[f"a5_{k}"]).max()
                       / np.abs(draws[f"a5_{k}"]).max()) for k in mlp.NAMES)
    if a5_rel > MLP_A5_RTOL:
        fail(f"mlp9 after {mk.A5_ITERS} iterations on the card: {a5_rel:.3g}"
             f" over {MLP_A5_RTOL:g}")
    Xv, yv = xy(mk.TEST)
    short_rel = {}
    for mode, (rows, kw) in mk.SHORT.items():
        p, hist = mlp.train(X[:rows], y[:rows], mlp.MLPConfig(**kw),
                            X_val=Xv, y_val=yv, device=dev)
        got = {k: p[k].cpu().numpy() for k in mlp.NAMES}
        got["loss"] = hist
        short_rel[mode] = max(
            float(np.abs(got[k] - draws[f"{mode}_{k}"]).max()
                  / np.abs(draws[f"{mode}_{k}"]).max()) for k in got)
        if len(hist) != len(draws[f"{mode}_loss"]) or \
                short_rel[mode] > MLP_A5_RTOL:
            fail(f"mlp9 short {mode} run on the card: {short_rel[mode]:.3g}"
                 f" over {MLP_A5_RTOL:g} ({len(hist)} losses)")
    work = os.path.join(WORK, "mlp9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(MLP9, "counters.json")) as fh:
        jc = json.load(fh)
    cases = {}
    for case, runs in (("a", [mk.CASES["a"]]), ("b", [mk.CASES["b"]]),
                       ("c", [mk.CASES["c"]]),
                       ("d", mk.case_d_runs(os.path.join(work, "ckpt")))):
        out = os.path.join(work, case)
        for args in runs:
            shutil.rmtree(out, ignore_errors=True)
            run_cli(["neuralNetwork", *mk.KEYS, *args, mk.TRAIN, out])
        with open(os.path.join(out, "part-r-00000")) as fh:
            got = fh.read().splitlines()
        with open(os.path.join(MLP9, case, "model.csv")) as fh:
            want = fh.read().splitlines()
        heads = [ln for ln in got if ln.startswith("#")]
        if heads != [ln for ln in want if ln.startswith("#")]:
            fail(f"mlp9 {case}: model layout {heads}")
        nn = read_json(out + ".counters.json")["NeuralNetwork"]
        if nn["lossEvaluations"] != \
                jc[f"{case}/train"]["NeuralNetwork"]["lossEvaluations"]:
            fail(f"mlp9 {case}: lossEvaluations {nn['lossEvaluations']}")
        strings = sum(a != b for g, w in zip(got, want)
                      for a, b in zip(g.split(","), w.split(",")))
        cases[case] = {"strings": strings, "rel": _mlp_model_rel(got, want),
                       "lines": got}
    if cases["d"]["lines"] != cases["a"]["lines"]:
        fail("mlp9 d (resumed) on the card != a (unchunked)")
    Xt = load_csv(mk.TEST, schema).feature_matrix(dtype=np.float32)
    for case in "abcd":
        model = os.path.join(MLP9, case, "model.csv")
        out = os.path.join(work, case + "_pred")
        run_cli(["neuralNetworkPredictor", *mk.KEYS,
                 f"-Dnn.model.file.path={model}", mk.TEST, out])
        with open(model) as fh:
            params = mlp.from_lines(fh.read().splitlines(), device="cpu")
        logits = np.sort(mlp.forward_logits(params, torch.from_numpy(Xt))
                         .numpy(), axis=1)
        gap = logits[:, -1] - logits[:, -2]
        with open(os.path.join(out, "part-m-00000")) as a, \
                open(os.path.join(MLP9, case, "pred.csv")) as b:
            gl = [ln.split(",") for ln in a.read().splitlines()]
            wl = [ln.split(",") for ln in b.read().splitlines()]
        labels = [i for i, (g, w) in enumerate(zip(gl, wl)) if g[-2] != w[-2]]
        if len(gl) != len(wl) or any(gap[i] > MLP_LOGIT_ATOL for i in labels):
            fail(f"mlp9 {case} predictor on the card: labels {labels[:5]}")
        cases[case]["pred_labels"] = len(labels)
        cases[case]["pred_percent_strings"] = sum(
            g[-1] != w[-1] for g, w in zip(gl, wl))
    reg = os.path.join(work, "registry")
    shutil.copytree(os.path.join(MLP9, "registry"), reg)
    served = os.path.join(work, "served")
    run_cli(["org.avenir.serving.PredictionService",
             f"-Dps.model.registry.dir={reg}",
             f"-Dps.model.name={mk.MODEL_NAME}", "-Dps.transport=inprocess",
             mk.TEST, served])
    same_bytes(os.path.join(served, "part-m-00000"),
               os.path.join(MLP9, "served.csv"), "mlp9 served on the card")
    fixture_launches = tf.launches
    for c in cases.values():
        c.pop("lines")
    print(f"mlp9 on the card: draws bit-equal; {mk.A5_ITERS} iterations "
          f"within {a5_rel:.3g}; short incr and minibatch runs within "
          f"{short_rel}; d == a; per case (model strings apart of "
          f"32, rel, predictor labels / percent strings apart): "
          f"{ {k: (v['strings'], round(v['rel'], 4), v['pred_labels'], v['pred_percent_strings']) for k, v in cases.items()} }; "
          f"threefry launches {fixture_launches}", flush=True)

    csv = os.path.join(WORK, "churn_scale.csv")
    if not os.path.exists(csv):
        churn_svm_csv(np.random.default_rng(20261059), MLP_SCALE_ROWS, csv)
    t0 = time.perf_counter()
    run_cli(["neuralNetwork", *mk.KEYS, "-Dnn.training.mode=batch",
             f"-Dnn.iteration.count={MLP_SCALE_ITERS}",
             "-Dnn.validation.interval=50",
             f"-Dnn.model.file.path={os.path.join(WORK, 'mlp_scale.csv')}",
             csv, os.path.join(WORK, "mlp_scale_train")])
    job_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(["neuralNetworkPredictor", *mk.KEYS,
             f"-Dnn.model.file.path={os.path.join(WORK, 'mlp_scale.csv')}",
             csv, os.path.join(WORK, "mlp_scale_pred")])
    pred_s = time.perf_counter() - t0
    Xs, ys = xy(csv)
    cfg = mlp.MLPConfig(iterations=MLP_GAP_ITERS, validation_interval=50)
    mlp.train(Xs[:1000], ys[:1000], cfg, device=dev)          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card, _ = mlp.train(Xs, ys, cfg, device=dev)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / MLP_GAP_ITERS * 1e3
    t0 = time.perf_counter()
    cpu, _ = mlp.train(Xs, ys, cfg, device="cpu")
    cpu_ms = (time.perf_counter() - t0) / MLP_GAP_ITERS * 1e3
    gap = max(float((card[k].cpu() - cpu[k]).abs().max()
                    / cpu[k].abs().max().clamp(min=1e-30))
              for k in mlp.NAMES)
    one = dict(iterations=1, batch_size=64)
    t0 = time.perf_counter()
    mlp.train(Xs[:MLP_MINIBATCH_ROWS], ys[:MLP_MINIBATCH_ROWS],
              mlp.MLPConfig(mode="minibatch", **one), device=dev)
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mlp.train(Xs[:MLP_INCR_ROWS], ys[:MLP_INCR_ROWS],
              mlp.MLPConfig(mode="incr", **one), device=dev)
    torch.cuda.synchronize()
    incr_s = time.perf_counter() - t0
    n_mb = min(len(ys), MLP_MINIBATCH_ROWS) // 64
    res = {"mlp9": cases, "a5_rel": a5_rel, "short_rel": short_rel,
           "job_s": job_s,
           "predict_s": pred_s, "predict_rows_per_s": len(ys) / pred_s,
           "batch_ms_per_iter": batch_ms, "cpu_batch_ms_per_iter": cpu_ms,
           "card_cpu_gap_100": gap, "minibatch_epoch_s": mb_s,
           "minibatch_ms_per_step": mb_s / n_mb * 1e3,
           "incr_epoch_s": incr_s,
           "incr_ms_per_step": incr_s / MLP_INCR_ROWS * 1e3,
           "fixture_launches": fixture_launches}
    print(f"neuralNetwork over {len(ys):,} rows: job {job_s:.2f} s "
          f"({MLP_SCALE_ITERS:,} batch iterations, CSV load included); the "
          f"batch step "
          f"{batch_ms:.3f} ms an iteration (CPU {cpu_ms:.1f}); the card's "
          f"weights after {MLP_GAP_ITERS} iterations within {gap:.3g} of "
          f"the CPU's; predictor {pred_s:.2f} s ({len(ys) / pred_s:,.0f} "
          f"rows/s); minibatch epoch {mb_s:.2f} s ({n_mb:,} steps, "
          f"{res['minibatch_ms_per_step']:.3f} ms a step); incr epoch over "
          f"{MLP_INCR_ROWS:,} rows {incr_s:.2f} s "
          f"({res['incr_ms_per_step']:.3f} ms a step)", flush=True)
    return res


def sa_scale_setup():
    """Phase 62's scale domain and SA parameters (the parent and the
    ``--sa-cpu-child`` build the same ones)."""
    from avenir_tpu_torch.optimize.annealing import AnnealingParams
    from avenir_tpu_torch.optimize.task_schedule import TaskScheduleDomain
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.task_sched_gen import generate
    T, E, K, ITERS = SA_SCALE
    domain = TaskScheduleDomain(generate(T, E, 4))
    params = AnnealingParams(max_num_iterations=ITERS, num_optimizers=K,
                             initial_temp=50.0, cooling_rate=0.98,
                             temp_update_interval=5, max_step_size=2,
                             locally_optimize=True,
                             max_num_local_iterations=100, seed=11)
    return domain, params


def sa_cpu_child(path):
    """``--sa-cpu-child``: phase 62's short SA run on the CPU, its output
    lines written to ``path`` as JSON with the wall seconds."""
    from avenir_tpu_torch.optimize.annealing import simulated_annealing
    domain, params = sa_scale_setup()
    short = dataclasses.replace(params, max_num_iterations=SA_CPU_ITERS,
                                locally_optimize=False)
    t0 = time.perf_counter()
    lines = _sa_lines(domain, simulated_annealing(domain, short,
                                                  device="cpu"))
    with open(path, "w") as fh:
        json.dump({"lines": lines, "s": time.perf_counter() - t0}, fh)


def optimize_phase(dev):
    """Phase 62: the golden sa fixture and opt9 byte-equal through the
    port's CLI on the card (every opt9 case a child process, all started
    together; the 2-process cases two gloo ranks each), then SA and GA at
    scale, and the card against the CPU (a child process started with the
    opt9 children)."""
    import torch
    from avenir_tpu_torch.optimize.annealing import simulated_annealing
    from avenir_tpu_torch.optimize.genetic import (GeneticParams,
                                                   genetic_algorithm)
    from avenir_tpu_torch.utils import threefry as tf
    mk = fixture_module("opt9")
    T, E, K, ITERS = SA_SCALE
    phase(f"62 optimize: golden sa and opt9 byte-equal on the card; SA with "
          f"{K:,} chains over {T} tasks x {E} employees, {ITERS:,} "
          f"iterations + local descent; GA {GA_SCALE[0]} islands x "
          f"{GA_SCALE[1]}, {GA_SCALE[2]} generations")
    work = os.path.join(WORK, "opt9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if RES not in sys.path:
        sys.path.insert(0, RES)
    from gen.task_sched_gen import generate
    tf.launches = 0
    dom8 = os.path.join(work, "ts8.json")
    with open(dom8, "w") as fh:
        fh.write(json.dumps(generate(8, 5, 4)))
    conf = os.path.join(work, "golden.conf")
    with open(os.path.join(RES, "opt.conf")) as fh:
        text = fh.read()
    with open(conf, "w") as fh:
        fh.write(text.replace('"taskSched.json"', json.dumps(dom8))
                 .replace("max.num.iterations = 2000",
                          "max.num.iterations = 200"))
    run_cli(["org.avenir.spark.optimize.SimulatedAnnealing",
             os.path.join(work, "golden"), conf])
    same_bytes(os.path.join(work, "golden", "part-r-00000"),
               os.path.join(SA_GOLDEN, "solutions.csv"), "golden sa")
    cmds, runs = [], []
    for case, (job, changes) in mk.CASES.items():
        c = mk.write_conf(os.path.join(work, case + ".conf"), changes)
        out = os.path.join(work, case)
        args = [job, out, c]
        if case == "sa_starts":
            args = [job, os.path.join(OPT9, "sa", "out.csv"), out, c]
        cmds.append((cli_cmd(out + ".launches.json", args),
                     lane_env({}, True)))
        runs.append((case, job, [out]))
    port = free_port()
    for case, job in mk.JOINED.items():
        c = mk.write_conf(os.path.join(work, case + ".conf"))
        outs = [os.path.join(work, f"{case}_{i}") for i in range(2)]
        cmds += [(cli_cmd(outs[i] + ".launches.json", [job, outs[i], c]),
                  lane_env({"RANK": str(i), "WORLD_SIZE": "2",
                            "LOCAL_RANK": str(i), "MASTER_ADDR": "127.0.0.1",
                            "MASTER_PORT": str(port)}, True))
                 for i in range(2)]
        runs.append((case, job, outs))
        port = free_port()
    # the CPU's 50-iteration SA at scale needs no card: its child starts
    # with the opt9 children and is read after the card's own runs
    domain, params = sa_scale_setup()
    cpu_out = os.path.join(work, "sa_cpu.json")
    cpu_child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sa-cpu-child",
         cpu_out], cwd=ROOT, env=lane_env({}, True),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    res = run_children(cmds)
    cases_s = time.perf_counter() - t0
    all_ok(res, "opt9 children")
    fixture_launches = tf.launches
    at = 0
    for case, job, outs in runs:
        group = mk.GROUP[job]
        for i, out in enumerate(outs):
            same_bytes(os.path.join(out, "part-r-00000"),
                       os.path.join(OPT9, case, "out.csv"),
                       f"opt9 {case}" + (f" rank {i}" if len(outs) > 1
                                         else ""))
            fixture_launches += read_json(out + ".launches.json")["threefry"]
        got = read_json(outs[0] + ".counters.json")[group] \
            if len(outs) == 1 else counter_dump(res[at][1])[group]
        if {group: got} != read_json(os.path.join(OPT9, case,
                                                  "counters.json")):
            fail(f"opt9 {case}: counters {got} differ from the fixture's")
        at += len(outs)

    simulated_annealing(domain, dataclasses.replace(
        params, max_num_iterations=5, locally_optimize=False), device=dev)
    torch.cuda.synchronize()
    tf.launches = 0
    t0 = time.perf_counter()
    res = simulated_annealing(domain, params, device=dev)
    torch.cuda.synchronize()
    sa_s = time.perf_counter() - t0
    sa_launches = tf.launches
    short = dataclasses.replace(params, max_num_iterations=SA_CPU_ITERS,
                                locally_optimize=False)
    card_lines = _sa_lines(domain, simulated_annealing(domain, short,
                                                       device=dev))
    I, P, GENS = GA_SCALE
    gparams = GeneticParams(num_generations=GENS, population_size=P,
                            num_islands=I, crossover_prob=0.8,
                            mutation_prob=0.15, seed=11)
    genetic_algorithm(domain, dataclasses.replace(gparams, num_generations=2),
                      device=dev)
    torch.cuda.synchronize()
    tf.launches = 0
    t0 = time.perf_counter()
    gres = genetic_algorithm(domain, gparams, device=dev)
    torch.cuda.synchronize()
    ga_s = time.perf_counter() - t0
    ga_launches = tf.launches
    _, se = cpu_child.communicate(timeout=600)
    if cpu_child.returncode != 0:
        fail(f"the SA CPU child failed: {se[-2000:]}")
    cpu = read_json(cpu_out)
    if card_lines != cpu["lines"]:
        bad = sum(a != b for a, b in zip(card_lines, cpu["lines"]))
        fail(f"SA at {K:,} chains, {SA_CPU_ITERS} iterations: {bad} lines "
             f"differ between the card and the CPU")
    steps = ITERS + params.max_num_local_iterations
    out = {"fixture_launches": fixture_launches, "opt9_children_s": cases_s,
           "sa_s": sa_s, "sa_chain_steps_per_s": K * steps / sa_s,
           "sa_launches": sa_launches,
           "sa_launches_per_step": sa_launches / steps,
           "sa_best": float(res.best_costs.min()),
           "sa_cpu_50_s": cpu["s"], "ga_s": ga_s,
           "ga_member_generations_per_s": I * P * GENS / ga_s,
           "ga_launches": ga_launches, "ga_best": gres.best_cost}
    print(f"opt9 on the card: every case byte-equal ({len(cmds)} children "
          f"in {cases_s:.1f} s; threefry launches {fixture_launches}); SA "
          f"{K:,} chains x {steps:,} steps ({ITERS:,} + "
          f"{params.max_num_local_iterations} descent) in {sa_s:.2f} s: "
          f"{out['sa_chain_steps_per_s']:,.0f} chain-steps/s, "
          f"{out['sa_launches_per_step']:.1f} threefry launches a step, best "
          f"{out['sa_best']:.3f}; {SA_CPU_ITERS} iterations: the card's "
          f"{K:,} lines == the CPU's (CPU {cpu['s']:.2f} s); GA {I} x {P} x "
          f"{GENS} in {ga_s:.2f} s ({out['ga_member_generations_per_s']:,.0f}"
          f" member-generations/s, {ga_launches} threefry launches, best "
          f"{gres.best_cost:.3f})", flush=True)
    return out


def _sa_lines(domain, res):
    return [f"{domain.to_string(s)},{c:.3f}"
            for s, c in zip(res.best_solutions, res.best_costs)]


def vector_scale_run(device, algorithms=None):
    """VectorBandits at VB_GROUPS groups on ``device``: each algorithm
    (all by default), three calls, rewards for VB_REWARD_EVENTS random
    groups' chosen actions after each (drawn from a stream seeded by the
    algorithm, so a run on the card and one on the CPU that select alike
    get the same rewards).  Returns ({algorithm: (3, G) actions},
    {algorithm: seconds in the selecting calls}, {algorithm: threefry
    launches})."""
    import torch
    from avenir_tpu_torch.reinforce.batch import VectorBandits
    from avenir_tpu_torch.utils import threefry as tf
    cuda = torch.device(device).type == "cuda"
    got, secs, launches = {}, {}, {}
    for algo in algorithms or VectorBandits.ALGORITHMS:
        rng = np.random.default_rng(
            [20261063, VectorBandits.ALGORITHMS.index(algo)])
        if cuda:       # warm: one call on a throwaway instance
            VectorBandits(algo, VB_GROUPS, 4, seed=3,
                          device=device).next_actions()
        vb = VectorBandits(algo, VB_GROUPS, 4, seed=3, device=device)
        calls, secs[algo] = [], 0.0
        tf.launches = 0
        for _ in range(3):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = vb.next_actions()
            secs[algo] += time.perf_counter() - t0
            calls.append(a)
            gi = rng.integers(0, VB_GROUPS, VB_REWARD_EVENTS)
            r = rng.normal(1.0, 0.5, VB_REWARD_EVENTS).astype(np.float32)
            vb.set_rewards(gi, a[gi], r)
        got[algo] = np.stack(calls)
        launches[algo] = tf.launches
    return got, secs, launches


VB_CPU_CHILDREN = 3


def bandit_cpu_child(path, algorithms):
    """``--bandit-cpu-child``: :func:`vector_scale_run` on the CPU for the
    comma-separated ``algorithms``, the selections saved to ``path``."""
    got, _, _ = vector_scale_run("cpu", algorithms.split(","))
    np.savez(path, **got)


def bandit_phase(dev):
    """Phase 63: golden bandit and price and every mab9 case through the
    port's CLI on the card; VectorBandits at VB_GROUPS groups, every
    algorithm, three calls, the card against the CPU (child processes
    started at the phase's beginning)."""
    import torch
    from avenir_tpu_torch.reinforce.batch import VectorBandits
    from avenir_tpu_torch.utils import threefry as tf
    mk = fixture_module("mab9")
    phase(f"63 bandits: golden bandit/price and mab9 on the card; "
          f"VectorBandits {VB_GROUPS:,} groups x {mk.A} actions, "
          f"{len(mk.ALGORITHMS)} algorithms x 3 calls, card == CPU")
    work = os.path.join(WORK, "mab9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sys.path.insert(0, RES)
    import importlib
    # the CPU twin's VB_GROUPS-group runs: children started now, an
    # algorithm subset each, read at the end
    algos = VectorBandits.ALGORITHMS
    cpu_children = []
    for j in range(VB_CPU_CHILDREN):
        path = os.path.join(work, f"vector_cpu{j}.npz")
        cpu_children.append((path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--bandit-cpu-child",
             path, ",".join(algos[j::VB_CPU_CHILDREN])], cwd=ROOT,
            env=lane_env({}, True), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    tf.launches = 0
    for name, gen, args, props, akey in (
            ("bandit", "bandit_rewards_gen", (600, 22, 4),
             "bandit.properties", "actions.csv"),
            ("price", "price_revenue_gen", (1000, 44, 5),
             "price_opt.properties", "prices.csv")):
        rw = os.path.join(work, name + "_rewards.csv")
        with open(rw, "w") as fh:
            fh.write("\n".join(importlib.import_module(
                f"gen.{gen}").generate(*args)))
        out = os.path.join(work, name)
        run_cli(["org.avenir.spark.reinforce.MultiArmBandit",
                 f"-Dconf.path={os.path.join(RES, props)}",
                 "-Dmab.model.state.file.in=/nonexistent",
                 f"-Dmab.model.state.file.out={out}_state/part", rw, out])
        golden = os.path.join(ROOT, "tests", "golden", "fixtures", name)
        same_bytes(os.path.join(out, "part-r-00000"),
                   os.path.join(golden, akey), f"golden {name} actions")
        same_bytes(os.path.join(out + "_state", "part", "part-r-00000"),
                   os.path.join(golden, "state.csv"), f"golden {name} state")
    want = read_json(os.path.join(MAB9, "rounds.json"))
    for case, (job, extra) in mk.cases().items():
        d = os.path.join(work, case)
        os.makedirs(d)
        got = mk.run_rounds(lambda a: 0 if run_cli(a) is None else 1, job,
                            extra, d)
        if got != want[case]:
            fail(f"mab9 {case} on the card differs from the fixture")
    got = mk.run_vector(VectorBandits, device=dev)
    with np.load(os.path.join(MAB9, "vector.npz")) as z:
        for algo in z.files:
            if not np.array_equal(got[algo], z[algo]):
                fail(f"mab9 VectorBandits {algo} on the card differs")
    fixture_launches = tf.launches
    print(f"mab9 on the card: {len(want)} cases x 3 rounds and "
          f"VectorBandits byte-equal (threefry launches {fixture_launches})",
          flush=True)
    got, secs, launches = vector_scale_run(dev)
    seen = []
    for path, child in cpu_children:
        _, se = child.communicate(timeout=900)
        if child.returncode != 0:
            fail(f"a VectorBandits CPU child failed: {se[-2000:]}")
        with np.load(path) as z:
            for algo in z.files:
                seen.append(algo)
                bad = int((got[algo] != z[algo]).sum())
                if bad:
                    fail(f"VectorBandits {algo} at {VB_GROUPS:,} groups: "
                         f"{bad} selections differ between the card and "
                         f"the CPU")
    if sorted(seen) != sorted(algos):
        fail(f"the CPU children ran {sorted(seen)}")
    rates = {a: 3 * VB_GROUPS / s for a, s in secs.items()}
    print(f"VectorBandits over {VB_GROUPS:,} groups: card == CPU for every "
          f"algorithm, 3 calls; selections/s (call incl. H2D and read-back):"
          f" { {k: round(v) for k, v in rates.items()} }; threefry "
          f"launches {launches}", flush=True)
    return {"fixture_launches": fixture_launches,
            "selections_per_s": rates, "launches": launches}


# --------------------------------------------------------------------------
# phases 64-66: the online learning plane (online9 on the card, an ad
# server's stream at scale) and the samplers through the threefry twin
# --------------------------------------------------------------------------

ONLINE9 = os.path.join(ROOT, "tests", "torch_fixtures", "online9")
ONLINE_MLP_ATOL = 1e-5        # case e's MLP parameters, card against JAX
ONLINE_SCALE_PREDICTS = 8_000
ONLINE_SCALE_FEATURES = 32
ONLINE_SCALE_ARMS = 8
ONLINE_SCALE_WINDOW = 256
ONLINE_SCALE_BUCKETS = (8, 64, 256)
ONLINE_SCALE_MLP_HIDDEN = 64
ONLINE_SCALE_SNAPSHOT_EVERY = 32
# (algorithm, head, transport): the third run supervised over the wire
ONLINE_SCALE_RUNS = (("ucb1", "bandit", "inprocess"),
                     ("softMax", "logistic", "inprocess"),
                     ("sampsonSampler", "mlp", "resp"))
METRO_CHAINS = 1_000_000
METRO_TRANSITIONS = 100
METRO_CPU_CHAINS = 65_536
WEIGHTED_DRAWS = 1_000_000
WEIGHTED_N = 1_000
WEIGHTED_CPU_DRAWS = 20_000
METRO_TARGET = (1.0, 2.0, 4.0, 8.0, 6.0, 3.0, 2.0, 1.0, 0.5)


def online_scale_stream():
    """An ad server's stream: ONLINE_SCALE_PREDICTS predict rows of 32
    features; a reward for 80% of them 1-3 windows later, 4-decimal values
    tied to the features; 1% orphan rewards (ids never served)."""
    rng = np.random.default_rng(20261065)
    n, F = ONLINE_SCALE_PREDICTS, ONLINE_SCALE_FEATURES
    X = rng.normal(size=(n, F)).round(4)
    beta = rng.normal(size=F) / np.sqrt(F)
    p = 1.0 / (1.0 + np.exp(-(X @ beta)))
    rewarded = rng.random(n) < 0.8
    vals = np.clip(p + 0.5 * (rng.random(n) - 0.5), 0.0, 1.9999).round(4)
    pos = np.arange(n, dtype=np.float64) * 1.8
    lag = rng.uniform(1.0, 3.0, n) * ONLINE_SCALE_WINDOW
    n_orph = n // 100
    lines = [f"predict,q{i}," + ",".join(f"{v:.4f}" for v in X[i])
             for i in range(n)]
    ids = np.nonzero(rewarded)[0]
    lines += [f"reward,q{i},{vals[i]:.4f}" for i in ids]
    lines += [f"reward,orphan{j},{v:.4f}"
              for j, v in enumerate(rng.random(n_orph).round(4))]
    at = np.concatenate([pos, pos[ids] + lag[ids],
                         rng.uniform(0, pos[-1], n_orph)])
    order = np.argsort(at, kind="stable")
    return [lines[i] for i in order]


def online_scale_config(algorithm, head):
    from avenir_tpu_torch.online import OnlineLearnerConfig
    return OnlineLearnerConfig(
        actions=tuple(str(a) for a in range(ONLINE_SCALE_ARMS)),
        n_features=ONLINE_SCALE_FEATURES, algorithm=algorithm, head=head,
        mlp_hidden=ONLINE_SCALE_MLP_HIDDEN if head == "mlp" else 0,
        learning_rate=0.05, temp_constant=0.3, seed=11)


def online_scale_run(device, msgs, algorithm, head, transport, work=None):
    """One run of the stream on ``device`` (in-process windows of
    ONLINE_SCALE_WINDOW messages, or over an embedded RESP broker with a
    supervisor snapshotting every ONLINE_SCALE_SNAPSHOT_EVERY windows).
    Returns (replies, stats)."""
    import torch
    from avenir_tpu_torch.core.metrics import Counters
    from avenir_tpu_torch.online import (OnlineLearnerService,
                                         OnlineWindowPlane)
    from avenir_tpu_torch.parallel.mesh import DeviceMesh, MeshContext
    from avenir_tpu_torch.pipeline.cache import program_cache
    from avenir_tpu_torch.utils import threefry as tf
    program_cache().clear()
    cfg = online_scale_config(algorithm, head)
    plane = OnlineWindowPlane(cfg, ctx=MeshContext(DeviceMesh([device])),
                              buckets=ONLINE_SCALE_BUCKETS,
                              pending_capacity=1 << 20)
    plane.profile = True
    counters = Counters()
    sup = None
    if transport == "resp":
        from avenir_tpu_torch.control.controller import (
            OnlineSupervisor, OnlineSupervisorPolicy)
        from avenir_tpu_torch.serving.registry import ModelRegistry
        shutil.rmtree(work, ignore_errors=True)
        sup = OnlineSupervisor(
            ModelRegistry(os.path.join(work, "registry")), "onl",
            os.path.join(work, "state"),
            policy=OnlineSupervisorPolicy(
                snapshot_every=ONLINE_SCALE_SNAPSHOT_EVERY),
            counters=counters)
    svc = OnlineLearnerService(plane, counters=counters, supervisor=sup)
    tf.launches = 0
    t0 = time.perf_counter()
    if transport == "resp":
        from avenir_tpu_torch.io import respq
        from avenir_tpu_torch.online.service import OnlineRespLoop
        server = respq.RespServer().start()
        feeder = respq.RespClient(port=server.port)
        for s in range(0, len(msgs), 10_000):
            feeder.lpush_many("requestQueue", msgs[s:s + 10_000])
        t0 = time.perf_counter()
        loop = OnlineRespLoop(svc, respq.RespClient(port=server.port),
                              batch=ONLINE_SCALE_WINDOW)
        loop.run()
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        replies = _drain(feeder)
        feeder.close()
        loop.client.close()
        server.stop()
    else:
        replies = []
        for i in range(0, len(msgs), ONLINE_SCALE_WINDOW):
            out, _ = svc.process_window(msgs[i:i + ONLINE_SCALE_WINDOW])
            replies.extend(out)
        wall = time.perf_counter() - t0
    st = plane.run_stats()
    w = max(st["windows"], 1)
    stats = {"windows": st["windows"], "wall_s": wall,
             "windows_per_s": st["windows"] / wall,
             "requests_per_s": counters.get("Online", "Requests") / wall,
             "ms_per_window": {k[:-2]: v / w * 1e3
                               for k, v in plane.timings.items()},
             "threefry_launches": tf.launches,
             "threefry_per_window": tf.launches / w,
             "joined": st["joined"], "orphans": st["orphans"],
             "retraces": st["retraces"], "hits": st["hits"]}
    if sup is not None:
        stats["snapshots"] = counters.get("Online", "Snapshots")
    return replies, stats


def samplers_subset(device, chains, draws):
    """The phase-66 draws on ``device`` for the first ``chains`` chains
    and ``draws`` rows (chain c and row i draw at counters that do not
    depend on the counts)."""
    from avenir_tpu_torch.stats import samplers
    from avenir_tpu_torch.utils import threefry as tf
    m = samplers.MetropolisSampler(1.5, 0.0, 1.0, METRO_TARGET,
                                   n_chains=chains, seed=66, device=device)
    cur = m.sub_sample(METRO_TRANSITIONS)
    w = np.random.default_rng(20261066).uniform(0.0, 5.0, WEIGHTED_N)
    idx = samplers.weighted_indices(tf.PRNGKey(66, device), w, draws)
    return cur, idx, m.trans_count


def online_cpu_child(stream_path, path):
    """``--online-cpu-child``: the first scale run and the sampler subsets
    on the CPU, saved to ``path``."""
    from avenir_tpu_torch.runtime import set_default_device
    set_default_device("cpu")
    with open(stream_path) as fh:
        msgs = fh.read().splitlines()
    replies, _ = online_scale_run("cpu", msgs, *ONLINE_SCALE_RUNS[0])
    cur, idx, _ = samplers_subset("cpu", METRO_CPU_CHAINS,
                                  WEIGHTED_CPU_DRAWS)
    np.savez(path, replies=np.asarray(replies), metro=cur, weighted=idx)


def online9_phase(dev):
    """Phase 64: every online9 case through ``onlineLearner`` on the card:
    replies, counters, journals and registry files equal the fixture's
    (the pin's clock aside); case e's MLP parameters within
    ONLINE_MLP_ATOL, its differing labels counted."""
    import contextlib
    import io
    from avenir_tpu_torch.cli import run as cli_run
    from avenir_tpu_torch.core import faults
    from avenir_tpu_torch.online.state import (OnlineLearnerConfig,
                                               _flatten, init_state,
                                               state_from_bytes)
    from avenir_tpu_torch.pipeline.cache import program_cache
    from avenir_tpu_torch.utils import threefry as tf
    from avenir_tpu_torch.utils.tracing import transfer_ledger
    mk = fixture_module("online9")
    phase(f"64 online9 on the card: onlineLearner cases "
          f"{','.join(mk.CASES)} == the JAX fixture")

    def main(args):
        with contextlib.redirect_stdout(io.StringIO()):
            return cli_run.main(args)
    tf.launches = 0
    mlp_gap, label_diffs = 0.0, 0
    t_cfg = init_state(OnlineLearnerConfig(
        actions=tuple(mk.ACTIONS.split(",")), n_features=mk.N_FEATURES,
        head="mlp", mlp_hidden=8))
    with transfer_ledger() as led:
        for case in mk.CASES:
            work = os.path.join(WORK, "online9", case)
            shutil.rmtree(work, ignore_errors=True)
            os.makedirs(work)
            mk.run_case(main, faults, program_cache().clear, case, work)
            got = os.path.join(work, "got")
            mk.keep(work, got, case)
            want = os.path.join(ONLINE9, case)
            rels = sorted(os.path.relpath(os.path.join(d, f), want)
                          for d, _, fs in os.walk(want) for f in fs)
            for rel in rels:
                g, w = os.path.join(got, rel), os.path.join(want, rel)
                if not os.path.exists(g):
                    fail(f"online9 {case}: {rel} missing on the card")
                with open(g, "rb") as a, open(w, "rb") as b:
                    ga, wb = a.read(), b.read()
                if case == "e" and rel.endswith("online_state.bin"):
                    hdr = 11 + int.from_bytes(wb[7:11], "little")
                    gs = dict(_flatten(state_from_bytes(ga, t_cfg)))
                    ws = dict(_flatten(state_from_bytes(wb, t_cfg)))
                    gap = max(float(np.abs(gs[k] - ws[k]).max())
                              for k in gs if "/mlp/" in k)
                    mlp_gap = max(mlp_gap, gap)
                    same = all(np.array_equal(gs[k], ws[k])
                               for k in gs if "/mlp/" not in k)
                    if ga[:hdr] != wb[:hdr] or not same or \
                            gap > ONLINE_MLP_ATOL:
                        fail(f"online9 e {rel}: header/bandit leaves "
                             f"differ or MLP gap {gap} > {ONLINE_MLP_ATOL}")
                    continue
                if case == "e" and rel == "replies.txt":
                    label_diffs = sum(x != y for x, y in zip(
                        ga.decode().splitlines(), wb.decode().splitlines()))
                    continue
                if CLOCK_FIELDS.sub(rb'"\1": T', ga) != \
                        CLOCK_FIELDS.sub(rb'"\1": T', wb):
                    fail(f"online9 {case}: {rel} differs from the fixture")
    backends = led.backend_snapshot()
    if not backends.get("threefry.cuda") or backends.get("threefry.torch"):
        fail(f"online9: the ledger shows threefry forms {backends}")
    print(f"online9 on the card: cases {list(mk.CASES)} byte-equal to the "
          f"fixture (bandit and logistic heads: replies, counters, "
          f"journals, every snapshot); case e's MLP parameters within "
          f"{mlp_gap:.3g} (limit {ONLINE_MLP_ATOL}), {label_diffs} reply "
          f"labels differ; threefry launches {tf.launches}", flush=True)
    return {"fixture_launches": tf.launches, "mlp_max_gap": mlp_gap,
            "mlp_label_diffs": label_diffs}


def online_scale_phase(dev, stream, cpu_child, gen_s):
    """Phase 65: the ad server's stream, its three runs on the card one
    after another in this process, each alone on the card (the CPU
    reference's child, started before phase 64, is the only other work on
    the host); the first run's replies byte-equal to that child's."""
    phase(f"65 online plane at scale: {ONLINE_SCALE_PREDICTS:,} predicts x "
          f"{ONLINE_SCALE_FEATURES} features, {ONLINE_SCALE_ARMS} arms, "
          f"windows of {ONLINE_SCALE_WINDOW}, runs {ONLINE_SCALE_RUNS}, "
          f"each alone on the card")
    with open(stream) as fh:
        msgs = fh.read().splitlines()
    runs, first = {}, None
    for i, (algo, head, transport) in enumerate(ONLINE_SCALE_RUNS):
        replies, st = online_scale_run(
            dev, msgs, algo, head, transport,
            work=os.path.join(WORK, "online", f"run{i}"))
        if len(replies) != ONLINE_SCALE_PREDICTS:
            fail(f"online scale {algo}/{head}: {len(replies)} replies for "
                 f"{ONLINE_SCALE_PREDICTS} predicts")
        if first is None:
            first = replies
        runs[f"{algo}/{head}/{transport}"] = st
        print(f"online {algo}/{head} ({transport}): {st['windows']} windows"
              f" in {st['wall_s']:.2f} s = {st['windows_per_s']:.1f} "
              f"windows/s, {st['requests_per_s']:.0f} requests/s; ms a "
              f"window {json.dumps({k: round(v, 4) for k, v in st['ms_per_window'].items()})}"
              f"; threefry launches a window {st['threefry_per_window']:.2f}"
              f"; joined {st['joined']}, orphans {st['orphans']}"
              + (f", snapshots {st['snapshots']}" if "snapshots" in st
                 else "") + f"; staging buffers allocated for "
              f"{st['retraces']} (request, reward) bucket pairs",
              flush=True)
        if st["retraces"] > len(ONLINE_SCALE_BUCKETS) ** 2:
            fail(f"online scale {algo}/{head}: {st['retraces']} buffer "
                 f"allocations for {len(ONLINE_SCALE_BUCKETS) ** 2} "
                 f"bucket pairs")
    path, child = cpu_child
    _, se = child.communicate(timeout=900)
    if child.returncode != 0:
        fail(f"the online CPU child failed: {se[-2000:]}")
    with np.load(path) as z:
        cpu_replies = list(z["replies"])
    bad = sum(a != b for a, b in zip(first, cpu_replies))
    if bad or len(first) != len(cpu_replies):
        fail(f"online scale ucb1/bandit: {bad} of {len(first)} replies "
             f"differ between the card and the CPU port")
    print(f"online scale ucb1/bandit: the card's {len(first):,} replies "
          f"byte-equal to the CPU port's; stream made in {gen_s:.1f} s",
          flush=True)
    return {"runs": runs, "stream_s": gen_s,
            "scale_launches": sum(r["threefry_launches"]
                                  for r in runs.values())}


def samplers_phase(dev, cpu_path):
    """Phase 66: MetropolisSampler at METRO_CHAINS x METRO_TRANSITIONS and
    weighted_indices at WEIGHTED_DRAWS over WEIGHTED_N weights on the card,
    bit-equal to the CPU port on the first chains and rows."""
    import torch
    from avenir_tpu_torch.utils import threefry as tf
    phase(f"66 samplers: Metropolis {METRO_CHAINS:,} chains x "
          f"{METRO_TRANSITIONS} transitions, weighted_indices "
          f"{WEIGHTED_DRAWS:,} draws over {WEIGHTED_N:,} weights; card == "
          f"CPU")
    samplers_subset(dev, 4096, 1000)            # warm the kernels
    tf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from avenir_tpu_torch.stats import samplers
    m = samplers.MetropolisSampler(1.5, 0.0, 1.0, METRO_TARGET,
                                   n_chains=METRO_CHAINS, seed=66,
                                   device=dev)
    cur = m.sub_sample(METRO_TRANSITIONS)
    metro_s = time.perf_counter() - t0
    metro_launches = tf.launches
    w = np.random.default_rng(20261066).uniform(0.0, 5.0, WEIGHTED_N)
    t0 = time.perf_counter()
    idx = samplers.weighted_indices(tf.PRNGKey(66, dev), w, WEIGHTED_DRAWS)
    weighted_s = time.perf_counter() - t0
    with np.load(cpu_path) as z:
        if not np.array_equal(cur[:METRO_CPU_CHAINS], z["metro"]):
            fail(f"Metropolis: {int((cur[:METRO_CPU_CHAINS] != z['metro']).sum())}"
                 f" of the first {METRO_CPU_CHAINS:,} chains differ from the "
                 f"CPU port's")
        if not np.array_equal(idx[:WEIGHTED_CPU_DRAWS], z["weighted"]):
            fail("weighted_indices: the card's first draws differ from the "
                 "CPU port's")
    frac = np.bincount(idx, minlength=WEIGHTED_N) / WEIGHTED_DRAWS
    err = float(np.abs(frac - w / w.sum()).max())
    if err > 0.002:
        fail(f"weighted_indices frequencies off by {err}")
    out = {"metro_s": metro_s,
           "metro_ms_per_transition": metro_s / METRO_TRANSITIONS * 1e3,
           "metro_launches": metro_launches,
           "metro_launches_per_transition":
               metro_launches / METRO_TRANSITIONS,
           "metro_accepted": m.trans_count,
           "weighted_s": weighted_s,
           "weighted_launches": tf.launches - metro_launches,
           "weighted_max_freq_err": err}
    print(f"samplers on the card == the CPU port on the first "
          f"{METRO_CPU_CHAINS:,} chains and {WEIGHTED_CPU_DRAWS:,} draws: "
          f"{json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in out.items()})}",
          flush=True)
    return out


def online_phases(dev):
    """Phases 64-66.  The scale stream is written first and the CPU
    reference's child (phase 65's first run and phase 66's subsets on the
    CPU) starts before phase 64; phases 64-66 run in this process, one
    after another."""
    work = os.path.join(WORK, "online")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    stream = os.path.join(work, "stream.txt")
    with open(stream, "w") as fh:
        fh.write("\n".join(online_scale_stream()) + "\n")
    gen_s = time.perf_counter() - t0
    cpu_path = os.path.join(work, "cpu.npz")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--online-cpu-child",
         stream, cpu_path], cwd=ROOT,
        env=lane_env({"CUDA_VISIBLE_DEVICES": ""}, False),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        o9 = online9_phase(dev)
        scale = online_scale_phase(dev, stream, (cpu_path, child), gen_s)
        samp = samplers_phase(dev, cpu_path)
    finally:
        if child.poll() is None:
            child.kill()
    return {"online9": o9, "scale": scale, "samplers": samp}


# --------------------------------------------------------------------------
# phases 67-68: the sequence, association and text jobs
# --------------------------------------------------------------------------

SEQ9 = os.path.join(ROOT, "tests", "torch_fixtures", "seq9")
GOLDEN = os.path.join(ROOT, "tests", "golden", "fixtures")
# phase 68: sequences, plain / tagged loyalty sequences, transactions,
# visitors x events a visitor, and the Apriori levels run at scale
SEQ_SCALE_EVENTS = 125_000
SEQ_SCALE_PLAIN = 50_000
SEQ_SCALE_TAGGED = 10_000
SEQ_SCALE_XACTIONS = 250_000
SEQ_SCALE_VISITS = (2_000, 250)    # users (the issue's), events a user
SEQ_SCALE_LEVELS = 3
SEQ_SCALE_SUPPORT = "0.02"


def gen_module(name):
    """resource/gen/<name>.py (the golden flows' generators)."""
    if RES not in sys.path:
        sys.path.insert(0, RES)
    import importlib
    return importlib.import_module(f"gen.{name}")


def write_lines(path, lines):
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def golden_seq_flows(work, plat=()):
    """tests/golden/flows.py's markov, conv, buyhist, sup, visit and
    apriori flows through the port's CLI, with the same generator calls
    and keys.  Returns ({golden file: output path}, {job: wall s})."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    outs, walls = {}, {}

    def run(name, args):
        t0 = time.perf_counter()
        run_cli([*args, *plat])
        walls[name] = round(time.perf_counter() - t0, 3)

    for name, mod, seed, props in (
            ("markov", "event_seq_gen", 21, "markov.properties"),
            ("conv", "conv_seq_gen", 34, "conv.properties")):
        d = os.path.join(work, name)
        os.makedirs(d)
        seqs = os.path.join(d, "sequences.csv")
        write_lines(seqs, gen_module(mod).generate(300, seed))
        conf = f"-Dconf.path={os.path.join(RES, props)}"
        run(f"{name} model", ["markovStateTransitionModel", conf, seqs,
                              os.path.join(d, "model")])
        run(f"{name} pred", [
            "markovModelClassifier", conf,
            f"-Dmmc.mm.model.path={d}/model/part-r-00000", seqs,
            os.path.join(d, "pred")])
        outs[f"{name}/model.csv"] = f"{d}/model/part-r-00000"
        outs[f"{name}/pred.csv"] = f"{d}/pred/part-m-00000"
    d = os.path.join(work, "buyhist")
    os.makedirs(d)
    loyal = gen_module("loyalty_seq_gen")
    write_lines(f"{d}/tagged.csv", loyal.generate(200, 41, "tagged"))
    write_lines(f"{d}/plain.csv", loyal.generate(40, 42, "plain"))
    conf = f"-Dconf.path={os.path.join(RES, 'buyhist.properties')}"
    run("buyhist model", ["hiddenMarkovModelBuilder", conf,
                          f"{d}/tagged.csv", f"{d}/model"])
    run("buyhist decoded", [
        "viterbiStatePredictor", conf,
        f"-Dvsp.hmm.model.path={d}/model/part-r-00000", f"{d}/plain.csv",
        f"{d}/decoded"])
    outs["buyhist/model.csv"] = f"{d}/model/part-r-00000"
    outs["buyhist/decoded.csv"] = f"{d}/decoded/part-m-00000"
    d = os.path.join(work, "sup")
    os.makedirs(d)
    write_lines(f"{d}/events.csv",
                gen_module("supplier_events_gen").generate(4, 50, 35))
    write_lines(f"{d}/init.csv", [f"S{i:03d},F" for i in range(4)])
    conf = f"-Dconf.path={os.path.join(RES, 'sup.conf')}"
    run("sup rates", ["stateTransitionRate", conf, f"{d}/events.csv",
                      f"{d}/rates"])
    run("sup forecast", [
        "contTimeStateTransitionStats", conf,
        f"-Dstate.trans.file.path={d}/rates/part-r-00000",
        f"{d}/init.csv", f"{d}/fc"])
    outs["sup/rates.csv"] = f"{d}/rates/part-r-00000"
    outs["sup/forecast.csv"] = f"{d}/fc/part-r-00000"
    d = os.path.join(work, "visit")
    os.makedirs(d)
    write_lines(f"{d}/visits.csv",
                gen_module("visit_events_gen").generate(10, 60, 43))
    run("visit hist", ["eventTimeDistribution",
                       f"-Dconf.path={os.path.join(RES, 'visit.properties')}",
                       f"{d}/visits.csv", f"{d}/hist"])
    outs["visit/hist.csv"] = f"{d}/hist/part-r-00000"
    d = os.path.join(work, "apriori")
    os.makedirs(d)
    data = f"{d}/xactions.csv"
    write_lines(data, gen_module("buy_xaction_gen").generate(500, 24))
    common = [f"-Dconf.path={os.path.join(RES, 'apriori.properties')}",
              "-Dfia.total.tans.count=500"]
    run("apriori level_1", ["frequentItemsApriori", *common,
                            "-Dfia.item.set.length=1",
                            "-Dfia.trans.id.output=true", data,
                            f"{d}/level_1"])
    for length, out in ((1, "freq_1"), (2, "freq_2")):
        args = ["frequentItemsApriori", *common,
                f"-Dfia.item.set.length={length}"]
        if length > 1:
            args.append(f"-Dfia.item.set.file.path={d}/level_1/part-r-00000")
        run(f"apriori {out}", args + [data, f"{d}/{out}"])
    os.makedirs(f"{d}/rules_in")
    with open(f"{d}/rules_in/part-r-00000", "w") as fh:
        fh.write(open(f"{d}/freq_1/part-r-00000").read() + "\n" +
                 open(f"{d}/freq_2/part-r-00000").read())
    run("apriori rules", ["associationRuleMiner", common[0],
                          f"{d}/rules_in", f"{d}/rules"])
    outs["apriori/freq_pairs.csv"] = f"{d}/freq_2/part-r-00000"
    outs["apriori/rules.csv"] = f"{d}/rules/part-r-00000"
    return outs, walls


def differing_lines(got, want):
    """Lines of two files that differ (and any length difference)."""
    a = open(got).read().splitlines()
    b = open(want).read().splitlines()
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def seq_fixture_phase():
    """Phase 67: the golden sequence and apriori flows and every seq9 case
    through the port's CLI on the card, byte for byte (seq9's counters
    too), no kernel launched."""
    import contextlib
    import io
    from avenir_tpu_torch.cli import run as cli_run
    phase("67 sequence on the card: golden markov, conv, buyhist, sup, "
          "visit and apriori flows and every seq9 case through the port's "
          "CLI, byte for byte")
    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        outs, walls = golden_seq_flows(os.path.join(WORK, "seq_golden"))
    forecast_diff = differing_lines(outs["sup/forecast.csv"],
                                    os.path.join(GOLDEN, "sup",
                                                 "forecast.csv"))
    for rel, path in outs.items():
        same_bytes(path, os.path.join(GOLDEN, rel), f"golden {rel}")
    mk = fixture_module("seq9")
    work = os.path.join(WORK, "seq9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    for case in mk.CASES:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            text, counters = mk.run_case(cli_run.main, SEQ9, work, case)
        walls[f"seq9 {case}"] = round(time.perf_counter() - t0, 3)
        with open(os.path.join(SEQ9, case, "out.csv")) as fh:
            if fh.read() != text:
                fail(f"seq9 {case}: the card's output differs from "
                     f"{case}/out.csv")
        if counters != read_json(os.path.join(SEQ9, case, "counters.json")):
            fail(f"seq9 {case}: counters {counters} differ from the "
                 f"fixture's")
    counts = launch_counts()
    if any(counts.values()):
        fail(f"phase 67: the sequence jobs launched a kernel: {counts}")
    print(f"seq9: all {len(mk.CASES)} cases byte-equal (output and "
          f"counters); sup/forecast.csv lines apart: {forecast_diff}; "
          f"kernel launches {counts}", flush=True)
    print(f"job walls (s): {json.dumps(walls)}", flush=True)
    return {"walls": walls, "seq9_cases": len(mk.CASES),
            "forecast_lines_apart": forecast_diff, "launches": counts}


def markov_chains(rng, n, p_rows, p_first, lens, emit=None):
    """Vectorised draws of n chains of a Markov model: the first state
    from ``p_first`` (n, S) rows, each next state from ``p_rows[state]``
    by one uniform and the cumulative row; with ``emit`` also an
    observation a step from ``emit[state]`` (drawn before the step, as
    loyalty_seq_gen does).  Returns (n, max(lens)) states [, obs]."""
    L = int(lens.max())
    cdf = np.cumsum(p_rows, axis=-1)
    first = (rng.random(n)[:, None] >= np.cumsum(p_first, axis=1)).sum(1)
    states = np.zeros((n, L), np.int64)
    obs = np.zeros((n, L), np.int64) if emit is not None else None
    cur = np.minimum(first, p_rows.shape[-1] - 1)
    ecdf = np.cumsum(emit, axis=1) if emit is not None else None
    for t in range(L):
        states[:, t] = cur
        if emit is not None:
            obs[:, t] = np.minimum((rng.random(n)[:, None]
                                    >= ecdf[cur]).sum(1), emit.shape[1] - 1)
        rows = cdf[np.arange(n), cur] if cdf.ndim == 3 else cdf[cur]
        cur = np.minimum((rng.random(n)[:, None] >= rows).sum(1),
                         p_rows.shape[-1] - 1)
    return (states, obs) if emit is not None else states


SEQ_SCALE_INPUTS = ("events", "plain", "tagged", "xactions", "visits")


def seq_scale_inputs(work, drawn):
    """Phase 68's inputs, drawn vectorised from the generators' own models
    (event_seq_gen's matrices, loyalty_seq_gen's HMM, buy_xaction_gen's
    bundles and catalog, visit_events_gen's hour profiles) with seeds
    71-75, in their line formats (the per-row generators take minutes at
    these sizes), as ``<work>/<name>.csv`` for each name of
    SEQ_SCALE_INPUTS; ``drawn(path)`` is called as each is written."""
    paths = {}
    ev = gen_module("event_seq_gen")
    rng = np.random.default_rng(71)
    n = SEQ_SCALE_EVENTS
    fraud = rng.random(n) < 0.3
    lens = rng.integers(8, 21, n)
    S = len(ev.STATES)
    mats = np.stack([ev.NORMAL, ev.FRAUD])[fraud.astype(int)]   # (n, S, S)
    chains = markov_chains(rng, n, mats, np.full((n, S), 1.0 / S), lens)
    names = np.asarray(ev.STATES, dtype=object)[chains]
    lines = [f"C{i:06d},{'F' if f else 'N'}," + ",".join(c[:ln])
             for i, (f, c, ln) in enumerate(zip(fraud.tolist(), names,
                                                lens.tolist()))]
    paths["events"] = os.path.join(work, "events.csv")
    write_lines(paths["events"], lines)
    drawn(paths["events"])
    lo = gen_module("loyalty_seq_gen")
    obs_names = np.asarray(lo.OBS, dtype=object)
    st_names = np.asarray(lo.STATES, dtype=object)
    for name, n, seed in (("plain", SEQ_SCALE_PLAIN, 72),
                          ("tagged", SEQ_SCALE_TAGGED, 73)):
        rng = np.random.default_rng(seed)
        lens = rng.integers(10, 26, n)
        states, obs = markov_chains(rng, n, lo.TRANS,
                                    np.broadcast_to(lo.INIT, (n, 3)), lens,
                                    emit=lo.EMIT)
        if name == "plain":
            lines = [f"U{i:05d}," + ",".join(obs_names[o[:ln]])
                     for i, (o, ln) in enumerate(zip(obs, lens.tolist()))]
        else:
            pairs = np.stack([obs_names[obs], st_names[states]], axis=2)
            lines = [f"U{i:05d}," + ",".join(p[:ln].ravel())
                     for i, (p, ln) in enumerate(zip(pairs, lens.tolist()))]
        paths[name] = os.path.join(work, f"{name}.csv")
        write_lines(paths[name], lines)
        drawn(paths[name])
    bx = gen_module("buy_xaction_gen")
    rng = np.random.default_rng(74)
    n = SEQ_SCALE_XACTIONS
    V = len(bx.CATALOG)
    member = np.zeros((n, V), bool)
    hit = rng.random((n, len(bx.BUNDLES))) < 0.35
    has = hit.any(axis=1)
    first_bundle = np.argmax(hit, axis=1)
    col = {it: j for j, it in enumerate(bx.CATALOG)}
    for b, (x, y) in enumerate(bx.BUNDLES):
        rows = has & (first_bundle == b)
        member[rows, col[x]] = member[rows, col[y]] = True
    active = np.ones(n, bool)
    while active.any():
        active &= member.sum(1) < rng.integers(2, 7, n)
        pick = rng.integers(0, V, n)
        member[np.flatnonzero(active), pick[active]] = True
    order = np.argsort(bx.CATALOG)
    bits = (member[:, order] * (1 << np.arange(V))).sum(1)
    sorted_names = [bx.CATALOG[j] for j in order]
    label = [",".join(sorted_names[j] for j in range(V) if m >> j & 1)
             for m in range(1 << V)]
    paths["xactions"] = os.path.join(work, "xactions.csv")
    write_lines(paths["xactions"], [f"T{i:06d},{label[m]}"
                                    for i, m in enumerate(bits.tolist())])
    drawn(paths["xactions"])
    vg = gen_module("visit_events_gen")
    rng = np.random.default_rng(75)
    users, per = SEQ_SCALE_VISITS
    night = (np.arange(users) % 2 == 1).repeat(per)
    day = rng.integers(0, 30, users * per)
    hour = np.where(night, (rng.random(users * per)[:, None]
                            >= np.cumsum(vg._night_p())).sum(1),
                    (rng.random(users * per)[:, None]
                     >= np.cumsum(vg._day_p())).sum(1)).clip(0, 23)
    ts = vg.BASE + day * vg.MS_DAY + hour * vg.MS_HOUR + \
        rng.integers(0, vg.MS_HOUR, users * per)
    uid = np.arange(users).repeat(per)
    paths["visits"] = os.path.join(work, "visits.csv")
    write_lines(paths["visits"], [f"U{u:04d},{t}" for u, t in
                                  zip(uid.tolist(), ts.tolist())])
    drawn(paths["visits"])


def seq_scale_jobs(paths, work):
    """Phase 68's jobs as (name, job, keys, input, output, units): the
    Markov model and classifier over the event sequences, the HMM and
    Viterbi, Apriori levels 1..SEQ_SCALE_LEVELS and the event-time
    histogram."""
    markov = os.path.join(RES, "markov.properties")
    buy = os.path.join(RES, "buyhist.properties")
    apr = os.path.join(RES, "apriori.properties")
    out = lambda name: os.path.join(work, name)   # noqa: E731
    jobs = [("markov model", "markovStateTransitionModel", markov, [],
             paths["events"], out("model"), SEQ_SCALE_EVENTS),
            ("markov classify", "markovModelClassifier", markov,
             [f"-Dmmc.mm.model.path={out('model')}/part-r-00000"],
             paths["events"], out("pred"), SEQ_SCALE_EVENTS),
            ("hmm model", "hiddenMarkovModelBuilder", buy, [],
             paths["tagged"], out("hmm"), SEQ_SCALE_TAGGED),
            ("hmm viterbi", "viterbiStatePredictor", buy,
             [f"-Dvsp.hmm.model.path={out('hmm')}/part-r-00000"],
             paths["plain"], out("decoded"), SEQ_SCALE_PLAIN)]
    for k in range(1, SEQ_SCALE_LEVELS + 1):
        keys = [f"-Dfia.item.set.length={k}",
                f"-Dfia.total.tans.count={SEQ_SCALE_XACTIONS}",
                f"-Dfia.support.threshold={SEQ_SCALE_SUPPORT}"]
        if k > 1:
            keys.append(f"-Dfia.item.set.file.path="
                        f"{out(f'level_{k - 1}')}/part-r-00000")
        jobs.append((f"apriori level {k}", "frequentItemsApriori", apr, keys,
                     paths["xactions"], out(f"level_{k}"),
                     SEQ_SCALE_XACTIONS))
    jobs.append(("event time", "eventTimeDistribution",
                 os.path.join(RES, "visit.properties"), [], paths["visits"],
                 out("hist"), SEQ_SCALE_VISITS[0] * SEQ_SCALE_VISITS[1]))
    return jobs


def seq_cpu_child(jobs_json):
    """``--seq-cpu-child``: a JSON list of CLI argv (one group of phase
    68's jobs) run in order with -Dplatform=cpu."""
    import contextlib
    import io
    for argv in read_json(jobs_json):
        with contextlib.redirect_stdout(io.StringIO()):
            run_cli(argv + ["-Dplatform=cpu"])


def seq_scale_phase(dev):
    """Phase 68: each job once in a child on the CPU and once on the card
    (the registered job function with a LayerProfile: the wall of each
    layer); every output byte-equal.  The CPU children run first, each
    started as soon as its inputs are drawn, and are waited for before the
    card's runs, which are timed with no other process beside them."""
    import torch
    from avenir_tpu_torch.cli import jobs as J
    from avenir_tpu_torch.core.config import load_config
    from avenir_tpu_torch.utils.tracing import LayerProfile
    users, per = SEQ_SCALE_VISITS
    phase(f"68 sequence at scale: markov model + classifier over "
          f"{SEQ_SCALE_EVENTS:,} sequences, Viterbi over "
          f"{SEQ_SCALE_PLAIN:,} (model of {SEQ_SCALE_TAGGED:,}), Apriori "
          f"levels 1-{SEQ_SCALE_LEVELS} over {SEQ_SCALE_XACTIONS:,} "
          f"transactions, event time over {users * per:,} events; card == "
          f"-Dplatform=cpu")
    work = os.path.join(WORK, "seq_scale")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    paths = {k: os.path.join(work, f"{k}.csv") for k in SEQ_SCALE_INPUTS}
    # the CPU reference: one child a group of dependent jobs (the names'
    # first word), started once the group's inputs are written
    cpu_work = os.path.join(work, "cpu")
    groups = {}
    for name, job, conf, keys, inp, out, _ in seq_scale_jobs(paths,
                                                             cpu_work):
        argvs, inputs = groups.setdefault(name.split(" ")[0], ([], set()))
        argvs.append([job, f"-Dconf.path={conf}", *keys, inp, out])
        inputs.add(inp)
    written, kids = set(), []

    def drawn(path):
        written.add(path)
        for g, (argvs, inputs) in list(groups.items()):
            if inputs <= written:
                del groups[g]
                spec = os.path.join(work, f"cpu_{g}.json")
                with open(spec, "w") as fh:
                    json.dump(argvs, fh)
                kids.append(Children([(
                    [sys.executable, os.path.abspath(__file__),
                     "--seq-cpu-child", spec],
                    lane_env({"CUDA_VISIBLE_DEVICES": "",
                              "OMP_NUM_THREADS": "1"}, False))],
                    timeout=600))
    t0 = time.perf_counter()
    seq_scale_inputs(work, drawn)
    gen_s = time.perf_counter() - t0
    if groups:
        fail(f"phase 68: no inputs drawn for {sorted(groups)}")
    all_ok([r for k in kids for r in k.wait()], "phase 68 CPU children")
    cpu_s = time.perf_counter() - t0
    card_work = os.path.join(work, "card")
    runs = {}
    zero_launches()
    for name, job, conf, keys, inp, out, units in seq_scale_jobs(
            paths, card_work):
        cfg = load_config(conf)
        cfg.update(dict(k[2:].split("=", 1) for k in keys))
        prof = LayerProfile(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J.resolve(job)(cfg, inp, out, profile=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = {"wall_s": round(wall, 3),
                      "per_s": round(units / wall, 1),
                      "layers_s": {k: round(v, 4)
                                   for k, v in prof.setup.items()}}
        print(f"{name}: {units:,} in {wall:.3f} s = {units / wall:,.0f}"
              f"/s; layers (s) {json.dumps(runs[name]['layers_s'])}",
              flush=True)
    counts = launch_counts()
    if any(counts.values()):
        fail(f"phase 68: the sequence jobs launched a kernel: {counts}")
    for _, _, _, _, _, out, _ in seq_scale_jobs(paths, card_work):
        for part in sorted(os.listdir(out)):
            if part.startswith("part-"):
                cpu = os.path.join(cpu_work, os.path.basename(out), part)
                with open(os.path.join(out, part), "rb") as a, \
                        open(cpu, "rb") as b:
                    if a.read() != b.read():
                        fail(f"phase 68: {os.path.basename(out)}/{part} "
                             f"on the card differs from -Dplatform=cpu")
    levels = [sum(1 for _ in open(os.path.join(card_work, f"level_{k}",
                                               "part-r-00000")))
              for k in range(1, SEQ_SCALE_LEVELS + 1)]
    print(f"every output byte-equal to the CPU children's (run before the "
          f"card's, alone); frequent itemsets a level {levels}; inputs "
          f"drawn in {gen_s:.1f} s, the CPU children done {cpu_s:.1f} s "
          f"after the draw began; kernel launches {counts}", flush=True)
    return {"runs": runs, "gen_s": round(gen_s, 2),
            "cpu_children_s": round(cpu_s, 2), "levels": levels,
            "launches": counts}


# --------------------------------------------------------------------------
# phases 69-70: the long tail (cluster, explore, partition, discriminant)
# --------------------------------------------------------------------------

TAIL9 = os.path.join(ROOT, "tests", "torch_fixtures", "tail9")
# phase 70: cust_seg customers (3 cluster groups, at most TAIL_KM_ITERS
# Lloyd iterations), hosp_readmit rows, churn_svm groups x rows a group,
# machine_failure rows for SMOTE's minority rows (the generator's ~8%).
# The SVM's rows a group and SMOTE's rows are cut to half (from 2,000
# and 20,000 of 250,000): their CPU children set the phase's wall
TAIL_KM_ROWS = 1_000_000
TAIL_KM_ITERS = 60
TAIL_HOSP_ROWS = 1_000_000
TAIL_SVM = (100, 1_000)
TAIL_SVM_C = "0.001"
# svm.properties as published (C = 1.0, where the lock-step solver does not
# converge on churn_svm's features): groups x rows a group, cut so that its
# run to the cap of 200 sweeps x rows a group fits the phase
TAIL_SVM_PUBLISHED = (100, 100)
TAIL_SMOTE_MINORITY = 10_000
TAIL_SMOTE_ROWS = 125_000
TAIL_GROUPS = ("kmeans", "hosp", "svm", "svm1", "smote")


def golden_tail_flows(work, plat=()):
    """tests/golden/flows.py's carm, hica, mi, svm and disease flows
    through the port's CLI, with the same generator calls and keys.
    Returns ({golden file: output path}, {job: wall s})."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    outs, walls = {}, {}

    def run(name, args):
        t0 = time.perf_counter()
        run_cli([*args, *plat])
        walls[name] = round(time.perf_counter() - t0, 3)

    def data(flow, gen, n, seed, name):
        d = os.path.join(work, flow)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        write_lines(path, gen_module(gen).generate(n, seed))
        return d, path

    d, calls = data("carm", "cust_call_gen", 500, 31, "calls.csv")
    conf = f"-Dconf.path={os.path.join(RES, 'carm.properties')}"
    schema = os.path.join(RES, "cust_call.json")
    run("carm mi", ["mutualInformation", conf,
                    f"-Dmut.feature.schema.file.path={schema}", calls,
                    f"{d}/mi"])
    run("carm affinity", ["categoricalClassAffinity", conf,
                          f"-Dcca.feature.schema.file.path={schema}", calls,
                          f"{d}/aff"])
    outs["carm/mi.csv"] = f"{d}/mi/part-r-00000"
    outs["carm/affinity.csv"] = f"{d}/aff/part-r-00000"
    d, deliv = data("hica", "delivery_gen", 800, 32, "deliveries.csv")
    for mode, extra in (("enc", []),
                        ("woe", ["-Dcoe.encoding.strategy=weightOfEvidence"])):
        run(f"hica {mode}", [
            "categoricalContinuousEncoding",
            f"-Dconf.path={os.path.join(RES, 'hica.properties')}",
            f"-Dcoe.feature.schema.file.path="
            f"{os.path.join(RES, 'delivery.json')}", *extra, deliv,
            f"{d}/{mode}"])
        outs[f"hica/{mode}.csv"] = f"{d}/{mode}/part-r-00000"
    d, calls = data("mi", "call_hangup_gen", 500, 23, "calls.csv")
    run("mi", ["mutualInformation",
               f"-Dconf.path={os.path.join(RES, 'mutual_info.properties')}",
               f"-Dmut.feature.schema.file.path="
               f"{os.path.join(RES, 'call_hangup.json')}", calls,
               f"{d}/out"])
    outs["mi/scores.csv"] = f"{d}/out/part-r-00000"
    d, churn = data("svm", "churn_svm_gen", 300, 33, "churn.csv")
    conf = f"-Dconf.path={os.path.join(RES, 'svm.properties')}"
    schema = f"-Dsvm.feature.schema.file.path=" \
        f"{os.path.join(RES, 'churn_svm.json')}"
    run("svm model", ["supportVectorMachine", conf, schema, churn,
                      f"{d}/model"])
    run("svm pred", ["supportVectorPredictor", conf, schema,
                     f"-Dsvm.model.file.path={d}/model/part-r-00000", churn,
                     f"{d}/pred"])
    outs["svm/model.csv"] = f"{d}/model/part-r-00000"
    outs["svm/pred.csv"] = f"{d}/pred/part-m-00000"
    d, pat = data("disease", "patient_gen", 600, 36, "patients.csv")
    conf = f"-Dconf.path={os.path.join(RES, 'disease.properties')}"
    schema = f"-Dcpg.feature.schema.file.path=" \
        f"{os.path.join(RES, 'patient.json')}"
    run("disease root", ["classPartitionGenerator", conf, schema, pat,
                         f"{d}/root"])
    root_info = open(f"{d}/root/part-r-00000").read().strip()
    run("disease splits", ["classPartitionGenerator", conf, schema,
                           "-Dcpg.split.attributes=1,2,3,4,5",
                           f"-Dcpg.parent.info={root_info}", pat,
                           f"{d}/splits"])
    run("disease rules", ["ruleEvaluator", conf, "-Drue.data.size=600", pat,
                          f"{d}/rules"])
    outs["disease/splits.csv"] = f"{d}/splits/part-r-00000"
    outs["disease/rules.csv"] = f"{d}/rules/part-r-00000"
    return outs, walls


def tail_fixture_phase():
    """Phase 69: the golden carm, disease, hica, mi and svm flows and
    every tail9 case through the port's CLI on the card: byte for byte,
    save the cases tail9/make.py holds to a tolerance (``compare``), whose
    differing lines are counted; the batched SVM's card model predicts the
    fixture's predictions; no kernel launched."""
    import contextlib
    import io
    from avenir_tpu_torch.cli import run as cli_run
    phase("69 long tail on the card: golden carm, disease, hica, mi and "
          "svm flows and every tail9 case through the port's CLI")
    zero_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        outs, walls = golden_tail_flows(os.path.join(WORK, "tail_golden"))
    for rel, path in outs.items():
        same_bytes(path, os.path.join(GOLDEN, rel), f"golden {rel}")
    mk = fixture_module("tail9")
    work = os.path.join(WORK, "tail9")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    apart = {}
    for case in mk.CASES:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            text, counters = mk.run_case(cli_run.main, TAIL9, work, case)
        walls[f"tail9 {case}"] = round(time.perf_counter() - t0, 3)
        with open(os.path.join(TAIL9, case, "out.csv")) as fh:
            want = fh.read()
        try:
            n = mk.compare(case, text, want)
        except AssertionError as exc:
            fail(f"tail9 {case}: the card's output is off the fixture: "
                 f"{exc}")
        if case in mk.TOLERANCE:
            apart[case] = n
        want_c = read_json(os.path.join(TAIL9, case, "counters.json"))
        if not case.startswith("svm_") or case not in mk.TOLERANCE:
            if counters != want_c:
                fail(f"tail9 {case}: counters {counters} differ from the "
                     f"fixture's {want_c}")
    # the card-trained batched model predicts what the JAX model predicts
    _, argv = mk.case_args("svm_batched_pred", TAIL9,
                           os.path.join(work, "card_model"))
    argv = [a if not a.startswith("-Dsvm.model.file.path=") else
            f"-Dsvm.model.file.path={work}/svm_batched/part-r-00000"
            for a in argv]
    with contextlib.redirect_stdout(io.StringIO()):
        run_cli(argv)
    same_bytes(os.path.join(work, "card_model", "svm_batched_pred",
                            "part-m-00000"),
               os.path.join(TAIL9, "svm_batched_pred", "out.csv"),
               "tail9 svm_batched_pred over the card's batched model")
    counts = launch_counts()
    if any(counts.values()):
        fail(f"phase 69: the long-tail jobs launched a kernel: {counts}")
    print(f"tail9: all {len(mk.CASES)} cases held (byte-equal but "
          f"{sorted(mk.TOLERANCE)}); lines apart in those: "
          f"{json.dumps(apart)}; kernel launches {counts}", flush=True)
    print(f"job walls (s): {json.dumps(walls)}", flush=True)
    return {"walls": walls, "tail9_cases": len(mk.CASES),
            "lines_apart": apart, "launches": counts}


def _clipped_int(rng, mean, sd, lo, hi, n):
    """``int(np.clip(rng.normal(mean, sd), lo, hi))``, n draws."""
    return np.clip(rng.normal(mean, sd, n), lo, hi).astype(np.int64)


def tail_scale_input(work, group):
    """Phase 70's input of one group, drawn vectorised from its
    generator's own model (seeds 81-84) and written under ``work``;
    returns the paths the group's jobs read."""
    paths = {}
    if group == "kmeans":
        cs = gen_module("cust_seg_gen")
        rng = np.random.default_rng(81)
        n = TAIL_KM_ROWS
        seg = rng.integers(len(cs.SEGMENTS), size=n)
        means = np.asarray(cs.SEGMENTS, np.float64)[seg]
        lo, hi = np.asarray(cs.CLIP, np.float64).T
        vals = np.clip(rng.normal(means, cs.SPREAD), lo, hi).astype(np.int64)
        lines = [f"U{i:07d}," + ",".join(map(str, v))
                 for i, v in enumerate(vals.tolist())]
        paths["data"] = os.path.join(work, "customers.csv")
        write_lines(paths["data"], lines)
        seeds = []
        for group_name, k in (("custSeg3", 3), ("custSeg4", 4),
                              ("custSeg5", 5)):
            step = n // k
            for j in range(k):
                parts = lines[j * step + k].split(",")
                seeds.append(",".join([group_name, "null"] + parts[1:]
                                      + ["inf", "active"]))
        paths["clusters"] = os.path.join(work, "clusters.csv")
        write_lines(paths["clusters"], seeds)
    elif group == "hosp":
        hr = gen_module("hosp_readmit_gen")
        rng = np.random.default_rng(82)
        n = TAIL_HOSP_ROWS
        age = _clipped_int(rng, 62, 18, 18, 95, n)
        los = np.clip(rng.gamma(2.0, 3.0, n), 1, 30).astype(np.int64)
        diag = rng.choice(5, n, p=[0.25, 0.2, 0.15, 0.15, 0.25])
        prior = np.clip(rng.poisson(1.0, n), 0, 9)
        disch = rng.choice(3, n, p=[0.6, 0.25, 0.15])
        risk = np.asarray([hr.DIAG_RISK[d] for d in hr.DIAGNOSES])
        p = risk[diag] + 0.08 * prior + 0.002 * (age - 60)
        readmit = rng.random(n) < np.clip(p, 0.02, 0.9)
        age = age.tolist()
        lines = [f"A{i:07d},{a},{s},{hr.DIAGNOSES[d]},{pr},"
                 f"{hr.DISCHARGE[ds]},{'T' if r else 'F'}"
                 for i, (a, s, d, pr, ds, r) in enumerate(zip(
                     age, los.tolist(), diag.tolist(), prior.tolist(),
                     disch.tolist(), readmit.tolist()))]
        paths["data"] = os.path.join(work, "admissions.csv")
        write_lines(paths["data"], lines)
    elif group in ("svm", "svm1"):
        cg = gen_module("churn_svm_gen")
        rng = np.random.default_rng(83 if group == "svm" else 85)
        G, m = TAIL_SVM if group == "svm" else TAIL_SVM_PUBLISHED
        n = G * m
        minutes = _clipped_int(rng, 90, 40, 0, 199, n)
        data_gb = _clipped_int(rng, 40, 20, 0, 99, n)
        calls = np.clip(rng.poisson(2.0, n), 0, 9)
        score = 1.2 * calls - 0.03 * minutes - 0.05 * data_gb + 1.5 + \
            rng.normal(0, 1.0, n)
        plan = rng.integers(len(cg.PLANS), size=n)
        pay = rng.integers(len(cg.PAYMENTS), size=n)
        lines = [f"C{i:07d},{cg.PLANS[pl]},{mi},{dg},{ca},{cg.PAYMENTS[py]},"
                 f"{'churned' if s > 0 else 'active'},R{i // m:03d}"
                 for i, (pl, mi, dg, ca, py, s) in enumerate(zip(
                     plan.tolist(), minutes.tolist(), data_gb.tolist(),
                     calls.tolist(), pay.tolist(), score.tolist()))]
        paths["data"] = os.path.join(work, f"churn_{group}.csv")
        write_lines(paths["data"], lines)
        schema = read_json(os.path.join(RES, "churn_svm.json"))
        schema["fields"].append({"name": "region", "ordinal": 7,
                                 "dataType": "string"})
        paths["schema"] = os.path.join(work, f"churn_region_{group}.json")
        with open(paths["schema"], "w") as fh:
            json.dump(schema, fh)
    else:
        rng = np.random.default_rng(84)
        n = TAIL_SMOTE_ROWS
        fail_ = np.zeros(n, bool)
        fail_[rng.choice(n, TAIL_SMOTE_MINORITY, replace=False)] = True
        temp = np.where(fail_, _clipped_int(rng, 95, 12, 20, 120, n),
                        _clipped_int(rng, 60, 15, 20, 120, n))
        vib = np.where(fail_, _clipped_int(rng, 70, 15, 0, 100, n),
                       _clipped_int(rng, 30, 15, 0, 100, n))
        age = np.where(fail_, _clipped_int(rng, 16, 5, 0, 25, n),
                       _clipped_int(rng, 7, 5, 0, 25, n))
        pres = _clipped_int(rng, 150, 35, 50, 250, n)
        hours = np.clip(rng.gamma(2.0, 3000.0, n), 0, 20000).astype(np.int64)
        lines = [f"M{i:06d},{t},{v},{p},{h},{a},{'T' if f else 'F'}"
                 for i, (t, v, p, h, a, f) in enumerate(zip(
                     temp.tolist(), vib.tolist(), pres.tolist(),
                     hours.tolist(), age.tolist(), fail_.tolist()))]
        paths["data"] = os.path.join(work, "machines.csv")
        write_lines(paths["data"], lines)
    return paths


def tail_scale_jobs(group, paths, out_dir):
    """Phase 70's jobs of one group as (name, job, keys, input, output,
    units)."""
    res = lambda name: os.path.join(RES, name)   # noqa: E731
    out = lambda name: os.path.join(out_dir, name)   # noqa: E731
    if group == "kmeans":
        return [("kmeans", "kmeansCluster",
                 [f"-Dconf.path={res('cluster.properties')}",
                  f"-Dkmc.schema.file.path={res('cust_seg.json')}",
                  f"-Dkmc.cluster.file.path={paths['clusters']}",
                  f"-Dkmc.num.iterations={TAIL_KM_ITERS}"],
                 paths["data"], out("kmeans"), TAIL_KM_ROWS)]
    if group == "hosp":
        schema = res("hosp_readmit.json")
        return [("mutual info", "mutualInformation",
                 [f"-Dmut.feature.schema.file.path={schema}",
                  "-Dmut.mutual.info.score.algorithms="
                  "mutual.info.maximization,joint.mutual.info,"
                  "min.redundancy.max.relevance"],
                 paths["data"], out("mi"), TAIL_HOSP_ROWS),
                ("numerical correlation", "numericalCorrelation",
                 [f"-Dnuc.schema.file.path={schema}"],
                 paths["data"], out("numcorr"), TAIL_HOSP_ROWS)]
    if group == "svm":
        return [("svm batched", "supportVectorMachine",
                 [f"-Dsvm.feature.schema.file.path={paths['schema']}",
                  "-Dsvm.positive.class.value=churned",
                  f"-Dsvm.pnalty.factor={TAIL_SVM_C}",
                  "-Dsvm.solver=batched", "-Dsvm.group.field.ordinals=7"],
                 paths["data"], out("svm"), TAIL_SVM[0] * TAIL_SVM[1])]
    if group == "svm1":
        return [("svm batched C=1", "supportVectorMachine",
                 [f"-Dconf.path={res('svm.properties')}",
                  f"-Dsvm.feature.schema.file.path={paths['schema']}",
                  "-Dsvm.solver=batched", "-Dsvm.group.field.ordinals=7"],
                 paths["data"], out("svm1"),
                 TAIL_SVM_PUBLISHED[0] * TAIL_SVM_PUBLISHED[1])]
    return [("smote", "classBasedOverSampler",
             [f"-Dconf.path={res('ovsa.properties')}",
              f"-Dcbos.feature.schema.file.path={res('machine_failure.json')}"],
             paths["data"], out("smote"), TAIL_SMOTE_MINORITY)]


def tail_cpu_child(group, work):
    """``--tail-cpu-child``: draw one group's phase-70 input, then run its
    jobs with -Dplatform=cpu into ``<work>/cpu``; writes
    ``<work>/<group>.json`` with the paths and the walls."""
    import contextlib
    import io
    t0 = time.perf_counter()
    paths = tail_scale_input(work, group)
    gen_s = time.perf_counter() - t0
    walls = {}
    for name, job, keys, inp, out, _ in tail_scale_jobs(
            group, paths, os.path.join(work, "cpu")):
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_cli([job, *keys, inp, out, "-Dplatform=cpu"])
        walls[name] = round(time.perf_counter() - t1, 3)
    with open(os.path.join(work, f"{group}.json"), "w") as fh:
        json.dump({"paths": paths, "gen_s": round(gen_s, 2),
                   "cpu_walls_s": walls}, fh)


def start_tail_cpu_children():
    """Phase 70's CPU children, started before phase 63 so that they draw
    their inputs and run on the CPU while phases 63-69 use the card:
    one process a group, each with its own threads."""
    work = os.path.join(WORK, "tail_scale")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    threads = {"kmeans": "1", "hosp": "1", "svm": "2", "svm1": "2",
               "smote": "2"}
    return work, Children([(
        [sys.executable, os.path.abspath(__file__), "--tail-cpu-child", g,
         work],
        lane_env({"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": threads[g]},
                 False)) for g in TAIL_GROUPS], timeout=900)


def tail_scale_phase(dev, work, kids):
    """Phase 70: each job once on the card with a LayerProfile (parse,
    encode, h2d, device, readback, finalize, write), after its CPU child
    (started before phase 63) has finished; every output byte-equal to
    the CPU's; rates printed by layer; no kernel launched."""
    import torch
    from avenir_tpu_torch.cli import jobs as J
    from avenir_tpu_torch.core.config import Config, load_config
    from avenir_tpu_torch.utils.tracing import LayerProfile
    G, m = TAIL_SVM
    phase(f"70 long tail at scale: kmeansCluster over {TAIL_KM_ROWS:,} "
          f"customers (3 groups, <= {TAIL_KM_ITERS} iterations), "
          f"mutualInformation + numericalCorrelation over "
          f"{TAIL_HOSP_ROWS:,} admissions, the batched SVM over {G} groups "
          f"x {m:,} rows at C={TAIL_SVM_C} and over "
          f"{TAIL_SVM_PUBLISHED[0]} x {TAIL_SVM_PUBLISHED[1]:,} at "
          f"svm.properties' C, SMOTE over {TAIL_SMOTE_MINORITY:,} minority rows "
          f"(a {TAIL_SMOTE_MINORITY:,}^2 pairwise); card == -Dplatform=cpu")
    t0 = time.perf_counter()
    all_ok(kids.wait(), "phase 70 CPU children")
    waited_s = time.perf_counter() - t0
    info = {g: read_json(os.path.join(work, f"{g}.json"))
            for g in TAIL_GROUPS}
    card_dir = os.path.join(work, "card")
    runs = {}
    # the batched SVM's lock-step steps and their cap, read off the solver
    from avenir_tpu_torch.discriminant import smo as S
    solver_run, steps = S._BatchedSMO.run, []

    def counted_run(self, *args):
        out = solver_run(self, *args)
        steps.append((int(out[3]), self.max_iter))
        return out
    S._BatchedSMO.run = counted_run
    zero_launches()
    for g in TAIL_GROUPS:
        for name, job, keys, inp, out, units in tail_scale_jobs(
                g, info[g]["paths"], card_dir):
            conf = [k for k in keys if k.startswith("-Dconf.path=")]
            cfg = load_config(conf[0].split("=", 1)[1]) if conf else Config()
            cfg.update(dict(k[2:].split("=", 1) for k in keys
                            if not k.startswith("-Dconf.path=")))
            prof = LayerProfile(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counters = J.resolve(job)(cfg, inp, out, profile=prof)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            runs[name] = {"wall_s": round(wall, 3),
                          "per_s": round(units / wall, 1),
                          "layers_s": {k: round(v, 4)
                                       for k, v in prof.setup.items()},
                          "cpu_wall_s": info[g]["cpu_walls_s"][name]}
            if job == "kmeansCluster":
                runs[name]["iterations"] = counters.get("Clustering",
                                                        "iterations")
            if job == "supportVectorMachine":
                runs[name]["steps"], runs[name]["cap"] = steps.pop()
            print(f"{name}: {units:,} in {wall:.3f} s = {units / wall:,.0f}"
                  f"/s (CPU child {info[g]['cpu_walls_s'][name]} s); "
                  f"layers (s) {json.dumps(runs[name]['layers_s'])}",
                  flush=True)
    S._BatchedSMO.run = solver_run
    counts = launch_counts()
    if any(counts.values()):
        fail(f"phase 70: the long-tail jobs launched a kernel: {counts}")
    for g in TAIL_GROUPS:
        for _, _, _, _, out, _ in tail_scale_jobs(g, info[g]["paths"],
                                                  card_dir):
            for part in sorted(os.listdir(out)):
                if part.startswith("part-"):
                    cpu = os.path.join(work, "cpu", os.path.basename(out),
                                       part)
                    with open(os.path.join(out, part), "rb") as a, \
                            open(cpu, "rb") as b:
                        if a.read() != b.read():
                            fail(f"phase 70: {os.path.basename(out)}/"
                                 f"{part} on the card differs from "
                                 f"-Dplatform=cpu")
    print(f"every output byte-equal to the CPU children's; k-means "
          f"iterations {runs['kmeans']['iterations']}; batched SVM steps "
          f"(of the cap) C={TAIL_SVM_C} "
          f"{runs['svm batched']['steps']} ({runs['svm batched']['cap']}), "
          f"C=1 {runs['svm batched C=1']['steps']} "
          f"({runs['svm batched C=1']['cap']}); inputs drawn in "
          f"{json.dumps({g: info[g]['gen_s'] for g in TAIL_GROUPS})} s; "
          f"waited {waited_s:.1f} s for the CPU children; kernel launches "
          f"{counts}", flush=True)
    return {"runs": runs, "waited_s": round(waited_s, 2),
            "gen_s": {g: info[g]["gen_s"] for g in TAIL_GROUPS},
            "launches": counts}


# --------------------------------------------------------------------------
# phase 71: the device profile capture (profile.trace.dir)
# --------------------------------------------------------------------------

# the device-side event categories of a torch.profiler Chrome trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels whose trace events must match their wrappers' counts
TRACED_KERNELS = {"b1_mma": "level_counts_mma_kernel", "b2": "vote_kernel"}


def load_trace(tdir, what):
    """The one Chrome trace a traced job wrote under ``tdir``, loaded."""
    files = sorted(f for f in os.listdir(tdir)
                   if f.endswith(".pt.trace.json")) \
        if os.path.isdir(tdir) else []
    if len(files) != 1:
        fail(f"{what}: {len(files)} trace files under {tdir}, want 1")
    with open(os.path.join(tdir, files[0])) as fh:
        trace = json.load(fh)
    if not isinstance(trace.get("traceEvents"), list):
        fail(f"{what}: {files[0]} has no traceEvents")
    return trace, os.path.getsize(os.path.join(tdir, files[0]))


def device_events(trace):
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_share(events, wall_ms):
    """The card's busy time over ``wall_ms``: the union of the device
    events' intervals (kernels, memcpys, memsets), so overlapping streams
    count once."""
    busy = 0.0
    end = None
    for ts, dur in sorted((float(e["ts"]), float(e.get("dur", 0)))
                          for e in events):
        if end is None or ts > end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    return {"busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "busy_share": busy / 1e3 / wall_ms if wall_ms else 0.0}


def kernel_name(name):
    """A demangled kernel name without its return type, namespaces'
    ``(anonymous namespace)``, template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, maxsplit=1)[0]


def top_kernels(events, k=5):
    """The ``k`` device kernels with the most total time: (short name, ms,
    launches)."""
    tot = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = kernel_name(e["name"])
            ms, n = tot.get(name, (0.0, 0))
            tot[name] = (ms + float(e.get("dur", 0)) / 1e3, n + 1)
    return [(name, round(ms, 4), n) for name, (ms, n) in
            sorted(tot.items(), key=lambda kv: -kv[1][0])[:k]]


def busy_shares(events, wall_ms, untraced_ms):
    """:func:`busy_share` over the traced job step, and the same device
    time over the job steps of untraced runs of the job (the capture's
    host-side recording lengthens the traced step)."""
    got = busy_share(events, wall_ms)
    got["untraced_wall_ms"] = list(untraced_ms)
    got["untraced_busy_share"] = [got["busy_ms"] / ms if ms else 0.0
                                  for ms in untraced_ms]
    return got


def busy_line(r):
    untraced = ", ".join(f"{100 * s:.2f}% of {ms}"
                         for s, ms in zip(r["untraced_busy_share"],
                                          r["untraced_wall_ms"]))
    return (f"card busy {r['busy_ms']:.3f} ms: {100 * r['busy_share']:.2f}% "
            f"of the traced job step's {r['wall_ms']} ms, {untraced} ms "
            f"untraced")


def untraced_job(args, out):
    """One CLI job run without the capture; its job step's wall (ms)."""
    run_cli(args + [out])
    with open(out + ".counters.json") as fh:
        return json.load(fh)["Profiling"]["job.timeMs"]


def traced_job(args, out, tdir, what):
    """One CLI job run with ``-Dprofile.trace.dir``, launch counts zeroed
    before and read after; returns the counts, the trace's device events,
    the job step's wall (ms), the trace file's bytes and the whole call's
    wall (s: the profiler's start, stop and export included)."""
    shutil.rmtree(tdir, ignore_errors=True)
    zero_launches()
    t0 = time.perf_counter()
    run_cli(args[:1] + [f"-Dprofile.trace.dir={tdir}"] + args[1:] + [out])
    call_s = time.perf_counter() - t0
    counts = launch_counts()
    trace, nbytes = load_trace(tdir, what)
    with open(out + ".counters.json") as fh:
        wall_ms = json.load(fh)["Profiling"]["job.timeMs"]
    return counts, device_events(trace), wall_ms, nbytes, call_s


def profile_phase(scale_csv):
    """Phase 71: rafo9's randomForestBuilder and modelPredictor through
    cli.run with ``-Dprofile.trace.dir`` (outputs byte-equal to untraced
    runs; one trace a job; B1's and B2's kernel events in the numbers their
    wrappers counted), then phase 30's CSV trained monolithic under the
    capture, between two untraced runs: the card's busy share of the
    traced and the untraced job steps, and its top kernels."""
    phase("71 profile capture: rafo9 randomForestBuilder and modelPredictor "
          f"traced, then the {STREAM_SCALE_ROWS:,}-row monolithic train")
    props = os.path.join(RES, "rafo.properties")
    schema = os.path.join(RES, "call_hangup.json")
    jobs = {
        "train": ["org.avenir.tree.RandomForestBuilder",
                  f"-Dconf.path={props}",
                  f"-Ddtb.feature.schema.file.path={schema}",
                  os.path.join(WORK, "rafo9_train.csv")],
        "predict": ["org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
                    f"-Dmop.model.dir.path={RAFO9}",
                    f"-Dmop.feature.schema.file.path={schema}",
                    os.path.join(RAFO9, "requests.csv")]}
    want_kernel = {"train": "b1_mma", "predict": "b2"}
    out = {}
    first = None
    for name, args in jobs.items():
        plain = os.path.join(WORK, f"prof_{name}_plain")
        t0 = time.perf_counter()
        plain_ms = untraced_job(args, plain)
        plain_s = time.perf_counter() - t0
        got = os.path.join(WORK, f"prof_{name}")
        first = first or time.perf_counter()
        counts, events, wall_ms, nbytes, call_s = traced_job(
            args, got, os.path.join(WORK, f"prof_{name}_trace"),
            f"traced rafo9 {name}")
        same_files(got, plain, f"traced rafo9 {name}")
        traced = {key: sum(1 for e in events if e.get("cat") == "kernel"
                           and kern in e["name"])
                  for key, kern in TRACED_KERNELS.items()}
        wrapped = {"b1_mma": counts["b1_mma"],
                   "b2": counts["b2"] + counts["b3"]}
        if counts["b1"] != counts["b1_mma"]:
            fail(f"traced rafo9 {name}: {counts['b1'] - counts['b1_mma']} "
                 f"B1 launches took the atomic form")
        if traced != wrapped:
            fail(f"traced rafo9 {name}: kernel events {traced} in the trace, "
                 f"the wrappers counted {wrapped}")
        if not traced[want_kernel[name]]:
            fail(f"traced rafo9 {name}: no {TRACED_KERNELS[want_kernel[name]]}"
                 f" event in the trace")
        out[name] = {"launches": counts, "trace_kernels": traced,
                     "trace_bytes": nbytes,
                     **busy_shares(events, wall_ms, [plain_ms]),
                     "top_kernels": top_kernels(events),
                     "call_s": call_s, "untraced_call_s": plain_s}
        print(f"traced rafo9 {name}: outputs byte-equal to the untraced "
              f"run; one trace ({nbytes:,} bytes); kernel events {traced} "
              f"== wrapper counts; {busy_line(out[name])}; the call "
              f"{call_s:.3f} s traced, {plain_s:.3f} s untraced", flush=True)
    # the scale train untraced before and after the traced run: the
    # capture records every host op, so its job step is longer
    scale_args = ["org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
                  f"-Ddtb.feature.schema.file.path={schema}", scale_csv]
    plain = os.path.join(WORK, "prof_scale_plain")
    plain_ms = [untraced_job(scale_args, plain)]
    # a capture that starts minutes after the process's first loses the
    # device events of its first ~20 ms (--trace-probe); this phase's
    # captures all start within seconds of the first
    since_first_s = time.perf_counter() - first
    counts, events, wall_ms, nbytes, call_s = traced_job(
        scale_args, os.path.join(WORK, "prof_scale"),
        os.path.join(WORK, "prof_scale_trace"), "traced scale train")
    same_files(os.path.join(WORK, "prof_scale"), plain, "traced scale train")
    plain_ms.append(untraced_job(scale_args, plain + "2"))
    traced = sum(1 for e in events if e.get("cat") == "kernel"
                 and TRACED_KERNELS["b1_mma"] in e["name"])
    if counts["b1"] <= 0 or traced != counts["b1_mma"] \
            or counts["b1_mma"] != counts["b1"]:
        fail(f"traced scale train: {traced} B1 kernel events, the wrapper "
             f"counted {counts['b1']} ({counts['b1_mma']} mma)")
    out["scale"] = {"launches": counts, "trace_kernels": {"b1_mma": traced},
                    "trace_bytes": nbytes,
                    **busy_shares(events, wall_ms, plain_ms),
                    "top_kernels": top_kernels(events), "call_s": call_s,
                    "since_first_capture_s": since_first_s}
    print(f"{STREAM_SCALE_ROWS:,}-row monolithic randomForestBuilder: "
          f"outputs byte-equal to the untraced runs; "
          f"{busy_line(out['scale'])}; the traced call {call_s:.3f} s, "
          f"started {since_first_s:.1f} s after the phase's first; top "
          f"kernels (name, ms, launches): {out['scale']['top_kernels']}",
          flush=True)
    return out


# --------------------------------------------------------------------------
# --trace-probe: does the capture keep every kernel launch, by process age?
# --------------------------------------------------------------------------

# (seconds of CUDA work before the process's next capture, whether a
# capture was started and stopped first): a phase-71-like first start at
# several process ages, and a start after an early warm-up capture
TRACE_PROBE_CASES = ((20, False), (200, False), (400, False), (600, False),
                     (35, True), (215, True), (415, True), (615, True))
TRACE_PROBE_CAPTURES = 6


def trace_probe_child(age_s, warm, out_dir):
    """One probe process: rafo9's train untraced until ``age_s`` seconds
    after its first CUDA work (with ``warm``, one traced train first), then
    TRACE_PROBE_CAPTURES traced jobs, train and predict in turn.  Prints
    one JSON line a capture: the process age, the profiler start's
    seconds, the wrappers' and the trace's B1 / B2 counts, and the host
    time of each B1 launch, each traced B1 kernel's start and the capture's
    stop, in microseconds after the profiler's start returned (the trace's
    times through its ``baseTimeNanoseconds``), and the start of the
    trace's own window."""
    import torch
    import torch.profiler as tp
    from avenir_tpu_torch.kernels import histogram
    age_s, warm = float(age_s), warm == "1"
    marks = {}
    start, stop = tp.profile.start, tp.profile.stop

    def timed_start(self):
        t0 = time.perf_counter()
        start(self)
        marks["start_s"] = time.perf_counter() - t0
        marks["start_ns"] = time.time_ns()

    def timed_stop(self):
        marks["stop_ns"] = time.time_ns()
        stop(self)
    tp.profile.start, tp.profile.stop = timed_start, timed_stop
    launch_ns = []
    mma_lib = histogram._mma_lib

    def timed_lib():
        fn = mma_lib()

        def call(*args):
            launch_ns.append(time.time_ns())
            return fn(*args)
        return call
    histogram._mma_lib = timed_lib
    props = os.path.join(RES, "rafo.properties")
    schema = os.path.join(RES, "call_hangup.json")
    jobs = {"train": ["org.avenir.tree.RandomForestBuilder",
                      f"-Dconf.path={props}",
                      f"-Ddtb.feature.schema.file.path={schema}",
                      os.path.join(os.path.dirname(out_dir),
                                   "rafo9_train.csv")],
            "predict": ["org.avenir.model.ModelPredictor",
                        f"-Dconf.path={props}",
                        f"-Dmop.model.dir.path={RAFO9}",
                        f"-Dmop.feature.schema.file.path={schema}",
                        os.path.join(RAFO9, "requests.csv")]}
    torch.zeros(1, device="cuda").sum().item()
    born = time.perf_counter()

    def capture(i, name):
        del launch_ns[:]
        marks.clear()
        tdir = os.path.join(out_dir, f"trace_{i}")
        age = time.perf_counter() - born
        counts, events, _, _, _ = traced_job(
            jobs[name], os.path.join(out_dir, f"out_{i}"), tdir,
            f"probe capture {i}")
        trace, _ = load_trace(tdir, f"probe capture {i}")
        base = int(trace.get("baseTimeNanoseconds", 0))

        def rel_us(ns):
            return round((ns - marks["start_ns"]) / 1e3, 1)
        kern = sorted(float(e["ts"]) for e in events
                      if e.get("cat") == "kernel"
                      and TRACED_KERNELS["b1_mma"] in e["name"])
        print(json.dumps({
            "age_s": round(age, 1), "warm": warm, "capture": i, "job": name,
            "start_s": round(marks["start_s"], 3),
            "b1": counts["b1_mma"], "b1_traced": len(kern),
            "b2": counts["b2"] + counts["b3"],
            "b2_traced": sum(1 for e in events if e.get("cat") == "kernel"
                             and TRACED_KERNELS["b2"] in e["name"]),
            "launch_us": [rel_us(ns) for ns in launch_ns],
            "kernel_us": [rel_us(base + round(ts * 1e3)) for ts in kern],
            "stop_us": rel_us(marks["stop_ns"]),
            "window_us": [rel_us(base + round(float(e["ts"]) * 1e3))
                          for e in trace["traceEvents"]
                          if e.get("cat") == "Trace"
                          and e.get("ph") == "X"][:1]}), flush=True)
    if warm:
        capture(-1, "train")
    while time.perf_counter() - born < age_s:
        run_cli(jobs["train"] + [os.path.join(out_dir, "untraced")])
    for i in range(TRACE_PROBE_CAPTURES):
        capture(i, ("train", "predict")[i % 2])


def trace_probe():
    """``--trace-probe``: builds B1 and B2, then runs one
    :func:`trace_probe_child` a TRACE_PROBE_CASES entry, all at once on
    the first card; prints each capture's line, then a summary of the
    captures whose B1 or B2 events differ from the wrappers' counts, and
    writes every line to ``chiprun_out/trace_probe.jsonl``."""
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from avenir_tpu_torch.kernels import build
    build.build_all(["histogram", "vote"])
    sys.path.insert(0, RES)
    from gen.call_hangup_gen import generate
    work = os.path.join(WORK, "trace_probe")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "rafo9_train.csv"), "w") as fh:
        fh.write("\n".join(generate(5000, 17)))
    kids = []
    for age, warm in TRACE_PROBE_CASES:
        out_dir = os.path.join(work, f"age{age}_{int(warm)}")
        os.makedirs(out_dir)
        with open(out_dir + ".out", "w") as so, \
                open(out_dir + ".err", "w") as se:
            kids.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--trace-probe-child", str(age), str(int(warm)), out_dir],
                stdout=so, stderr=se, env=lane_env({}, one_card=True)))
        _CHILD_PROCS.append(kids[-1])
    lines, failed = [], []
    for p, (age, warm) in zip(kids, TRACE_PROBE_CASES):
        out_dir = os.path.join(work, f"age{age}_{int(warm)}")
        p.wait()
        if p.returncode != 0:
            failed.append((age, warm))
            with open(out_dir + ".err") as fh:
                print(f"probe {(age, warm)} failed (rc {p.returncode}): "
                      f"{fh.read()[-2000:]}", flush=True)
        with open(out_dir + ".out") as fh:
            lines += [json.loads(l) for l in fh if l.startswith("{")]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "trace_probe.jsonl"),
              "w") as fh:
        fh.writelines(json.dumps(l) + "\n" for l in lines)
    for l in lines:
        print(json.dumps(l), flush=True)
    short = [l for l in lines
             if l["b1"] != l["b1_traced"] or l["b2"] != l["b2_traced"]]
    print(json.dumps({"captures": len(lines), "short": len(short),
                      "short_cases": [(l["age_s"], l["warm"], l["capture"])
                                      for l in short],
                      "failed_processes": failed}), flush=True)
    if failed:
        sys.exit(1)


def main():
    import torch
    phase("1 device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    try:
        from avenir_tpu_torch.kernels import build, vote
        from avenir_tpu_torch.utils.tracing import transfer_ledger
    except ImportError as exc:
        fail(f"cannot import the port ({exc}); run from a checkout's root")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"nvidia-smi unavailable (rc {smi.returncode})"
    print(card, flush=True)
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    from avenir_tpu_torch.io import native_csv, native_wire
    # the g++ reader and serving codec compile on a thread while the nvcc
    # processes run
    native_err = []
    native_t = threading.Thread(target=lambda: native_err.extend(
        _try(native_csv.build) + _try(native_wire.build)))
    native_t.start()
    # topk.cu compiles longest and is first needed in phase 15: it builds
    # on a thread started with the others and is waited for there
    topk_err, topk_secs = [], {}
    topk_t = threading.Thread(target=lambda: topk_err.extend(_try(
        lambda: topk_secs.update(build.build_all(["topk"])))))
    topk_t.start()
    secs = build.build_all([n for n in build.SOURCES if n != "topk"])
    native_t.join()
    if native_err:
        fail(f"native CSV reader or serving codec build failed: "
             f"{native_err[0]}")
    for name, s in secs.items():
        print(f"built {build.SOURCES[name]} in {s:.1f} s", flush=True)
        log = build.build_log.get(name, (0, ""))[1].strip()
        if log:
            print(log, flush=True)
    native_s = native_csv.build_log[0] if native_csv.build_log else 0.0
    print(f"built {os.path.relpath(native_csv.SOURCE, ROOT)} with g++ in "
          f"{native_s:.1f} s into {os.path.relpath(native_csv.library_path(), ROOT)}",
          flush=True)
    print(f"built {os.path.relpath(native_wire.SOURCE, ROOT)} with g++ into "
          f"{os.path.relpath(native_wire.library_path(), ROOT)}", flush=True)

    phase("3 kernel vs plain version")
    rng = np.random.default_rng(20261016)
    max_err = 0
    for shape, want_form in ((RAFO_SHAPE, "table"), (WIDE_SHAPE, "scan")):
        for n in row_counts(shape):
            stacked, vals, codes = random_forest_inputs(rng, shape, n)
            model = vote.prepare_vote_model(*stacked, dev)
            d_vals = torch.from_numpy(vals).to(dev)
            d_codes = torch.from_numpy(codes).to(dev)
            forms = vote_forms(model, want_form)
            for min_odds in (1.0, 1.5):
                want = vote.ensemble_vote_torch(d_vals, d_codes,
                                                *model.stacked(), min_odds)
                for form, m in forms:
                    got = vote.ensemble_vote(d_vals, d_codes, m, min_odds)
                    torch.cuda.synchronize()
                    if got.shape != (n,) or got.dtype != torch.int32:
                        fail(f"kernel output {tuple(got.shape)} {got.dtype}")
                    err = int((got.long() - want.long()).abs().max().item()) \
                        if n else 0
                    max_err = max(max_err, err)
                    if err:
                        bad = int((got != want).sum().item())
                        fail(f"kernel ({form} form) != plain version at "
                             f"shape {shape}, n={n}, min_odds={min_odds}: "
                             f"{bad} rows differ")
            print(f"shape T,P,F,C,K={shape} n={n}: exact in forms "
                  f"{[f for f, _ in forms]} (table bytes "
                  f"{model.table_bytes()}, scan smem="
                  f"{model.smem_bytes() <= vote.SMEM_LIMIT}, "
                  f"vetoes={int((got == shape[4]).sum().item())})",
                  flush=True)

    # ---- the main path: counts zeroed just before, read just after ----
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    props = os.path.join(RES, "rafo.properties")
    schema = os.path.join(RES, "call_hangup.json")
    vote.launches = vote.table_launches = 0
    with transfer_ledger() as ledger:
        phase("4 golden rf fixture")
        sys.path.insert(0, RES)
        from gen.call_hangup_gen import generate
        train = os.path.join(WORK, "rf_train.csv")
        with open(train, "w") as fh:
            fh.write("\n".join(generate(400, 13)))
        run_cli(["org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
                 f"-Dmop.model.dir.path={RF_GOLDEN}",
                 f"-Dmop.feature.schema.file.path={schema}",
                 train, os.path.join(WORK, "rf_pred")])
        same_bytes(os.path.join(WORK, "rf_pred", "part-m-00000"),
                   os.path.join(RF_GOLDEN, "pred.csv"), "golden rf")

        phase("5 rafo9 fixture")
        requests = os.path.join(RAFO9, "requests.csv")
        run_cli(["org.avenir.model.ModelPredictor", f"-Dconf.path={props}",
                 f"-Dmop.model.dir.path={RAFO9}",
                 f"-Dmop.feature.schema.file.path={schema}",
                 requests, os.path.join(WORK, "rafo9_pred")])
        same_bytes(os.path.join(WORK, "rafo9_pred", "part-m-00000"),
                   os.path.join(RAFO9, "pred.csv"), "rafo9 modelPredictor")
        registry = os.path.join(WORK, "registry")
        shutil.copytree(os.path.join(RAFO9, "registry"), registry)
        served = os.path.join(WORK, "rafo9_served")
        t0 = time.perf_counter()
        run_cli(["org.avenir.serving.PredictionService",
                 f"-Dconf.path={props}", f"-Dps.model.registry.dir={registry}",
                 "-Dps.model.name=rafo9", "-Dps.transport=inprocess",
                 requests, served])
        serve_s = time.perf_counter() - t0
        same_bytes(os.path.join(served, "part-m-00000"),
                   os.path.join(RAFO9, "served.csv"), "rafo9 predictionService")
    launches = vote.launches
    main_table = vote.table_launches
    backends = ledger.backend_snapshot()
    print(f"main path: ensemble_vote launches={launches}, of which the "
          f"table form {main_table}; KernelBackends={backends}", flush=True)
    with open(served + ".counters.json") as fh:
        sc = json.load(fh)
    print(f"predictionService: {sc['Serving']['Requests']} requests in "
          f"{sc['Serving']['Batches']} batches, "
          f"{sc['Dispatches']['ensemble.vote']} vote launches "
          f"(incl. one warm-up batch per bucket), wall {serve_s:.2f} s, "
          f"serve.request p50/p99 {sc['Serving']['serve.request.p50Us']}/"
          f"{sc['Serving']['serve.request.p99Us']} us", flush=True)
    if launches <= 0:
        fail("the main path never launched the ensemble-vote kernel")
    if main_table != launches:
        fail(f"serving main path: {launches - main_table} vote launches "
             f"took the scan form; the golden rf and rafo9 forests take the "
             f"table form")
    if not backends.get("ensemble.vote.cuda"):
        fail("ledger shows no ensemble.vote.cuda")
    wrong = [k for k in backends if k.endswith((".torch", ".host"))]
    if wrong:
        fail(f"ledger shows non-kernel vote forms on the main path: {wrong}")

    phase("6 times")
    # the published forest (rafo9) over its fixture requests tiled to 1M rows
    from avenir_tpu_torch.core.schema import FeatureSchema
    from avenir_tpu_torch.core.table import load_csv
    from avenir_tpu_torch.models.forest import EnsembleModel
    from avenir_tpu_torch.models.tree import DecisionTreeModel
    from avenir_tpu_torch.weights import load_model_dir
    fs = FeatureSchema.load(schema)
    ens = EnsembleModel([DecisionTreeModel(pl, fs, device=dev)
                         for pl in load_model_dir(RAFO9)], device=dev)
    vals, codes = ens.models[0].matrix.feature_arrays(load_csv(requests, fs))
    n = 1_000_000
    reps = -(-n // len(vals))
    vote_forms(ens._stacked, "table")
    rafo9 = time_vote(ens._stacked, np.tile(vals, (reps, 1))[:n],
                      np.tile(codes, (reps, 1))[:n], plain=True,
                      old=scan_form(ens._stacked))
    print(f"rafo9 forest {ens._stacked.shape} (T,P,F,C,K), n={n}: {rafo9}",
          flush=True)
    stacked, vals_r, codes_r = random_forest_inputs(rng, RAFO_SHAPE, n)
    rnd_model = vote.prepare_vote_model(*stacked, dev)
    rnd = time_vote(rnd_model, vals_r, codes_r, plain=True,
                    old=scan_form(rnd_model))
    print(f"random inputs at shape {RAFO_SHAPE}, n={n}: {rnd}", flush=True)
    stacked, vals_w, codes_w = random_forest_inputs(rng, WIDE_SHAPE, n)
    wide = time_vote(vote.prepare_vote_model(*stacked, dev), vals_w, codes_w,
                     plain=False)
    print(f"random inputs at wide shape {WIDE_SHAPE}, n={n} (predicates "
          f"from global memory): {wide}", flush=True)
    print("no single PyTorch call computes the vote: library_ms is null",
          flush=True)
    for b, layers in serving_layers(load_model_dir(RAFO9), fs, requests,
                                    dev).items():
        print(f"served batch of {b} rows (rafo9), median ms per layer: "
              f"{layers}", flush=True)

    phase("7 histogram kernel vs plain version")
    from avenir_tpu_torch.kernels import histogram
    b1_err = 0.0
    for name, shape in B1_SHAPES.items():
        T, N, S, B, C = shape
        want_form = "atomic" if name == "wide" else "mma"
        got_form = histogram.level_form(*shape, torch.uint8)
        if got_form != want_form or \
                histogram.level_form(*shape, torch.float32) != "atomic":
            fail(f"level form at {name} {shape}: {got_form} for uint8 "
                 f"weights, expected {want_form}; float32 must be atomic")
        for n in (1, 7, 1000, B1_BIG_ROWS[name]):
            host = level_inputs(rng, shape, n + 3)
            full = [torch.from_numpy(a).to(dev) for a in host]
            # rows [3:] too: slices that start off any 16-byte boundary,
            # as a chunked level passes them
            for off in ((0, 3) if n == 1000 else (0,)):
                nid, br, cls, w8 = (a[off:off + n] for a in full)
                for w in (w8, w8.to(torch.float32)):
                    want = histogram.forest_level_counts_torch(
                        nid, br, cls, w, N, B, C)
                    forms = ["mma", "atomic"] if histogram.level_form(
                        *shape, w.dtype) == "mma" else ["atomic"]
                    for form in forms:
                        got = histogram.forest_level_counts(
                            nid, br, cls, w, N, B, C, form=form)
                        torch.cuda.synchronize()
                        if got.shape != (T, N, S, B, C) \
                                or got.dtype != torch.float32:
                            fail(f"histogram output {tuple(got.shape)} "
                                 f"{got.dtype}")
                        err = float((got - want).abs().max().item())
                        b1_err = max(b1_err, err)
                        if err or not torch.equal(got, want):
                            bad = int((got != want).sum().item())
                            fail(f"histogram kernel ({form} form) != plain "
                                 f"version at {name} {shape}, n={n}, rows "
                                 f"from {off}, weights {w.dtype}: {bad} "
                                 f"cells differ")
            u8_forms = "the mma and atomic forms" if got_form == "mma" \
                else "the atomic form"
            print(f"{name} T,N,S,B,C={shape} n={n}: exact in {u8_forms} "
                  f"for uint8 weights ({got_form} selected) and the atomic "
                  f"form for float32 (plan {histogram.mma_plan(*shape)}, "
                  f"total={float(want.double().sum().item()):.0f})",
                  flush=True)
            del full, nid, br, cls, w8, w, got, want

    # ---- the training main path: counts zeroed just before, read after ----
    from avenir_tpu_torch.core.config import load_config
    vote.launches = 0
    histogram.launches = histogram.mma_launches = 0
    with transfer_ledger() as train_ledger:
        phase("8 training main path")
        rf_model = os.path.join(WORK, "rf_model")
        run_cli(["org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
                 f"-Ddtb.feature.schema.file.path={schema}",
                 "-Ddtb.num.trees=3", train, rf_model])
        for i in range(3):
            same_bytes(os.path.join(rf_model, f"tree_{i}.json"),
                       os.path.join(RF_GOLDEN, f"tree_{i}.json"),
                       f"golden rf randomForestBuilder tree {i}")
        dt_train = os.path.join(WORK, "dt_train.csv")
        with open(dt_train, "w") as fh:
            fh.write("\n".join(generate(400, 12)))
        dec_in = None
        for level in range(1, 4):
            args = ["org.avenir.tree.DecisionTreeBuilder",
                    f"-Dconf.path={os.path.join(RES, 'detr.properties')}",
                    f"-Ddtb.feature.schema.file.path={schema}",
                    f"-Ddtb.decision.file.path.out={WORK}/dec_out.json"]
            if dec_in:
                args.append(f"-Ddtb.decision.file.path.in={dec_in}")
            run_cli(args + [dt_train, os.path.join(WORK, f"dt_level_{level}")])
            dec_in = os.path.join(WORK, "dec_in.json")
            os.replace(os.path.join(WORK, "dec_out.json"), dec_in)
        same_bytes(dec_in, os.path.join(DT_GOLDEN, "decision_paths.json"),
                   "golden dt decisionTreeBuilder x3")
        r9_train = os.path.join(WORK, "rafo9_train.csv")
        with open(r9_train, "w") as fh:
            fh.write("\n".join(generate(5000, 17)))
        r9_model = os.path.join(WORK, "rafo9_model")
        trained_reg = os.path.join(WORK, "trained_registry")
        t0 = time.perf_counter()
        run_cli(["org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
                 f"-Ddtb.feature.schema.file.path={schema}",
                 f"-Ddtb.model.registry.dir={trained_reg}",
                 "-Ddtb.model.name=rafo9", r9_train, r9_model])
        train_s = time.perf_counter() - t0
        for i in range(9):
            same_bytes(os.path.join(r9_model, f"tree_{i}.json"),
                       os.path.join(RAFO9, f"tree_{i}.json"),
                       f"rafo9 randomForestBuilder tree {i}")
        same_bytes(os.path.join(trained_reg, "rafo9", "v_000001", "meta.json"),
                   os.path.join(RAFO9, "registry", "rafo9", "v_000001",
                                "meta.json"), "rafo9 published meta.json")
        served_t = os.path.join(WORK, "rafo9_served_trained")
        run_cli(["org.avenir.serving.PredictionService",
                 f"-Dconf.path={props}",
                 f"-Dps.model.registry.dir={trained_reg}",
                 "-Dps.model.name=rafo9", "-Dps.transport=inprocess",
                 requests, served_t])
        same_bytes(os.path.join(served_t, "part-m-00000"),
                   os.path.join(RAFO9, "served.csv"),
                   "predictionService from the freshly trained registry")
    b1_launches = histogram.launches
    b1_mma_launches = histogram.mma_launches
    train_backends = train_ledger.backend_snapshot()
    with open(r9_model + ".counters.json") as fh:
        rc = json.load(fh)
    print(f"training main path: forest_level_counts launches={b1_launches}, "
          f"of which the mma form {b1_mma_launches}, "
          f"ensemble_vote launches={vote.launches}; "
          f"KernelBackends={train_backends}; rafo9 randomForestBuilder "
          f"{train_s:.2f} s wall, Dispatches={rc.get('Dispatches')}",
          flush=True)
    if b1_launches <= 0:
        fail("the training main path never launched the histogram kernel")
    if b1_mma_launches != b1_launches:
        fail(f"training main path: {b1_launches - b1_mma_launches} "
             f"histogram launches took the atomic form; every rafo-width "
             f"level takes the mma form")
    for site in ("forest.level.cuda", "tree.level.cuda",
                 "forest.level.form.mma", "tree.level.form.mma"):
        if not train_backends.get(site):
            fail(f"training ledger shows no {site}")
    wrong = [k for k in train_backends
             if k.endswith((".torch", ".host", ".atomic"))]
    if wrong:
        fail(f"ledger shows non-kernel or atomic forms on the training "
             f"path: {wrong}")

    phase("9 scale: rafo forest on 1,000,000 rows")
    from avenir_tpu_torch.cli.jobs import _tree_params
    from avenir_tpu_torch.models.forest import ForestParams, build_forest
    from avenir_tpu_torch.utils.tracing import LayerProfile
    cfg = load_config(props)
    fparams = ForestParams(tree=_tree_params(cfg),
                           num_trees=cfg.get_int("dtb.num.trees"),
                           seed=cfg.get_int("dtb.random.seed"))
    big = hangup_table(np.random.default_rng(20261017), 1_000_000, fs)
    torch.cuda.synchronize()
    histogram.launches = histogram.mma_launches = 0
    from avenir_tpu_torch.models import forest as forest_mod
    wire = {}
    to_device = forest_mod.weights_to_device

    def weights_spy(w, w_max, device):
        # the weights' own H2D bytes, from a ledger around the upload
        with transfer_ledger() as led:
            out = to_device(w, w_max, device)
        wire.update(bytes=led.h2d_bytes, w_max=w_max, T=w.shape[1])
        return out
    forest_mod.weights_to_device = weights_spy
    try:
        t0 = time.perf_counter()
        gpu_trees = build_forest(big, fparams, device=dev)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
    finally:
        forest_mod.weights_to_device = to_device
    w_T = wire["T"]
    w_want = big.n_rows * (-(-w_T // 2) if wire["w_max"] < 16 and w_T > 1
                           else w_T)
    if wire["bytes"] != w_want:
        fail(f"1M-row rafo forest: bootstrap weights uploaded "
             f"{wire['bytes']} bytes; the wire for w_max {wire['w_max']} "
             f"and T={w_T} ships {w_want}")
    prof = LayerProfile(dev)
    t0 = time.perf_counter()
    prof_trees = build_forest(big, fparams, device=dev, profile=prof)
    prof_s = time.perf_counter() - t0
    scale_b1 = (histogram.launches, histogram.mma_launches)
    if scale_b1[0] <= 0 or scale_b1[1] != scale_b1[0]:
        fail(f"1M-row rafo forest: {scale_b1[0]} histogram launches, "
             f"{scale_b1[1]} in the mma form; all must be")
    t0 = time.perf_counter()
    cpu_trees = build_forest(big, fparams, device="cpu")
    cpu_s = time.perf_counter() - t0
    gpu_json = [t.to_json() for t in gpu_trees]
    if gpu_json != [t.to_json() for t in cpu_trees] or \
            gpu_json != [t.to_json() for t in prof_trees]:
        fail("1M-row rafo forest: card and CPU trees differ")
    print(f"1M-row rafo forest (9 trees, depth 4): identical trees on the "
          f"card and the CPU; card wall {gpu_s:.3f} s (profiled run "
          f"{prof_s:.3f} s), CPU plain-version wall {cpu_s:.2f} s; "
          f"{len(prof.levels)} levels; histogram launches (two card builds) "
          f"{scale_b1[0]}, all in the mma form; bootstrap weights H2D "
          f"{wire['bytes']:,} bytes (w_max {wire['w_max']:g}, T={w_T}: "
          f"{wire['bytes'] / big.n_rows:g} bytes a row, uint8 would be "
          f"{w_T})", flush=True)
    print(f"  setup ms: {json.dumps({k: v * 1e3 for k, v in prof.setup.items()})}",
          flush=True)
    print(f"  median ms per level: {json.dumps(prof.median_ms())}",
          flush=True)

    phase("10 histogram kernel times")
    rafo_t = time_b1(rng, B1_SHAPES["rafo"], 1_000_000, dev)
    print(f"rafo {B1_SHAPES['rafo']} n=1,000,000: {rafo_t}", flush=True)
    root_t = time_b1(rng, B1_SHAPES["rafo_root"], 1_000_000, dev)
    print(f"rafo root level {B1_SHAPES['rafo_root']} n=1,000,000: {root_t}",
          flush=True)
    bench_t = time_b1(rng, B1_SHAPES["bench"], 8_000_000, dev)
    print(f"bench {B1_SHAPES['bench']} n=8,000,000: {bench_t}", flush=True)
    print("no single PyTorch call computes the histogram: library_ms is null",
          flush=True)

    phase("11 int8 vote kernel vs plain version")
    b3_err = 0
    for shape, want_form in ((RAFO_SHAPE, "table"), (WIDE_SHAPE, "scan")):
        for n in row_counts(shape):
            stacked, qv, qc = random_quantized_inputs(rng, shape, n)
            model = vote.prepare_quantized_vote_model(*stacked, dev)
            d_qv = torch.from_numpy(qv).to(dev)
            d_qc = torch.from_numpy(qc).to(dev)
            forms = vote_forms(model, want_form)
            for min_odds in (1.0, 1.5):
                want = vote.quantized_vote_torch(d_qv, d_qc,
                                                 *model.stacked(), min_odds)
                for form, m in forms:
                    got = vote.quantized_vote(d_qv, d_qc, m, min_odds)
                    torch.cuda.synchronize()
                    if got.shape != (n,) or got.dtype != torch.int32:
                        fail(f"int8 vote output {tuple(got.shape)} "
                             f"{got.dtype}")
                    err = int((got.long() - want.long()).abs().max().item()) \
                        if n else 0
                    b3_err = max(b3_err, err)
                    if err:
                        bad = int((got != want).sum().item())
                        fail(f"int8 vote kernel ({form} form) != plain "
                             f"version at shape {shape}, n={n}, "
                             f"min_odds={min_odds}: {bad} rows differ")
            print(f"int8 shape T,P,F,C,K={shape} n={n}: exact in forms "
                  f"{[f for f, _ in forms]} (table bytes "
                  f"{model.table_bytes()}, "
                  f"smem={model.smem_bytes() <= vote.SMEM_LIMIT}, "
                  f"smem_bytes={model.smem_bytes()}, "
                  f"vetoes={int((got == shape[4]).sum().item())})",
                  flush=True)
            del d_qv, d_qc, got, want

    phase("12 bin-counts kernel vs plain version")
    b4_err = 0.0
    for name, (R, B) in B4_SHAPES.items():
        for n in B4_ROWS:
            b4_codes = torch.from_numpy(rng.integers(
                -2, B + 2, (n, R), dtype=np.int32)).to(dev)
            part = torch.from_numpy(rng.random(n) < 0.6).to(dev)
            for mask in (None, part):
                got = histogram.bin_counts(b4_codes, B, mask)
                want = histogram.bin_counts_torch(b4_codes, B, mask)
                torch.cuda.synchronize()
                if got.shape != (R, B) or got.dtype != torch.float32:
                    fail(f"bin counts output {tuple(got.shape)} {got.dtype}")
                err = float((got - want).abs().max().item())
                b4_err = max(b4_err, err)
                if err or not torch.equal(got, want):
                    fail(f"bin-counts kernel != plain version at {name} "
                         f"R={R} B={B}, n={n}, mask "
                         f"{'partial' if mask is not None else 'None'}")
            print(f"{name} R,B=({R},{B}) n={n}: exact with mask None and "
                  f"partial (total={float(want.sum().item()):.0f})",
                  flush=True)

    # ---- the sidecar main path: counts zeroed just before, read after ----
    vote.launches = vote.quantized_launches = vote.table_launches = 0
    histogram.launches = histogram.bin_counts_launches = 0
    with transfer_ledger() as side_ledger:
        phase("13 sidecar main path")
        q_model = os.path.join(WORK, "rafo9q_model")
        q_reg = os.path.join(WORK, "rafo9q_registry")
        t0 = time.perf_counter()
        run_cli(["org.avenir.tree.RandomForestBuilder", f"-Dconf.path={props}",
                 f"-Ddtb.feature.schema.file.path={schema}",
                 f"-Ddtb.model.registry.dir={q_reg}",
                 "-Ddtb.model.name=rafo9", "-Ddtb.model.quantize=true",
                 "-Ddtb.baseline.publish=true", r9_train, q_model])
        q_train_s = time.perf_counter() - t0
        publish_launches = {"ensemble_vote": vote.launches,
                            "quantized_vote": vote.quantized_launches,
                            "bin_counts": histogram.bin_counts_launches}
        for i in range(9):
            same_bytes(os.path.join(q_model, f"tree_{i}.json"),
                       os.path.join(RAFO9, f"tree_{i}.json"),
                       f"rafo9q randomForestBuilder tree {i}")
        version = os.path.join("rafo9", "v_000001")
        for f in ("meta.json", "baseline.json", "quantized.json"):
            same_bytes(os.path.join(q_reg, version, f),
                       os.path.join(RAFO9Q, "registry", version, f),
                       f"rafo9q published {f}")
        for f in ("arrays.npz", "baseline.npz", "quantized.npz"):
            same_arrays(os.path.join(q_reg, version, f),
                        os.path.join(RAFO9Q, "registry", version, f),
                        f"rafo9q published {f}")
        with open(q_model + ".counters.json") as fh:
            q_counters = json.load(fh)
        with open(os.path.join(RAFO9Q, "train_counters.json")) as fh:
            want_counters = json.load(fh)
        if q_counters["Random forest"] != want_counters:
            fail(f"rafo9q counters {q_counters['Random forest']} != "
                 f"{want_counters}")
        print(f"rafo9q counters equal the fixture's: "
              f"{q_counters['Random forest']}", flush=True)
        served_q = os.path.join(WORK, "rafo9q_served")
        t0 = time.perf_counter()
        run_cli(["org.avenir.serving.PredictionService",
                 f"-Dconf.path={props}", f"-Dps.model.registry.dir={q_reg}",
                 "-Dps.model.name=rafo9", "-Dps.transport=inprocess",
                 "-Dps.quantized=true", requests, served_q])
        q_serve_s = time.perf_counter() - t0
        same_bytes(os.path.join(served_q, "part-m-00000"),
                   os.path.join(RAFO9Q, "served_quantized.csv"),
                   "rafo9q predictionService -Dps.quantized=true")
    b3_launches = vote.quantized_launches
    b4_side_launches = histogram.bin_counts_launches
    side_table = vote.table_launches
    if side_table != vote.launches + b3_launches:
        fail(f"sidecar main path: {vote.launches + b3_launches - side_table} "
             f"float or int8 vote launches took the scan form; the rafo9 "
             f"forests take the table form")
    side_backends = side_ledger.backend_snapshot()
    with open(served_q + ".counters.json") as fh:
        sq = json.load(fh)
    print(f"sidecar main path: launches in the publish {publish_launches}, "
          f"quantized_vote launches in all={b3_launches}, bin_counts "
          f"launches={b4_side_launches}, table-form vote launches="
          f"{side_table}; "
          f"KernelBackends={side_backends}; "
          f"randomForestBuilder {q_train_s:.2f} s wall; predictionService "
          f"{sq['Serving']['Requests']} requests in "
          f"{sq['Serving']['Batches']} batches, "
          f"{sq['Dispatches']['quantized.vote']} int8 vote launches, "
          f"H2D {sq['Transfers']['H2DBytes']} bytes, wall {q_serve_s:.2f} s",
          flush=True)
    for k, v in publish_launches.items():
        if v <= 0:
            fail(f"the sidecar publish never launched {k}")
    for site in ("quantized.vote.cuda", "baseline.absorb.cuda"):
        if not side_backends.get(site):
            fail(f"sidecar ledger shows no {site}")
    wrong = [k for k in side_backends if k.endswith((".torch", ".host"))]
    if wrong:
        fail(f"ledger shows non-kernel forms on the sidecar path: {wrong}")

    phase("14 int8 vote kernel times")
    from avenir_tpu_torch.serving.quantized import load_quantized
    from avenir_tpu_torch.serving.registry import ModelRegistry
    qf = load_quantized(ModelRegistry(q_reg), "rafo9", 1)
    if qf is None:
        fail("the published rafo9 version has no int8 sidecar")
    # the rafo9 requests (phase 6's feature arrays) quantized, tiled to 1M
    req_vals, req_codes = ens.models[0].matrix.feature_arrays(
        load_csv(requests, fs))
    qv, qc = qf.quantize_rows(req_vals, req_codes)
    n = 1_000_000
    reps = -(-n // len(qv))
    q_vote = qf.prepare(dev).model
    vote_forms(q_vote, "table")
    b3 = time_vote(q_vote, np.tile(qv, (reps, 1))[:n],
                   np.tile(qc, (reps, 1))[:n], plain=True,
                   old=scan_form(q_vote))
    print(f"int8 rafo9 forest {qf.q_lo.shape} (T,P,F), n={n}: {b3}",
          flush=True)
    print("no single PyTorch call computes the int8 vote: library_ms is "
          "null", flush=True)

    topk_t.join()
    if topk_err:
        fail(f"topk.cu build failed: {topk_err[0]}")
    print(f"built topk.cu in {topk_secs.get('topk', 0.0):.1f} s (on a "
          f"thread since phase 2)", flush=True)
    log = build.build_log.get("topk", (0, ""))[1].strip()
    if log:
        print(log, flush=True)
    b5_err, b5_launches, b5_scale, b5_t, knn_scale = knn_phases(dev, rng)

    b6_err = b6_phase(dev, rng)
    b7_err = b7_phase(dev, rng)
    round_err, round_launches = merge_rounds_check(dev, rng)
    b7_err = max(b7_err, round_err)
    phase("21 sharded serving main path (serve_mesh over cuda x S)")
    b6_launches, fin_launches = sharded_serving([dev], "one card")
    phase("22 sharded knn main path (runtime context cuda x 4)")
    b7_scan, b7_launches, knn_warm_4, comp4 = sharded_knn([dev], "one card",
                                                          knn_scale)
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(n_cards)]
        phase("19, 21-22 and 24's layouts again over distinct devices")
        distinct_b6(cards)
        distinct_b4(cards)
        sharded_serving(cards, "distinct devices")
        sharded_knn(cards, "distinct devices", knn_scale)
    else:
        print("phases 19, 21-22, 24 over distinct devices skipped: one "
              "device visible", flush=True)
    b6_t, fin_t, b7_t = sharded_times(dev, ens, requests, fs, comp4,
                                      knn_scale, knn_warm_4)

    b4_err = max(b4_err, b4_phase(dev, rng))
    b4_launches, drift_b2, drift_strings, drift_fused = \
        drift_main_path(dev)
    drift = drift_scale(dev, fs)
    b4_t = b4_times(dev, fs)
    b4 = b4_t["rafo_1m"]
    blk = b4_t["rafo_2048"]

    streamed = stream_main_path(dev)
    # phases 29 and 30's five processes start up together, each held at
    # its gate until its phase lets it go
    plans = [crash_plan(), scale_plan(os.path.join(WORK, "stream_scale.csv"))]
    stages = start_stages(plans)
    stream_resume(plans[0], stages[0])
    scale, scale_trees, scale_counts, scale_csv = stream_scale(
        fs, plans[1], stages[1])
    multi = multi_process_phases(scale_csv, scale, scale_trees,
                                 scale_counts)
    cached = multi["cache"]
    nb_counts, nb_backends = bayes_main_path()
    nb_train, nb_cli, nb_csv = bayes_scale(dev)
    nb_joined = bayes_joined(nb_csv)
    wire = wire_phases(dev)
    fleet = fleet_phases(dev)
    retrain9 = retrain9_phase()
    retrain = retrain_scale(dev, fs, scale_csv, scale_trees)
    logistic = logistic_phase(dev)
    threefry_t = threefry_phase(dev)
    mlp_r = mlp_phase(dev)
    opt_r = optimize_phase(dev)
    # phase 70's CPU children run on the host's idle cores through the
    # card-bound phases 63-69
    tail_work, tail_kids = start_tail_cpu_children()
    bandit_r = bandit_phase(dev)
    online_r = online_phases(dev)
    seq_fix = seq_fixture_phase()
    seq_scale = seq_scale_phase(dev)
    tail_fix = tail_fixture_phase()
    tail_scale = tail_scale_phase(dev, tail_work, tail_kids)
    profile = profile_phase(scale_csv)
    phase()
    tf_main = {"mlp": mlp_r["fixture_launches"],
               "optimize": opt_r["fixture_launches"],
               "bandits": bandit_r["fixture_launches"],
               "online9": online_r["online9"]["fixture_launches"],
               "online_scale": online_r["scale"]["scale_launches"],
               "samplers": online_r["samplers"]["metro_launches"]
               + online_r["samplers"]["weighted_launches"]}
    if min(tf_main.values()) <= 0:
        fail(f"a main path of phases 61-66 never launched the threefry "
             f"kernel: {tf_main}")
    print(f"phase seconds: {json.dumps(PHASE_SECONDS)}; total "
          f"{sum(PHASE_SECONDS.values()):.1f} s", flush=True)

    def per_process(run, key):
        return [g[key] for g in run["launches"]]
    lane, joined = multi["lane"], multi["joined"]
    scale2 = multi["scale2"]["native"]["shards"]
    ranks = multi["joined_inputs"]["ranks"]

    def joined_job(name, key):
        return [rank[name][key] for rank in ranks]

    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "ensemble_vote", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/vote.cu",
        "replaces": "avenir_tpu/ops/pallas/vote.py:119",
        "launches": launches, "max_abs_err": max_err,
        "ms": rafo9["ms"], "plain_ms": rafo9["plain_ms"],
        "bound_ms": rafo9["bound_ms"], "bound_by": rafo9["bound_by"],
        "library_ms": None, "form": rafo9["form"],
        "table_launches": main_table, "old_form": rafo9["old_form"],
        "old_ms": rafo9["old_ms"], "device_ms": rafo9["device_ms"],
        "old_device_ms": rafo9["old_device_ms"],
        "drift_launches": drift_b2,
        "drift_fused_launches": drift_fused["b2"],
        "drift_fused_windows": drift_fused["windows"],
        "drift_replay_fused_launches": drift["fused_job"]["fused"]["b2"],
        "stream_launches": streamed["b2"],
        "shard_lane_launches": per_process(lane, "b2"),
        "joined_predictor_launches": [g["b2"] for g in joined["mp"]],
        "joined_mono_launches": joined_job("mono", "b2"),
        "joined_stream_off_launches": joined_job("soff", "b2"),
        "wire_launches": {p: wire["serve"][p]["b2_launches"]
                          for p in ("native", "python")},
        "wire_batches": {p: wire["serve"][p]["batches"]
                         for p in ("native", "python")},
        "delta_launches": wire["delta"]["b2_launches"],
        "delta_table_launches": wire["delta"]["b2_table_launches"],
        "fleet_launches": {c: fleet["main"][c]["launches"]
                           for c in ("a", "f")},
        "fleet_batches": {c: fleet["main"][c]["batches"]
                          for c in ("a", "f")},
        "fleet_loop_launches": [r["b2_launches"] for r in fleet["loop"]],
        "fleet_swap_launches": fleet["swap"]["b2_after"],
        "fleet_autoscale_launches": fleet["autoscale"]["b2"],
        "retrain9_launches": {k: v["b2"] for k, v in retrain9.items()},
        "retrain_scale_launches": retrain["scale"]["launches"]["b2"]}, {
        "name": "forest_level_counts", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/histogram.cu",
        "replaces": "avenir_tpu/ops/pallas/histogram.py:40",
        "launches": b1_launches, "max_abs_err": b1_err,
        "ms": rafo_t["ms"], "plain_ms": rafo_t["plain_ms"],
        "bound_ms": rafo_t["bound_ms"], "bound_by": rafo_t["bound_by"],
        "library_ms": None, "device_ms": rafo_t["device_ms"],
        "form": rafo_t["form"], "mma_launches": b1_mma_launches,
        "old_form": "atomic", "old_ms": rafo_t["old_ms"],
        "old_device_ms": rafo_t["old_device_ms"],
        "root_device_ms": root_t["device_ms"],
        "root_old_device_ms": root_t["old_device_ms"],
        "root_bound_ms": root_t["bound_ms"],
        "bench_device_ms": bench_t["device_ms"],
        "bench_old_device_ms": bench_t["old_device_ms"],
        "bench_bound_ms": bench_t["bound_ms"],
        "stream_launches": streamed["b1"],
        "stream_mma_launches": streamed["b1_mma"],
        "stream_scale_launches": scale["stream"]["b1"],
        "shard_lane_launches": per_process(lane, "b1"),
        "shard_lane_mma_launches": per_process(lane, "b1_mma"),
        "joined_launches": [g["b1"] for g in joined["rf"]],
        "two_process_scale_launches": [r["b1"] for r in scale2],
        "cache_launches": [cached[p]["b1"] for p in ("build", "use")],
        "joined_mono_launches": joined_job("mono", "b1"),
        "joined_mono_mma_launches": joined_job("mono", "b1_mma"),
        "joined_unequal_launches": joined_job("unequal", "b1"),
        "joined_stream_off_launches": joined_job("soff", "b1"),
        "joined_dt_launches": [sum(rank[f"dt{lv}"]["b1"]
                                   for lv in range(JOINED_DT_LEVELS))
                               for rank in ranks],
        "retrain9_launches": {k: v["b1"] for k, v in retrain9.items()},
        "retrain9_mma_launches": {k: v["b1_mma"]
                                  for k, v in retrain9.items()},
        "retrain_scale_launches": retrain["scale"]["launches"]["b1"],
        "retrain_scale_mma_launches":
            retrain["scale"]["launches"]["b1_mma"]}, {
        "name": "quantized_vote", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/vote.cu",
        "replaces": "avenir_tpu/ops/pallas/vote.py:129",
        "launches": b3_launches, "max_abs_err": b3_err,
        "ms": b3["ms"], "plain_ms": b3["plain_ms"],
        "bound_ms": b3["bound_ms"], "bound_by": b3["bound_by"],
        "library_ms": None, "form": b3["form"], "old_form": b3["old_form"],
        "old_ms": b3["old_ms"], "device_ms": b3["device_ms"],
        "old_device_ms": b3["old_device_ms"],
        "stream_launches": streamed["b3"],
        "shard_lane_launches": per_process(lane, "b3"),
        "joined_mono_launches": joined_job("mono", "b3"),
        "joined_stream_off_launches": joined_job("soff", "b3"),
        "predictq_launches": wire["predictq"]["b3_launches"],
        "predictq_batches": wire["predictq"]["batches"],
        "fleet_launches": fleet["main"]["e"]["launches"],
        "fleet_batches": fleet["main"]["e"]["batches"]}, {
        "name": "bin_counts", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/bin_counts.cu",
        "replaces": "avenir_tpu/ops/pallas/histogram.py:94",
        "launches": b4_launches, "max_abs_err": b4_err,
        "ms": b4["ms"], "plain_ms": b4["plain_ms"],
        "bound_ms": b4["bound_ms"], "bound_by": b4["bound_by"],
        "library_ms": None, "device_ms": b4["device_ms"],
        "old_ms": b4["old_ms"], "old_device_ms": b4["old_device_ms"],
        "block_2048_ms": blk["ms"], "block_2048_device_ms": blk["device_ms"],
        "block_2048_old_ms": blk["old_ms"],
        "block_2048_old_device_ms": blk["old_device_ms"],
        "block_2048_bound_ms": blk["bound_ms"],
        "empty_launch_ms": b4_t["empty_ms"],
        "empty_launch_device_ms": b4_t["empty_device_ms"],
        "sidecar_launches": b4_side_launches,
        "drift_replay_launches": drift["launches"],
        "drift_replay_rows_per_s": drift["rows_per_s"],
        "drift_six_decimal_diffs": drift_strings,
        "drift_fused_launches": drift_fused["b4"],
        "drift_fused_windows": drift_fused["windows"],
        "drift_replay_fused_launches": drift["fused_job"]["fused"]["b4"],
        "drift_replay_fused_windows": drift["fused_job"]["fused"]["windows"],
        "stream_launches": streamed["b4"],
        "stream_unfused_launches": streamed["unfused"]["b4"],
        "stream_blocks": streamed["blocks"],
        "stream_scale_launches": scale["stream"]["b4"],
        "shard_lane_launches": per_process(lane, "b4"),
        "joined_launches": [g["b4"] for g in joined["rf"]],
        "two_process_scale_launches": [r["b4"] for r in scale2],
        "cache_launches": [cached[p]["b4"] for p in ("build", "use")],
        "joined_mono_launches": joined_job("mono", "b4"),
        "joined_stream_off_launches": joined_job("soff", "b4"),
        "drift_resp_launches": wire["drift"]["b4_launches"],
        "drift_resp_windows": wire["drift"]["windows"],
        "retrain9_launches": {k: v["b4"] for k, v in retrain9.items()},
        "retrain_scale_launches": retrain["scale"]["launches"]["b4"]}, {
        "name": "topk_scan", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/topk.cu",
        "replaces": "avenir_tpu/ops/pallas/topk.py:39",
        "launches": b5_launches, "max_abs_err": b5_err,
        "ms": b5_t["euclidean"]["ms"],
        "plain_ms": b5_t["euclidean"]["plain_ms"],
        "bound_ms": b5_t["euclidean"]["bound_ms"],
        "bound_by": b5_t["euclidean"]["bound_by"],
        "library_ms": None, "splits": b5_t["euclidean"]["splits"],
        "scale_launches": b5_scale[0], "split_merge_launches": b5_scale[1],
        "split_merge_ms": b5_t["euclidean"]["split_merge_ms"],
        "old_ms": b5_t["euclidean"]["old_ms"],
        "bound_ms_with_tail": b5_t["euclidean"]["bound_ms_with_tail"],
        "device_ms": b5_t["euclidean"]["device_ms"],
        "split_merge_device_ms":
            b5_t["euclidean"]["split_merge_device_ms"],
        "split_merge_old_device_ms":
            b5_t["euclidean"]["split_merge_old_device_ms"],
        "split_merge_bound_ms": b5_t["euclidean"]["split_merge_bound_ms"],
        "two_process_knn_launches": per_process(multi["knn2"], "b5"),
        "joined_knn_launches": joined_job("knn", "b5"),
        "nb_pipeline_launches": nb_counts["b5"]}, {
        "name": "ensemble_partial_votes", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/vote.cu",
        "replaces": "avenir_tpu/ops/pallas/vote.py:73",
        "launches": b6_launches, "max_abs_err": b6_err,
        "ms": b6_t["ms"], "plain_ms": b6_t["plain_ms"],
        "bound_ms": b6_t["bound_ms"], "bound_by": b6_t["bound_by"],
        "library_ms": None, "form": b6_t["form"],
        "old_ms": b6_t["old_ms"], "device_ms": b6_t["device_ms"],
        "old_device_ms": b6_t["old_device_ms"],
        "finalize_device_ms": fin_t["device_ms"],
        "finalize_launches": fin_launches, "finalize_ms": fin_t["ms"],
        "finalize_plain_ms": fin_t["plain_ms"],
        "finalize_bound_ms": fin_t["bound_ms"],
        "finalize_bound_by": fin_t["bound_by"],
        "delta_launches": wire["delta"]["sharded_partial_launches"],
        "delta_finalize_launches":
            wire["delta"]["sharded_finalize_launches"],
        "fleet_launches": fleet["sharded"]["partial_launches"],
        "fleet_finalize_launches": fleet["sharded"]["finalize_launches"],
        "fleet_batches": fleet["sharded"]["batches"]}, {
        "name": "topk_scan_sharded", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/topk.cu",
        "replaces": "avenir_tpu/ops/pallas/topk.py:128",
        "launches": b7_launches, "scan_launches": b7_scan,
        "max_abs_err": b7_err,
        "ms": b7_t["ms"], "plain_ms": b7_t["plain_ms"],
        "bound_ms": b7_t["bound_ms"], "bound_by": b7_t["bound_by"],
        "library_ms": None, "device_ms": b7_t["device_ms"],
        "old_ms": b7_t["old_ms"],
        "old_device_ms": b7_t["old_device_ms"],
        "process_merge_launches": per_process(multi["knn2"],
                                              "b7_merge"),
        "round_merge_lists": ROUND_LISTS,
        "round_merge_launches": round_launches}, {
        "name": "threefry2x32", "route": "cuda",
        "source": "avenir_tpu_torch/csrc/threefry.cu",
        "replaces": "none: jax.random's threefry2x32 (no pl.pallas_call), "
                    "drawn at avenir_tpu/optimize/annealing.py:103",
        "launches": sum(tf_main.values()), "max_abs_err": 0,
        "ms": threefry_t["ms"], "plain_ms": threefry_t["plain_ms"],
        "bound_ms": threefry_t["bound_ms"],
        "bound_by": threefry_t["bound_by"], "library_ms": None,
        "device_ms": threefry_t["device_ms"], "n": threefry_t["n"],
        "normal_ms": threefry_t["normal_ms"],
        "normal_device_ms": threefry_t["normal_device_ms"],
        "main_path_launches": tf_main,
        "sa_scale_launches": opt_r["sa_launches"],
        "ga_scale_launches": opt_r["ga_launches"],
        "vector_bandit_launches": bandit_r["launches"],
        "online_scale_launches_per_window": {
            k: r["threefry_per_window"]
            for k, r in online_r["scale"]["runs"].items()},
        "metropolis_launches_per_transition":
            online_r["samplers"]["metro_launches_per_transition"]}],
        "bayes": {"main_path_launches": nb_counts,
                  "main_path_backends": nb_backends,
                  "train_10m": nb_train, "cli_1m": nb_cli,
                  "joined": nb_joined},
        "wire": {"serve": {p: {k: v for k, v in wire["serve"][p].items()
                               if k != "backends"}
                           for p in wire["serve"]},
                 "predictq": wire["predictq"], "delta": wire["delta"],
                 "durable": wire["durable"]},
        "fleet": {"main": {c: {k: v for k, v in r.items()
                               if k != "backends"}
                           for c, r in fleet["main"].items()},
                  "loop": fleet["loop"], "sharded": fleet["sharded"],
                  "swap": fleet["swap"], "autoscale": fleet["autoscale"],
                  "hosts": fleet["hosts"]},
        "retrain": {"retrain9": retrain9, **retrain},
        "logistic": logistic,
        "mlp": mlp_r, "optimize": opt_r,
        "bandits": {k: v for k, v in bandit_r.items() if k != "launches"},
        "online": online_r,
        "sequence": {"fixtures": seq_fix, "scale": seq_scale},
        "long_tail": {"fixtures": tail_fix, "scale": tail_scale},
        "profile": profile,
        "fused": {"drift9": drift_fused, "replay": drift["fused_job"],
                  "rafo9s": {k: v for k, v in streamed.items()
                             if k != "unfused"},
                  "rafo9s_unfused": streamed["unfused"]},
        "phase_seconds": PHASE_SECONDS}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scale-child"]:
        scale_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--shard-child"]:
        shard_child(*sys.argv[2:8])
    elif sys.argv[1:2] == ["--cli-child"]:
        cli_child(*sys.argv[2:])
    elif sys.argv[1:2] == ["--cache-child"]:
        cache_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--joined-child"]:
        joined_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--sa-cpu-child"]:
        sa_cpu_child(sys.argv[2])
    elif sys.argv[1:2] == ["--bandit-cpu-child"]:
        bandit_cpu_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--online-cpu-child"]:
        online_cpu_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--seq-cpu-child"]:
        seq_cpu_child(sys.argv[2])
    elif sys.argv[1:2] == ["--tail-cpu-child"]:
        tail_cpu_child(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--trace-probe-child"]:
        trace_probe_child(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--trace-probe"]:
        trace_probe()
    else:
        main()
