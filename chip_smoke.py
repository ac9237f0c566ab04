#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``shifu_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --time-of DIR [--seed N]

Run from the repository root on a machine with an NVIDIA GPU (built and
measured on an H100).  The main path's data (steps 3-6) comes from a
generator of its own, seeded from ``--seed``, so the checks and timings
around it never move it.  With ``--time-of DIR`` it only times the
histogram kernels B1 and B2 and a chunk of GBT trees of the
``shifu_tpu_torch`` in checkout DIR (``time_of``), to compare two
versions on one card.  Otherwise it

1. requires CUDA and prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. builds every hand-written kernel from ``shifu_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and holds each against its
   plain PyTorch version on the card: ``tree_traverse`` over a 100-tree,
   depth-7 forest (K=255 nodes), 64 bins and 256 columns at N in
   {1, 8, 64, 333, 512, 4096} must equal the plain version bit for bit;
   ``hist`` (the histogram build) over 256 uint8 columns of 64 bins with
   two stat channels [w, w*g] (integer weights 1-3, ~30% of rows
   inactive) at N in {1, 1000, 65536, 1048576} and K in {1, 2, 32} (and
   K=4096 where it is timed, step 7), and over 7 int32 columns of 4001
   bins at K=8, must give bit for bit what the plain version of its own
   fixed-point arithmetic gives, the float64 plain version's count
   channel exactly, the w*g channel within 1e-5 of that version's sum of
   |stats| per cell plus the fixed point's quantum (half of 2^-e a row),
   and the same bits on a second launch; ``stats_hist`` (the stats
   plane's fine histogram) over ~5%
   missing cells at (N, C, B, S) in {262144 x 224 x 4096 with S = 4 and
   2, 100003 x 13 x 64 with S = 4 and 2, 4096 x 5 x 4096 x 2, 1 x 7 x
   4096 x 4} must give the plain version's count channels exactly, the
   weighted ones within 1e-6 of the plain value, and the same bits on a
   second launch; ``hist_batch`` (the tree-batched histogram of the
   Random Forest) over 8 trees of ``hist``'s data at N = 1,048,576 and K
   in {1, 32, 4096} and over 7 int32 columns of 4001 bins at K=8 must give
   every tree a ``hist`` launch's bits, held to the plain versions as
   ``hist`` is, and the same bits on a second launch;
3. drives the port's serving path at full width: writes a synthetic GBT
   model set (ModelConfig.json, ColumnConfig.json with 224 numeric + 32
   categorical final-selected columns, models/model0.gbt with 100 trees of
   depth 7 from ``--seed``) with the port's own savers, starts
   ``ServeServer`` on ``cuda`` behind the stdlib HTTP handler on
   127.0.0.1:0, POSTs raw-record batches of 1, 7, 64, 333, 512 and 1500
   records (missing fields, junk numbers, unknown categories, one malformed
   record) plus pre-binned requests, GETs /healthz, and checks every score
   against the same model set served on ``device="cpu"`` within 1e-3 on the
   0-1000 scale (f32 tree sums run in another order on the card).  Kernel
   launch counts are zeroed just before this phase and read just after it:
   every kernel of the path must have launched.  Then the serving plane
   (``serve_plane_phase``) on a copy of the set, telemetry on,
   ``-Dshifu.scorelog.sampleRate=1.0``, ``traceSampleRate`` 0.1: the
   server's warm must capture every rung of both paths as a CUDA graph
   holding one ``tree_traverse`` launch; 4 client threads POST batches of
   1, 7, 64, 333, 512 and 1500 rows, raw and pre-binned in turns (each
   kind and size from two clients), while a rung of
   128 is captured beside their replays (launch counts zeroed just before,
   read just after: every ``tree_traverse`` launch is either a rung's
   eager warm-up or one a graph replay ran, one a replay, and at least one
   replay a scored batch), with no capture forced (``serve_capture_count()``
   0) and every score within 1e-3 of the CPU server; outcomes drawn from the CPU
   scores (Bernoulli) are posted for 1,834 rows and ``/quality``'s live AUC
   must equal the AUC of the logged scores (after stop, from the score
   log's committed segments) rounded to its 6 decimals; a ``/swap`` to a
   50-tree forest captures at ``prepare`` and nothing at ``commit``, its
   scores within 1e-3 of the CPU, a fresh registry restores the journal
   at generation 1, and a rollback scores bit for bit as before; a
   second server with ``maxQueueRows`` 64 and ``requestDeadlineMs``
   0.001 answers a coded 429 (``Retry-After``) and a coded 504, and its
   brownout governor flips on queue buildup and back (the flush deadline
   restored); the SERVE heartbeat must be live with its extras, and the
   stopped server must leave ``serve.request`` spans and
   ``metrics.prom``.  It prints the closed-loop p50/p99 over HTTP at 1,
   64 and 512 records (raw and pre-binned; ``LATENCY_REQUESTS`` requests
   each, a p99 only where at least 100 back it) and, for every rung, its
   replay against an eager launch of the same function (bit-equal, and
   their device times); a ``torch.profiler`` trace of one replay must
   show the graph running its ``tree_traverse`` kernel.  Then the fleet
   (``fleet_phase``): ``python -m shifu_tpu_torch.cli --dir <set> serve
   --replicas 2 --port 0 --device cuda`` as a subprocess over a copy of
   the set, each replica a worker process with its own CUDA context and
   captured rungs; raw and pre-binned batches through the router within
   1e-3 of the set on the CPU; every replica at 0 forced captures, its
   ``tree_traverse`` launches its warm-ups plus its replays' launches,
   read from its own ``/healthz``; a coordinated ``/swap`` to a 50-tree
   forest and back under two clients, every answer scored by one
   generation's forest and none by an older generation after a newer
   one answered; aggregate rows/s of pre-binned 512-row requests with 2
   replicas, then a SIGKILL of one worker (its pid from its announce
   file) under load with every request answered and the dead replica
   buried in the router's ``/status``, and rows/s with 1 replica; a
   SIGINT to the router stops every worker;
4. drives the port's training path at full width: writes the same column
   plan's training set (the wire plane of 1,048,576 rows, y from a logit
   on 10 columns drawn from ``--seed``, integer weights) with the port's
   own savers and ``WireWriter``, and runs ``shifu_tpu_torch.cli.main
   train`` on ``cuda`` (TreeNum 10, MaxDepth 7, Loss log, LearningRate
   0.1, CheckpointInterval 5, validSetRate 0.2).  It checks the exit
   code, the 10 depth-7 trees of ``models/model0.gbt``, falling train and
   validation errors, an informative column on top of the feature
   importance, and exactly 80 ``hist`` launches (7 levels and the leaf
   sums a tree; the 10 leaf-sum launches also counted on their own),
   counted from zero around the run.  Then: one chunk of trees under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
   chunk); 5 trees, then ``train -resume`` to 10, bit-identical to the
   uninterrupted forest; the same 5-tree checkpoint without its per-row
   score sidecar resumed to 10, its trees replayed through
   ``tree_traverse`` (launches counted from zero around the run), with
   the uninterrupted forest's splits and leaves within 1e-5 relative;
   the train phase split into upload, grow and checkpoints from
   ``tmp/profile.json``; and the plane's first 16,384 rows trained to 3
   trees on ``cuda`` and on ``cpu``, with equal split features on levels
   0-1, per-tree errors within 1e-4 relative and the two forests' AUCs
   (scored by ``tree_traverse``) within 0.005;
5. drives the port's Random Forest path at full width: ``init -model``'s
   RF params (TreeNum 10, MaxDepth 14, TWOTHIRDS, entropy, Loss squared)
   plus CheckpointInterval 8 on the same 1,048,576-row plane through
   ``cli.main train`` on ``cuda``, with exactly 14 ``hist_batch`` launches
   (the 8-tree batch, one a level) and 38 ``hist`` launches (the batch's
   8 leaf-sum levels, then 2 trees one by one), counted from zero around
   the run (10 of the ``hist`` launches leaf sums, counted on their own);
   32,767-node trees, a falling out-of-bag error, every tree's root split
   on an informative column (the column a depth-14 impurity importance
   puts on top may be a many-category one: it sums the gains of thousands
   of deep splits), the peak device memory.  Then: the two chunks again
   on resident tensors (the batch under ``set_sync_debug_mode("error")``),
   each reproducing the CLI's trees bit for bit, timed per tree with CUDA
   events around every histogram launch and leaf-sum level; 8 trees,
   then ``train -resume`` to 10, bit-identical, its restored trees
   replayed through ``tree_traverse``; and the plane's first 16,384
   rows, 3 trees at depth 7, on ``cuda`` and ``cpu``: bags equal (0
   rows differ), levels 0-1 equal, errors within 1e-4 relative, AUCs within
   0.005;
   then the mesh (``mesh_phase``): two rank processes of this script
   (``--mesh-rank``, joined through ``SHIFU_COORDINATOR`` /
   ``SHIFU_NUM_PROCESSES`` / ``SHIFU_PROCESS_ID`` by
   ``parallel.mesh.initialize_distributed``) share the card over gloo,
   each on its block of the rows: the train phase's GBT set through
   ``cli.main train`` (524,288 rows a rank; 80 ``hist`` launches and 80
   cell all_reduces a rank) must write the one-rank forest bit for bit,
   out of core on the plane's first 524,288 rows in 4 windows of 131,072
   (2 resident, 2 on the disk tail): a 3-tree depth-7 c2f GBT through
   ``cli.main train -Dshifu.train.streaming=on`` and a 4-tree depth-7 RF
   in two super-batches of 2 (17 tail sweeps, 56 ``hist_batch`` launches)
   must equal one rank's forests, disk passes, tail sweeps and bytes read
   bit for bit, every B1/B2 launch one rank's and each with one
   all_reduce, and a streamed NN (2 epochs, 65,536 x 256 in windows of
   16,384) one rank's within 1e-4; the window loop's sharded level
   histogram, path histograms (B2 at TB = 7), leaf sums and RF
   super-batch (B2 at TB = 2) on the first window must equal the
   fixed-point plain versions over the whole window; the elastic sync
   drill (``parallel/elastic_demo --device cuda``, 2 controllers at 256
   features, 4 epochs, one killed at ``dcn:step=3`` and relaunched) must
   end bit-identical to an unkilled control;
   an RF of 8 depth-7 trees on the plane's first 262,144 rows (7
   ``hist_batch`` and 8 leaf-sum ``hist`` launches, 15 all_reduces), the
   stats accumulator over two chunks of a 262,144 x 224 chunk (2
   ``stats_hist`` launches and all_reduces; boundaries, counts and fine
   cells) and the Scorer's walk of the GBT over the whole plane (1
   ``tree_traverse`` launch a rank, the rows gathered) must equal one
   rank's bit for bit, and 2 bags of an NN on the ensemble axis (5
   full-batch epochs on 65,536 x 256) one rank's within the reference's
   tolerance (valid errors 1e-4, params 1e-3); WDL at the reference's
   defaults on the plane's first 65,536 rows (224 numeric, 32
   categorical): 2 bags on the ensemble axis (tables replicated, 3
   full-batch epochs; each member bit-equal to it trained alone on one
   rank), 1 bag on the data axis in batches of 16,384, its tables
   row-sharded by ``auto`` past a lowered ``shardMinBytes`` and
   replicated, and 1 bag streamed in windows of 16,384, each within 1e-4
   of one rank's valid errors and 5e-4 of its params (a quarter of one
   Adam step: a stack of 2 against 1, or a batch's sums split over the
   ranks, sum in another order); ``stats -correlation``'s
   accumulator over the 262,144 x 224 chunk (cells within 1e-10) and SE
   over the NN plane (256 candidates, sums within 1e-6) one rank's;
   each rank times sharded
   builds by part (raw launch, flush, the meta and the cells'
   all_reduces): B1 at GBT levels 0 and 6, B2 at TB = 8, K = 32 and B3
   on its half of a 262,144 x 224 chunk; a third process
   joins a world of one over NCCL and all_reduces int64; meanwhile this
   process checks the int64 mode of B1, B2 and B3 on two row blocks
   against the fixed-point plain versions on the card, and the flush of
   their sum against one launch, bit for bit;
   then the tree ensembles on the same plane through ``cli.main train``
   on ``cuda`` (``bagging_phase``, ``multiclass_phase``): the GBT above
   with ``baggingNum`` 5 (exactly 70 ``hist_batch`` launches at TB = 5,
   one a level of a round, and 50 ``hist`` leaf-sum launches), five model
   files, distinct members, member 0 bit-identical to ``train_gbt`` on the
   card with its settings, the members timed on resident tensors beside
   that single forest; the same config with ``numKFold`` 3 (70 launches
   at TB = 3); a three-class target drawn from ``--seed`` on the same
   plane: a native RF with init -model's params (S = 3 class channels;
   14 ``hist_batch`` and 38 ``hist`` launches; class-distribution leaves,
   a falling out-of-bag misclassification), its forest walked over 65,536
   rows by ``tree_traverse``'s node-index walk (one launch, bit-equal to
   the plain version), and a one-vs-all GBT (240 ``hist`` launches, one
   ``tree_traverse`` launch a class model when scored), accuracy above
   the majority class's share for both; then the out-of-core tree
   trainers (``stream_phase``) through ``cli.main train`` on ``cuda`` on
   a 4,194,304 x 256 wire plane from ``--seed`` (shards of 524,288 rows,
   1.07 GB of bins; ``should_stream`` streams it on its own): (a) the GBT
   above with windows of 524,288 rows, 7 resident in the 1 GiB device
   cache and 1 on the disk tail, coarse-to-fine (``hist`` and
   ``hist_batch`` both launched, counted from zero around the run; the
   device busy share of a 3-tree run from ``torch.profiler``); (a') the
   exact schedule for 3 trees: (a)'s first 3 trees and progress bit for
   bit in 27 tail sweeps, more a tree than (a)'s; (a0) (a)'s first tree, cut
   to depth 2, at the default geometry (two 4,129,776-row windows, none resident); (b) 6 trees with CheckpointInterval 5, then
   ``train -resume`` to 10 from the 5-tree checkpoint, with and without
   its score sidecar (8 ``tree_traverse`` launches, one a window),
   bit-identical to (a); (c) ``init -model``'s RF cut to 8 trees, one
   super-batch (15 tail sweeps, 112 ``hist_batch`` launches), falling out-of-bag
   errors, the peak device memory; (d) the plane's first 16,384 rows in
   windows of 4,096 (6 resident): (a)'s GBT cut to 2 trees with
   coarse-to-fine on and off and a 4-tree depth-7 RF on the card, the coarse-to-fine GBT also
   on the CPU with equal splits and masks, leaves within 1e-5 relative
   (+1e-6), errors within 1e-5 relative, equal tail sweeps; (e) a streamed 2-bag GBT of 5 trees on the train
   plane (windows of 131,072, 6 resident), member 1 bit-identical to its
   single ``train_gbt_streamed`` run; then ``hist_batch`` at the tail
   window's path shape (TB = 7, N = 524,288, K = 64) and ``hist`` over
   the coalesced resident block (N = 3,670,016, K = 32) on the run's own
   inputs, held to their plain versions and timed;
6. drives the port's stats path through the CLI: writes the column
   plan's raw data as an 8,192-row '|'-delimited CSV (224 numeric columns
   with ~5% empty cells, 32 categorical, ``weight``, ``tag``; a cut in
   rows, not width), runs ``new``, ``init`` (it must type 224 numeric and
   32 categorical candidates) and ``stats`` on ``cuda`` in chunks of 4,096
   rows with a fused budget that keeps 1 chunk resident and overflows 1
   into the provisional grid, with exactly 2 ``stats_hist`` launches
   counted from zero around ``stats``; checks every numeric column's
   counts and finite boundaries, and that ``stats`` on ``cpu`` writes the
   same ColumnConfig.json (integers, types, categories and binBoundary
   equal, floats within 1e-5 relative + 1e-4); times the host parse
   alone (the CSV's numeric columns binned at maxNumBin 63, the plan's
   width).  Then (``stats_extra_phase``) the rest of ``stats`` on copies
   of that set, card and CPU: ``stats -correlation -rebin -vars
   num000,cat224 -ivr 0.9 -bic 100`` with ``psiColumnName`` cat224 (the
   correlation matrices within 1e-6, PSI on every column, the two columns
   rebinned) and ``export corr`` copying the matrix; MunroPat; and
   ``-Dshifu.stats.checkpointChunks=1`` interrupted by the ``stats:chunk``
   fault at chunk 1 and resumed on the card against an uninterrupted run
   on the CPU; every ColumnConfig.json card vs CPU as above and
   ``stats_hist`` launched in every card run.  Then the offline path's
   end on the same set (``e2e_phase``):
   ``norm`` through the CLI writes the 8,192 x 256 uint8 wire plane,
   whose bins must equal the serving path's device transform
   (``FusedTransform.apply_device`` in float64) on the CSV's first 4,096
   records,
   ``train`` on ``cuda`` reads it (GBT, TreeNum 10, MaxDepth 7, Loss log:
   80 ``hist`` launches), ``eval -new`` and ``eval -run`` score the CSV on
   ``cuda`` (``tree_traverse`` launched 1 model x 2 chunks times, counted
   from zero around it) and on ``cpu``: per-row scores within 1e-3
   (unrounded and in the %.3f score files), AUC within 1e-6, and the
   card's scores within 1e-3 of ``score_records_offline`` on those 4,096
   records; ``norm`` and both ``eval -run`` calls must be served from the
   raw cache ``stats`` wrote (one hit each, no miss); prints the walls of
   ``norm``, ``train`` and ``eval`` and eval's rows/s.  Then
   (``raw_cache_phase``) ``norm`` and ``eval -run`` on ``cuda`` in fresh
   copies of the set, with the raw cache and under
   ``-Dshifu.ingest.rawCache=false``, in turns off, on: hits
   only where it is on, wire planes byte-equal and score files equal to
   the e2e phase's, every wall printed; and (``posttrain_phase``)
   ``posttrain`` of the GBT on ``cuda`` (``tree_traverse`` launched once
   a model a norm shard, counted from zero around it) and on ``cpu``:
   every column's binAvgScore within 1.  Then the multi-class CLI path
   (``multiclass_cli_phase``): the same CSV's first 4,096 rows with a
   three-valued tag through ``new → init → stats → norm → train`` (native
   RF, then one-vs-all GBT) and ``eval -run`` on
   ``cuda`` and on ``cpu``: ``EvalPerformance.json`` accuracy and
   confusion matrix equal, class scores within 1e-5 in the %.6f score
   files, ``tree_traverse`` launched models x chunks times (1, then 3).
   Then the port's ``NumericAccumulator`` on ``cuda`` at a
   deployment's size: 8 weighted chunks of 262,144 rows x 224 columns from
   ``--seed`` (3 resident, 5 overflowing, 8 ``stats_hist`` launches), the
   ms a chunk update and the finalize take and the peak device memory,
   and the first 2 chunks on ``cuda`` and ``cpu`` with equal counts,
   boundaries and percentiles;
7. drives the NN/LR slice (no hand kernel: the products are cuBLAS
   GEMMs through ``torch.matmul``): writes a ``tmp/NormalizedData``
   plane of 262,144 rows x 256 f32 inputs from ``--seed`` as the
   port's ``norm`` writes it (npz shards, ``schema.json``; 0.27 GB,
   resident) and runs ``cli.main train`` on ``cuda`` (``nn_phase``):
   (a) ``init -model``'s NN (R, LearningRate 0.1, [20, 10] tanh, full
   batch) with baggingNum 5 for 20 epochs — five ``model{i}.nn`` files
   ``load_any`` scores, falling train and validation errors, ms per
   epoch — and 10 epochs then ``train -resume`` to 20, bit-identical;
   (b) ``bench_nn``'s net ([512, 256] relu, ADAM 0.001, MiniBatchs
   4096, log loss) for 2 epochs: ms per step and per epoch (its
   ``torch.profiler`` epoch over the plane's first quarter), the step's
   6 x rows x parameters FLOPs over its time against the dense FP32 peak
   of 67 TFLOP/s; (c) LR at ``init -model``'s params: ms per epoch; (d)
   (a)'s net on the first 16,384 rows for 10 epochs on ``cuda`` and
   ``cpu``: per-epoch errors within 1e-4 relative, AUCs within 0.005
   (the plane drawn on the card from ``--seed``).
   Then (``nn_serve_phase``) (a)'s five nets served over HTTP on ``cuda``
   from the serving set's configs (``x`` from the fused transform, one
   stacked forward), every score within 1e-2 of the same set on ``cpu``
   over raw batches of 1, 7, 64 and 333 records; and after the e2e and
   multi-class CLI cells (``e2e_nn_phase``) ``bench.py --plane e2e``'s
   NN ([64, 32] relu, ADAM 0.001, log loss, 10 epochs) trained on the
   e2e set's own norm plane on ``cuda`` and ``eval -run`` on ``cuda`` and
   ``cpu``: scores within 1e-2 in the %.3f files, AUC within 1e-4.
   Then the streamed NN trainer (``nn_stream_phase``) on a
   ``tmp/NormalizedData`` plane of 1,310,720 x 256 f32 (1.35 GB at
   ``should_stream``'s 4 x 258 bytes a row), which streams by a
   ``shifu.train.memoryBudgetBytes`` of 1 GiB in two windows with nothing
   forced: (a) ``init -model``'s NN, full batch, 2 epochs, falling
   errors, ms an epoch; (b) 1 epoch then ``train -resume`` to 2,
   bit-identical; (c) one minibatch run; (d) the first 16,384 rows
   forced to stream in windows of 8,192, card and CPU, errors within
   1e-4 relative; (e) ``torch.profiler`` over 2 epochs: the device busy
   share.  And
   (``varselect_phase``) ``varselect`` with ``filterBy SE`` through the
   CLI on ``cuda`` over ``nn_phase``'s 262,144 x 256 plane with (a)'s
   ``model0.nn``, then on its first 16,384 rows on ``cuda`` and ``cpu``:
   the same 64 columns selected, SE scores within 1e-6; then
   (``genetic_phase``) ``varselect`` with ``filterBy GENETIC`` on ``cuda``
   over the same plane with the reference's default WrapperSettings
   (16 candidates, 5 generations of 40 full-batch ADAM epochs, their nets
   stacked as one GEMM a layer) and filterNum 64, its wall and epochs a
   second, and on the plane's first 16,384 rows (10 epochs, 3
   generations) resident and streamed in windows of 8,192, each on
   ``cuda`` and ``cpu`` with the same ``genetic.json`` credit ranking and
   selection.  Then the WDL and SVM slice (no hand kernel: ``F.embedding``
   gathers, cuBLAS GEMMs and matvecs): (``wdl_phase``) a norm plane (f32)
   and a clean plane (uint8 bins) of 262,144 x 256 from the same rows
   of ``--seed``, the reference's WDL defaults (EmbedColumnNum 8, [64, 32]
   relu, wide and deep, ADAM 0.002, L2 1e-5) with baggingNum 5 through
   ``cli.main train`` on ``cuda``: (a) 5 full-batch epochs, falling
   errors, ms an epoch; (b) one epoch at MiniBatchs 128 over the
   planes' first 32,768 rows (a cut in rows), ms a step, the
   step's kernel launches (profiled over 5 and 10 steps) and the epoch's
   host syncs (one); (c) ``-Dshifu.wdl.hashBuckets=32`` trained on (b)'s
   32,768 rows, its bucket ids on the card equal to
   the host's and its models served over HTTP on ``cuda`` against
   ``cpu`` within 1e-2 (raw batches of 1, 7, 64 and 333 records); (d)
   the first 16,384 rows, 2 bags, 2 epochs, on ``cuda`` and ``cpu``,
   resident and streamed in windows of 8,192:
   errors within 1e-4 relative, AUCs within 0.005; (e) 2 minibatch epochs then ``train
   -resume`` to 4, bit-identical; (f) ``-Dshifu.wdl.shardTables=on``
   (the row-sharded plane on a world of one) beside (d)'s card runs and
   (e)'s uninterrupted run: the model files bit for bit, full batch
   resident and streamed and at MiniBatchs 1,024; (g) (c)'s models
   through the bucket scorer with ``serveCopy`` ``full``, ``sharded``
   (a shard of one on the one card) and ``hot`` (``serveHotRows`` 8, below
   every column's cardinality), every rung captured on the card, 917
   rows in requests of 1-512: ``sharded`` bit for bit ``full``, ``hot``
   within 1e-3 of its CPU copy on the 0-1000 scale and away from
   ``full`` where an id is cold, no capture forced; (``svm_phase``) the rbf kernel SVM at
   the 16,384-row cap x 256 through the CLI and its 2,000-iteration dual
   solve timed alone, the dual on 2,048 rows on ``cuda`` and ``cpu``
   (duals within 1e-4, decisions within 1e-3, support sets equal but
   near the 1e-6 threshold), the linear SVM (hinge on the NN path) on
   the 262,144 x 256 plane, and both served over HTTP on ``cuda``
   against ``cpu`` (raw batches of 1, 7, 64 and 333 records);
8. drives the commands around the offline path through ``cli.main`` on
   the e2e set (``aux_tree_phase``, after ``posttrain_phase``; copies of
   the set, one run on ``cuda``, one with ``--device cpu``): (a)
   ``export`` pmml, pmml -c, columnstats, woemapping, bagging and spec,
   the copies' files equal (gzip payloads for specs), and
   ``export/reference/model0.gbt`` re-read by ``load_reference_tree``,
   whose float64 host scores equal the native forest walked by one
   ``tree_traverse`` launch within rtol 1e-5 / atol 1e-6 on rows with
   every numeric the forest splits on present; (b) ``encode``
   (``tree_traverse``'s node-index walk, one launch a chunk: 2) with
   ``tmp/EncodedData`` byte-equal to the CPU's, and the RF phase's depth-14 forest walked by ``encode``'s
   walk over 16,384 rows of the train plane (node ids past 16,383, equal
   to the CPU's ``traverse_nodes``, one launch); (c) ``combo new -alg
   LR:GBT``, ``run`` and ``eval`` on the CSV's first 4,096 rows (80
   ``hist`` launches for the GBT member, one ``tree_traverse`` launch a
   chunk of the eval CSV), member and assembled AUCs within 0.005 of the
   CPU's; (f) ``convert``, ``save``/``history``/``switch``/``show``,
   ``analysis -fi`` and ``test -filter``
   with the CPU copy's return codes and files.  After ``e2e_nn_phase``
   (``aux_nn_phase``): the exports of the e2e NN, its Encog spec re-read
   by ``load_encog_nn`` scoring as the native net on ``cuda``, and (e)
   ``varselect -recursive 2`` (SE, filterNum 3, a [16] tanh net of 30
   ADAM epochs) on ``cuda`` and ``cpu`` with equal
   ``ColumnConfig.json.{0,1,2}`` selections.  Then (``wdl_e2e_phase``,
   ``svm_e2e_phase``) WDL and both SVMs trained on the e2e set's own
   planes on ``cuda``, ``eval -run`` on ``cuda`` and ``cpu`` (AUCs within
   0.005), the WDL set's ``export -t spec`` re-read by
   ``load_reference_wdl`` scoring as the native model within rtol 1e-5,
   and ``combo`` WDL:GBT as in (c) (its GBT member 5 trees: 40 ``hist``,
   one ``tree_traverse`` a chunk; its WDL member 5 full-batch epochs);
   then every input kind and config check (``inputs_phase``): the stats
   CSV cut into ``.gz``, ``.bz2``, ``.xz``, ``.zip`` and plain shards, a
   shard of the wrong width and a corrupt ``.gz``, read with
   ``-Dshifu.data.badThreshold=0.2`` and a ``filterExpressions`` using
   ``&`` and a string comparison through ``init → stats → norm → train
   (GBT, 3 trees) → eval -run`` on ``cuda`` and (stats, norm and eval of
   the card's forest) on ``cpu``: one shard and no row quarantined and
   the kept rows equal to a host count, ColumnConfig.json card vs CPU
   equal, eval scores within SCORE_TOL, ``train -dry`` writes no model,
   ``baggingSampleRate`` 5 fails ``probe``, and ``prng.poisson`` at
   rates 10, 37, 1000 and 1e5 (jax's rejection sampler) on the card
   bit-equal to the CPU's; the smoke imports neither ``pyarrow`` nor
   ``fsspec`` (the card's machine is not known to have them), so parquet
   and remote sources are held by the CPU tests alone; and the offline
   telemetry
   (``telemetry_phase``): ``init → stats → norm → train (GBT, 3 trees) →
   eval -run`` on the CSV with ``--telemetry --profile DIR`` on ``cuda``,
   then ``analysis --telemetry``, ``--utilization``, ``--timeline`` and
   ``monitor --once --json``: every step's span tree in the trace,
   ``drift.json`` written, the cost records' launches of ``pallas.hist``,
   ``stats.stats_hist`` and ``pallas.tree_traverse`` equal to the
   kernels' counts over the same run (zeroed just before it), the
   utilization rows of those planes under 105% of the H100 row's bytes/s,
   each step's ``torch.profiler`` trace naming its hand kernel, and each
   step's modelled bytes over that kernel's device time in the trace
   under 105% of the peak as well; the cost models' bytes at the timed
   shapes are logged beside the bounds' (a model charges every row and
   node, so it is never below the bound); then the continual refresh
   loop (``refresh_phase``) on a copy of the e2e set: a GBT incumbent
   (TreeNum 10, MaxDepth 7, CheckpointInterval 5) trained through
   ``cli.main``, 2,048 drifted rows (fresh rows of the CSV's generator,
   every numeric column scaled 2x, as ``bench_refresh`` drifts) appended
   to a copy of the CSV and ``norm --telemetry`` run again, its
   ``drift.json`` the trigger; ``refresh`` through ``cli.main`` on
   ``cuda`` once, in registry mode, the data-window cursor at the
   incumbent's 8,192 rows: decisions ``trigger, train, promote,
   complete``, ``serving.json`` at generation 1, the warm retrain
   resumed from 10 trees with 10 appended (the derived units), the first
   10 bit-equal to the incumbent's, exactly 80 ``hist`` launches and
   ``tree_traverse`` launched for the restored forest's replay over the
   new window and the gate (counted from zero around the command); the
   gate on the CPU over the card's candidate and holdout within 1e-6 of
   the card's AUCs; and an in-process ``ServeServer`` on ``cuda``
   (``sloP99Ms`` 1000, a client scoring across the swap) with a
   ``RefreshController(server=...)`` fed the drifted rows' bins through
   ``observe``: a ``refresh:promote`` fault after a 4-tree retrain (32
   ``hist`` launches) leaves the incumbent live and bit-identical, a
   fresh controller resumes at the gate with no ``hist`` launch and
   promotes (every rung captured at ``prepare``, none at ``commit``, no
   SLO alert, no forced capture), the canary pinned at promotion scores
   bit for bit on 3 probation ticks, and an injected SLO alert rolls
   back to generation 0, scoring bit for bit as before;
9. times each kernel (CUDA events, launches queued behind a spin kernel so
   the host cannot starve the card) beside its plain version, one PyTorch
   call that computes the same function where there is one, and its bound
   (the larger of the bytes this data makes it move over 3.35 TB/s and its
   integer operations over 67 T/s): ``tree_traverse`` at the serving top
   rung N=512, at N=16,384 (the e2e eval set), at N=65536 and at
   N=1,048,576 (the train replay's rows) on the forest packed once, as a
   pinning caller does, and on the e2e phase's trained forest at the eval
   chunk's 4,096 rows and 16,384 rows (the eval set's bins, repeated),
   ``stats_hist`` at N=262,144 x 224 columns x 4096 buckets with S = 4
   and 2 (``index_add_`` the PyTorch call), split by part (amax, staging
   the ids, adds, flush),
   ``hist`` at N = 1,048,576 and K
   in {1, 32, 4096} and ``hist_batch`` at TB=8 and the same N and K
   beside 8 ``hist`` launches (``scatter_add_`` the PyTorch call), each
   split by part (partition, row walk, adds, flush), ``hist_batch`` at the
   bagged GBT's TB = 5 (K = 1, 32) and the native RF's S = 3 (TB = 8, K =
   4096), every tree first held to ``hist``, tree 0 to the plain versions,
   ``tree_traverse``'s node-index walk of the native forest; times the device
   transform at
   N=512 with and without its x blocks; and reports ms per tree of the
   full-width train, with a ``torch.profiler`` breakdown of one tree's
   device time;
10. prints one JSON line listing every ported kernel, then as its last line
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Any failed check exits non-zero before the last line is printed.

The time budget: the whole run must take at most 750 s on an H100 (a
third of headroom under the 1,200 s limit for a contended host), and
``mark`` logs every phase's wall, all of them again before the end.
Each cut below is of depth (rows, trees, epochs, requests, turns, CPU
twins) and never of width; every kernel is still checked against its
plain version at its shapes, every path driven and every launch count
asserted.  Walls on an H100 80GB HBM3 at 700 W before the cuts and with
them but for the last round (PERF.md §4 keeps the table):

- the serve plane's closed loop: 100 pre-binned requests a size (were
  300), raw 1 / 64 / 512 records 20 / 10 / 2 (were 100 / 100 / 8), and 2
  load clients (were 4): ``serve_plane_phase`` 101.1 -> 45.6 s;
- the NN, WDL and SVM serves: raw batches of 1-333 records (were
  1-1500): ``nn_serve_phase`` 12.4 -> 4.1 s, ``svm_phase`` 19.6 -> 10.4;
- the card-vs-CPU twins on CUT_ROWS = 32,768 rows (were 65,536), GBT 3
  trees (were 5), RF 3 (were 10): ``train_phase`` 22.9 -> 7.8 s,
  ``rf_phase`` 40.4 -> 11.7, and the NN, WDL, varselect and GENETIC
  twins (GENETIC 10 epochs, were 20): ``genetic_phase`` 22.2 -> 12.8;
- stream (d): (a)'s GBT 2 trees (were 5), the same 65,536 rows; (e) 2
  bags (were 3): ``stream_phase`` 99.1 -> 86.8 s;
- the NN stream plane 1,310,720 rows under a 1 GiB memory budget (was
  2,621,440 under the default 2 GiB), 4 epochs (were 6), and the planes
  drawn on the card: ``nn_stream_phase`` 59.0 -> 22.3 s; the NN (a) run
  20 epochs (was 40) and (b)'s profile over a quarter of the plane:
  ``nn_phase`` 58.4 -> 30.7 s;
- WDL: (b) and (c) on 65,536 rows, the step profiles at 5 and 10 steps
  (were 20 and 40), the full-batch profile on 65,536 rows: ``wdl_phase``
  131.6 -> 88.3 s;
- the raw-cache turns off, on (were on, off, off, on):
  ``raw_cache_phase`` 38.7 -> 16.6 s; e2e's host-side checks on 4,096
  records: ``e2e_phase`` 19.7 -> 10.5 s; the multi-class CLI on 8,192
  rows: ``multiclass_cli_phase`` 26.0 -> 15.3 s;
- the CSV phases' CLI steps parse inline (INLINE_PARSE), and the port's
  config loader resolves a class's type hints once:
  ``aux_tree_phase`` 66.1 -> 48.5 s, ``aux_nn_phase`` 22.5 -> 11.9,
  ``wdl_combo`` 38.4 -> 26.5;
- the last round, for a contended host (the same tree took 668.5 s and
  782.9 s on two calls): the stats CSV 8,192 rows (was 16,384; 2
  chunks, 1 resident), which every phase on it reads (``combo`` and the
  multi-class CLI took 8,192 rows of it already), the eval forest still
  timed at 16,384 rows; (a') 5 trees (were 10); NN (b) 2 epochs (3);
  WDL (d) 2 epochs (3).

``inputs_phase`` and ``telemetry_phase`` came after these cuts and cut
nothing: about 36 s and 8 s, the whole 592.7 s on an H100 80GB HBM3 at
700 W (PERF.md §4).

``refresh_phase`` (7-9 s) came next. Its first whole run took 827.1 s
on a contended host, so this round cut depth again (walls of that run
-> the next, on two calls whose hosts differed, so part of each saving
is the host's):

- the Poisson draws 65,536 rows a rate and key (were 262,144):
  34.4 -> 10.1 s, ``inputs_phase`` 69.4 -> 33.9 s;
- the multi-class CLI on 4,096 rows (were 8,192):
  ``multiclass_cli_phase`` 17.7 -> 10.2 s;
- WDL (b) and (c) on 32,768 rows (were 65,536): (b)'s CLI 7.7 -> 3.2
  s, ``wdl_phase`` 116.8 -> 81.6 s.

The whole: 827.1 -> 668.6 s (PERF.md §4).  That round had also cut
``combo`` LR:GBT and WDL:GBT to the CSV's first 4,096 rows (LR:GBT's
runs and evals 32.8 -> 16.9 s, ``wdl_combo`` 34.0 -> 18.5 s), but there
the GBT member's card and CPU AUCs came out 0.00334 apart against
COMBO_AUC_TOL 0.005 (0.00046 on 8,192 rows): a split near-tie that
flips on fewer rows, as the same cut's 0.005141 had shown before.
``combo`` is back on 8,192 rows.  Its whole run took 766.1 s on a
contended host (``aux_tree_phase`` 53.2 s, ``wdl_combo`` 38.2), so this
round cut depth again (walls before):

- the tree stream (d)'s card-vs-CPU twin on 32,768 rows in 8 windows of
  4,096 (were 65,536 in windows of 8,192): its CPU run 11.0 -> 6.3 s;
- (a0)'s tree cut to depth 3 (was 7): 17.2 s;
- the Poisson draws 16,384 rows a rate and key (were 65,536): 10.1 /
  19.2 s on a quiet / a contended host.

The port's config loader now builds one coercer a field type
(``config/jsonbean.py``), which halves a 258-column ColumnConfig.json's
load (0.22 -> 0.115 s on a CPU), read a few times by every CLI step.

``mesh_phase`` (12.7-17.3 s) came next.  The whole took 533.8 s on one
call and 711.3 s on a slower host, past 700 s, so this round cut the
CPU twins' depth (walls of that run, the CPU half of each twin):

- CUT_ROWS 16,384 rows (was 32,768) for every card-vs-CPU twin on it,
  the streamed twins in the same number of windows (CUT_ROWS / 4): GBT
  3.40 s, RF 3.69, NN (d) 0.96, varselect SE 1.42, WDL (d) 1.86 + 2.03,
  stream NN (d) 0.77 on the CPU before;
- the tree stream (d)'s twin on 16,384 rows in 8 windows of 2,048 (was
  32,768 in windows of 4,096): its CPU run 7.41 s before.

That run took 782.7 s on a slower host still (every host-bound phase
1.1-1.7x its quick-host wall), so this round cut the NN and WDL planes,
the host-heaviest rows (walls of that run):

- the NN plane (``nn_phase``, varselect, GENETIC, the linear SVM) and
  the WDL planes NN_ROWS = WDL_ROWS = 262,144 rows (were 1,048,576):
  ``nn_phase`` 34.7 s, ``varselect_phase`` 7.1, ``genetic_phase`` 14.2,
  ``svm_phase`` 12.3, ``wdl_phase`` 105.9 (WDL (a)'s CLI train 27.9 s).

``mesh_phase`` then gained the out-of-core mesh and the elastic sync
drill: 16.3 -> 20.6-24.7 s on calls of the phase alone, the drill's five
controller processes (20.3-23.4 s) beside the ranks.  This round cut depth
in the stream phase to pay for it (walls of the last whole run before ->
a call of the phase alone after):

- stream (c): ``init -model``'s RF at 8 trees, one super-batch (was 10,
  two): 7.8 -> 4.1 s;
- stream (a0): its tree at depth 2 (was 3): 9.0 -> 6.7 s;
- stream (e): the members at 5 trees (were 10): 4.4-6.1 s before.

Those cuts paid 5-10 s against the mesh phase's 18-21 s of growth on the
slow hosts that the whole runs drew (718.5-729.8 s), and took away the
card's only streamed RF of two super-batches.  So the mesh's streamed RF
now runs in two super-batches of 2, and this round cut depth again
(walls of the last whole run before, 729.8 s):

- the streamed NN (``nn_stream_phase``, 23.7 s): 2 epochs (were 4),
  the resume from 1 (was 2): (a)'s CLI 6.9 s, (b)'s 4.4;
- the serve plane's closed loop: raw 1 / 64 records 10 / 5 requests
  (were 20 / 10): 2.6 + 2.5 s;
- ``combo`` WDL:GBT's WDL member 5 epochs (were 10): ``wdl_combo``
  35.7 s (its runs 8.6 s on the card, 14.6 on the CPU);
- the elastic drill: 4 epochs of 8,192 rows a controller (were 6 of
  16,384): 25.9 s, beside the ranks;
- a sharded build's all_reduces timed 3 times (were 5) a rank.

That run took 604.8 s on a quick host, the mesh phase 31.8 s, so the
smoke's marks went one level down (``mesh_phase: ...``,
``wdl_phase: ...``): WDL's step profiles took 47.7 of the phase's 69.0
s, nearly all of it ``torch.profiler`` recording every host op.
``profile_device`` now records the CUDA activity alone (its readers
take only device events): the profiles 4.3 s, ``wdl_phase`` 24.5 s, on
a call of the phase alone (``tools/smoke_phases.py`` runs phases alone).

``wdl_phase`` then gained (f) and (g) (1.4 and 0.4 s) and ``mesh_phase``
a rank's WDL runs, streamed WDL, correlation and SE (5.1 s a rank,
behind its older steps): 7.0 s in all on an H100 80GB HBM3 at 700 W in a
whole run of 498.4 s.  This round cut depth to pay for them (walls of
that run -> the next, 461.3 s on another host):

- the mesh's streamed c2f GBT 3 trees (were 5): a rank's 4.58 -> 1.71 s;
- ``combo`` WDL:GBT's GBT member 5 trees (were 10): ``wdl_combo`` 24.2
  -> 17.8 s, its CPU run 10.8 -> 6.2 s;
- stream (a') 3 trees (were 5): 2.50 -> 1.42 s;
- the fleet's two rows/s windows 1 s each (were 2): 2.0 s by
  construction (``fleet_phase`` 27.8 -> 22.7 s, host included).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT_OPS_PER_S = 67e12              # H100 SXM non-tensor 32-bit rate
OPS_PER_LEVEL = 8                  # loads, compares, clamps, select, madd
SCORE_TOL = 1e-3                   # 0-1000 scale, card vs CPU
N_TREES, DEPTH, N_BINS, N_NUM, N_CAT = 100, 7, 64, 224, 32
N_COLS = N_NUM + N_CAT
KERNEL_ROWS = (1, 8, 64, 333, 512, 4096)
RAW_BATCHES = (1, 7, 64, 333, 512, 1500)
GEMM_RAW_BATCHES = (1, 7, 64, 333)        # NN, WDL, SVM serves (a cut)
TRAVERSE_ROWS = (512, 16384, 65536, 1 << 20)   # serve's top rung, the
#                                          e2e eval set, a chunk, replay
HIST_ROWS = (1, 1000, 65536, 1 << 20)
HIST_NODES = (1, 2, 32)
CHUNK_REPEATS = 15                 # timed GBT chunks (the tree is host-bound)
HIST_WIDE = (1 << 20, 7, 4001, 8)          # N, C, B (int32 bins), K
HIST_TOL = 1e-5                            # x the plain version on |stats|
TRAIN_ROWS, TRAIN_TREES, TRAIN_CKPT = 1 << 20, 10, 5
NN_ROWS = WDL_ROWS = 1 << 18               # the NN and WDL planes (a cut)
CUT_ROWS, CUT_TREES = 16384, 3             # card vs CPU twins (a cut)
ERR_RTOL, AUC_TOL = 1e-4, 0.005            # card vs CPU
REPLAY_RTOL = 1e-5                         # replayed vs uninterrupted leaves
N_INFORMATIVE = 10
TRAIN_PARTS = ("train/upload", "train/grow", "train/checkpoint")
STATS_BUCKETS = 4096                       # the stats plane's fine sketch
STATS_TOL = 1e-6                           # weighted B3 cells, x |value|
STATS_CASES = ((262144, N_NUM, STATS_BUCKETS, 4), (262144, N_NUM,
               STATS_BUCKETS, 2), (100003, 13, 64, 4), (100003, 13, 64, 2),
               (4096, 5, STATS_BUCKETS, 2), (1, 7, STATS_BUCKETS, 4))
CSV_ROWS, CSV_CHUNK = 8192, 4096           # the stats CLI phase's cut
EVAL_TIMED_ROWS = 16384                    # time_eval_walk's larger N
# the parse holds the GIL: on the card's host an inline pass is ~2.3x
# faster than the default pool of eight threads (PERF.md), so the CSV
# phases' CLI steps parse inline; the rows parsed are the same
INLINE_PARSE = "-Dshifu.ingest.parseWorkers=0"
E2E_EVAL, E2E_AUC_TOL = "e2e", 1e-6        # eval set; AUC card vs CPU
E2E_CHECK_ROWS = 4096                      # rows of e2e's host-side checks
CHUNK_BYTES = CSV_CHUNK * (5 * N_NUM + 8)  # what a kept chunk holds
RESIDENT_CHUNKS, RESIDENT_ROWS = 8, 262144
CARD_CPU_RTOL, CARD_CPU_ATOL = 1e-5, 1e-4  # ColumnConfig floats, card/CPU
HIST_BATCH = 8                             # B2's tree batch (RF_TREE_BATCH)
HIST_BATCH_NODES = (1, 32, 4096)           # K: shallow levels, the deepest
HIST_TIMED_NODES = HIST_BATCH_NODES        # B1 timed at the same K
HIST_BATCH_WIDE = (1 << 20, 7, 4001, 8)    # N, C, B (int32 bins), K
RF_TREES, RF_DEPTH, RF_CKPT = 10, 14, 8    # init -model's RF + a checkpoint
RF_CUT_DEPTH, RF_CUT_TREES = 7, 3          # card vs CPU on CUT_ROWS rows
BAG_MEMBERS, BAG_KFOLD = 5, 3              # bagged GBT; its k-fold twin
BAG_TIMED_NODES = (1, 32)                  # B2 at TB = BAG_MEMBERS
MC_CLASSES, MC_WALK_ROWS = 3, 65536        # three-class target; B4 walk
MC_CLI_ROWS = 4096                         # the multi-class CLI's rows
NN_EPOCHS, NN_CKPT, NN_BAGS = 20, 10, 5    # init -model's NN, bagged
NN_WIDE = {"NumHiddenNodes": [512, 256],    # bench_nn's net (shifu_tpu/
           "ActivationFunc": ["relu", "relu"],  # bench.py:134-151)
           "Propagation": "ADAM", "LearningRate": 0.001,
           "MiniBatchs": 4096, "Loss": "log"}
NN_WIDE_EPOCHS, NN_LR_EPOCHS, NN_CUT_EPOCHS = 2, 20, 10
NN_PROFILE_SHARE = 4       # (b)'s profile: the plane's first quarter
NN_E2E = {"NumHiddenLayers": 2, "NumHiddenNodes": [64, 32],  # bench.py
          "ActivationFunc": ["relu", "relu"],    # --plane e2e's NN
          "LearningRate": 0.001, "Propagation": "ADAM", "Loss": "log"}
NN_E2E_EPOCHS = 10
NN_ERR_RTOL, NN_AUC_TOL = 1e-4, 0.005       # card vs CPU, (d)
NN_SCORE_TOL, NN_E2E_AUC_TOL = 1e-2, 1e-4   # NN eval and serve, 0-1000
FP32_PEAK = 67e12          # H100 SXM dense FP32 outside the tensor cores
MC_TAGS = ["t0", "t1", "t2"]               # the multi-class CSV's tags
MC_SCORE_TOL = 1e-5 + 1e-9                 # class scores card vs CPU (%.6f)
STREAM_ROWS, STREAM_WINDOW = 1 << 22, 1 << 19   # the out-of-core plane;
#                                       its shards and (a)'s windows
STREAM_RESIDENT = 7                        # (a): 7 x 140.5 MB <= 1 GiB
STREAM_A0_TREES = 1                        # (a0): 13 s a tree at depth 7
STREAM_A0_DEPTH = 2                        # (a0)'s tree (a cut)
STREAM_RF_TREES = 8                        # (c): one super-batch (a cut)
STREAM_EXACT_TREES = 3                     # (a'): (a)'s first 3 trees
STREAM_CUT_ROWS = 16384                    # (d) card vs CPU: 8 windows,
STREAM_CUT_WINDOW = STREAM_CUT_ROWS // 8   # 6 of them resident
STREAM_CUT_RESIDENT = 6
STREAM_CUT_RF_TREES = 4                    # (d)'s RF, depth DEPTH
STREAM_CUT_TREES = 2                       # (d)'s GBT: (a)'s, 2 trees
STREAM_CUT_CPU = ("gbt_c2f",)              # (d)'s cases also run on the CPU
STREAM_LEAF_RTOL, STREAM_LEAF_ATOL = 1e-5, 1e-6    # (d) leaves, card/CPU
STREAM_ERR_RTOL = 1e-5                     # (d) progress errors
MEMBER_WINDOW, MEMBER_RESIDENT, MEMBER_BAGS = 1 << 17, 6, 2   # (e)
MEMBER_TREES = 5                           # (e)'s members (a cut)
NN_STREAM_ROWS = 5 * (1 << 18)             # 1,310,720 rows: 1.35 GB at
#                        4 * (N_COLS + 2) bytes, over NN_STREAM_BUDGET
NN_STREAM_BUDGET = {"shifu.train.memoryBudgetBytes": str(1 << 30)}
NN_STREAM_EPOCHS, NN_STREAM_CKPT = 2, 1    # init -model's NN; a resume
NN_STREAM_BATCH = 1 << 16                  # (c)'s minibatch
NN_STREAM_CUT_WINDOW = CUT_ROWS // 4       # (d): 4 windows of CUT_ROWS
VARSEL_KEEP, VARSEL_SE_ATOL = 64, 1e-6     # SE filterNum; card vs CPU
GBT_ROW_BYTES = N_COLS + 12                # a prepared GBT window row
RF_ROW_BYTES = N_COLS + 8                  # a prepared RF window row


def marker(walls: dict, t_start: float, prefix: str = ""):
    """A ``mark(what)`` that records the wall since the last mark (or
    ``t_start``) in ``walls[what]`` and logs it beside the time since
    ``t_start``."""
    last = [t_start]

    def mark(what: str) -> None:
        now = time.perf_counter()
        walls[what] = round(now - last[0], 1)
        last[0] = now
        log(f"{prefix}{what} done at {now - t_start:.1f} s "
            f"({walls[what]:.1f} s)")
    return mark


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"chip_smoke: {msg}", flush=True)


# ------------------------------------------------------------- the card
def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------- the forest
def random_forest(rng, n_trees, depth, n_bins, n_cols, leaf_frac=0.1):
    """Complete-binary forest: ~``leaf_frac`` of internal nodes are early
    leaves, left masks random bits, leaf values N(0, 0.1)."""
    k = (1 << (depth + 1)) - 1
    sf = rng.integers(0, n_cols, size=(n_trees, k)).astype(np.int32)
    sf[rng.random((n_trees, k)) < leaf_frac] = -1
    sf[:, (1 << depth) - 1:] = -1
    lm = rng.random((n_trees, k, n_bins)) < 0.5
    lv = rng.normal(0.0, 0.1, size=(n_trees, k)).astype(np.float32)
    return sf, lm, lv


def device_ms(torch, fn, launches: int = 20, repeats: int = 7) -> float:
    """Median device time of one ``fn()`` call: each repeat queues a spin
    kernel, then ``launches`` calls between two CUDA events, so the card
    runs them back to back whatever the host's enqueue cost."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)          # ~25 ms of spinning
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        torch.cuda.synchronize()
        per.append(start.elapsed_time(end) / launches)
    return float(np.median(per))


# ------------------------------------------------------- phase: kernels
def check_kernels(torch, tq, rng) -> dict:
    """tree_traverse against its plain version at every N; returns the max
    |kernel - plain| seen."""
    sf, lm, lv = random_forest(rng, N_TREES, DEPTH, N_BINS, N_COLS)
    dev = torch.device("cuda")
    forest = [torch.from_numpy(a).to(dev)
              for a in (sf, lm.astype(np.uint8), lv)]
    err = 0.0
    for n in KERNEL_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to(dev)
        got = tq.predict_forest_quant(*forest, bins, DEPTH)
        want = tq.predict_forest_quant_ref(*forest, bins, DEPTH)
        torch.cuda.synchronize()
        if got.shape != (N_TREES, n) or not torch.equal(got, want):
            fail(f"tree_traverse != plain version at N={n} (max |d| "
                 f"{(got - want).abs().max().item()})")
        err = max(err, (got - want).abs().max().item())
        log(f"tree_traverse == plain version bit for bit at N={n}")
    return {"tree_traverse": err}


def hist_inputs(torch, rng, n, c, b, k, dtype=np.uint8):
    """B1 inputs on the card: uniform bins, node ids in [0, K) with ~30%
    of rows inactive (-1), stats [w, w*g] with integer w in 1..3 and
    g ~ N(0, 1)."""
    bins = rng.integers(0, b, size=(n, c), dtype=dtype)
    node = rng.integers(0, k, size=n, dtype=np.int32)
    node[rng.random(n) < 0.3] = -1
    w = rng.integers(1, 4, size=n).astype(np.float32)
    stats = np.stack([w, w * rng.standard_normal(n, np.float32)], axis=1)
    return [torch.from_numpy(a).to("cuda") for a in (bins, node, stats)]


def quantum_floor(torch, hist, bins, node, stats, k, b):
    """What the fixed point itself may lose in each cell: half of its
    quantum 2^-e a row of the cell (``hist.channel_exp``)."""
    rows = hist.build_histograms_ref(bins, node, torch.ones_like(stats[:, :1]),
                                     k, b)
    e = hist.channel_exp(stats.abs().amax(dim=0), bins.shape[0])
    return rows * torch.pow(2.0, -e.double() - 1).float()


def held_to_plain(torch, hist, got, bins, node, stats, k, b, where, name):
    """One tree's histogram against the plain versions: bit-equal to the
    kernel's own arithmetic (``build_histograms_fixed_ref``), counts equal
    to the float64 plain version, w*g within HIST_TOL of it run on |stats|
    plus the fixed point's quantum floor.  Returns max |got - plain|."""
    if not torch.equal(got, hist.build_histograms_fixed_ref(
            bins, node, stats, k, b)):
        fail(f"{name} != its fixed-point plain version at {where}")
    want = hist.build_histograms_ref(bins, node, stats, k, b)
    scale = hist.build_histograms_ref(bins, node, stats.abs(), k, b)
    d = (got - want).abs()
    if not torch.equal(got[..., 0], want[..., 0]):
        fail(f"{name} count channel != plain version at {where}")
    floor = quantum_floor(torch, hist, bins, node, stats, k, b)
    if not bool((d <= HIST_TOL * scale + floor).all()):
        fail(f"{name} w*g channel beyond {HIST_TOL} x |stats| and the "
             f"quantum at {where} (max |d| {d.max().item()})")
    return d.max().item()


def check_hist(torch, rng) -> dict:
    """B1 against its plain versions (``held_to_plain``), a second launch
    bit-equal.  Returns the max |kernel - plain| seen."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import build_histograms
    cases = [(n, N_COLS, N_BINS, k, np.uint8) for n in HIST_ROWS
             for k in HIST_NODES] + [HIST_WIDE + (np.int32,)]
    err = 0.0
    for n, c, b, k, dtype in cases:
        bins, node, stats = hist_inputs(torch, rng, n, c, b, k, dtype)
        got = build_histograms(bins, node, stats, k, b)
        again = build_histograms(bins, node, stats, k, b)
        torch.cuda.synchronize()
        where = f"N={n} C={c} B={b} K={k} {np.dtype(dtype).name}"
        if got.shape != (k, c, b, 2) or not torch.equal(got, again):
            fail(f"hist: two launches differ at {where}")
        d = held_to_plain(torch, hist, got, bins, node, stats, k, b, where,
                          "hist")
        err = max(err, d)
        log(f"hist == plain version at {where}: bit-equal to the fixed "
            f"point, counts equal, max |d| {d:.3g}, relaunch bit-equal")
        del bins, node, stats, got, again
    return {"hist": err}


def batch_inputs(torch, rng, n, c, b, k, tb, dtype=np.uint8, s=2):
    """B2 inputs on the card in ``hist_inputs``' style: shared uniform
    bins; per tree node ids in [0, K) with ~30% of rows inactive and
    stats [w, w*g], w a Poisson(1) bag times an integer weight 1..3 (so
    ~37% of each tree's rows weigh 0), g ~ N(0, 1) — or, for S > 2, the
    native multi-class channels w * onehot(class), the class uniform in
    [0, S)."""
    bins = rng.integers(0, b, size=(n, c), dtype=dtype)
    node = rng.integers(0, k, size=(tb, n), dtype=np.int32)
    node[rng.random((tb, n)) < 0.3] = -1
    w = (rng.poisson(1.0, size=(tb, n))
         * rng.integers(1, 4, size=n)).astype(np.float32)
    if s > 2:
        stats = w[:, :, None] * np.eye(s, dtype=np.float32)[
            rng.integers(0, s, size=n)]
    else:
        stats = np.stack([w, w * rng.standard_normal((tb, n), np.float32)],
                         axis=2)
    return [torch.from_numpy(a).to("cuda") for a in (bins, node, stats)]


def check_hist_batch(torch, rng) -> dict:
    """B2 against B1 and its plain versions: every tree's slice bit-equal
    to a B1 launch on that tree's inputs and held to the plain versions
    as B1 is (``held_to_plain``), a second launch bit-equal.  TB=8 at full
    width for each K in HIST_BATCH_NODES and at one int32-bin shape.
    Returns the max |kernel - plain| seen."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import (build_histograms,
                                          build_histograms_batch)
    cases = [(TRAIN_ROWS, N_COLS, N_BINS, k, np.uint8)
             for k in HIST_BATCH_NODES] + [HIST_BATCH_WIDE + (np.int32,)]
    err = 0.0
    for n, c, b, k, dtype in cases:
        bins, node, stats = batch_inputs(torch, rng, n, c, b, k, HIST_BATCH,
                                         dtype)
        where = f"TB={HIST_BATCH} N={n} C={c} B={b} K={k} " \
                f"{np.dtype(dtype).name}"
        got = build_histograms_batch(bins, node, stats, k, b)
        again = build_histograms_batch(bins, node, stats, k, b)
        torch.cuda.synchronize()
        if got.shape != (HIST_BATCH, k, c, b, 2) or \
                not torch.equal(got, again):
            fail(f"hist_batch: two launches differ at {where}")
        del again
        for t in range(HIST_BATCH):
            if not torch.equal(got[t], build_histograms(bins, node[t],
                                                        stats[t], k, b)):
                fail(f"hist_batch tree {t} != hist (B1) at {where}")
        d_max = 0.0
        for t in range(HIST_BATCH):            # one tree at a time: memory
            d_max = max(d_max, held_to_plain(
                torch, hist, got[t], bins, node[t], stats[t], k, b, where,
                f"hist_batch tree {t}"))
            torch.cuda.empty_cache()
        err = max(err, d_max)
        plan = hist.hist_plan(n, c, HIST_BATCH, k, b, 2,
                              np.dtype(dtype).itemsize)
        log(f"hist_batch == hist per tree bit for bit and == plain version "
            f"at {where}: counts equal, max |d| {d_max:.3g}, relaunch "
            f"bit-equal (plan {plan})")
        del bins, node, stats, got
        torch.cuda.empty_cache()
    return {"hist_batch": err}


# ---------------------------------------------------- phase: model set
def write_model_set(root: str, rng) -> dict:
    """The synthetic GBT model set, written with the port's own savers in
    the reference's file formats.  Returns the column plan for records."""
    from shifu_tpu_torch.config import (ColumnConfig, ModelConfig,
                                        save_column_configs)
    from shifu_tpu_torch.config.column_config import ColumnFlag, ColumnType
    from shifu_tpu_torch.config.model_config import Algorithm, NormType

    mc = ModelConfig()
    mc.basic.name = "chip_smoke"
    mc.dataSet.targetColumnName = "tag"
    mc.dataSet.posTags, mc.dataSet.negTags = ["bad"], ["good"]
    mc.normalize.normType = NormType.ZSCALE
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": N_TREES, "FeatureSubsetStrategy":
                       "TWOTHIRDS", "MaxDepth": DEPTH,
                       "MinInstancesPerNode": 5, "MinInfoGain": 0.0,
                       "DropoutRate": 0.0, "Impurity": "variance",
                       "LearningRate": 0.1, "Loss": "log"}
    mc.save(os.path.join(root, "ModelConfig.json"))

    ccs, plan = [], []
    for j in range(N_COLS):
        cc = ColumnConfig(columnNum=j, finalSelect=True)
        bn = cc.columnBinning
        if j < N_NUM:
            mean, std = float(rng.normal(0, 50)), float(rng.uniform(0.5, 20))
            cc.columnName = f"num{j:03d}"
            cuts = np.sort(rng.normal(mean, std, size=N_BINS - 2))
            bn.binBoundary = [float("-inf")] + [float(c) for c in cuts]
            n_val = N_BINS - 1
            plan.append(("num", cc.columnName, mean, std))
        else:
            n_val = int(rng.integers(20, 61))
            cc.columnName = f"cat{j:03d}"
            cc.columnType = ColumnType.C
            bn.binCategory = [f"{cc.columnName}_v{k}" for k in range(n_val)]
            plan.append(("cat", cc.columnName, bn.binCategory, None))
        neg = rng.integers(50, 500, size=n_val + 1)
        pos = rng.integers(5, 100, size=n_val + 1)
        rate = pos / (pos + neg)
        bn.binCountNeg, bn.binCountPos = neg.tolist(), pos.tolist()
        bn.binPosRate = rate.tolist()
        bn.binCountWoe = np.log((pos / pos.sum()) / (neg / neg.sum())).tolist()
        bn.length = n_val + 1
        if j < N_NUM:
            cc.columnStats.mean, cc.columnStats.stdDev = mean, std
        else:
            cc.columnStats.mean = float(rate.mean())
            cc.columnStats.stdDev = float(rate.std())
        ccs.append(cc)
    tag = ColumnConfig(columnNum=N_COLS, columnName="tag",
                       columnType=ColumnType.C, columnFlag=ColumnFlag.Target)
    save_column_configs(ccs + [tag], os.path.join(root, "ColumnConfig.json"))

    write_forest(os.path.join(root, "models"), rng, N_TREES,
                 [c.columnName for c in ccs], init_score=-1.2)
    return {"plan": plan}


def write_forest(models_dir: str, rng, n_trees: int, names,
                 init_score: float) -> None:
    """``models_dir/model0.gbt``: a random GBT forest of ``n_trees``
    depth-DEPTH trees over the plan's columns (``random_forest``)."""
    from shifu_tpu_torch.models.tree import TreeModelSpec, save_model
    from shifu_tpu_torch.ops.tree import TreeArrays
    sf, lm, lv = random_forest(rng, n_trees, DEPTH, N_BINS, N_COLS)
    spec = TreeModelSpec(algorithm="GBT", n_trees=n_trees, depth=DEPTH,
                         n_bins=N_BINS, loss="log", learning_rate=0.1,
                         init_score=init_score,
                         column_nums=list(range(N_COLS)),
                         feature_names=list(names))
    save_model(os.path.join(models_dir, "model0.gbt"), spec,
               [TreeArrays(split_feat=sf[t], left_mask=lm[t],
                           leaf_value=lv[t], depth=DEPTH)
                for t in range(n_trees)])


def make_records(rng, plan, n: int, malformed_at=None) -> list:
    """Raw JSON records: ~5% missing fields, ~1% unparseable numbers,
    ~3% unknown categories, some numbers sent as strings."""
    junk = ["n/a", "1_000", "", "?", "0x1F"]
    recs = []
    for i in range(n):
        rec = {}
        for kind, name, a, b in plan:
            roll = rng.random()
            if roll < 0.05:
                continue
            if kind == "num":
                v = float(rng.normal(a, 1.5 * b))
                rec[name] = junk[int(rng.integers(len(junk)))] \
                    if roll < 0.06 else (repr(v) if roll < 0.2 else v)
            else:
                rec[name] = "zz-unknown" if roll < 0.08 \
                    else a[int(rng.integers(len(a)))]
        recs.append(rec)
    if malformed_at is not None:
        recs[malformed_at] = ["not", "a", "record"]
    return recs


# -------------------------------------------------------- phase: serve
def serve_phase(torch, tq, root: str, plan, rng,
                tol: float = SCORE_TOL, raw_batches=RAW_BATCHES) -> dict:
    """The main path over HTTP on the card, checked against the CPU
    within ``tol``: a forest set walks ``tree_traverse`` (every scored
    batch must launch it) and takes pre-binned requests; an NN set takes
    pre-normalized rows and launches no hand kernel."""
    from shifu_tpu_torch.serve import ServeServer

    t0 = time.perf_counter()
    server = ServeServer(root, device="cuda").start()
    log(f"cuda server up in {time.perf_counter() - t0:.2f} s "
        f"(buckets {server.status()['buckets']})")
    cpu = ServeServer(root, device="cpu")
    httpd, worker, http = serve_front(server)

    def call(path, body=None):
        status, doc, _ = http(path, body)
        if status != 200:
            fail(f"{path}: HTTP {status} {doc}")
        return doc

    requests = [make_records(rng, plan, n, malformed_at=3 if n == 64
                             else None) for n in raw_batches]
    scorer = server.registry.get(server.key)
    t_parse = time.perf_counter()
    # the host half of each raw request, timed alone; the CPU check below
    # scores these parsed rows
    parsed = [scorer.transform.parse_records(r) for r in requests]
    parse_s = time.perf_counter() - t_parse
    prebinned = [(rng.normal(size=(n, scorer.n_features)).astype(
        np.float32), rng.integers(0, N_BINS, size=(n, scorer.n_bins_cols))
        if scorer.needs_bins else None) for n in (5, 100)]
    forests = bool(scorer.scorer.tree_models)
    try:
        batches_before = server.batcher.stats["batches"]
        tq.predict_forest_quant.launches = 0
        t1 = time.perf_counter()
        answers = [call("/score", {"records": r}) for r in requests]
        pre = [call("/score", {"rows": x.tolist()} if b is None else
                    {"rows": x.tolist(), "bins": b.tolist()})
               for x, b in prebinned]
        health = call("/healthz")
        wall = time.perf_counter() - t1
        launches = tq.predict_forest_quant.launches
        batches = server.batcher.stats["batches"] - batches_before
    finally:
        close_front(httpd, worker)
        server.stop()
    log(f"main path: {len(requests)} raw + {len(prebinned)} pre-binned "
        f"requests in {wall:.3f} s, {batches} batches, {launches} "
        f"tree_traverse launches; host record parsing alone takes "
        f"{parse_s:.3f} s of it ({sum(map(len, requests))} records x "
        f"{N_COLS} columns)")
    if forests and (launches < batches or launches == 0):
        fail(f"tree_traverse launched {launches} times for {batches} "
             "scored batches")
    if not (health["state"] == "serving" and health["accepts_raw"]
            and health["device"].startswith("cuda")
            and health["buckets"] == [1, 8, 64, 512]):
        fail(f"unexpected /healthz: {health}")

    worst = 0.0
    cpu_scorer = cpu.registry.get(cpu.key)
    for recs, got, (packed, kept, errors) in zip(requests, answers, parsed):
        if got["errors"] != errors:
            fail(f"errors differ: {got['errors']} vs {errors}")
        want = [None] * len(recs)
        for i, v in zip(kept, cpu_scorer.score_batch_raw(packed)
                        .mean(axis=1)):
            want[int(i)] = float(v)
        for s, w in zip(got["scores"], want):
            if (s is None) != (w is None):
                fail("a null score on one device only")
            if s is not None:
                if not math.isfinite(s) or not 0.0 <= s <= 1000.0:
                    fail(f"score {s} outside [0, 1000]")
                worst = max(worst, abs(s - w))
    malformed = answers[raw_batches.index(64)]
    if malformed["scores"][3] is not None or \
            [e["code"] for e in malformed["errors"]] != ["bad_record"]:
        fail(f"malformed record not rejected alone: {malformed['errors']}")
    for (x, b), got in zip(prebinned, pre):
        want = cpu.score(x, b)
        worst = max(worst, float(np.max(np.abs(
            np.asarray(got["scores"]) - want))))
    if worst > tol:
        fail(f"card vs CPU scores differ by {worst} > {tol}")
    log(f"every score within {worst:.3g} of the CPU path (tolerance "
        f"{tol}); malformed record rejected with its code")
    return {"launches": {"tree_traverse": launches}, "batches": batches,
            "max_abs_score_diff": worst, "wall_s": wall, "parse_s": parse_s}


# --------------------------------------------------- phase: serve plane
PLANE_CLIENTS = 2                          # client threads (a cut)
PLANE_EXTRA_RUNG = 128                     # captured while clients run
PLANE_REFINE_EVERY = 32                    # bucketRefineEvery (batches)
PLANE_SWAP_TREES = 50                      # the swap's forest
# closed-loop requests a (kind, size): a raw record costs ~2 ms of host
# parse, so raw requests get a p50 alone (the smoke's time budget); a p99
# needs P99_MIN_REQUESTS
LATENCY_REQUESTS = {"pre": {1: 100, 64: 100, 512: 100},
                    "raw": {1: 10, 64: 5, 512: 2}}
P99_MIN_REQUESTS = 100
QUALITY_TOL = 1e-9                 # /quality (6 decimals) vs the logged
#                                    scores' AUC rounded as it rounds


def http_caller(port: int):
    """``call(path, body=None, headers=None) -> (status, doc, headers)``
    against 127.0.0.1:``port``; ``body`` is a JSON document or bytes."""
    import urllib.error

    def call(path, body=None, headers=None):
        data = body if body is None or isinstance(body, bytes) \
            else json.dumps(body).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data,
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.load(resp), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e), dict(e.headers)
    return call


def serve_front(server):
    """(stdlib HTTP front-end on 127.0.0.1:0, its thread, its caller)."""
    from http.server import ThreadingHTTPServer

    from shifu_tpu_torch.serve.server import _make_handler
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(server))
    worker = threading.Thread(target=httpd.serve_forever, daemon=True)
    worker.start()
    return httpd, worker, http_caller(httpd.server_address[1])


def close_front(httpd, worker) -> None:
    httpd.shutdown()
    httpd.server_close()
    worker.join(timeout=30)


def serve_plane_phase(torch, tq, root: str, serve_root: str, plan, rng,
                      gpu: str) -> dict:
    """The whole serving plane on the card over HTTP (see module docs,
    step 3): captured rungs, 2 clients, outcomes and live quality, a
    swap / restore / rollback, 429 / 504, brownout, latencies, and each
    rung's replay against its eager function."""
    from shifu_tpu_torch import obs
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.eval.metrics import auc_trapezoid, sweep
    from shifu_tpu_torch.serve import ServeServer, serve_capture_count

    t_phase = time.perf_counter()
    d = os.path.join(root, "serve_plane")
    shutil.copytree(serve_root, d, ignore=shutil.ignore_patterns(
        "serving", "telemetry"))
    d_cpu, d_tight = d + "_cpu", d + "_tight"
    for dst in (d_cpu, d_tight):
        shutil.copytree(d, dst)
    swap_dir = os.path.join(root, "serve_plane_swap", "models")
    write_forest(swap_dir, rng, PLANE_SWAP_TREES,
                 [name for _, name, _, _ in plan], init_score=-0.8)
    # the budget holds every row the phase logs (≈180 MB, the bins of
    # each): past the default 64 MiB the latency requests would prune the
    # load's segments, which the quality check reads after the stop
    props = {"shifu.scorelog.sampleRate": "1.0",
             "shifu.scorelog.budgetBytes": str(1 << 30),
             "shifu.serve.traceSampleRate": "0.1",
             "shifu.serve.bucketRefineEvery": str(PLANE_REFINE_EVERY),
             "shifu.telemetry.heartbeatSeconds": "1"}
    for k, v in props.items():
        environment.set_property(k, v)
    obs.set_enabled(True)
    out: dict = {}
    try:
        cpu = ServeServer(d_cpu, device="cpu", scorelog_sample_rate=0.0)
        # no governor on this server: 4 clients of up to 1,500 records
        # build a queue that would brown it out and stop the score log
        # the quality check reads (brownout is driven on its own below)
        environment.set_property("shifu.serve.brownout", "false")
        t0 = time.perf_counter()
        server = ServeServer(d, device="cuda")
        out["warm_s"] = time.perf_counter() - t0
        environment.set_property("shifu.serve.brownout", "")
        key = server.key
        live = server.registry.get(key)
        warm_buckets = live.buckets
        if live.captures != 2 * len(warm_buckets) or any(
                r.graph is None or r.launches != 1
                for r in live._rungs.values()):
            fail(f"warm captured {live.captures} rungs for ladder "
                 f"{warm_buckets}: every rung of both paths must be a "
                 "graph holding one tree_traverse launch")
        server.start()
        httpd, worker, call = serve_front(server)
        try:
            out.update(plane_load(torch, tq, server, cpu, call, plan, rng,
                                  gpu))
            out.update(plane_swap(torch, server, cpu, call, swap_dir,
                                  d, out.pop("payloads"), gpu))
            out["latency_ms"] = plane_latency(call, server.registry.get(key),
                                              plan, rng, gpu)
            out["rungs"] = plane_rungs(torch, server.registry.get(key),
                                       plan, rng, gpu)
            out["replay_trace"] = replay_trace(
                torch, server.registry.get(key), gpu)
            beat = obs.read_health(obs.health_dir_for(d))
            if not beat or obs.classify(beat[0]) != "live" or not all(
                    k in beat[0] for k in ("queue_depth", "queue_buildup",
                                           "slo", "mode", "quality")):
                fail(f"no live SERVE heartbeat with the serve extras: "
                     f"{beat}")
        finally:
            close_front(httpd, worker)
            server.stop()
        out.update(plane_overload(d_tight, plan, rng))
        out.update(plane_quality_logged(d, out.pop("joined"),
                                        out["quality"], auc_trapezoid,
                                        sweep))
    finally:
        for k in list(props) + ["shifu.serve.maxQueueRows",
                                "shifu.serve.requestDeadlineMs",
                                "shifu.serve.brownout"]:
            environment.set_property(k, "")
        obs.set_enabled(None)
    if serve_capture_count() != 0:
        fail(f"serve_capture_count() = {serve_capture_count()} after the "
             "serve plane phase")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"serve plane: {out['batches']} batches, {out['launches']} "
        f"tree_traverse launches by graph replays, captures {out['captures']}, swap "
        f"prepare {out['swap']['prepare_s']:.3f} s; phase "
        f"{out['wall_s']:.1f} s — [{gpu}]")
    return out


def plane_load(torch, tq, server, cpu, call, plan, rng, gpu) -> dict:
    """PLANE_CLIENTS client threads of raw and pre-binned batches over
    HTTP, a rung
    captured while they run; capture count, B4 replays and every score
    against the CPU server."""
    from shifu_tpu_torch.serve import serve_capture_count
    live = server.registry.get(server.key)
    raw = {n: make_records(rng, plan, n) for n in RAW_BATCHES}
    pre = {n: (rng.normal(size=(n, live.n_features)).astype(np.float32),
               rng.integers(0, N_BINS, size=(n, live.n_bins_cols))
               .astype(np.int32)) for n in RAW_BATCHES}
    bodies = {}
    for n in RAW_BATCHES:
        bodies["raw", n] = json.dumps({"records": raw[n]}).encode()
        bodies["pre", n] = json.dumps({"rows": pre[n][0].tolist(),
                                       "bins": pre[n][1].tolist()}).encode()
    results, lock = [], threading.Lock()

    def client(ci):
        # every size once a client, raw and pre-binned in turns: the two
        # clients send each (kind, size) once
        for si, n in enumerate(RAW_BATCHES):
            kind = ("raw", "pre")[(ci + si) % 2]
            req = f"c{ci}{kind}{n}"
            got = call("/score", bodies[kind, n], {"X-Shifu-Request": req})
            with lock:
                results.append((req, ci, kind, n) + got[:2])

    warm_captures, warm_buckets = live.captures, live.buckets
    batches0 = server.batcher.stats["batches"]
    counts0 = (live.replays, live.replayed_launches, live.warm_launches)
    tq.predict_forest_quant.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(PLANE_CLIENTS)]
    for t in threads:
        t.start()
    added = live.extend_buckets([PLANE_EXTRA_RUNG])   # beside the replays
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    batches = server.batcher.stats["batches"] - batches0
    for _ in range(100):                    # a refinement still capturing
        if not server.batcher._refining:
            break
        time.sleep(0.05)
    launches = tq.predict_forest_quant.launches
    replays, replayed, warm_launches = (
        now - then for now, then in zip(
            (live.replays, live.replayed_launches, live.warm_launches),
            counts0))
    rungs_added = len(live.buckets) - len(warm_buckets)
    if added != 1 or PLANE_EXTRA_RUNG not in live.buckets:
        fail(f"extend_buckets added {added} rungs: {live.buckets}")
    if live.captures != warm_captures + 2 * rungs_added or \
            serve_capture_count() != 0:
        fail(f"captures {live.captures} after warm {warm_captures} and "
             f"{rungs_added} added rungs; serve_capture_count() = "
             f"{serve_capture_count()}")
    if launches != replayed + warm_launches or replayed != replays or \
            any(r.launches != 1 for r in live._rungs.values()) or \
            replays < batches or batches == 0:
        fail(f"tree_traverse launched {launches} times: {replayed} by "
             f"{replays} graph replays, {warm_launches} by the new rungs' "
             f"warm-ups; {batches} scored batches")
    worst = 0.0
    want = {}
    cpu_scorer = cpu.registry.get(cpu.key)
    for n in RAW_BATCHES:          # the host parse once, scored on the CPU
        packed = live.transform.parse_records(raw[n])[0]
        want["raw", n] = cpu_scorer.score_batch_raw(packed).mean(axis=1)
        want["pre", n] = cpu_scorer.score_batch(*pre[n]).mean(axis=1)
    for req, _, kind, n, status, doc in results:
        if status != 200 or (kind == "raw" and doc["errors"]):
            fail(f"request {req}: {status} {doc.get('error', doc)}")
        if doc.get("req") != req:
            fail(f"request {req} answered for {doc.get('req')}")
        worst = max(worst, float(np.max(np.abs(
            np.asarray(doc["scores"]) - want[kind, n]))))
    if worst > SCORE_TOL:
        fail(f"serve plane: card vs CPU scores differ by {worst}")
    log(f"serve plane load: {len(results)} requests from {PLANE_CLIENTS} "
        f"clients in {wall:.3f} s, {batches} batches, {replays} graph "
        f"replays running {replayed} tree_traverse launches (+ "
        f"{warm_launches} by the new rungs' eager warm-ups), ladder "
        f"{list(live.buckets)} (captures "
        f"{warm_captures} at warm, {live.captures} now, "
        f"serve_capture_count 0); scores within {worst:.3g} of the CPU "
        f"— [{gpu}]")
    # the generator's labels: Bernoulli(p = the CPU score / 1000), for
    # requests that keep the joined window under the monitor's 4,096 rows
    lab_rng = np.random.default_rng(rng.integers(1 << 30))
    joined = {}
    for req, ci, kind, n, _, _ in sorted(results):
        if (ci < 2 and n <= 512) or (ci == 2 and n == 1500):
            joined[req] = (lab_rng.random(n) < want[kind, n] / 1000.0
                           ).astype(float).tolist()
    status, doc, _ = call("/outcome", {"outcomes": [
        {"req": r, "labels": lab} for r, lab in joined.items()]})
    rows = sum(len(v) for v in joined.values())
    if status != 200 or doc["joined_rows"] != rows or doc["late"]:
        fail(f"/outcome joined {doc} of {rows} rows")
    status, quality, _ = call("/quality")
    if status != 200 or quality["joined"] != rows \
            or quality["live_auc"] is None:
        fail(f"/quality after {rows} joined rows: {quality}")
    return {"launches": replayed, "warm_launches": warm_launches,
            "replays": replays, "batches": batches, "wall_s": wall,
            "captures": {"warm": warm_captures, "after_load": live.captures,
                         "rungs_added": rungs_added},
            "max_abs_score_diff": worst, "joined": joined,
            "quality": quality,
            "payloads": {"raw64": raw[64], "pre333": pre[333]}}


def plane_swap(torch, server, cpu, call, swap_dir, d, payloads,
               gpu) -> dict:
    """/swap prepare (captures) and commit (none) to the 50-tree forest,
    its scores against the CPU, the journal restored by a fresh registry,
    then a rollback to the bit-identical incumbent."""
    from shifu_tpu_torch.eval.scorer import load_models
    from shifu_tpu_torch.serve import ServeServer, serve_capture_count
    from shifu_tpu_torch.serve.registry import ModelRegistry
    key = server.key
    old = server.registry.get(key)
    packed = old.transform.parse_records(payloads["raw64"])[0]
    x, bins = payloads["pre333"]
    before = (old.score_batch_raw(packed), old.score_batch(x, bins))
    t0 = time.perf_counter()
    status, prep, _ = call("/swap", {"phase": "prepare", "dir": swap_dir})
    prepare_s = time.perf_counter() - t0
    pend = server.registry._pending.get(key)
    if status != 200 or pend is None or prep["prepared_generation"] != 1 \
            or pend.scorer.captures != 2 * len(pend.scorer.buckets):
        fail(f"/swap prepare: {status} {prep}")
    status, com, _ = call("/swap", {"phase": "commit"})
    live = server.registry.get(key)
    if status != 200 or com["generation"] != 1 or live is not pend.scorer:
        fail(f"/swap commit: {status} {com}")
    captures = live.captures
    bins = bins[:, :live.n_bins_cols]
    status, a, _ = call("/score", {"records": payloads["raw64"]})
    status2, b, _ = call("/score", {"rows": x.tolist(),
                                    "bins": bins.tolist()})
    cpu50 = ServeServer(cpu.model_set_dir, models=load_models(swap_dir),
                        key="swap", device="cpu", scorelog_sample_rate=0.0)
    worst = max(
        float(np.max(np.abs(np.asarray(a["scores"])
                            - np.asarray(cpu50.score_raw(
                                payloads["raw64"])["scores"])))),
        float(np.max(np.abs(np.asarray(b["scores"]) - cpu50.score(x, bins)))))
    if status != 200 or status2 != 200 or a["generation"] != 1 \
            or worst > SCORE_TOL or live.captures != captures \
            or serve_capture_count() != 0:
        fail(f"after the commit: {status}/{status2}, generation "
             f"{a.get('generation')}, scores within {worst}, captures "
             f"{captures} -> {live.captures}")
    fresh = ModelRegistry(state_dir=os.path.join(d, "serving"),
                          device="cuda")
    fresh.restore(key, os.path.join(d, "models"), buckets=live.buckets,
                  transform=server.transform)
    hist = [(h["generation"], h["models_dir"])
            for h in fresh.generation_history(key)]
    restored = fresh.get(key).score_batch_raw(packed)
    if fresh.generation(key) != 1 or \
            hist != [(0, os.path.join(d, "models"))] or \
            not np.array_equal(restored, live.score_batch_raw(packed)):
        fail(f"journal restored at generation {fresh.generation(key)} "
             f"with history {hist}")
    server.registry.rollback(key)
    back = server.registry.get(key)
    x, bins = payloads["pre333"]
    del fresh
    if back is not old or server.registry.generation(key) != 0 or not (
            np.array_equal(back.score_batch_raw(packed), before[0])
            and np.array_equal(back.score_batch(x, bins), before[1])):
        fail("rollback did not restore the incumbent bit for bit")
    log(f"swap to {PLANE_SWAP_TREES} trees: prepare {prepare_s:.3f} s "
        f"({pend.scorer.captures} captures), commit 0 captures, scores "
        f"within {worst:.3g} of the CPU; journal restored at generation 1 "
        f"by a fresh registry; rollback bit-identical — [{gpu}]")
    return {"swap": {"prepare_s": prepare_s,
                     "prepare_captures": pend.scorer.captures,
                     "max_abs_score_diff": worst}}


def plane_overload(d_tight, plan, rng) -> dict:
    """429 over a small maxQueueRows, 504 under a tiny requestDeadlineMs
    (a second server on the card), and brownout flipped and back."""
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.serve import ServeServer
    environment.set_property("shifu.serve.maxQueueRows", "64")
    environment.set_property("shifu.serve.requestDeadlineMs", "0.001")
    tight = ServeServer(d_tight, device="cuda", key="tight",
                        scorelog_sample_rate=0.0)
    environment.set_property("shifu.serve.maxQueueRows", "")
    environment.set_property("shifu.serve.requestDeadlineMs", "")
    sc = tight.registry.get("tight")
    recs = make_records(rng, plan, 7)
    httpd, worker, call = serve_front(tight)
    try:
        b = tight.batcher
        b.submit_burst(np.zeros((64, sc.n_features), np.float32),
                       np.zeros((64, sc.n_bins_cols), np.int32))
        s429, d429, h429 = call("/score", {"records": recs})
        if s429 != 429 or d429.get("error") != "overloaded" \
                or not d429.get("retry_after_ms", 0) > 0 \
                or int(h429.get("Retry-After", 0)) < 1:
            fail(f"expected a coded 429: {s429} {d429} {h429}")
        b.drain()
        delay0 = b.max_delay_s
        b.submit_burst(np.zeros((4 * 512 + 1, sc.n_features), np.float32),
                       np.zeros((4 * 512 + 1, sc.n_bins_cols), np.int32))
        modes = [tight.check_brownout(), tight.check_brownout()]
        shrunk = b.max_delay_s
        b.drain()
        modes += [tight.check_brownout() for _ in range(3)]
        if modes != ["normal", "brownout", "brownout", "brownout",
                     "normal"] or not shrunk < delay0 == b.max_delay_s:
            fail(f"brownout modes {modes}, flush deadline {delay0} -> "
                 f"{shrunk} -> {b.max_delay_s}")
        tight.start()
        s504, d504, _ = call("/score", {"records": recs})
        if s504 != 504 or d504.get("error") != "deadline_exceeded":
            fail(f"expected a coded 504: {s504} {d504}")
    finally:
        close_front(httpd, worker)
        tight.stop()
    log(f"overload: 429 {d429} (Retry-After {h429.get('Retry-After')}), "
        f"504 {d504['error']}; brownout {modes}")
    return {"overload": {"429": d429, "504": d504["error"],
                         "brownout": modes}}


def plane_quality_logged(d, joined, quality, auc_trapezoid, sweep) -> dict:
    """/quality's live AUC against the AUC of the logged scores of the
    joined requests (the committed score-log segments after stop), and
    the trace and metrics the stopped server left."""
    from shifu_tpu_torch import obs
    recs = obs.read_score_records(obs.scorelog_dir(d))
    by_req = {}
    for r in recs:
        if r["req"] in joined:
            by_req.setdefault(r["req"], []).extend(r["scores"])
    if set(by_req) != set(joined):
        fail(f"score log holds {len(by_req)} of {len(joined)} joined "
             "requests")
    s = np.concatenate([by_req[r] for r in joined])
    y = np.concatenate([joined[r] for r in joined])
    c = sweep(s, y)
    logged = float(auc_trapezoid(c.fp / max(c.neg_total, 1e-12),
                                 c.tp / max(c.pos_total, 1e-12)))
    diff = abs(round(logged, 6) - quality["live_auc"])
    if diff > QUALITY_TOL:
        fail(f"/quality live AUC {quality['live_auc']} vs the logged "
             f"scores' {logged}")
    trace = os.path.join(d, "telemetry", "trace.jsonl")
    spans = [json.loads(line) for line in open(trace)]
    n_req = sum(1 for r in spans if r.get("name") == "serve.request")
    if not n_req or not os.path.isfile(os.path.join(
            d, "telemetry", "metrics.prom")):
        fail("the stopped server left no serve.request span or no "
             "metrics.prom")
    log(f"quality: live AUC {quality['live_auc']:.6f} over "
        f"{quality['joined']} joined rows = the logged scores' AUC "
        f"{logged:.6f} (diff {diff:.3g}); {len(recs)} logged records, "
        f"{n_req} sampled serve.request spans")
    return {"live_auc": quality["live_auc"], "logged_auc": logged,
            "logged_records": len(recs), "request_spans": n_req}


def plane_latency(call, scorer, plan, rng, gpu) -> dict:
    """Closed-loop request latency over HTTP (one client, sequential) at
    1, 64 and 512 records, raw and pre-binned: ``LATENCY_REQUESTS``
    requests a kind and size, p50 in ms, and p99 where at least
    ``P99_MIN_REQUESTS`` requests back it (else None)."""
    out = {}
    for n in (1, 64, 512):
        bodies = {
            "raw": json.dumps({"records": make_records(rng, plan, n)}
                              ).encode(),
            "pre": json.dumps({
                "rows": np.zeros((n, scorer.n_features)).tolist(),
                "bins": rng.integers(0, N_BINS,
                                     size=(n, scorer.n_bins_cols)).tolist()
            }).encode()}
        for kind, body in bodies.items():
            count = LATENCY_REQUESTS[kind][n]
            ms = []
            for _ in range(count):
                t0 = time.perf_counter()
                status, doc, _ = call("/score", body)
                ms.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    fail(f"latency request: {status} {doc}")
            p50 = float(np.percentile(ms, 50))
            p99 = float(np.percentile(ms, 99)) \
                if count >= P99_MIN_REQUESTS else None
            out[f"{kind}_{n}"] = {"requests": count, "p50": p50, "p99": p99}
            tail = f"p99 {p99:.3f} ms" if p99 is not None \
                else f"no p99 (under {P99_MIN_REQUESTS} requests)"
            log(f"closed-loop {kind} {n} records: p50 {p50:.3f} ms, {tail} "
                f"over {count} requests — [{gpu}]")
    return out


def replay_trace(torch, scorer, gpu) -> dict:
    """One replay of the pre-binned rung of 64 under ``torch.profiler``:
    the device kernels the graph ran must include its ``tree_traverse``
    launches (the kernel's count adds a graph's launches at each replay
    on the host; this is the device's own record of one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rung = scorer._rungs[(False, 64)]
    with rung.lock, profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
        rung.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    walks = [n for n in names if "forest_walk_kernel" in n
             or "tree_traverse_kernel" in n]
    if len(walks) != rung.launches:
        fail(f"a replay of the rung of 64 ran {len(walks)} tree_traverse "
             f"kernels (its capture recorded {rung.launches}); the device "
             f"ran {len(names)} ops: {sorted(set(names))[:8]}")
    log(f"torch.profiler over one replay of the rung of 64: {len(names)} "
        f"device ops, {len(walks)} of them the tree_traverse kernel "
        f"({walks[0][:60]}) — [{gpu}]")
    return {"device_ops": len(names), "tree_traverse": len(walks)}


def plane_rungs(torch, scorer, plan, rng, gpu) -> dict:
    """Each rung's replay against its eager function: bit-equal scores
    from a full rung of data, and the device time of one replay and of
    one eager launch of the same function on the rung's inputs."""
    packed_all = scorer.transform.parse_records(
        make_records(rng, plan, scorer.buckets[-1]))[0]
    out = {}
    for b in scorer.buckets:
        x = rng.normal(size=(b, scorer.n_features)).astype(np.float32)
        bins = rng.integers(0, N_BINS, size=(b, scorer.n_bins_cols)
                            ).astype(np.int32)
        for raw, arrays in ((False, [x, bins]), (True, [packed_all[:b]])):
            got = scorer.score_batch_raw(arrays[0]) if raw \
                else scorer.score_batch(*arrays)
            if not np.array_equal(got, scorer.eager_batch(arrays, raw=raw)):
                fail(f"rung {b} ({'raw' if raw else 'pre-binned'}): the "
                     "replay differs from the eager launch")
            rung = scorer._rungs[(raw, b)]
            fn = scorer._raw_fn if raw else scorer._fn
            with torch.no_grad():
                replay = device_ms(torch, rung.graph.replay)
                eager = device_ms(torch, lambda: fn(*rung.inputs))
            name = f"{'raw' if raw else 'pre'}_{b}"
            out[name] = {"replay_ms": replay, "eager_ms": eager}
            log(f"rung {name}: replay {replay:.4f} ms, eager "
                f"{eager:.4f} ms on the device, bit-equal — [{gpu}]")
    return out


# ---------------------------------------------------- phase: the fleet
FLEET_REPLICAS = 2
FLEET_CLIENTS = 2                          # client threads during a swap
FLEET_BATCH = 512                          # rows of a throughput request
FLEET_LOAD_S = 1.0                         # seconds of each rows/s window
FLEET_START_S = 240.0                      # router + workers' start limit
FLEET_DEVICE = "cuda"                      # the workers' --device
# the workers' SLO objective: the default (2 x the 2 ms flush deadline)
# burns under 512-row requests and the router drains a burning replica,
# so the load would stall on drains rather than measure the fleet
FLEET_SLO = "-Dshifu.serve.sloP99Ms=1000"


def start_fleet(d: str, log_path: str):
    """``python -m shifu_tpu_torch.cli --dir d serve --replicas 2 --port
    0 --device cuda`` as a user starts it; returns (process, router
    port) once the router prints its address.  Its output (and its
    workers') goes to
    ``log_path``."""
    out = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "shifu_tpu_torch.cli", FLEET_SLO, "--dir",
         d, "serve",
         "--replicas", str(FLEET_REPLICAS), "--port", "0", "--device",
         FLEET_DEVICE],
        stdout=out, stderr=subprocess.STDOUT)
    out.close()
    deadline = time.monotonic() + FLEET_START_S
    pat = re.compile(r"serve fleet: (\d+) replica\(s\) on "
                     r"http://127\.0\.0\.1:(\d+) on (\S+)")
    while time.monotonic() < deadline:
        with open(log_path) as f:
            m = pat.search(f.read())
        if m:
            if int(m.group(1)) != FLEET_REPLICAS or \
                    m.group(3) != FLEET_DEVICE:
                stop_fleet(proc)
                fail(f"fleet started as {m.group(0)!r}")
            return proc, int(m.group(2))
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    stop_fleet(proc)
    with open(log_path) as f:
        tail = f.read()[-4000:]
    fail(f"the fleet did not start (rc {proc.returncode}):\n{tail}")


def stop_fleet(proc) -> None:
    """SIGINT the router (it stops its workers), then make sure."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    # a zombie child of the router counts as gone
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def fleet_load(call, body, clients: int, seconds: float):
    """``clients`` threads POST ``body`` to /score for ``seconds``;
    returns (records of (t0, t1, status, doc), rows/s of the rows answered
    200)."""
    recs, lock, stop = [], threading.Lock(), threading.Event()
    n_rows = len(body["bins"])

    def run():
        while not stop.is_set():
            t0 = time.monotonic()
            status, doc, _ = call("/score", body)
            with lock:
                recs.append((t0, time.monotonic(), status, doc))

    threads = [threading.Thread(target=run, daemon=True)
               for _ in range(clients)]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
        if t.is_alive():
            fail("a fleet client hung")
    wall = time.monotonic() - t_start
    ok = [r for r in recs if r[2] == 200]
    return recs, len(ok) * n_rows / wall


def fleet_phase(torch, root: str, serve_root: str, plan, rng,
                gpu: str) -> dict:
    """The serving fleet through the entry point a user calls: ``serve
    --replicas 2 --port 0`` over the serve phase's set (100 trees of depth
    7 on 224 numeric + 32 categorical columns), every replica a process of
    its own on the card.  Raw and pre-binned batches through the router
    within SCORE_TOL of the set on the CPU; every replica at 0 forced
    captures with its B4 launches and replays read from its own /healthz;
    a coordinated /swap to a 50-tree forest and back under FLEET_CLIENTS
    clients, every answer scored by one generation's forest and no
    request that started after another finished scored by an older
    generation; aggregate pre-binned rows/s with 2 replicas, then a
    SIGKILL of r0 (its pid from its announce file) under load, every
    request answered, r0 buried in the router's /status, and rows/s with
    the 1 replica left; the router's SIGINT stops every worker."""
    import signal

    from shifu_tpu_torch.serve import ServeServer
    d = os.path.join(root, "fleet")
    shutil.copytree(serve_root, d, ignore=shutil.ignore_patterns(
        "serving", "telemetry"))
    swap_dir = os.path.join(root, "fleet_models50")
    write_forest(swap_dir, rng, PLANE_SWAP_TREES,
                 [p[1] for p in plan], init_score=-0.7)
    cpu = ServeServer(d, device="cpu")
    cpu_swap = ServeServer(d, device="cpu", models=swap_dir, key="s50")
    sc = cpu.registry.get(cpu.key)
    records = {n: make_records(rng, plan, n) for n in (1, 64)}
    pre = {n: (rng.normal(size=(n, sc.n_features)).astype(np.float32),
               rng.integers(0, N_BINS, size=(n, sc.n_bins_cols)))
           for n in (1, 64, FLEET_BATCH)}
    body = {n: {"rows": x.tolist(), "bins": b.tolist()}
            for n, (x, b) in pre.items()}
    want = {("pre", n): cpu.score(x, b) for n, (x, b) in pre.items()}
    want50 = {n: cpu_swap.score(x, b) for n, (x, b) in pre.items()}
    for n, recs in records.items():
        packed, kept, _ = sc.transform.parse_records(recs)
        w = [None] * n
        for i, v in zip(kept, sc.score_batch_raw(packed).mean(axis=1)):
            w[int(i)] = float(v)
        want[("raw", n)] = w
    log_path = os.path.join(root, "fleet.log")
    t0 = time.perf_counter()
    proc, port = start_fleet(d, log_path)
    start_s = time.perf_counter() - t0
    call = http_caller(port)
    worst = 0.0

    def check(got, w, where):
        nonlocal worst
        for s, v in zip(got["scores"], w):
            if (s is None) != (v is None):
                fail(f"fleet {where}: a null score on one side only")
            if s is not None:
                worst = max(worst, abs(s - v))
        if worst > SCORE_TOL:
            fail(f"fleet {where}: card vs CPU scores differ by {worst}")

    try:
        fdir = os.path.join(d, "serving", "fleet")
        ann = {}
        for i in range(FLEET_REPLICAS):
            with open(os.path.join(fdir, f"r{i}.json")) as f:
                ann[f"r{i}"] = json.load(f)

        def replica(name):
            status, doc, _ = http_caller(ann[name]["port"])("/healthz")
            if status != 200:
                fail(f"replica {name} /healthz: HTTP {status}")
            return doc

        status, fleet0, _ = call("/status")
        if status != 200 or fleet0["up"] != FLEET_REPLICAS or \
                not fleet0["accepts_raw"]:
            fail(f"fleet /status after start: {fleet0}")
        warm = {n: replica(n)["graphs"] for n in ann}
        for name, g in warm.items():
            if g["captures_forced"] or g["replays"] or \
                    g["tree_traverse_launches"] != g["warm_launches"]:
                fail(f"replica {name} after warm: {g}")
        # raw and pre-binned batches through the router
        t1 = time.perf_counter()
        for _ in range(2):
            for n, recs in records.items():
                status, got, _ = call("/score", {"records": recs})
                if status != 200:
                    fail(f"fleet raw {n}: HTTP {status} {got}")
                check(got, want[("raw", n)], f"raw {n}")
            for n in pre:
                status, got, _ = call("/score", body[n])
                if status != 200:
                    fail(f"fleet pre-binned {n}: HTTP {status} {got}")
                check(got, want[("pre", n)], f"pre-binned {n}")
        batches_s = time.perf_counter() - t1
        # a coordinated swap to 50 trees and back under load
        swap_recs, lock, stop = [], threading.Lock(), threading.Event()

        def pound():
            while not stop.is_set():
                t_a = time.monotonic()
                status, got, _ = call("/score", body[64])
                with lock:
                    swap_recs.append((t_a, time.monotonic(), status, got))

        threads = [threading.Thread(target=pound, daemon=True)
                   for _ in range(FLEET_CLIENTS)]
        def answered(gen):                 # wait for an answer of ``gen``
            deadline = time.monotonic() + 30.0
            while not any(r[3].get("generation") == gen
                          for r in list(swap_recs)):
                if time.monotonic() > deadline:
                    fail(f"no answer of generation {gen} during the swaps")
                time.sleep(0.05)

        for t in threads:
            t.start()
        answered(0)
        swaps = []
        for gen, target in enumerate((swap_dir, os.path.join(d, "models"))):
            t2 = time.perf_counter()
            status, doc, _ = call("/swap", {"dir": target})
            if status != 200 or sorted(doc["committed"]) != sorted(ann) \
                    or doc.get("errors"):
                fail(f"fleet /swap to {target}: HTTP {status} {doc}")
            swaps.append(time.perf_counter() - t2)
            answered(gen + 1)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        gens = sorted({r[3].get("generation") for r in swap_recs})
        if any(r[2] != 200 for r in swap_recs) or gens != [0, 1, 2]:
            fail(f"swap under load: statuses "
                 f"{sorted({r[2] for r in swap_recs})}, generations {gens}")
        forest = {0: want[("pre", 64)], 1: want50[64], 2: want[("pre", 64)]}
        for _, _, _, got in swap_recs:
            check(got, forest[got["generation"]],
                  f"swap generation {got['generation']}")
        ends = sorted((r[1], r[3]["generation"]) for r in swap_recs)
        mixed = 0
        for t_a, _, _, got in swap_recs:
            finished_before = [g for t_b, g in ends if t_b < t_a]
            if finished_before and max(finished_before) > got["generation"]:
                mixed += 1
        if mixed:
            fail(f"{mixed} responses scored by an older generation after a "
                 "newer one answered")
        # aggregate rows/s: 2 replicas, then r0 SIGKILLed under load
        recs2, rows_s2 = fleet_load(call, body[FLEET_BATCH], 2 *
                                    FLEET_REPLICAS, FLEET_LOAD_S)
        before_kill = {n: replica(n)["graphs"] for n in ann}
        killer = threading.Timer(
            0.3, os.kill, (ann["r0"]["pid"], signal.SIGKILL))
        killer.start()
        kill_recs, _ = fleet_load(call, body[64], FLEET_CLIENTS, 1.8)
        killer.join()
        bad = [(r[2], r[3]) for r in kill_recs if r[2] != 200]
        if bad or len(kill_recs) < 2:
            fail(f"across the SIGKILL {len(bad)} of {len(kill_recs)} "
                 f"requests were not answered: {bad[:2]}")
        for r in kill_recs:
            check(r[3], want[("pre", 64)], "across the SIGKILL")
        deadline = time.monotonic() + 15.0
        while True:
            _, st, _ = call("/status")
            states = {r["name"]: r["state"] for r in st["replicas"]}
            if states["r0"] == "dead":
                break
            if time.monotonic() > deadline:
                fail(f"r0 not buried after the SIGKILL: {states}")
            time.sleep(0.2)
        if states["r1"] != "up" or st["up"] != 1:
            fail(f"after the SIGKILL the fleet is {st}")
        recs1, rows_s1 = fleet_load(call, body[FLEET_BATCH], 2,
                                    FLEET_LOAD_S)
        for recs in (recs2, recs1):
            if any(r[2] != 200 for r in recs):
                fail("a throughput request was not answered 200")
            for r in recs[:4]:
                check(r[3], want[("pre", FLEET_BATCH)], "throughput")
        after = replica("r1")["graphs"]
    finally:
        stop_fleet(proc)
    graphs = {"r0": before_kill["r0"], "r1": after}
    for name, g in graphs.items():
        if g["captures_forced"] or g["replays"] == 0 or \
                g["replayed_launches"] != g["replays"] or \
                g["tree_traverse_launches"] != g["warm_launches"] + \
                g["replayed_launches"]:
            fail(f"replica {name}'s B4 counts do not add up: {g}")
    per_replica = {n: (g["tree_traverse_launches"], g["replays"])
                   for n, g in graphs.items()}
    left = [n for n, a in ann.items() if pid_alive(a["pid"])]
    if proc.returncode != 0 or left:
        fail(f"the router exited {proc.returncode}; workers left {left}")
    log(f"fleet: {FLEET_REPLICAS} replicas up in {start_s:.2f} s; raw and "
        f"pre-binned batches in {batches_s:.3f} s within {worst:.3g} of the "
        f"CPU; swaps to {PLANE_SWAP_TREES} trees and back in "
        f"{swaps[0]:.3f} / {swaps[1]:.3f} s under {FLEET_CLIENTS} clients "
        f"({len(swap_recs)} requests, generations {gens}, none mixed); "
        f"{len(kill_recs)} requests across r0's SIGKILL all answered; "
        f"pre-binned {FLEET_BATCH}-row rows/s: {rows_s2:.0f} with 2 "
        f"replicas, {rows_s1:.0f} with 1; B4 (launches, replays) per "
        f"replica {per_replica}; 0 captures forced — [{gpu}]")
    return {"launches": {n: g["tree_traverse_launches"]
                         for n, g in graphs.items()},
            "replays": {n: g["replays"] for n, g in graphs.items()},
            "warm_launches": {n: g["warm_launches"]
                              for n, g in graphs.items()},
            "rows_per_s": {"2": rows_s2, "1": rows_s1},
            "swap_s": swaps, "start_s": start_s,
            "max_abs_score_diff": worst}


# ------------------------------------------------------- phase: train
def train_plane(rng, plan, n: int, on_card: bool = True):
    """The training plane of the serving column plan: bins [n, 256] uint8,
    each column uniform over its value bins and its missing bin; y drawn
    from a logit on N_INFORMATIVE columns (numeric: a linear trend over
    the bins, categorical: a random effect per category); integer weights
    1..3.  Drawn on the card by a generator seeded from ``rng`` (a host
    draw of 1,048,576 rows takes seconds), or with ``rng`` on the host
    (``on_card=False``: the out-of-core plane, whose first rows are
    ``stream_cut_phase``'s card-vs-CPU data).  Returns (bins, y, w,
    informative column ids, categorical mask)."""
    is_cat = np.array([kind == "cat" for kind, _, _, _ in plan])
    n_bins = [len(a) + 1 if kind == "cat" else N_BINS
              for kind, _, a, _ in plan]
    if not on_card:
        bins = rng.integers(0, N_BINS, size=(n, N_COLS), dtype=np.uint8)
        for j in np.flatnonzero(is_cat):
            bins[:, j] = rng.integers(0, n_bins[j], size=n, dtype=np.uint8)
    else:
        import torch
        gen = torch.Generator(device="cuda")
        gen.manual_seed(int(rng.integers(1 << 62)))
        # u in [0, 1) times a column's bin count, truncated: uniform
        hi = torch.tensor(n_bins, dtype=torch.float32, device="cuda")
        on = torch.empty((n, N_COLS), dtype=torch.uint8, device="cuda")
        for r0 in range(0, n, 1 << 20):
            u = torch.rand((min(n, r0 + (1 << 20)) - r0, N_COLS),
                           generator=gen, device="cuda")
            on[r0:r0 + len(u)] = (u * hi).to(torch.uint8)
        bins = on.cpu().numpy()
    informative = np.sort(rng.choice(N_COLS, size=N_INFORMATIVE,
                                     replace=False))
    logit = np.full(n, -1.0, np.float32)
    for j in informative:
        if is_cat[j]:
            effect = rng.normal(0.0, 1.2, size=n_bins[j])
        else:
            effect = rng.choice([-1.0, 1.0]) * rng.uniform(0.6, 2.0) \
                * np.linspace(-1.0, 1.0, N_BINS)
        logit += effect.astype(np.float32)[bins[:, j]]
    y = (rng.random(n, np.float32) < 1.0 / (1.0 + np.exp(-logit))) \
        .astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    return bins, y, w, informative, is_cat


def write_plane(clean: str, bins, y, w, names, sig,
                shard: int = 1 << 18) -> None:
    """The norm step's clean output as the port's ``WireWriter`` writes
    it: the wire plane in shards of ``shard`` rows, and ``schema.json``."""
    from shifu_tpu_torch.data.spill import WireWriter, wire_dir
    from shifu_tpu_torch.ioutil import atomic_write_json
    keys = ("bins", "y", "w")
    ww = WireWriter(wire_dir(clean, keys), keys,
                    {"bins": np.uint8, "y": np.float32, "w": np.float32},
                    {"bins": (bins.shape[1],)}, sig)
    rows = []
    for r0 in range(0, len(y), shard):
        ww.append({"bins": bins[r0:r0 + shard], "y": y[r0:r0 + shard],
                   "w": w[r0:r0 + shard]})
        rows.append(min(shard, len(y) - r0))
    ww.finish()
    atomic_write_json(os.path.join(clean, "schema.json"), {
        "outputNames": names, "columnNums": list(range(len(names))),
        "columnNames": names, "normType": "ZSCALE", "numShards": len(rows),
        "numRows": len(y), "shardRows": rows, "binsDtype": "uint8",
        "width": len(names), "wire": True, "wireKeys": list(keys),
        "wireSignature": sig})


def set_train_params(d: str, params: dict) -> None:
    from shifu_tpu_torch.config import ModelConfig
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.params = dict(params)
    mc.save(path)


def write_train_set(d: str, serve_root: str, params: dict, clean: str,
                    algorithm: str = "GBT",
                    plane_dir: str = "CleanedData") -> str:
    """A model set for ``train``: the serving set's ModelConfig and
    ColumnConfig with the given algorithm, train#params and validSetRate
    0.2, its ``tmp/<plane_dir>`` a link to the plane ``clean``."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    os.makedirs(os.path.join(d, "tmp"))
    shutil.copy(os.path.join(serve_root, "ColumnConfig.json"), d)
    mc = ModelConfig.load(os.path.join(serve_root, "ModelConfig.json"))
    mc.basic.name = os.path.basename(d)
    mc.dataSet.dataPath = os.path.join(d, "data.csv")   # norm's input
    mc.train.algorithm = Algorithm[algorithm]
    mc.train.validSetRate = 0.2
    mc.save(os.path.join(d, "ModelConfig.json"))
    set_train_params(d, params)
    os.symlink(clean, os.path.join(d, "tmp", plane_dir))
    return d


def train_cli(d: str, device: str, *extra: str) -> float:
    """``train`` through the CLI a user calls; returns its wall seconds."""
    from shifu_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(["--dir", d, "train", *extra, "--device", device])
    if rc != 0:
        fail(f"train {' '.join(extra)} on {device} exited {rc} in {d}")
    return time.perf_counter() - t0


def load_forest(d: str, kind: str = "gbt"):
    from shifu_tpu_torch.models.tree import load_model
    return load_model(os.path.join(d, "models", f"model0.{kind}"))


def progress_errors(d: str) -> np.ndarray:
    """[trees, 2] (train, validation) errors from ``tmp/train.progress``."""
    with open(os.path.join(d, "tmp", "train.progress")) as f:
        return np.array([[float(a), float(b)] for a, b in re.findall(
            r"Train Error: (\S+) Validation Error: (\S+)", f.read())])


def auc(score: np.ndarray, y: np.ndarray) -> float:
    """Rank AUC with ties at their mean rank."""
    _, inv, cnt = np.unique(score, return_inverse=True, return_counts=True)
    rank = (np.cumsum(cnt) - (cnt - 1) / 2.0)[inv]
    pos = y > 0.5
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((rank[pos].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def tree_counters():
    """The launch counts of the tree-training kernels' wrappers: B1
    (``hist``, the leaf sums' launches included), the leaf sums on their
    own, B2 (``hist_batch``) and B4 (``tree_traverse``)."""
    from shifu_tpu_torch.ops import tree as tree_ops
    from shifu_tpu_torch.ops import tree_quant as tq
    return {"hist": tree_ops.build_histograms,
            "leaf_sums": tree_ops._leaf_raw_hist,
            "hist_batch": tree_ops.build_histograms_batch,
            "tree_traverse": tq.predict_forest_quant}


def zero_tree_counts() -> None:
    for fn in tree_counters().values():
        fn.launches = 0


def read_tree_counts() -> dict:
    return {name: fn.launches for name, fn in tree_counters().items()}


def train_phase(torch, root: str, serve_root: str, plan, rng,
                device: str = "cuda") -> dict:
    """The training path at full width, checked by the repo's own means;
    the tree kernels' counts (``tree_counters``) are zeroed just before the
    run and read just after it."""
    t0 = time.perf_counter()
    bins, y, w, informative, is_cat = train_plane(rng, plan, TRAIN_ROWS)
    names = [p[1] for p in plan]
    clean = os.path.join(root, "plane")
    write_plane(clean, bins, y, w, names, {"chip_smoke": "full"})
    params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH, "Loss": "log",
              "LearningRate": 0.1, "CheckpointInterval": TRAIN_CKPT}
    full = write_train_set(os.path.join(root, "train"), serve_root, params,
                           clean)
    log(f"training set written in {time.perf_counter() - t0:.2f} s: "
        f"{TRAIN_ROWS} rows x {N_COLS} columns, informative columns "
        f"{informative.tolist()}, positive rate {y.mean():.4f}")

    zero_tree_counts()
    wall = train_cli(full, device)
    launches = read_tree_counts()
    want = {"hist": TRAIN_TREES * (DEPTH + 1), "leaf_sums": TRAIN_TREES,
            "hist_batch": 0, "tree_traverse": 0}
    if launches != want:
        fail(f"GBT train launched {launches}, not {want} ({TRAIN_TREES} "
             f"trees x {DEPTH} levels and the leaf sums)")

    spec, trees = load_forest(full)
    if spec.n_trees != TRAIN_TREES or len(trees) != TRAIN_TREES or \
            spec.depth != DEPTH or spec.n_bins != N_BINS:
        fail(f"model0.gbt holds {len(trees)} trees of depth {spec.depth} "
             f"over {spec.n_bins} bins")
    if any(t.split_feat.shape != ((1 << (DEPTH + 1)) - 1,)
           or t.split_feat[0] < 0 for t in trees):
        fail("a tree has the wrong node count or no root split")
    err = progress_errors(full)
    if err.shape != (TRAIN_TREES, 2) or not np.all(np.diff(err[:, 0]) < 0) \
            or not err[-1, 1] < err[0, 1]:
        fail(f"errors do not fall tree by tree: {err.tolist()}")
    with open(os.path.join(full, "tmp", "feature_importance.json")) as f:
        fi = json.load(f)
    top = names.index(max(fi, key=fi.get))
    if top not in informative:
        fail(f"top feature {names[top]} is not an informative column")
    ck = os.path.join(full, "tmp", "checkpoints", "forest_ckpt.npz")
    for path in (ck, ck + ".scores.npz", ck + ".meta.json",
                 os.path.join(full, "tmp", "journal", "TRAIN.json")):
        if not os.path.isfile(path):
            fail(f"train left no {path}")
    with open(os.path.join(full, "tmp", "profile.json")) as f:
        phases = json.load(f)["TRAIN"]["phases_s"]
    if any(p not in phases for p in TRAIN_PARTS):
        fail(f"profile.json does not split the train phase: {phases}")
    phases["train/other"] = round(
        phases["train"] - sum(phases[p] for p in TRAIN_PARTS), 3)
    log(f"main path (train): {TRAIN_TREES} trees of depth {DEPTH} in "
        f"{wall:.3f} s wall ({phases}); train error {err[0, 0]:.6f} -> "
        f"{err[-1, 0]:.6f}, validation {err[0, 1]:.6f} -> {err[-1, 1]:.6f}; "
        f"top feature {names[top]}; launches {launches}")
    out = {"launches": launches, "wall_s": wall, "phases_s": phases,
           "errors": err.tolist(), "dir": full}
    out["chunk"] = chunk_phase(torch, bins, y, w, is_cat, device)

    # resume: 5 trees, then -resume to 10, against the forest above
    part = write_train_set(os.path.join(root, "resume"), serve_root,
                           dict(params, TreeNum=TRAIN_CKPT), clean)
    train_cli(part, device)
    # the same 5-tree checkpoint without its per-row score sidecar, for
    # the replay resume below
    replay = write_train_set(os.path.join(root, "replay"), serve_root,
                             params, clean)
    shutil.copytree(os.path.join(part, "tmp", "checkpoints"),
                    os.path.join(replay, "tmp", "checkpoints"),
                    ignore=shutil.ignore_patterns("*.scores.npz"))
    set_train_params(part, params)
    train_cli(part, device, "-resume")
    _, got = load_forest(part)
    if len(got) != len(trees):
        fail(f"resumed forest has {len(got)} trees")
    for t, (a, b) in enumerate(zip(got, trees)):
        if any(getattr(a, k).tobytes() != getattr(b, k).tobytes()
               for k in ("split_feat", "left_mask", "leaf_value")):
            fail(f"resumed forest differs from the uninterrupted one at "
                 f"tree {t}")
    log(f"{TRAIN_CKPT} trees + train -resume to {TRAIN_TREES}: forest "
        "bit-identical to the uninterrupted run")
    out["replay"] = replay_phase(replay, device, trees)

    # card vs CPU on the plane's first CUT_ROWS rows
    cut = os.path.join(root, "plane_cut")
    write_plane(cut, bins[:CUT_ROWS], y[:CUT_ROWS], w[:CUT_ROWS], names,
                {"chip_smoke": "cut"})
    runs = []
    for name, dev in (("card", device), ("cpu", "cpu")):
        d = write_train_set(os.path.join(root, f"cut_{name}"), serve_root,
                            dict(params, TreeNum=CUT_TREES), cut)
        runs.append((train_cli(d, dev), load_forest(d), progress_errors(d)))
    out["cut"] = compare_cut(torch, *runs, bins[:CUT_ROWS], y[:CUT_ROWS],
                             device)
    out["plane"] = (bins, y, w, informative, is_cat, clean, cut, names)
    return out


def replay_phase(d: str, device: str, trees) -> dict:
    """``train -resume`` from a 5-tree checkpoint with no score sidecar:
    the restored trees replay through ``tree_traverse`` (counts zeroed
    just before, read just after; one launch for the one depth group),
    then 5 more trees grow (40 ``hist`` launches: 7 levels and the leaf
    sums a tree).  Split features and
    left masks must equal the uninterrupted forest's, leaves within
    REPLAY_RTOL (the replay adds each tree's leaf to the scores as the
    uninterrupted run does, so bit-equality is expected and reported)."""
    zero_tree_counts()
    wall = train_cli(d, device, "-resume")
    launches = read_tree_counts()
    grown = TRAIN_TREES - TRAIN_CKPT
    if launches["tree_traverse"] < 1 or launches["hist_batch"] != 0 or \
            launches["hist"] != grown * (DEPTH + 1) or \
            launches["leaf_sums"] != grown:
        fail(f"replay resume launched {launches}, not >= 1 tree_traverse, "
             f"{grown * (DEPTH + 1)} hist of which {grown} leaf sums")
    _, got = load_forest(d)
    if len(got) != len(trees):
        fail(f"replayed forest has {len(got)} trees")
    worst, bit_equal = 0.0, True
    for t, (a, b) in enumerate(zip(got, trees)):
        if not (np.array_equal(a.split_feat, b.split_feat)
                and np.array_equal(a.left_mask, b.left_mask)):
            fail(f"replayed forest splits differ from the uninterrupted "
                 f"one at tree {t}")
        d_leaf = np.abs(a.leaf_value - b.leaf_value)
        if not np.all(d_leaf <= REPLAY_RTOL * np.abs(b.leaf_value) + 1e-7):
            fail(f"replayed leaves differ by up to {d_leaf.max()} at tree "
                 f"{t}")
        worst = max(worst, float(d_leaf.max()))
        bit_equal &= a.leaf_value.tobytes() == b.leaf_value.tobytes()
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        replay_s = json.load(f)["TRAIN"]["phases_s"].get("train/replay")
    log(f"{TRAIN_CKPT} trees without their score sidecar + train -resume "
        f"to {TRAIN_TREES}: launches {launches}; splits equal, leaves "
        f"within {worst:.3g} of the uninterrupted forest (bit-identical: "
        f"{bit_equal}); replay launch {replay_s} s, run {wall:.3f} s")
    return {"launches": launches, "max_abs_leaf_diff": worst,
            "bit_identical": bit_equal, "wall_s": wall}


def compare_cut(torch, card, cpu, bins, y, device: str) -> dict:
    """Levels 0-1 split alike, per-tree errors within ERR_RTOL, and the
    AUCs of the two forests' scores (walked by tree_traverse on the card)
    within AUC_TOL on the validation rows."""
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.train.sampling import validation_split
    (s_card, (spec_a, trees_a), err_a), (s_cpu, (spec_b, trees_b), err_b) \
        = card, cpu
    for t, (a, b) in enumerate(zip(trees_a, trees_b)):
        if not np.array_equal(a.split_feat[:3], b.split_feat[:3]):
            fail(f"tree {t}: levels 0-1 split on {a.split_feat[:3]} on the "
                 f"card, {b.split_feat[:3]} on the CPU")
    # below level 1 near-tie splits may go either way (ROADMAP Queue 3,
    # C4/C9): counted, not checked
    deeper = sum(int((a.split_feat != b.split_feat).sum())
                 for a, b in zip(trees_a, trees_b))
    if err_a.shape != (CUT_TREES, 2) or err_b.shape != (CUT_TREES, 2):
        fail(f"train.progress holds {len(err_a)} and {len(err_b)} trees")
    rel = np.abs(err_a - err_b) / np.abs(err_b)
    if not np.all(rel <= ERR_RTOL):
        fail(f"card vs CPU errors differ by up to {rel.max()} relative")
    vmask = validation_split(len(y), 0.2, 0)
    bins_d = torch.from_numpy(bins).to(device)
    aucs = []
    for spec, trees in ((spec_a, trees_a), (spec_b, trees_b)):
        pred = tq.predict_forest_quant(*tq.stack_forest_quant(trees, device),
                                       bins_d, DEPTH)
        score = (spec.init_score + spec.learning_rate * pred.sum(0)).cpu()
        aucs.append(auc(score.numpy()[vmask], y[vmask]))
    if abs(aucs[0] - aucs[1]) > AUC_TOL:
        fail(f"card vs CPU validation AUC {aucs[0]:.5f} vs {aucs[1]:.5f}")
    log(f"card vs CPU on {len(y)} rows x {CUT_TREES} trees: levels 0-1 "
        f"equal ({deeper} of {CUT_TREES * len(trees_a[0].split_feat)} "
        f"nodes split on another feature below them), errors within "
        f"{rel.max():.3g} relative, validation AUC {aucs[0]:.5f} vs "
        f"{aucs[1]:.5f}; train wall {s_card:.2f} s on the card, "
        f"{s_cpu:.2f} s on the CPU")
    return {"max_rel_err": float(rel.max()), "auc": aucs,
            "nodes_differ": deeper, "wall_s": [s_card, s_cpu]}


def chunk_phase(torch, bins, y, w, is_cat, device: str) -> dict:
    """One chunk of two full-width trees straight through
    ``gbt_forest_chunk`` on device-resident tensors: under
    ``set_sync_debug_mode("error")`` (any host sync raises), then timed
    (host wall around a synchronised chunk), then traced with
    ``torch.profiler`` for the device time by kernel."""
    from shifu_tpu_torch.train import dt_trainer as dt
    from shifu_tpu_torch.train.sampling import validation_split
    dev = torch.device(device)
    vmask = validation_split(len(y), 0.2, 0)
    bins_d = dt.put_bins(bins, N_BINS, dev)
    y_d, tw, vw = (torch.from_numpy(a.astype(np.float32)).to(dev)
                   for a in (y, w * ~vmask, w * vmask))
    settings = dt.DTSettings(n_trees=2, depth=DEPTH, loss="log",
                             learning_rate=0.1)
    fa = torch.ones((2, N_COLS), dtype=torch.bool, device=dev)
    cat = torch.from_numpy(is_cat).to(dev)
    f = torch.zeros(len(y), device=dev)

    def run():
        return dt.gbt_forest_chunk(bins_d, y_d, tw, vw, f, fa, cat,
                                   settings, N_BINS, "variance",
                                   bool(is_cat.any()))
    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    walls = []
    for _ in range(CHUNK_REPEATS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / 2)
    ms_tree = float(np.median(walls))
    quart = [float(q) for q in np.percentile(walls, [25, 75])]
    prof = profile_device(torch, run)
    log(f"a 2-tree chunk ran under set_sync_debug_mode('error') with no "
        f"host sync; {ms_tree:.3f} ms per tree (median of {CHUNK_REPEATS} "
        f"chunks, host wall; quartiles {quart[0]:.3f} / {quart[1]:.3f}), "
        f"{TRAIN_ROWS * 1e3 / ms_tree:.4g} rows x trees / s")
    return {"ms_per_tree": ms_tree, "quartiles_ms": quart, "profile": prof}


def profile_device(torch, run, what: str = "one 2-tree chunk") -> dict:
    """Device time by kernel over one ``run()`` (``what``) from
    ``torch.profiler``: kernel-busy ms, its share of the run's profiled
    wall time, and the kernels that take the most (``by_name``: every
    device op's ms and launches).  It records the CUDA activity alone:
    the host ops' events are not read, and recording them cost tens of
    seconds of host time over a few WDL epochs (~300 ops a step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0.0:
        log("torch.profiler recorded no device time: breakdown not measured")
        return {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    log(f"torch.profiler over {what}: kernels busy {busy:.3f} ms "
        f"of {wall_ms:.3f} ms profiled wall ({busy / wall_ms:.1%}); top "
        "kernels (ms, launches):")
    for name, (ms, n) in top:
        log(f"  {ms:9.3f} ms {n:5d}x  {name[:110]}")
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "top": [(name[:110], ms, n) for name, (ms, n) in top],
            "by_name": by_name}



# ------------------------------------------------------- phase: RF train
def rf_phase(torch, root: str, serve_root: str, plane,
             device: str = "cuda") -> dict:
    """The Random Forest path at full width: ``init -model``'s RF
    defaults (TreeNum 10, MaxDepth 14, TWOTHIRDS, entropy, Loss squared)
    with CheckpointInterval 8 on the GBT phase's 1,048,576 x 256 plane,
    through ``cli.main train`` on ``cuda``.  The first chunk of 8 trees
    grows as one batch (one ``hist_batch`` launch a level: 14, and one
    ``hist`` launch a tree for its leaf sums: 8), the last 2 one by one
    (``hist``: 2 x 15); the counts are zeroed just before the run and
    read just after it.  Then: the chunk again on resident
    tensors, timed per level; 8 trees and ``train -resume`` to 10,
    bit-identical through a ``tree_traverse`` replay; card vs CPU on the
    plane's first CUT_ROWS rows at depth RF_CUT_DEPTH."""
    from shifu_tpu_torch.pipeline.create import _ALG_DEFAULT_PARAMS
    bins, y, w, informative, is_cat, clean, cut, names = plane
    params = dict(_ALG_DEFAULT_PARAMS["RF"][1], CheckpointInterval=RF_CKPT)
    if (params["TreeNum"], params["MaxDepth"]) != (RF_TREES, RF_DEPTH):
        fail(f"init -model's RF defaults changed: {params}")
    full = write_train_set(os.path.join(root, "rf"), serve_root, params,
                           clean, "RF")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_tree_counts()
    wall = train_cli(full, device)
    launches = read_tree_counts()
    peak = torch.cuda.max_memory_allocated() - base
    want = {"hist_batch": RF_DEPTH,
            "hist": RF_CKPT + (RF_TREES - RF_CKPT) * (RF_DEPTH + 1),
            "leaf_sums": RF_TREES, "tree_traverse": 0}
    if launches != want:
        fail(f"RF train launched {launches}, not {want}")

    spec, trees = load_forest(full, "rf")
    nodes = (1 << (RF_DEPTH + 1)) - 1
    if spec.algorithm != "RF" or spec.n_trees != RF_TREES or \
            len(trees) != RF_TREES or spec.depth != RF_DEPTH:
        fail(f"model0.rf: {spec.algorithm}, {len(trees)} trees of depth "
             f"{spec.depth}")
    if any(t.split_feat.shape != (nodes,) or t.split_feat[0] < 0
           for t in trees):
        fail("an RF tree has the wrong node count or no root split")
    deep = min(int((t.split_feat[(1 << (RF_DEPTH - 1)) - 1:] >= 0).sum())
               for t in trees)
    err = progress_errors(full)
    if err.shape != (RF_TREES, 2) or not np.isfinite(err).all() \
            or not err[-1, 1] < err[0, 1]:
        fail(f"RF errors: {err.tolist()} (out-of-bag error must fall)")
    with open(os.path.join(full, "tmp", "feature_importance.json")) as f:
        fi = json.load(f)
    top = names.index(max(fi, key=fi.get))
    roots = [int(t.split_feat[0]) for t in trees]
    if any(r not in informative for r in roots):
        fail(f"RF root splits on {[names[r] for r in roots]}, not all "
             f"informative columns {[names[i] for i in informative]}")
    ck = os.path.join(full, "tmp", "checkpoints", "forest_ckpt.npz")
    for path in (ck, ck + ".meta.json",
                 os.path.join(full, "tmp", "journal", "TRAIN.json")):
        if not os.path.isfile(path):
            fail(f"RF train left no {path}")
    with open(os.path.join(full, "tmp", "profile.json")) as f:
        phases = json.load(f)["TRAIN"]["phases_s"]
    if any(p not in phases for p in TRAIN_PARTS):
        fail(f"profile.json does not split the RF train phase: {phases}")
    phases["train/other"] = round(
        phases["train"] - sum(phases[p] for p in TRAIN_PARTS), 3)
    log(f"main path (RF train): {RF_TREES} trees of depth {RF_DEPTH} "
        f"({nodes} nodes; every tree splits >= {deep} nodes on its deepest "
        f"split level) in {wall:.3f} s wall ({phases}); train error "
        f"{err[0, 0]:.6f} -> {err[-1, 0]:.6f}, out-of-bag {err[0, 1]:.6f} "
        f"-> {err[-1, 1]:.6f}; roots on informative "
        f"{sorted({names[r] for r in roots})}, top feature {names[top]}; "
        f"launches "
        f"{launches}; peak device memory {peak / 2**30:.3f} GiB")
    out = {"launches": launches, "wall_s": wall, "phases_s": phases,
           "errors": err.tolist(), "peak_bytes": peak}
    out["chunk"] = rf_chunk_phase(torch, full, bins, y, w, is_cat, trees,
                                  params, device)

    # resume: stop after the 8-tree checkpoint, then -resume to 10
    part = write_train_set(os.path.join(root, "rf_resume"), serve_root,
                           dict(params, TreeNum=RF_CKPT), clean, "RF")
    train_cli(part, device)
    set_train_params(part, params)
    zero_tree_counts()
    resume_wall = train_cli(part, device, "-resume")
    r_launches = read_tree_counts()
    if r_launches["tree_traverse"] < 1 or r_launches["hist_batch"] != 0 \
            or r_launches["hist"] != (RF_TREES - RF_CKPT) * (RF_DEPTH + 1) \
            or r_launches["leaf_sums"] != RF_TREES - RF_CKPT:
        fail(f"RF resume launched {r_launches}")
    _, got = load_forest(part, "rf")
    if len(got) != RF_TREES:
        fail(f"resumed RF has {len(got)} trees")
    for t, (a, b) in enumerate(zip(got, trees)):
        if any(getattr(a, k).tobytes() != getattr(b, k).tobytes()
               for k in ("split_feat", "left_mask", "leaf_value")):
            fail(f"resumed RF differs from the uninterrupted one at tree {t}")
    if not np.array_equal(progress_errors(part), err[RF_CKPT:]):
        fail("resumed RF's errors differ from the uninterrupted run's")
    with open(os.path.join(part, "tmp", "profile.json")) as f:
        replay_s = json.load(f)["TRAIN"]["phases_s"].get("train/replay")
    log(f"RF: {RF_CKPT} trees + train -resume to {RF_TREES}: launches "
        f"{r_launches} (the {RF_CKPT} restored {nodes}-node trees replay "
        f"their bags through tree_traverse in {replay_s} s); forest and "
        f"errors bit-identical to the uninterrupted run; run "
        f"{resume_wall:.3f} s")
    out["resume"] = {"launches": r_launches, "wall_s": resume_wall,
                     "replay_s": replay_s}
    out["cut"] = compare_rf_cut(torch, root, serve_root, params, cut,
                                bins[:CUT_ROWS], y[:CUT_ROWS], device)
    return out


def rf_settings(d: str, params: dict):
    """The trainer's settings for model set ``d`` under ``params``."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.train import dt_trainer as dt
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    return dt.settings_from_params(params, mc.train, Algorithm.RF)


def rf_chunk_phase(torch, full, bins, y, w, is_cat, trees, params,
                   device: str) -> dict:
    """The RF run's chunks again, straight through ``rf_forest_chunk`` on
    device-resident tensors: the 8-tree batch under
    ``set_sync_debug_mode("error")`` (no host sync once the bags are
    drawn), then the 2-tree remainder, each timed on the host around a
    synchronised chunk, with CUDA events around every histogram launch
    and leaf-sum level (device ms by level).  Both must reproduce the CLI
    run's trees bit for bit."""
    from shifu_tpu_torch.ops import tree as tree_ops
    from shifu_tpu_torch.train import dt_trainer as dt
    dev = torch.device(device)
    settings = rf_settings(full, params)
    bins_d = dt.put_bins(bins, N_BINS, dev)
    y_d, w_d = (torch.from_numpy(a).to(dev) for a in (y, w))
    cat = torch.from_numpy(is_cat).to(dev)
    fa = torch.from_numpy(np.stack([dt._feat_subset(settings, N_COLS, t)
                                    for t in range(RF_TREES)])).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bags = dt.draw_bags(settings, range(RF_TREES), len(y), dev)
    torch.cuda.synchronize()
    bag_ms = (time.perf_counter() - t0) * 1e3
    zero = torch.zeros(len(y), device=dev)

    events, inside = [], []

    def timed(name, fn):
        def call(*a, **k):
            if inside:             # B1 under the leaf sums: theirs
                return fn(*a, **k)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            inside.append(name)
            try:
                r = fn(*a, **k)
            finally:
                inside.pop()
            e1.record()
            events.append((name, e0, e1))
            return r
        call.launches = 0          # the wrapped function counts into this
        return call

    real = {n: getattr(tree_ops, n) for n in
            ("build_histograms_batch", "build_histograms", "_level_leaf_raw")}
    for n, fn in real.items():
        setattr(tree_ops, n, timed(n, fn))
    out = {"bag_ms": bag_ms}
    try:
        for part, sl, debug in (("batch", slice(0, RF_CKPT), True),
                                ("remainder", slice(RF_CKPT, RF_TREES),
                                 False)):
            events.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if debug:
                torch.cuda.set_sync_debug_mode("error")
            try:
                _, _, packed = dt.rf_forest_chunk(
                    bins_d, y_d, w_d, bags[sl], zero, zero, fa[sl], cat,
                    settings, N_BINS, bool(is_cat.any()), HIST_BATCH)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            levels = {}
            for name, e0, e1 in events:
                levels.setdefault(name, []).append(e0.elapsed_time(e1))
            n_trees = sl.stop - sl.start
            for j, row in enumerate(packed.cpu().numpy()):
                tree = dt._unpack_tree(row, (1 << (RF_DEPTH + 1)) - 1,
                                       N_BINS, N_COLS, RF_DEPTH)[0]
                want = trees[sl.start + j]
                if any(getattr(tree, k).tobytes() != getattr(want, k)
                       .tobytes() for k in ("split_feat", "left_mask",
                                            "leaf_value")):
                    fail(f"RF {part} chunk tree {j} differs from the CLI "
                         "run's")
            leaf_ms = levels.get("_level_leaf_raw", [])
            out[part] = {"ms_per_tree": ms / n_trees, "levels_ms": levels,
                         "leaf_ms_per_tree_max": max(leaf_ms, default=0.0)}
            hist_name = "build_histograms_batch" if part == "batch" \
                else "build_histograms"
            per_level = levels.get(hist_name, [])
            log(f"RF {part}: {n_trees} trees in {ms:.1f} ms, "
                f"{ms / n_trees:.1f} ms per tree (host wall around a "
                f"synchronised chunk{', no host sync inside' if debug else ''}"
                f"); {hist_name} device ms by launch "
                f"{[round(v, 3) for v in per_level]}; leaf sums "
                f"{sum(leaf_ms):.1f} ms (at most {max(leaf_ms, default=0):.3f}"
                f" ms a tree, {len(leaf_ms)} trees)")
    finally:
        for n, fn in real.items():
            setattr(tree_ops, n, fn)
    log(f"RF bags: {RF_TREES} x {len(y)} Poisson draws in {bag_ms:.1f} ms")
    return out


def compare_rf_cut(torch, root, serve_root, params, cut, bins, y,
                   device: str) -> dict:
    """RF at depth RF_CUT_DEPTH on the plane's first CUT_ROWS rows, on the
    card and on the CPU: the bags drawn on each equal (0 rows differ),
    levels 0-1 split alike, per-tree errors within ERR_RTOL relative, and
    the two forests' AUCs (scored by tree_traverse on the card) within
    AUC_TOL."""
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.train import dt_trainer as dt
    params = dict(params, MaxDepth=RF_CUT_DEPTH, TreeNum=RF_CUT_TREES)
    runs, sets = [], []
    for name, dev in (("card", device), ("cpu", "cpu")):
        d = write_train_set(os.path.join(root, f"rf_cut_{name}"), serve_root,
                            params, cut, "RF")
        sets.append(d)
        runs.append((train_cli(d, dev), load_forest(d, "rf"),
                     progress_errors(d)))
    settings = rf_settings(sets[0], params)
    bags = [dt.draw_bags(settings, range(RF_CUT_TREES), CUT_ROWS, dev).cpu()
            for dev in (device, "cpu")]
    bag_diff = int((bags[0] != bags[1]).sum())
    if bag_diff:
        fail(f"RF bags drawn on the card and the CPU differ in {bag_diff} "
             "rows")
    (s_card, (_, trees_a), err_a), (s_cpu, (_, trees_b), err_b) = runs
    for t, (a, b) in enumerate(zip(trees_a, trees_b)):
        if not np.array_equal(a.split_feat[:3], b.split_feat[:3]):
            fail(f"RF tree {t}: levels 0-1 split on {a.split_feat[:3]} on "
                 f"the card, {b.split_feat[:3]} on the CPU")
    deeper = sum(int((a.split_feat != b.split_feat).sum())
                 for a, b in zip(trees_a, trees_b))
    if err_a.shape != (RF_CUT_TREES, 2) or err_b.shape != (RF_CUT_TREES, 2):
        fail(f"RF train.progress holds {len(err_a)} and {len(err_b)} trees")
    rel = np.abs(err_a - err_b) / np.abs(err_b)
    if not np.all(rel <= ERR_RTOL):
        fail(f"RF card vs CPU errors differ by up to {rel.max()} relative")
    bins_d = torch.from_numpy(bins).to(device)
    aucs = []
    for trees in (trees_a, trees_b):
        pred = tq.predict_forest_quant(*tq.stack_forest_quant(trees, device),
                                       bins_d, RF_CUT_DEPTH)
        aucs.append(auc(pred.mean(0).cpu().numpy(), y))
    if abs(aucs[0] - aucs[1]) > AUC_TOL:
        fail(f"RF card vs CPU AUC {aucs[0]:.5f} vs {aucs[1]:.5f}")
    log(f"RF card vs CPU on {len(y)} rows x {RF_CUT_TREES} trees of depth "
        f"{RF_CUT_DEPTH}: bags equal ({bag_diff} rows differ), levels 0-1 "
        f"equal ({deeper} of {RF_CUT_TREES * len(trees_a[0].split_feat)} "
        f"nodes "
        f"split on another feature below them), errors within "
        f"{rel.max():.3g} relative, AUC {aucs[0]:.5f} vs {aucs[1]:.5f}; "
        f"train wall {s_card:.2f} s on the card, {s_cpu:.2f} s on the CPU")
    return {"bag_rows_differ": bag_diff, "max_rel_err": float(rel.max()),
            "auc": aucs, "nodes_differ": deeper, "wall_s": [s_card, s_cpu]}


# ---------------------------------------------------------- phase: stats
def stats_inputs(torch, rng, n, c, b, s):
    """B3 inputs on the card: bucket ids uniform in [0, B) with ~5% of
    cells missing (-1); stats [pos, neg] 0/1 indicators, and with S = 4
    also [w * pos, w * neg] with w uniform in [0.5, 3)."""
    idx = rng.integers(0, b, size=(n, c), dtype=np.int32)
    idx[rng.random((n, c)) < 0.05] = -1
    pos = (rng.random(n) < 0.3).astype(np.float32)
    chans = [pos, 1.0 - pos]
    if s == 4:
        w = rng.uniform(0.5, 3.0, n).astype(np.float32)
        chans += [w * pos, w * (1.0 - pos)]
    exact = (True, True) + (False,) * (s - 2)
    return [torch.from_numpy(a).to("cuda")
            for a in (idx, np.stack(chans, axis=1))] + [exact]


def check_stats_hist(torch, rng) -> dict:
    """B3 against its plain version on the card: counts bit-equal,
    weighted channels within STATS_TOL of the plain value, a relaunch
    bit-identical.  Returns the max |kernel - plain| seen."""
    from shifu_tpu_torch.ops import stats_hist as sh
    err = 0.0
    for n, c, b, s in STATS_CASES:
        idx, st, exact = stats_inputs(torch, rng, n, c, b, s)
        got = sh.stats_histograms(idx, st, b, exact)
        again = sh.stats_histograms(idx, st, b, exact)
        want = sh.stats_histograms_ref(idx, st, b)
        torch.cuda.synchronize()
        where = f"N={n} C={c} B={b} S={s}"
        d = (got - want).abs()
        if got.shape != (c, b, s) or not torch.equal(got, again):
            fail(f"stats_hist: two launches differ at {where}")
        if not torch.equal(got[..., :2], want[..., :2]):
            fail(f"stats_hist counts != plain version at {where}")
        if not bool((d <= STATS_TOL * want.abs()).all()):
            fail(f"stats_hist weighted cells beyond {STATS_TOL} relative "
                 f"at {where} (max |d| {d.max().item()})")
        err = max(err, d.max().item())
        log(f"stats_hist == plain version at {where}: counts equal, max "
            f"|d| {d.max().item():.3g}, relaunch bit-equal")
        del idx, st, got, again, want, d
    return {"stats_hist": err}


def write_stats_csv(path: str, rng, plan, n: int) -> float:
    """The raw data of the smoke's column plan as a '|'-delimited CSV, its
    header row in ``<path>.header``: 224 numeric columns (~5% empty cells), 32 categorical
    columns of their 20-60 categories, an integer ``weight`` 1..3 and a
    ``tag`` (bad/good) drawn from a logit on two numeric columns and one
    categorical.  Returns the positive rate."""
    cols, names = [], []
    logit = np.full(n, -1.0)
    for j, (kind, name, a, b) in enumerate(plan):
        if kind == "num":
            v = rng.normal(a, b, size=n)
            if j < 2:
                logit += (v - a) / b
            cells = np.array([f"{x:.6g}" for x in v], dtype=object)
            cells[rng.random(n) < 0.05] = ""
        else:
            k = rng.integers(0, len(a), size=n)
            if j == N_NUM:
                logit += rng.normal(0, 1, size=len(a))[k]
            cells = np.asarray(a, dtype=object)[k]
        cols.append(cells)
        names.append(name)
    y = rng.random(n) < 1.0 / (1.0 + np.exp(-logit))
    cols.append(rng.integers(1, 4, size=n).astype(str).astype(object))
    cols.append(np.where(y, "bad", "good").astype(object))
    with open(path + ".header", "w") as f:
        f.write("|".join(names + ["weight", "tag"]) + "\n")
    with open(path, "w") as f:
        f.write("\n".join("|".join(r) for r in zip(*cols)) + "\n")
    return float(y.mean())


def stats_cli(d: str, device: str, *props: str) -> float:
    """``stats`` of set ``d`` on ``device``, parsing inline (INLINE_PARSE);
    its wall s."""
    from shifu_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(["--dir", d, INLINE_PARSE, *props, "stats", "--device",
                   device])
    if rc != 0:
        fail(f"stats on {device} exited {rc} in {d}")
    return time.perf_counter() - t0


def compare_column_configs(got, want, where="", worst=None) -> dict:
    """Integers, strings, categories and binBoundary equal; floats within
    CARD_CPU_RTOL relative + CARD_CPU_ATOL.  Returns the largest float
    difference seen, absolute and relative, with where each was."""
    if worst is None:
        worst = {"abs": (0.0, ""), "rel": (0.0, "")}
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"ColumnConfig keys differ at {where}")
        for k in want:
            compare_column_configs(got[k], want[k], f"{where}.{k}", worst)
    elif isinstance(want, list) and not where.endswith(".binBoundary"):
        if not isinstance(got, list) or len(got) != len(want):
            fail(f"ColumnConfig lists differ at {where}")
        for i, (g, w) in enumerate(zip(got, want)):
            compare_column_configs(g, w, f"{where}[{i}]", worst)
    elif isinstance(want, float) and isinstance(got, float) and got != want:
        d = abs(got - want)
        if d > CARD_CPU_RTOL * abs(want) + CARD_CPU_ATOL:
            fail(f"card vs CPU ColumnConfig {where}: {got} vs {want}")
        worst["abs"] = max(worst["abs"], (d, where))
        worst["rel"] = max(worst["rel"], (d / abs(want), where))
    elif got != want:
        fail(f"card vs CPU ColumnConfig {where}: {got!r} vs {want!r}")
    return worst


def stats_phase(torch, root: str, plan, rng) -> dict:
    """``new → init → stats`` through the CLI a user calls, on the card:
    a synthetic CSV at the full width of the column plan (CSV_ROWS rows,
    a cut in rows only), chunks of CSV_CHUNK rows and a fused budget that
    keeps 1 of the 2 chunks resident and overflows 1 into the provisional
    grid.  The ``stats_hist`` count is zeroed just before ``stats`` and
    read just after (2 launches: one a chunk).  The same set's ``stats``
    on the CPU must give the same ColumnConfig.json (see
    compare_column_configs)."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.path_finder import PathFinder
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.data.extract import ChunkExtractor
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.config import load_column_configs
    base = os.path.join(root, "stats")
    os.makedirs(base)
    csv = os.path.join(base, "data.csv")
    t0 = time.perf_counter()
    pos_rate = write_stats_csv(csv, rng, plan, CSV_ROWS)
    log(f"stats CSV written in {time.perf_counter() - t0:.2f} s: {CSV_ROWS} "
        f"rows x {N_COLS + 2} fields, positive rate {pos_rate:.4f}")
    if cli.main(["--dir", base, "new", "card"]) != 0:
        fail("new exited non-zero")
    d = os.path.join(base, "card")
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = ["bad"], ["good"], "weight"
    ds.headerPath, ds.headerDelimiter = csv + ".header", "|"
    mc.stats.maxNumBin = N_BINS - 1         # the plan's 63 value bins
    mc.save(os.path.join(d, "ModelConfig.json"))
    t0 = time.perf_counter()
    if cli.main(["--dir", d, "init"]) != 0:
        fail("init exited non-zero")
    init_s = time.perf_counter() - t0
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    kinds = [(c.is_categorical(), c.is_candidate()) for c in ccs]
    if kinds.count((False, True)) != N_NUM or \
            kinds.count((True, True)) != N_CAT:
        fail(f"init typed {kinds.count((False, True))} numeric and "
             f"{kinds.count((True, True))} categorical candidates")
    cpu_dir = os.path.join(base, "cpu")
    shutil.copytree(d, cpu_dir)

    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    budget = f"-Dshifu.stats.fusedBudgetBytes={CHUNK_BYTES}"
    try:
        sh.stats_histograms_cuda.launches = 0
        wall = stats_cli(d, "cuda", budget)
        launches = sh.stats_histograms_cuda.launches
        cpu_wall = stats_cli(cpu_dir, "cpu", budget)
        # the host parse alone: the same chunks through the extractor
        mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
        src = DataSource(csv, "|", header_path=csv + ".header")
        ex = ChunkExtractor(mc, load_column_configs(
            PathFinder(mc, d).column_config_path))
        t0 = time.perf_counter()
        for chunk in src.iter_chunks(CSV_CHUNK):
            ex.extract(chunk)
        parse_s = time.perf_counter() - t0
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
        environment.reset_for_tests()       # drop the -D budget
    if launches != CSV_ROWS // CSV_CHUNK:
        fail(f"stats launched stats_hist {launches} times for "
             f"{CSV_ROWS // CSV_CHUNK} chunks")
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        phases = json.load(f)["STATS"]["phases_s"]
    with open(os.path.join(d, "ColumnConfig.json")) as f:
        card = json.load(f)
    with open(os.path.join(cpu_dir, "ColumnConfig.json")) as f:
        cpu = json.load(f)
    numeric = [c for c in card if c["columnBinning"].get("binBoundary")]
    for c in numeric:
        st, bn = c["columnStats"], c["columnBinning"]
        if st["totalCount"] != CSV_ROWS or \
                sum(bn["binCountPos"]) + sum(bn["binCountNeg"]) != CSV_ROWS \
                or len(bn["binBoundary"]) < 2 \
                or not all(math.isfinite(v) for v in bn["binBoundary"][1:]):
            fail(f"stats wrote a bad numeric column {c['columnName']}")
    if len(numeric) != N_NUM:
        fail(f"{len(numeric)} numeric columns binned, not {N_NUM}")
    if len(card) != len(cpu):
        fail(f"{len(card)} columns on the card, {len(cpu)} on the CPU")
    worst = None
    for a, b in zip(card, cpu):
        worst = compare_column_configs(a, b, a["columnName"], worst)
    cells = CSV_ROWS * (N_COLS + 2)
    log(f"main path (stats): new + init ({init_s:.2f} s) + stats on the "
        f"card in {wall:.3f} s ({phases}); {launches} stats_hist launches; "
        f"card vs CPU ColumnConfig: counts, categories and boundaries "
        f"equal, floats within {worst['abs'][0]:.3g} absolute (at "
        f"{worst['abs'][1]}) and {worst['rel'][0]:.3g} relative (at "
        f"{worst['rel'][1]}); CPU stats {cpu_wall:.2f} s; the host parse "
        f"alone takes {parse_s:.3f} s, "
        f"{parse_s * 1e6 / cells:.3f} us a cell")
    return {"launches": {"stats_hist": launches}, "wall_s": wall,
            "init_s": init_s, "cpu_wall_s": cpu_wall, "phases_s": phases,
            "parse_s": parse_s, "parse_us_per_cell": parse_s * 1e6 / cells,
            "float_diff": worst, "dir": d, "csv": csv}


STATS_REBIN = ("-ivr", "0.9", "-bic", "100")  # -rebin's flags (+ -vars)
STATS_CKPT_CHUNKS = 1                      # checkpointChunks of the drill
STATS_FAULT_CHUNK = 1                      # the drill's stats:chunk fault


def read_corr(d: str):
    with open(os.path.join(d, "correlation.csv")) as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    return rows[0][1:], np.array([[float(v) for v in r[1:]]
                                  for r in rows[1:]])


def stats_extra_phase(torch, root: str, d: str, plan, gpu: str) -> dict:
    """The rest of ``stats`` through the CLI on copies of the stats
    phase's set (CSV_ROWS rows x 258 fields; its raw cache served), card
    and CPU: (1) ``stats -correlation -rebin -vars <a numeric, a
    categorical> -ivr 0.9 -bic 100`` with ``psiColumnName`` a
    categorical column, then ``export corr``; (2) MunroPat exact binning;
    (3) ``-Dshifu.stats.checkpointChunks=1`` interrupted at
    ``stats:chunk=1`` and resumed on the card, against an uninterrupted
    checkpointing run on the CPU.  Every ColumnConfig.json on the card
    equals the CPU's (compare_column_configs), the correlation matrices
    within 1e-6 (float64 pair sums on both), the exported matrix is the
    step's file; the ``stats_hist`` count is zeroed before the card runs
    and read after them."""
    from shifu_tpu_torch import cli, faults
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.ops import stats_hist as sh
    num, cat = plan[0][1], plan[N_NUM][1]
    budget = f"-Dshifu.stats.fusedBudgetBytes={CHUNK_BYTES}"

    def copy(name, **stats_fields):
        out = {}
        for dev in ("card", "cpu"):
            dst = os.path.join(root, "stats_x", name, dev)
            shutil.copytree(d, dst)
            path = os.path.join(dst, "ModelConfig.json")
            with open(path) as f:
                mc = json.load(f)
            mc["stats"].update(stats_fields)
            with open(path, "w") as f:
                json.dump(mc, f, indent=2)
            out[dev] = dst
        return out

    def stats(dirs, dev, *argv):
        t0 = time.perf_counter()
        rc = cli.main(["--dir", dirs[dev], budget, INLINE_PARSE, *argv[:-1],
                       "stats",
                       *argv[-1], "--device",
                       "cuda" if dev == "card" else "cpu"])
        if rc != 0:
            fail(f"stats {argv} on {dev} exited {rc}")
        return time.perf_counter() - t0

    def same_configs(dirs, what):
        docs = []
        for dev in ("card", "cpu"):
            with open(os.path.join(dirs[dev], "ColumnConfig.json")) as f:
                docs.append(json.load(f))
        worst = None
        for a, b in zip(*docs):
            worst = compare_column_configs(a, b, f"{what} {a['columnName']}",
                                           worst)
        return docs[0], worst

    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        sh.stats_histograms_cuda.launches = 0
        # (1) correlation + PSI + rebin in one run, then export corr
        extras = copy("extras", psiColumnName=cat)
        flags = ["-correlation", "-rebin", "-vars", f"{num},{cat}",
                 *STATS_REBIN]
        walls = {dev: stats(extras, dev, flags) for dev in ("card", "cpu")}
        card, worst1 = same_configs(extras, "extras")
        names, corr = read_corr(extras["card"])
        cpu_names, cpu_corr = read_corr(extras["cpu"])
        corr_diff = float(np.max(np.abs(corr - cpu_corr)))
        if names != cpu_names or len(names) != N_COLS or corr_diff > 1e-6 \
                or not np.allclose(np.diag(corr), 1.0) \
                or not np.all(np.abs(corr) <= 1.0 + 1e-6):
            fail(f"correlation card vs CPU: {len(names)} columns, "
                 f"max diff {corr_diff}")
        psi_cols = [c for c in card if c["columnStats"].get("psi")
                    is not None]
        if len(psi_cols) != N_COLS or any(
                len(c["columnStats"]["unitStats"]) != len(plan[N_NUM][2])
                for c in psi_cols):
            fail(f"PSI on {len(psi_cols)} columns, not {N_COLS}")
        rebinned = {c["columnName"]: len(c["columnBinning"]["binCountNeg"])
                    for c in card if c["columnName"] in (num, cat)}
        if cli.main(["--dir", extras["card"], "export", "corr"]) != 0:
            fail("export corr exited non-zero")
        with open(os.path.join(extras["card"], "export",
                               "correlation.csv"), "rb") as f, \
                open(os.path.join(extras["card"], "correlation.csv"),
                     "rb") as g:
            if f.read() != g.read():
                fail("export corr did not copy the matrix")
        launches = {"extras": sh.stats_histograms_cuda.launches}
        # (2) MunroPat exact binning
        munro = copy("munropat", binningAlgorithm="MunroPat")
        walls_m = {dev: stats(munro, dev, []) for dev in ("card", "cpu")}
        card_m, worst2 = same_configs(munro, "MunroPat")
        if any(c["columnBinning"].get("binningAlgorithm") != "MunroPat"
               for c in card_m if c["columnBinning"].get("binBoundary")):
            fail("MunroPat not recorded on every numeric column")
        launches["munropat"] = sh.stats_histograms_cuda.launches - \
            sum(launches.values())
        # (3) mid-sweep checkpoints: interrupted at a chunk and resumed
        ckpt = copy("checkpoint")
        props = [f"-Dshifu.stats.checkpointChunks={STATS_CKPT_CHUNKS}"]
        faults.reset_for_tests()
        t0 = time.perf_counter()
        try:
            stats(ckpt, "card", *props, f"-Dshifu.faults=stats:chunk="
                  f"{STATS_FAULT_CHUNK}:ioerror", [])
            fail("the stats:chunk fault did not fire")
        except faults.InjectedFault:
            pass
        partial = os.path.join(ckpt["card"], "tmp", "stats",
                               "partial_sweep.npz")
        if not os.path.isfile(partial):
            fail("no mid-sweep checkpoint after the interrupted run")
        environment.set_property("shifu.faults", "")
        faults.reset_for_tests()
        stats(ckpt, "card", *props, [])
        resume_s = time.perf_counter() - t0
        if os.path.isfile(partial):
            fail("the resumed run left its checkpoint behind")
        stats(ckpt, "cpu", *props, [])
        _, worst3 = same_configs(ckpt, "checkpoint")
        launches["checkpoint"] = sh.stats_histograms_cuda.launches - \
            sum(launches.values())
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
        environment.reset_for_tests()
        faults.reset_for_tests()
    if min(launches.values()) < 1:
        fail(f"stats_hist did not launch in every card run: {launches}")
    worst = max((w["abs"] for w in (worst1, worst2, worst3)),
                key=lambda t: t[0])
    log(f"stats extras: -correlation/-psi/-rebin {walls['card']:.3f} s on "
        f"the card ({walls['cpu']:.3f} s CPU), {len(names)}x{len(names)} "
        f"matrix within {corr_diff:.3g} of the CPU, PSI over "
        f"{len(plan[N_NUM][2])} units of {cat}, rebinned to {rebinned}; "
        f"MunroPat {walls_m['card']:.3f} s ({walls_m['cpu']:.3f} s CPU); "
        f"checkpoint drill interrupted at chunk {STATS_FAULT_CHUNK} and "
        f"resumed in {resume_s:.3f} s; every ColumnConfig card vs CPU "
        f"within {worst[0]:.3g} ({worst[1]}); stats_hist launches "
        f"{launches} — [{gpu}]")
    return {"launches": launches, "corr_diff": corr_diff,
            "walls_s": {"extras": walls, "munropat": walls_m,
                        "checkpoint_card": resume_s}}


def csv_records(csv: str) -> list:
    """The CSV's rows as JSON records of their string cells, as a client
    of ``serve`` would send them."""
    with open(csv + ".header") as f:
        names = f.read().strip().split("|")
    with open(csv) as f:
        return [dict(zip(names, line.rstrip("\n").split("|")))
                for line in f]


def eval_scores(d: str, name: str):
    """(rows [N, 6 + models] of the ``EvalScore`` file as strings, the
    ``EvalPerformance.json`` of eval set ``name``)."""
    ev = os.path.join(d, "evals", name)
    with open(os.path.join(ev, "EvalScore")) as f:
        rows = [line.rstrip("\n").split("|") for line in f][1:]
    perf = {}
    if os.path.isfile(os.path.join(ev, "EvalPerformance.json")):
        with open(os.path.join(ev, "EvalPerformance.json")) as f:
            perf = json.load(f)
    return np.asarray(rows, dtype=object), perf


def e2e_phase(torch, d: str, csv: str, gpu: str) -> dict:
    """``norm → train → eval`` through the CLI a user calls, on the stats
    phase's model set (the CSV_ROWS-row CSV at full width, chunks of
    CSV_CHUNK rows): the port's own ``norm`` writes the wire plane that
    ``train`` (GBT, the train phase's TreeNum, MaxDepth and Loss) reads,
    then ``eval -new`` and ``eval -run`` score the same CSV on the card
    and on the CPU.  Checks: the plane's bins equal the serving path's
    device transform (``FusedTransform.apply_device``, float64) on the
    CSV's first E2E_CHECK_ROWS records; per-row scores card vs CPU within
    SCORE_TOL, unrounded and in the score files (%.3f); AUC card vs CPU
    within E2E_AUC_TOL;
    the eval scores of those records against ``score_records_offline``
    within SCORE_TOL;
    ``tree_traverse`` launched models x chunks times during the card's
    ``eval``, counted from zero just before it."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.eval.scorer import Scorer, load_models
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.pipeline.evaluate import score_records_offline
    from shifu_tpu_torch.serve.transform import FusedTransform
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH,
                       "Loss": "log", "LearningRate": 0.1}
    ev = mc.evals[0].dataSet          # `new`'s eval set, on the same CSV
    ev.dataPath, ev.dataDelimiter = csv, "|"
    ev.headerPath, ev.headerDelimiter = csv + ".header", "|"
    mc.save(path)
    device, cpu_dir = "cuda", d + "_eval_cpu"
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    walls = {}

    def step(name, *argv):
        t0 = time.perf_counter()
        if cli.main(["--dir", argv[0], *argv[1:]]) != 0:
            fail(f"{' '.join(argv[1:])} exited non-zero in {argv[0]}")
        walls[name] = time.perf_counter() - t0

    passes = {}

    def served(name, *argv):
        """``step`` that must be served from the raw cache stats wrote."""
        before = dict(parsepool.cache_passes)
        step(name, *argv)
        passes[name] = {k: parsepool.cache_passes[k] - before[k]
                        for k in ("hits", "misses")}
        if passes[name] != {"hits": 1, "misses": 0}:
            fail(f"{name} made raw cache passes {passes[name]}, not one hit")

    try:
        served("norm", d, "norm")
        zero_tree_counts()
        step("train", d, "train", "--device", device)
        train_launches = read_tree_counts()
        step("eval_new", d, "eval", "-new", E2E_EVAL)
        shutil.copytree(d, cpu_dir)
        tq.predict_forest_quant.launches = 0
        served("eval", d, "eval", "-run", E2E_EVAL, "--device", device)
        eval_launches = tq.predict_forest_quant.launches
        served("eval_cpu", cpu_dir, "eval", "-run", E2E_EVAL, "--device",
               "cpu")
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
    want = {"hist": TRAIN_TREES * (DEPTH + 1), "leaf_sums": TRAIN_TREES,
            "hist_batch": 0, "tree_traverse": 0}
    if train_launches != want:
        fail(f"e2e train launched {train_launches}, not {want}")
    n_models = len(load_models(os.path.join(d, "models")))
    chunks = -(-CSV_ROWS // CSV_CHUNK)
    if eval_launches != n_models * chunks:
        fail(f"eval launched tree_traverse {eval_launches} times for "
             f"{n_models} model(s) x {chunks} chunks")

    clean = Shards.open(os.path.join(d, "tmp", "CleanedData"))
    plane = clean.load_all()
    bins = plane["bins"]
    if not clean.is_wire or bins.shape != (CSV_ROWS, N_COLS) or \
            bins.dtype != np.uint8:
        fail(f"norm wrote a {bins.dtype} plane of {bins.shape} "
             f"(wire {clean.is_wire}), not {CSV_ROWS} x {N_COLS} uint8")
    # the host-side checks below read the CSV's first E2E_CHECK_ROWS
    # records (the smoke's time budget)
    recs = csv_records(csv)[:E2E_CHECK_ROWS]
    tf = FusedTransform.from_dir(d, dtype=torch.float64)
    t0 = time.perf_counter()
    packed, kept, errors = tf.parse_records(recs)
    parse_s = time.perf_counter() - t0
    if errors or len(kept) != E2E_CHECK_ROWS:
        fail(f"serve parse rejected {len(errors)} of the CSV's records")
    _, dev_bins = tf.apply_device(torch.from_numpy(packed).to(device),
                                  need_x=False)
    bins_differ = int((dev_bins.cpu().numpy()
                       != bins[:E2E_CHECK_ROWS]).sum())
    if bins_differ:
        fail(f"the norm plane's bins differ from the serving transform's "
             f"in {bins_differ} cells")

    card, perf = eval_scores(d, E2E_EVAL)
    cpu, cpu_perf = eval_scores(cpu_dir, E2E_EVAL)
    if card.shape != (CSV_ROWS, 6 + n_models) or card.shape != cpu.shape \
            or not np.array_equal(card[:, :2], cpu[:, :2]):
        fail(f"EvalScore card {card.shape} and CPU {cpu.shape} disagree "
             "in shape, tag or weight")
    card_cpu = float(np.abs(card[:, 2:].astype(float)
                            - cpu[:, 2:].astype(float)).max())
    if not card_cpu <= SCORE_TOL + 1e-9:
        fail(f"eval scores card vs CPU differ by {card_cpu}")
    # the same rows unrounded: the eval scorer on the plane's bins (the
    # eval transform's bins, the same code on the same CSV)
    raw = [Scorer.from_dir(os.path.join(d, "models"), device=dv).score(
        None, bins).mean for dv in (device, "cpu")]
    card_cpu_raw = float(np.abs(raw[0] - raw[1]).max())
    if not card_cpu_raw <= SCORE_TOL:
        fail(f"unrounded eval scores card vs CPU differ by {card_cpu_raw}")
    auc_diff = abs(perf["areaUnderRoc"] - cpu_perf["areaUnderRoc"])
    if not auc_diff <= E2E_AUC_TOL or not 0.6 < perf["areaUnderRoc"] < 1.0:
        fail(f"eval AUC {perf['areaUnderRoc']} on the card vs "
             f"{cpu_perf['areaUnderRoc']} on the CPU")
    t0 = time.perf_counter()
    offline = score_records_offline(d, recs, device=device)
    offline_s = time.perf_counter() - t0
    offline_diff = float(np.abs(card[:E2E_CHECK_ROWS, 2].astype(float)
                                - offline).max())
    if not offline_diff <= SCORE_TOL:
        fail(f"eval scores vs score_records_offline differ by "
             f"{offline_diff}")
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        profile = json.load(f)
    log(f"main path (e2e): raw cache passes {passes}; "
        f"norm {walls['norm']:.3f} s "
        f"({profile['NORMALIZE']['phases_s']}) -> {CSV_ROWS} x {N_COLS} "
        f"uint8 wire plane, bins equal to the serving transform's on "
        f"{E2E_CHECK_ROWS} rows (its host parse {parse_s:.3f} s); train "
        f"{walls['train']:.3f} s "
        f"({TRAIN_TREES} trees, launches {train_launches}); eval -run "
        f"{walls['eval']:.3f} s on {device} ({CSV_ROWS / walls['eval']:.0f}"
        f" rows/s, {profile['EVAL']['phases_s']}), {eval_launches} "
        f"tree_traverse launches ({n_models} model(s) x {chunks} chunks); "
        f"CPU eval {walls['eval_cpu']:.3f} s; AUC {perf['areaUnderRoc']:.6f}"
        f" (card - CPU {auc_diff:.3g}); max |card - CPU| score "
        f"{card_cpu_raw:.3g} ({card_cpu:.3g} in the %.3f score files), "
        f"max |eval - offline| {offline_diff:.3g} (offline scoring of "
        f"{E2E_CHECK_ROWS} rows {offline_s:.3f} s) — [{gpu}]")
    return {"walls_s": walls, "train_launches": train_launches,
            "eval_launches": eval_launches, "cache_passes": passes,
            "auc": perf["areaUnderRoc"],
            "auc_card_cpu": auc_diff, "score_card_cpu": card_cpu_raw,
            "score_card_cpu_files": card_cpu,
            "score_offline": offline_diff, "rows_per_s":
            CSV_ROWS / walls["eval"], "serve_parse_s": parse_s,
            "phases_s": {k: profile[k]["phases_s"]
                         for k in ("NORMALIZE", "TRAIN", "EVAL")},
            "bins": bins}


# ------------------------------------------------------------ phase: NN
def nn_plane(rng, n: int, d: int):
    """The NN training plane: x [n, d] f32 standard normal (one ZSCALE
    value a column, as ``norm`` writes the final-selected columns; drawn
    on the card by a generator seeded from ``rng``, as the host draw of a
    plane this size takes seconds), y from a logit on N_INFORMATIVE
    columns, integer weights 1..3."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(int(rng.integers(1 << 62)))
    x = torch.randn((n, d), generator=gen, device="cuda").cpu().numpy()
    cols = np.sort(rng.choice(d, size=N_INFORMATIVE, replace=False))
    coef = rng.choice([-1.0, 1.0], N_INFORMATIVE) \
        * rng.uniform(0.4, 1.2, N_INFORMATIVE)
    logit = x[:, cols] @ coef.astype(np.float32) - 1.0
    y = (rng.random(n, np.float32) < 1.0 / (1.0 + np.exp(-logit))) \
        .astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    return x, y, w


def write_norm_plane(d: str, x, y, w, names) -> None:
    """The norm step's ``tmp/NormalizedData`` as the port's ``norm``
    writes it: npz ``part-*.npz`` shards of (x, y, w) of 2^18 rows and
    ``schema.json``."""
    from shifu_tpu_torch.ioutil import atomic_savez, atomic_write_json
    os.makedirs(d)
    shard, rows = 1 << 18, []
    for i, r0 in enumerate(range(0, len(y), shard)):
        atomic_savez(os.path.join(d, f"part-{i:05d}.npz"),
                     x=x[r0:r0 + shard], y=y[r0:r0 + shard],
                     w=w[r0:r0 + shard])
        rows.append(min(shard, len(y) - r0))
    atomic_write_json(os.path.join(d, "schema.json"), {
        "outputNames": names, "columnNums": list(range(len(names))),
        "columnNames": names, "normType": "ZSCALE", "numShards": len(rows),
        "numRows": len(y), "shardRows": rows, "width": len(names)})


class EpochClock:
    """Host clock at each epoch's progress line: the trainer calls it
    right after its one host fetch an epoch, so the gaps are epoch walls
    (``TrainProcessor._progress_fn`` wrapped while the context is open)."""

    def __enter__(self):
        from shifu_tpu_torch.pipeline.train import TrainProcessor
        self.times, self._orig = [], TrainProcessor._progress_fn
        clock = self

        def wrapped(proc, pf, run):
            inner = clock._orig(proc, pf, run)

            def progress(epoch, tr, va):
                clock.times.append(time.perf_counter())
                inner(epoch, tr, va)
            return progress
        TrainProcessor._progress_fn = wrapped
        return self

    def __exit__(self, *exc):
        from shifu_tpu_torch.pipeline.train import TrainProcessor
        TrainProcessor._progress_fn = self._orig
        return False

    def ms_per_epoch(self) -> float:
        """Median epoch wall (the first epoch has no start mark)."""
        return float(np.median(np.diff(self.times))) * 1e3


def nn_set(root: str, name: str, serve_root: str, plane: str,
           algorithm: str, params=None, **train) -> str:
    """A model set over the NN plane ``plane``; ``params`` None takes
    ``init -model``'s defaults for the algorithm (through the CLI)."""
    from shifu_tpu_torch import cli
    d = write_train_set(os.path.join(root, name), serve_root, params or {},
                        plane, algorithm, plane_dir="NormalizedData")
    if params is None and cli.main(["--dir", d, "init", "-model"]) != 0:
        fail(f"init -model failed in {d}")
    set_train_conf(d, **train)
    return d


def nn_members(d: str) -> list:
    """``[(file, spec, params)]`` of every NN model of ``d``, loaded."""
    from shifu_tpu_torch.eval.scorer import discover_model_paths
    from shifu_tpu_torch.models.nn import load_model
    return [(os.path.basename(p), *load_model(p))
            for p in discover_model_paths(os.path.join(d, "models"))]


def nn_scores(torch, d: str, x, device) -> np.ndarray:
    """The set's mean score (0-1000) over rows ``x`` on ``device``."""
    from shifu_tpu_torch.eval.scorer import Scorer
    return Scorer.from_dir(os.path.join(d, "models"), device=device).score(
        x, None).mean


def check_falling(d: str, what: str, cols=(0, 1)) -> np.ndarray:
    """``tmp/train.progress``'s errors: finite, and the train (column 0)
    and validation (1) errors of ``cols`` lower at the last epoch."""
    errs = progress_errors(d)
    if len(errs) < 2 or not np.all(np.isfinite(errs)) or \
            not np.all(errs[-1, list(cols)] < errs[0, list(cols)]):
        fail(f"{what}: train/validation errors do not fall: "
             f"{errs[0] if len(errs) else None} -> "
             f"{errs[-1] if len(errs) else None}")
    return errs


def nn_phase(torch, root: str, serve_root: str, rng, gpu: str) -> dict:
    """The NN/LR slice's training path at full width through ``cli.main
    train`` on ``cuda``: a norm plane of NN_ROWS x N_COLS f32 from
    ``--seed`` (1.07 GB, resident under the 2 GiB budget), written as the
    port's ``norm`` writes it.

    (a) ``init -model``'s NN (R, LearningRate 0.1, [20, 10] tanh, full
        batch) with baggingNum NN_BAGS and CheckpointInterval NN_CKPT for
        NN_EPOCHS epochs: NN_BAGS model files ``load_any`` scores, falling
        errors, ms per epoch; NN_CKPT epochs then ``train -resume`` to
        NN_EPOCHS, bit-identical to the uninterrupted run;
    (b) ``bench_nn``'s wide net (NN_WIDE) for NN_WIDE_EPOCHS epochs: ms per
        step and per epoch, the step's 6 * rows * parameters FLOPs over its
        time against the card's dense FP32 peak;
    (c) LR at ``init -model``'s params: ms per epoch;
    (d) (a)'s net on the plane's first CUT_ROWS rows for NN_CUT_EPOCHS
        epochs on ``cuda`` and on ``cpu``: per-epoch errors within
        NN_ERR_RTOL relative, the two sets' AUCs within NN_AUC_TOL."""
    from shifu_tpu_torch.models import load_any
    names = [f"f{j:03d}" for j in range(N_COLS)]
    t0 = time.perf_counter()
    x, y, w = nn_plane(rng, NN_ROWS, N_COLS)
    plane = os.path.join(root, "nn_plane")
    write_norm_plane(plane, x, y, w, names)
    write_s = time.perf_counter() - t0
    out = {"plane_gb": x.nbytes / 1e9, "plane_write_s": write_s}

    # (a) init -model's NN, bagged, resumed
    a = nn_set(root, "nn_a", serve_root, plane, "NN", baggingNum=NN_BAGS,
               numTrainEpochs=NN_EPOCHS)
    set_train_params(a, {**load_params(a), "CheckpointInterval": NN_CKPT})
    with EpochClock() as clock:
        wall = train_cli(a, "cuda")
    members = nn_members(a)
    if [m[0] for m in members] != [f"model{i}.nn" for i in range(NN_BAGS)]:
        fail(f"(a) wrote {[m[0] for m in members]}")
    head = x[:4096]
    for f, _, _ in members:
        s = load_any(os.path.join(a, "models", f)).compute(head, "cuda")
        if s.shape != (4096, 1) or not np.all(np.isfinite(s)):
            fail(f"(a) {f} scores {s.shape}, finite {np.isfinite(s).all()}")
    errs = check_falling(a, "(a)")
    r = nn_set(root, "nn_a_resume", serve_root, plane, "NN",
               baggingNum=NN_BAGS, numTrainEpochs=NN_CKPT)
    set_train_params(r, load_params(a))
    train_cli(r, "cuda")
    set_train_conf(r, numTrainEpochs=NN_EPOCHS)
    train_cli(r, "cuda", "-resume")
    for (f, _, pa), (_, _, pr) in zip(members, nn_members(r)):
        for la, lr in zip(pa, pr):
            if not all(torch.equal(la[k], lr[k]) for k in ("w", "b")):
                fail(f"(a) {f}: {NN_CKPT} epochs + train -resume differ "
                     "from the uninterrupted run")
    prof = nn_epoch_profile(torch, a, x, y, w, "(a)", epochs=5)
    out["a"] = {"ms_per_epoch": clock.ms_per_epoch(), "wall_s": wall,
                "profile": prof,
                "errors_first": errs[0].tolist(),
                "errors_last": errs[-1].tolist(), "resume_bit_identical":
                True}
    log(f"(a) init -model NN x {NN_BAGS} bags on {NN_ROWS} x {N_COLS}: "
        f"{out['a']['ms_per_epoch']:.3f} ms an epoch (CLI train "
        f"{wall:.3f} s for {NN_EPOCHS} epochs), errors {errs[0]} -> "
        f"{errs[-1]}; {NN_CKPT} epochs + train -resume bit-identical "
        f"— [{gpu}]")

    # (b) the wide net
    b = nn_set(root, "nn_b", serve_root, plane, "NN", dict(NN_WIDE),
               baggingNum=1, numTrainEpochs=NN_WIDE_EPOCHS)
    with EpochClock() as clock:
        wall = train_cli(b, "cuda")
    # the wide net overfits the plane's 246 noise columns within three
    # epochs: its validation error may rise while the train error falls
    check_falling(b, "(b)", cols=(0,))
    (_, spec, params), = nn_members(b)
    n_params = sum(int(l[k].numel()) for l in params for k in ("w", "b"))
    steps = -(-NN_ROWS // NN_WIDE["MiniBatchs"])
    ms_epoch = clock.ms_per_epoch()
    ms_step = ms_epoch / steps
    flops_step = 6.0 * NN_WIDE["MiniBatchs"] * n_params
    rate = flops_step / (ms_step * 1e-3)
    q = len(y) // NN_PROFILE_SHARE          # (b) profiled on a quarter
    out["b"] = {"profile": nn_epoch_profile(torch, b, x[:q], y[:q], w[:q],
                                            "(b)", 1),
                "ms_per_epoch": ms_epoch, "ms_per_step": ms_step,
                "steps_per_epoch": steps, "parameters": n_params,
                "flops_per_step": flops_step, "flop_per_s": rate,
                "fp32_peak_share": rate / FP32_PEAK, "wall_s": wall}
    log(f"(b) wide NN {NN_WIDE['NumHiddenNodes']} ADAM, MiniBatchs "
        f"{NN_WIDE['MiniBatchs']}: {ms_epoch:.3f} ms an epoch, "
        f"{ms_step:.4f} ms a step ({steps} steps; the epoch's error pass "
        f"included), {flops_step / 1e9:.3f} GFLOP a step (6 x rows x "
        f"{n_params} parameters) -> {rate / 1e12:.3f} TFLOP/s, "
        f"{100 * rate / FP32_PEAK:.2f}% of the H100 SXM's dense FP32 peak "
        f"of 67 TFLOP/s (NVIDIA data sheet) — [{gpu}]")

    # (c) LR at init -model's params
    c = nn_set(root, "nn_c", serve_root, plane, "LR", baggingNum=1,
               numTrainEpochs=NN_LR_EPOCHS)
    with EpochClock() as clock:
        wall = train_cli(c, "cuda")
    check_falling(c, "(c)")
    out["c"] = {"ms_per_epoch": clock.ms_per_epoch(), "wall_s": wall}
    log(f"(c) LR ({load_params(c)}): {out['c']['ms_per_epoch']:.3f} ms an "
        f"epoch — [{gpu}]")

    # (d) the card against the CPU on the first CUT_ROWS rows
    cut = os.path.join(root, "nn_cut_plane")
    write_norm_plane(cut, x[:CUT_ROWS], y[:CUT_ROWS], w[:CUT_ROWS], names)
    runs = []                                   # (wall, errors, AUC)
    for i, dev in enumerate(("cuda", "cpu")):
        dd = nn_set(root, f"nn_d{i}", serve_root, cut, "NN",
                    load_params(a), baggingNum=NN_BAGS,
                    numTrainEpochs=NN_CUT_EPOCHS)
        runs.append((train_cli(dd, dev), progress_errors(dd),
                     auc(nn_scores(torch, dd, x[:CUT_ROWS], dev),
                         y[:CUT_ROWS])))
    card, cpu = runs
    rel = float(np.max(np.abs(card[1] - cpu[1]) / np.abs(cpu[1])))
    auc_diff = abs(card[2] - cpu[2])
    if not rel <= NN_ERR_RTOL or not auc_diff <= NN_AUC_TOL:
        fail(f"(d) card vs CPU: errors {rel:.3g} relative (limit "
             f"{NN_ERR_RTOL}), AUC {card[2]:.6f} vs {cpu[2]:.6f}")
    out["d"] = {"err_rel": rel, "auc_cuda": card[2], "auc_cpu": cpu[2],
                "auc_diff": auc_diff, "wall_cuda_s": card[0],
                "wall_cpu_s": cpu[0]}
    log(f"(d) {CUT_ROWS} rows, {NN_CUT_EPOCHS} epochs: errors card vs CPU "
        f"within {rel:.3g} relative, AUC {card[2]:.6f} / {cpu[2]:.6f}; "
        f"train {card[0]:.3f} s on the card, {cpu[0]:.3f} s on the CPU "
        f"— [{gpu}]")
    out["models_dir"] = os.path.join(a, "models")
    return out


def nn_epoch_profile(torch, d: str, x, y, w, what: str,
                     epochs: int) -> dict:
    """Set ``d``'s trainer on resident tensors under ``torch.profiler``:
    ``train_ensemble`` for ``epochs`` epochs with the set's members and
    masks; device ms an epoch in kernels (the plane's upload and other
    copies left out), the GEMMs' share, launches an epoch."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.pipeline.train import settings_from_params
    from shifu_tpu_torch.train.nn_trainer import train_ensemble
    from shifu_tpu_torch.train.sampling import member_masks
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    spec = nn_members(d)[0][1]
    tw, vw = member_masks(len(y), mc.train.baggingNum,
                          valid_rate=mc.train.validSetRate, targets=y)
    settings = settings_from_params(mc.train.params, mc.train)
    settings.epochs = epochs
    prof = profile_device(
        torch, lambda: train_ensemble(x, y, tw * w, vw * w, spec, settings,
                                      device="cuda"),
        what=f"{epochs} epoch(s) of {what}'s trainer over {len(y)} rows, "
        "upload included")
    if not prof:
        return {}
    kern = {k: v for k, v in prof["by_name"].items()
            if not k.startswith(("Memcpy", "Memset"))}
    busy = sum(ms for ms, _ in kern.values()) / epochs
    gemm = sum(ms for k, (ms, _) in kern.items()
               if "gemm" in k.lower() or "cutlass" in k.lower()) / epochs
    launches = sum(n for _, n in kern.values()) / epochs
    log(f"{what}: device busy {busy:.3f} ms an epoch of {len(y)} rows in "
        f"kernels (GEMMs {gemm:.3f} ms), {launches:.0f} kernel launches an "
        "epoch")
    return {"kernel_ms_per_epoch": busy, "gemm_ms_per_epoch": gemm,
            "launches_per_epoch": launches, "top": prof["top"]}


def load_params(d: str) -> dict:
    from shifu_tpu_torch.config import ModelConfig
    return dict(ModelConfig.load(os.path.join(d, "ModelConfig.json"))
                .train.params or {})


def nn_serve_phase(torch, tq, root: str, serve_root: str, models: str,
                   plan, rng) -> dict:
    """(a)'s bagged NN set of N_COLS inputs served over HTTP on ``cuda``
    (the serving set's configs, ``x`` from the fused transform into one
    stacked forward), checked against the same set on ``cpu`` within
    NN_SCORE_TOL over the raw batches of GEMM_RAW_BATCHES records."""
    from shifu_tpu_torch.config.model_config import Algorithm
    d = os.path.join(root, "nn_serve")
    os.makedirs(d)
    for f in ("ModelConfig.json", "ColumnConfig.json"):
        shutil.copy(os.path.join(serve_root, f), d)
    shutil.copytree(models, os.path.join(d, "models"))
    set_train_conf(d, algorithm=Algorithm.NN)
    return serve_phase(torch, tq, d, plan, rng, tol=NN_SCORE_TOL,
                       raw_batches=GEMM_RAW_BATCHES)


def e2e_nn_phase(torch, d: str, csv: str, gpu: str) -> dict:
    """``bench.py --plane e2e``'s NN on the e2e set's own norm plane (the
    port's ``norm`` wrote it): ``train`` on ``cuda``, then ``eval -run`` on
    ``cuda`` and on ``cpu``: scores within NN_SCORE_TOL (the %.3f files),
    AUC within NN_E2E_AUC_TOL."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data import parsepool
    set_train_params(d, dict(NN_E2E))
    set_train_conf(d, algorithm=Algorithm.NN, numTrainEpochs=NN_E2E_EPOCHS)
    cpu_dir = d + "_nn_cpu"
    walls = {}
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        walls["train"] = train_cli(d, "cuda")
        shutil.copytree(d, cpu_dir)
        for name, dd, dev in (("eval", d, "cuda"), ("eval_cpu", cpu_dir,
                                                    "cpu")):
            t0 = time.perf_counter()
            if cli.main(["--dir", dd, "eval", "-run", E2E_EVAL, "--device",
                         dev]) != 0:
                fail(f"NN eval -run on {dev} exited non-zero")
            walls[name] = time.perf_counter() - t0
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
    check_falling(d, "e2e NN")
    card, perf = eval_scores(d, E2E_EVAL)
    cpu, cpu_perf = eval_scores(cpu_dir, E2E_EVAL)
    if card.shape != (CSV_ROWS, 7) or card.shape != cpu.shape:
        fail(f"NN EvalScore card {card.shape} vs CPU {cpu.shape}")
    diff = float(np.abs(card[:, 2:].astype(float)
                        - cpu[:, 2:].astype(float)).max())
    auc_diff = abs(perf["areaUnderRoc"] - cpu_perf["areaUnderRoc"])
    # ten full-batch ADAM steps at 0.001 (the bench's config) move the
    # net only a little: its AUC need only beat chance
    if not diff <= NN_SCORE_TOL or not auc_diff <= NN_E2E_AUC_TOL or \
            not 0.55 < perf["areaUnderRoc"] < 1.0:
        fail(f"NN eval card vs CPU: scores {diff}, AUC "
             f"{perf['areaUnderRoc']} vs {cpu_perf['areaUnderRoc']}")
    log(f"e2e NN {NN_E2E['NumHiddenNodes']} ({NN_E2E_EPOCHS} epochs): "
        f"train {walls['train']:.3f} s, eval -run {walls['eval']:.3f} s "
        f"on the card, {walls['eval_cpu']:.3f} s on the CPU; AUC "
        f"{perf['areaUnderRoc']:.6f} (card - CPU {auc_diff:.3g}), max "
        f"|card - CPU| score {diff:.3g} in the %.3f score files — [{gpu}]")
    return {"walls_s": walls, "auc": perf["areaUnderRoc"],
            "auc_card_cpu": auc_diff, "score_card_cpu_files": diff}


# ------------------------------------------------- phase: raw cache turns
WIRE_SUB = os.path.join("tmp", "CleanedData", ".spill_cache",
                        "spill-bins-y-w")


def file_bytes(d: str) -> dict:
    """Every file of directory ``d`` by name, as bytes."""
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = fh.read()
    return out


CACHE_TURNS = ("off", "on")                # raw_cache_phase's turns


def raw_cache_phase(d: str, gpu: str) -> dict:
    """``norm`` and ``eval -run`` on the card over the e2e set, with the
    raw cache ``stats`` wrote (on) and under ``-Dshifu.ingest.rawCache=
    false`` (off), in turns off, on (one turn each: the smoke's time
    budget), each turn in a fresh copy of
    the set and each step's wall around ``cli.main``.  Checks: an on turn
    is served (one hit a step, no miss), an off turn makes no cache pass;
    every turn's wire plane is byte-equal to the e2e phase's and its
    score file equal to the e2e phase's."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.data import parsepool
    want_plane = file_bytes(os.path.join(d, WIRE_SUB))
    with open(os.path.join(d, "evals", E2E_EVAL, "EvalScore"), "rb") as f:
        want_scores = f.read()
    walls = {"on": {"norm": [], "eval": []}, "off": {"norm": [], "eval": []}}
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        for i, mode in enumerate(CACHE_TURNS):
            t = f"{d}_cache_{i}"
            shutil.copytree(d, t)
            props = [] if mode == "on" else ["-Dshifu.ingest.rawCache=false"]
            before = dict(parsepool.cache_passes)
            for name, argv in (("norm", ["norm"]),
                               ("eval", ["eval", "-run", E2E_EVAL,
                                         "--device", "cuda"])):
                t0 = time.perf_counter()
                rc = cli.main([*props, "--dir", t, *argv])
                walls[mode][name].append(time.perf_counter() - t0)
                environment.set_property("shifu.ingest.rawCache", "")
                if rc != 0:
                    fail(f"{name} with the raw cache {mode} exited {rc}")
            got = {k: parsepool.cache_passes[k] - before[k]
                   for k in ("hits", "misses")}
            if got != ({"hits": 2, "misses": 0} if mode == "on"
                       else {"hits": 0, "misses": 0}):
                fail(f"raw cache {mode}: norm + eval made passes {got}")
            if file_bytes(os.path.join(t, WIRE_SUB)) != want_plane:
                fail(f"the wire plane with the raw cache {mode} differs")
            with open(os.path.join(t, "evals", E2E_EVAL, "EvalScore"),
                      "rb") as f:
                if f.read() != want_scores:
                    fail(f"eval scores with the raw cache {mode} differ")
            shutil.rmtree(t)
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
    log(f"raw cache on the e2e set ({CSV_ROWS} x {N_COLS + 2} CSV), in "
        f"turns {'/'.join(CACHE_TURNS)}: norm on {walls['on']['norm']} s, off "
        f"{walls['off']['norm']} s; eval -run on {walls['on']['eval']} s, "
        f"off {walls['off']['eval']} s; wire planes byte-equal, score files "
        f"equal — [{gpu}]")
    return walls


# -------------------------------------------------------- phase: posttrain
# featureImportance.csv values are bin-average spreads in score units
# (0-1000), card vs CPU apart only by the f32 order of the score sums
FI_TOL = 0.01


def posttrain_phase(torch, tq, d: str, gpu: str) -> dict:
    """``posttrain`` of the e2e set's GBT through the CLI on ``cuda`` and
    on ``cpu``, each in a copy of the set: ``tree_traverse`` launched once
    a model a norm shard on the card (counted from zero around it, none on
    the CPU); ``binAvgScore`` of every column within 1 card vs CPU (the
    rounded average of scores that differ in f32 summation order), every
    final-selected column scored; the two featureImportance.csv hold the
    same ranking, value for value within ``FI_TOL`` score units at each
    rank, and name for name except where two columns' CPU values tie
    within ``FI_TOL``."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.eval.scorer import load_models
    out, runs = {}, {}
    for dev in ("cuda", "cpu"):
        t = f"{d}_posttrain_{dev}"
        shutil.copytree(d, t)
        tq.predict_forest_quant.launches = 0
        t0 = time.perf_counter()
        if cli.main(["--dir", t, "posttrain", "--device", dev]) != 0:
            fail(f"posttrain on {dev} exited non-zero")
        out[f"wall_{dev}_s"] = time.perf_counter() - t0
        out[f"launches_{dev}"] = tq.predict_forest_quant.launches
        with open(os.path.join(t, "ColumnConfig.json")) as f:
            bas = {c["columnName"]: c["columnBinning"]["binAvgScore"]
                   for c in json.load(f)
                   if c["columnBinning"].get("binAvgScore")}
        with open(os.path.join(t, "posttrain",
                               "featureImportance.csv")) as f:
            fi = [(name, float(v)) for name, v in
                  (line.rstrip("\n").split("\t") for line in f)]
        runs[dev] = (bas, fi)
    n_shards = Shards.open(os.path.join(d, "tmp", "NormalizedData")).n_shards
    want = len(load_models(os.path.join(d, "models"))) * n_shards
    if out["launches_cuda"] != want or out["launches_cpu"] != 0:
        fail(f"posttrain launched tree_traverse {out['launches_cuda']} "
             f"times on the card (want {want}), {out['launches_cpu']} on "
             "the CPU")
    (card, fi_card), (cpu, fi_cpu) = runs["cuda"], runs["cpu"]
    if len(card) != N_COLS or set(card) != set(cpu):
        fail(f"posttrain scored {len(card)} columns on the card, "
             f"{len(cpu)} on the CPU, of {N_COLS} model inputs")
    diff = max(max(abs(a - b) for a, b in zip(card[k], cpu[k]))
               for k in card)
    if diff > 1:
        fail(f"posttrain card vs CPU: binAvgScore differs by {diff}")
    cpu_fi = dict(fi_cpu)
    if len(fi_card) != len(fi_cpu) or any(
            abs(vc - vp) > FI_TOL
            or (name != name_cpu
                and abs(cpu_fi.get(name, math.inf) - vp) > FI_TOL)
            for (name, vc), (name_cpu, vp) in zip(fi_card, fi_cpu)):
        fail("posttrain card vs CPU: featureImportance.csv ranks differ "
             f"(card {fi_card[:5]}, CPU {fi_cpu[:5]})")
    out["bin_avg_max_diff"] = diff
    log(f"posttrain of the e2e GBT: {out['launches_cuda']} tree_traverse "
        f"launch(es) on the card, {out['wall_cuda_s']:.3f} s (CPU "
        f"{out['wall_cpu_s']:.3f} s); binAvgScore card vs CPU within "
        f"{diff} over {N_COLS} columns — [{gpu}]")
    return out


# ---------------------------------------------- phase: NN out of core
class LogGrab:
    """The records of logger ``name`` that match ``pattern`` while it is
    installed (the logger at INFO meanwhile), and the host clock at
    each."""

    def __init__(self, name: str, pattern: str):
        import logging
        self.pattern = re.compile(pattern)
        self.logger = logging.getLogger(name)
        self.matches, self.times = [], []
        outer = self

        class _H(logging.Handler):
            def emit(self, record):
                m = outer.pattern.search(record.getMessage())
                if m:
                    outer.matches.append(m.groups())
                    outer.times.append(time.perf_counter())
        self.handler = _H()

    def __enter__(self):
        import logging
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)
        return False


def nn_stream_cli(d: str, device: str, props: dict, *extra: str):
    """``train`` of an NN set through the CLI with ``-D`` properties
    (cleared after the run); (wall s, the streamed run's window rows)."""
    from shifu_tpu_torch.config import environment
    argv = [f"-D{k}={v}" for k, v in props.items()]
    try:
        with LogGrab("shifu_tpu_torch.pipeline.train",
                     r"STREAMED on \w+: (\d+) rows x (\d+) features, "
                     r"window (\d+) rows") as g:
            wall = train_cli(d, device, *argv, *extra)
    finally:
        for k in props:
            environment.set_property(k, "")
    if len(g.matches) != 1:
        fail(f"train on {device} in {d} did not stream")
    return wall, int(g.matches[0][2])


def nn_stream_phase(torch, root: str, serve_root: str, rng,
                    gpu: str) -> dict:
    """The streamed NN/LR trainer at full width through ``cli.main train``
    on ``cuda``: a norm plane of NN_STREAM_ROWS x N_COLS f32 from
    ``--seed`` (1.35 GB at ``should_stream``'s 4 * (256 + 2) bytes a row),
    which streams by its ``shifu.train.memoryBudgetBytes`` of 1 GiB
    (NN_STREAM_BUDGET; a cut for the smoke's time budget from 2.71 GB
    and the default 2 GiB) with nothing forced, in two windows.

    (a) ``init -model``'s NN (full batch) for NN_STREAM_EPOCHS epochs:
        falling errors, ms an epoch; (b) NN_STREAM_CKPT epochs then
        ``train -resume`` to NN_STREAM_EPOCHS, bit-identical model files;
    (c) one minibatch run (ADAM, MiniBatchs NN_STREAM_BATCH) for 2 epochs;
    (d) the first CUT_ROWS rows forced to stream in windows of
        NN_STREAM_CUT_WINDOW, card and CPU: per-epoch errors within
        NN_ERR_RTOL relative;
    (e) ``torch.profiler`` over 2 epochs of (a)'s trainer: the device's
        busy share and the seconds an epoch."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import should_stream
    names = [f"f{j:03d}" for j in range(N_COLS)]
    t0 = time.perf_counter()
    x, y, w = nn_plane(rng, NN_STREAM_ROWS, N_COLS)
    plane = os.path.join(root, "nn_stream_plane")
    write_norm_plane(plane, x, y, w, names)
    out = {"plane_gb": NN_STREAM_ROWS * 4 * (N_COLS + 2) / 1e9,
           "plane_write_s": time.perf_counter() - t0}
    from shifu_tpu_torch.config import environment
    for k, v in NN_STREAM_BUDGET.items():
        environment.set_property(k, v)
    try:
        streams = should_stream(Shards.open(plane))
    finally:
        for k in NN_STREAM_BUDGET:
            environment.set_property(k, "")
    if not streams:
        fail("the NN stream plane does not stream by its budget")

    a = nn_set(root, "nn_s_a", serve_root, plane, "NN", baggingNum=1,
               numTrainEpochs=NN_STREAM_EPOCHS)
    set_train_params(a, {**load_params(a),
                         "CheckpointInterval": NN_STREAM_CKPT})
    with EpochClock() as clock:
        wall, window = nn_stream_cli(a, "cuda", NN_STREAM_BUDGET)
    windows = -(-NN_STREAM_ROWS // window)
    if windows < 2:
        fail(f"stream (a) took the plane in {windows} window(s)")
    errs = check_falling(a, "stream (a)")
    out["a"] = {"wall_s": wall, "ms_per_epoch": clock.ms_per_epoch(),
                "window_rows": window, "windows": windows,
                "errors_first": errs[0].tolist(),
                "errors_last": errs[-1].tolist()}
    log(f"stream (a) init -model NN on {NN_STREAM_ROWS} x {N_COLS} "
        f"({out['plane_gb']:.2f} GB): {windows} windows of {window} rows, "
        f"{NN_STREAM_EPOCHS} epochs in {wall:.3f} s through the CLI, "
        f"{out['a']['ms_per_epoch']:.1f} ms an epoch, errors {errs[0]} -> "
        f"{errs[-1]} — [{gpu}]")

    b = nn_set(root, "nn_s_b", serve_root, plane, "NN", load_params(a),
               baggingNum=1, numTrainEpochs=NN_STREAM_CKPT)
    nn_stream_cli(b, "cuda", NN_STREAM_BUDGET)
    set_train_conf(b, numTrainEpochs=NN_STREAM_EPOCHS)
    nn_stream_cli(b, "cuda", NN_STREAM_BUDGET, "-resume")
    for (f, _, pa), (_, _, pb) in zip(nn_members(a), nn_members(b)):
        for la, lb in zip(pa, pb):
            if not all(torch.equal(la[k], lb[k]) for k in ("w", "b")):
                fail(f"stream (b) {f}: {NN_STREAM_CKPT} epochs + train "
                     "-resume differ from the uninterrupted run")
    log(f"stream (b) {NN_STREAM_CKPT} epochs + train -resume to "
        f"{NN_STREAM_EPOCHS}: bit-identical — [{gpu}]")

    c = nn_set(root, "nn_s_c", serve_root, plane, "NN",
               {**load_params(a), "Propagation": "ADAM",
                "LearningRate": 0.01, "MiniBatchs": NN_STREAM_BATCH},
               baggingNum=1, numTrainEpochs=2)
    wall_c, _ = nn_stream_cli(c, "cuda", NN_STREAM_BUDGET)
    errs_c = check_falling(c, "stream (c) minibatch", cols=(0,))
    out["c"] = {"wall_s": wall_c, "errors": errs_c.tolist()}
    log(f"stream (c) minibatch (ADAM, MiniBatchs {NN_STREAM_BATCH}): 2 "
        f"epochs in {wall_c:.3f} s, errors {errs_c.tolist()} — [{gpu}]")

    cut = os.path.join(root, "nn_stream_cut")
    write_norm_plane(cut, x[:CUT_ROWS], y[:CUT_ROWS], w[:CUT_ROWS], names)
    runs = []
    for i, dev in enumerate(("cuda", "cpu")):
        dd = nn_set(root, f"nn_s_d{i}", serve_root, cut, "NN",
                    load_params(a), baggingNum=NN_BAGS,
                    numTrainEpochs=NN_CUT_EPOCHS)
        wall_d, _ = nn_stream_cli(
            dd, dev, {"shifu.train.streaming": "on",
                      "shifu.train.windowRows": NN_STREAM_CUT_WINDOW})
        runs.append((wall_d, progress_errors(dd)))
    rel = float(np.max(np.abs(runs[0][1] - runs[1][1]) / np.abs(runs[1][1])))
    if not rel <= NN_ERR_RTOL:
        fail(f"stream (d) card vs CPU: errors {rel:.3g} relative")
    out["d"] = {"err_rel": rel, "wall_cuda_s": runs[0][0],
                "wall_cpu_s": runs[1][0]}
    log(f"stream (d) {CUT_ROWS} rows in windows of {NN_STREAM_CUT_WINDOW}, "
        f"{NN_BAGS} bags, {NN_CUT_EPOCHS} epochs: errors card vs CPU within "
        f"{rel:.3g} relative; {runs[0][0]:.3f} s on the card, "
        f"{runs[1][0]:.3f} s on the CPU — [{gpu}]")
    out["e"] = nn_stream_profile(torch, a, window, gpu)
    del x, y, w
    return out


def nn_stream_profile(torch, d: str, window: int, gpu: str) -> dict:
    """``torch.profiler`` over 2 epochs of set ``d``'s streamed trainer
    (its windows, masks and settings): device busy share, seconds an
    epoch (the closing eval pass included in the wall)."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import (ShardStream,
                                                mask_fn_from_settings)
    from shifu_tpu_torch.pipeline.train import settings_from_params
    from shifu_tpu_torch.train.nn_trainer import train_ensemble_streamed
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    spec = nn_members(d)[0][1]
    settings = settings_from_params(mc.train.params, mc.train)
    settings.epochs = 2
    stream = ShardStream(Shards.open(os.path.join(d, "tmp",
                                                  "NormalizedData")),
                         ("x", "y", "w"), window, remainder_multiple=1)
    mask_fn = mask_fn_from_settings(1, valid_rate=mc.train.validSetRate,
                                    seed=settings.seed)
    prof = profile_device(
        torch, lambda: train_ensemble_streamed(stream, spec, settings, 1,
                                               mask_fn, device="cuda"),
        what="2 epochs (3 passes) of the streamed NN trainer")
    if not prof:
        return {}
    copies = sum(ms for k, (ms, _) in prof["by_name"].items()
                 if k.startswith("Memcpy"))
    out = {"busy_share": prof["busy_ms"] / prof["wall_ms"],
           "s_per_epoch": prof["wall_ms"] / 3e3, "copy_ms": copies,
           "busy_ms": prof["busy_ms"], "wall_ms": prof["wall_ms"],
           "top": prof["top"]}
    log(f"stream (e) 2 epochs + the closing pass: {out['s_per_epoch']:.3f} "
        f"s a pass, device busy {100 * out['busy_share']:.1f}% "
        f"({copies:.1f} ms of {prof['busy_ms']:.1f} busy ms in copies) "
        f"— [{gpu}]")
    return out


# -------------------------------------------------------- phase: varselect
def varsel_set(root: str, name: str, src: str, plane: str, rng,
               device: str, by: str = "SE", keep: int = VARSEL_KEEP,
               params=None, props=()) -> str:
    """A copy of NN set ``src``'s configs and ``model0.nn`` over norm
    plane ``plane``, its ColumnConfig named as the plane's features (f000
    ...; KS and IV from ``rng``), with ``filterBy`` ``by``, ``filterNum``
    ``keep`` and varSelect ``params``; runs ``varselect`` on ``device``
    there with ``-D`` ``props`` (cleared after the run)."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import (ModelConfig, environment,
                                        load_column_configs,
                                        save_column_configs)
    from shifu_tpu_torch.config.model_config import FilterBy
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "tmp"))
    os.makedirs(os.path.join(d, "models"))
    shutil.copy(os.path.join(src, "ModelConfig.json"), d)
    shutil.copy(os.path.join(src, "models", "model0.nn"),
                os.path.join(d, "models"))
    os.symlink(plane, os.path.join(d, "tmp", "NormalizedData"))
    ccs = load_column_configs(os.path.join(src, "ColumnConfig.json"))
    ks = rng.uniform(0.01, 0.5, len(ccs))
    for c, k in zip(ccs, ks):
        if c.is_candidate():
            c.columnName = f"f{c.columnNum:03d}"
            c.columnStats.ks, c.columnStats.iv = float(k), float(k) / 2
    save_column_configs(ccs, os.path.join(d, "ColumnConfig.json"))
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.varSelect.filterBy = FilterBy[by]
    mc.varSelect.filterNum = keep
    if params is not None:
        mc.varSelect.params = params
    mc.save(path)
    try:
        rc = cli.main(["--dir", d, *props, "varselect", "--device", device])
    finally:
        for p in props:
            environment.set_property(p[2:].split("=", 1)[0], "")
    if rc != 0:
        fail(f"varselect by {by} on {device} exited {rc} in {d}")
    return d


def varselect_phase(torch, root: str, nn_dir: str, cut_plane: str, rng,
                    gpu: str) -> dict:
    """``varselect`` with ``filterBy SE`` through the CLI on ``cuda`` over
    ``nn_phase``'s 262,144 x 256 plane with its (a) ``model0.nn``
    (streamed, mask-batched: MaskBatch 32 frozen forwards a launch); then
    the same on the plane's first CUT_ROWS rows on ``cuda`` and on
    ``cpu``: the same VARSEL_KEEP columns selected, SE scores within
    VARSEL_SE_ATOL."""
    def read(d):
        with open(os.path.join(d, "varsels", "se.json")) as f:
            se = json.load(f)
        with open(os.path.join(d, "ColumnConfig.json")) as f:
            sel = sorted(c["columnName"] for c in json.load(f)
                         if c.get("finalSelect"))
        return se, sel
    seed = int(rng.integers(1 << 31))
    t0 = time.perf_counter()
    full = varsel_set(root, "vs_full", nn_dir, os.path.join(
        nn_dir, "tmp", "NormalizedData"), np.random.default_rng(seed),
        "cuda")
    wall = time.perf_counter() - t0
    se, sel = read(full)
    if len(se) != N_COLS or len(sel) != VARSEL_KEEP or \
            not all(math.isfinite(v) for v in se.values()):
        fail(f"varselect scored {len(se)} columns, selected {len(sel)}")
    runs, walls = [], {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs.append(read(varsel_set(root, f"vs_cut_{dev}", nn_dir,
                                    cut_plane, np.random.default_rng(seed),
                                    dev)))
        walls[dev] = time.perf_counter() - t0
    (se_g, sel_g), (se_c, sel_c) = runs
    diff = max(abs(se_g[k] - se_c[k]) for k in se_c)
    if sel_g != sel_c or set(se_g) != set(se_c) or diff > VARSEL_SE_ATOL:
        fail(f"varselect card vs CPU: selections equal {sel_g == sel_c}, "
             f"SE scores within {diff}")
    top = list(se)[:5]
    log(f"varselect SE on {NN_ROWS} x {N_COLS}: {wall:.3f} s through "
        f"the CLI on the card, top {top}; on {CUT_ROWS} rows card vs CPU: "
        f"the same {VARSEL_KEEP} columns, SE within {diff:.3g} ({walls})"
        f" — [{gpu}]")
    return {"wall_s": wall, "cut_walls_s": walls, "se_diff": diff,
            "top": top}


# ------------------------------------------- phase: export, encode, combo
AUX_EXPORTS = (("pmml",), ("pmml", "-c"), ("columnstats",),
               ("woemapping",), ("bagging",), ("-t", "spec"))
SPEC_RTOL, SPEC_ATOL = 1e-5, 1e-6          # tests/test_reference_export.py
COMBO_AUC_TOL = 0.005                      # member AUCs, card vs CPU
COMBO_TREES = 5                            # combo WDL:GBT's GBT member
COMBO_ROWS = CSV_ROWS                      # combo's rows of the e2e CSV
GENETIC_KEEP = 64                          # GENETIC's filterNum
GENETIC_WINDOW = CUT_ROWS // 4             # streamed GENETIC's window rows
GENETIC_CUT = {"WrapperEpochs": 10, "POPULATION_MULTIPLY_CNT": 3}
RECURSIVE_KEEP = 3                         # the CSV's 3 informative columns
RECURSIVE_NN = {"NumHiddenNodes": [16], "ActivationFunc": ["tanh"],
                "Propagation": "ADAM", "LearningRate": 0.05}
RECURSIVE_EPOCHS = 30


def cli_ok(d: str, *argv: str) -> float:
    """A CLI command in model set ``d`` that must exit 0, parsing inline
    (INLINE_PARSE); its wall s."""
    from shifu_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main([INLINE_PARSE, "--dir", d, *argv])
    if rc != 0:
        fail(f"{' '.join(argv)} exited {rc} in {d}")
    return time.perf_counter() - t0


def files_under(d: str) -> dict:
    """{relative path: bytes} of every file under ``d``; a gzipped
    reference spec contributes its payload (its header carries the time
    of writing)."""
    import gzip
    out = {}
    for base, _, names in os.walk(d):
        for name in names:
            p = os.path.join(base, name)
            with open(p, "rb") as f:
                data = f.read()
            if data[:2] == b"\x1f\x8b":
                data = gzip.decompress(data)
            out[os.path.relpath(p, d)] = data
    return out


def export_pair(card: str, cpu: str, what: str) -> float:
    """Every AUX_EXPORTS type in both copies: the same files (export runs
    on the host, so the copies' files must be equal); total wall s."""
    wall = 0.0
    for argv in AUX_EXPORTS:
        wall += cli_ok(card, "export", *argv)
        cli_ok(cpu, "export", *argv)
        got, want = (files_under(os.path.join(x, "export"))
                     for x in (card, cpu))
        if got != want or not got:
            fail(f"{what} export {' '.join(argv)}: files differ between "
                 f"the copies ({sorted(set(got) ^ set(want))})")
    names = sorted(files_under(os.path.join(card, "export")))
    if not any(n.endswith(".pmml") for n in names) or not any(
            n.startswith("reference") for n in names):
        fail(f"{what} export wrote {names}")
    return wall


def csv_chunk(d: str, csv: str):
    """(the transform of the whole CSV as one chunk, the raw chunk, the
    column configs) of model set ``d``."""
    from shifu_tpu_torch.config import ModelConfig, load_column_configs
    from shifu_tpu_torch.data.reader import DataSource
    from shifu_tpu_torch.data.transform import DatasetTransformer
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    ccs = load_column_configs(os.path.join(d, "ColumnConfig.json"))
    (chunk,) = list(DataSource(csv, "|", header_path=csv + ".header")
                    .iter_chunks(CSV_ROWS))
    return DatasetTransformer(mc, ccs).transform(chunk), chunk, ccs


def spec_roundtrip_trees(torch, tq, d: str, csv: str) -> dict:
    """``export/reference/model0.gbt`` re-read by ``load_reference_tree``:
    its float64 host scores (link applied) against the native forest
    scored through ``tree_traverse`` on the card (launches counted), on
    the CSV's rows with every numeric the forest splits on present (the
    format imputes a missing numeric to its mean, where the native forest
    routes it through the missing bin; with 224 numeric columns of ~5%
    empty cells hardly any row has every numeric present)."""
    from shifu_tpu_torch.models.reference_import import load_reference_tree
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    ref = load_reference_tree(os.path.join(d, "export", "reference",
                                           "model0.gbt"))
    native = IndependentTreeModel.load(os.path.join(d, "models",
                                                    "model0.gbt"))
    tc, chunk, ccs = csv_chunk(d, csv)
    tq.predict_forest_quant.launches = 0
    card = native.compute(torch.from_numpy(tc.bins).to("cuda"))[:, 0]
    launches = tq.predict_forest_quant.launches
    by_num = {cc.columnNum: cc for cc in ccs}
    split_on = {int(f) for t in native.trees for f in t.split_feat if f >= 0}
    raw, missing = {}, np.zeros(tc.n, bool)
    for j, num in enumerate(native.spec.column_nums):
        cc = by_num[num]
        if cc.is_categorical():
            raw[num] = tc.bins[:, j].astype(np.float64)
        else:
            cells = chunk.col(cc.columnName)
            v = np.array([float(x) if str(x).strip() else np.nan
                          for x in cells])
            raw[num] = v
            if j in split_on:
                missing |= ~np.isfinite(v)
    t0 = time.perf_counter()
    host = 1.0 / (1.0 + np.exp(-ref.compute(raw)))
    host_s = time.perf_counter() - t0
    ok = ~missing
    err = np.abs(card[ok] - host[ok])
    if launches != 1 or ok.sum() < 100 or \
            not (err <= SPEC_ATOL + SPEC_RTOL * np.abs(host[ok])).all():
        fail(f"spec round trip: {launches} launch(es), {ok.sum()} complete "
             f"rows, max |card - host| {err.max() if ok.any() else None}")
    return {"launches": launches, "rows": int(ok.sum()),
            "split_columns": len(split_on),
            "max_abs_err": float(err.max()), "host_s": host_s}


def rf_encode_check(torch, tq, rf_dir: str, bins: np.ndarray) -> dict:
    """``encode``'s walk (``pipeline.encode.leaf_indices``) of the RF
    phase's depth-14 forest over ``bins`` on the card (one launch) and on
    the CPU (``traverse_nodes``): equal node ids, up to 32,766."""
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    from shifu_tpu_torch.pipeline.encode import leaf_indices
    model = IndependentTreeModel.load(os.path.join(rf_dir, "models",
                                                   "model0.rf"))
    tq.predict_forest_quant.launches = 0
    t0 = time.perf_counter()
    card = leaf_indices(model, torch.from_numpy(bins).to(
        "cuda", model.bins_dtype)).cpu().numpy()
    card_s = time.perf_counter() - t0
    launches = tq.predict_forest_quant.launches
    t0 = time.perf_counter()
    cpu = leaf_indices(model, torch.from_numpy(bins.astype(np.int32)))
    cpu_s = time.perf_counter() - t0
    differ = int((card != cpu.numpy()).sum())
    top = int(card.max())
    if launches != 1 or differ or top <= (1 << (RF_DEPTH - 1)):
        fail(f"RF encode walk: {launches} launch(es), {differ} ids differ "
             f"from the CPU's, deepest id {top}")
    return {"launches": launches, "max_node_id": top, "ms": card_s * 1e3,
            "cpu_ms": cpu_s * 1e3, "rows": len(bins)}


def headed_cut(csv: str, rows: int) -> str:
    """The CSV's first ``rows`` rows after its header line, as ``combo
    eval`` reads eval data (its reader takes no header file, as the
    reference's does)."""
    path = f"{csv}.head{rows}"
    with open(csv + ".header") as h, open(csv) as src, \
            open(path, "w") as out:
        out.write(h.read())
        for _, line in zip(range(rows), src):
            out.write(line)
    return path


def combo_pair(root: str, d: str, csv: str, algs: str = "LR:GBT",
               params=None, epochs=None) -> dict:
    """``combo new -alg <algs>`` (a GBT and one other member), ``run`` and
    ``eval`` through the CLI on the card and on the CPU, from copies of
    ``d`` whose training data and one eval set are the CSV's first
    COMBO_ROWS rows (a cut in rows: each member's ``norm`` and every eval
    parse the text), with ``params`` / ``epochs`` as the copies'
    train#params and numTrainEpochs where given: the GBT member's ``hist``
    launches (its 8 a tree) and the eval's ``tree_traverse`` launches (one
    a chunk) counted on the card, none on the CPU; member and assembled
    AUCs within COMBO_AUC_TOL."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.ops import tree_quant as tq
    out, walls, counts = {}, {}, {}
    cut = headed_cut(csv, COMBO_ROWS)
    tag = algs.replace(":", "_")
    for dev in ("cuda", "cpu"):
        p = os.path.join(root, f"combo_{tag}_{dev}")
        shutil.copytree(d, p)
        path = os.path.join(p, "ModelConfig.json")
        mc = ModelConfig.load(path)
        for ds in (mc.dataSet, mc.evals[0].dataSet):
            ds.dataPath, ds.headerPath = cut, None
        mc.evals = mc.evals[:1]
        if params is not None:
            mc.train.params = dict(params)
        if epochs is not None:
            mc.train.numTrainEpochs = epochs
        mc.save(path)
        cli_ok(p, "combo", "new", "-alg", algs)
        zero_tree_counts()
        walls[f"run_{dev}"] = cli_ok(p, "combo", "run", "--device", dev)
        counts[f"run_{dev}"] = read_tree_counts()
        tq.predict_forest_quant.launches = 0
        walls[f"eval_{dev}"] = cli_ok(p, "combo", "eval", "--device", dev)
        counts[f"eval_{dev}"] = tq.predict_forest_quant.launches
        with open(os.path.join(p, f"ComboEval.{mc.evals[0].name}.json")) \
                as f:
            out[dev] = json.load(f)
    chunks = -(-(COMBO_ROWS + 1) // CSV_CHUNK)   # the header shortens one
    run_want = (params or {}).get("TreeNum", TRAIN_TREES) * (DEPTH + 1)
    if counts["run_cuda"]["hist"] != run_want or counts["eval_cuda"] != \
            chunks or counts["eval_cpu"] or any(counts["run_cpu"].values()):
        fail(f"combo {algs} launches {counts}: want {run_want} hist "
             "launches in "
             f"the card's run and {chunks} tree_traverse in its eval")
    aucs = [(g["areaUnderRoc"], c["areaUnderRoc"]) for g, c in zip(
        out["cuda"]["memberAuc"], out["cpu"]["memberAuc"])]
    aucs.append((out["cuda"]["areaUnderRoc"], out["cpu"]["areaUnderRoc"]))
    diff = max(abs(a - b) for a, b in aucs)
    if len(aucs) != 3 or diff > COMBO_AUC_TOL or aucs[-1][0] < 0.6:
        fail(f"combo {algs} AUCs card vs CPU {aucs}")
    return {"walls_s": walls, "hist_launches": counts["run_cuda"]["hist"],
            "run_launches": counts["run_cuda"],
            "eval_launches": counts["eval_cuda"], "aucs": aucs,
            "auc_diff": diff}


def host_steps(card: str, cpu: str) -> dict:
    """``convert``, ``save``/``history``/``switch``/``show``, ``analysis
    -fi`` and ``test -filter`` (the training set) in both copies: the same
    return codes and files."""
    steps = (("convert", "-tozipb"), ("save", "v1"), ("history",),
             ("switch", "v1"), ("show",), ("analysis", "-fi", "{model}"),
             ("test", "-filter"))
    walls = {}
    for argv in steps:
        for x in (card, cpu):
            model = os.path.join(x, "models", "model0.gbt")
            walls[argv[0]] = cli_ok(x, *[a.format(model=model)
                                         for a in argv])
    for sub in ("models", ".backup"):
        got, want = (files_under(os.path.join(x, sub)) for x in (card, cpu))
        if got != want:
            fail(f"host steps: {sub} differs ({sorted(set(got) ^ set(want))})")
    if "model0.gbt.fi" not in files_under(os.path.join(card, "models")):
        fail("analysis -fi wrote no model0.gbt.fi")
    return walls


def aux_tree_phase(torch, tq, root: str, d: str, csv: str, rf_dir: str,
                   rf_bins: np.ndarray, gpu: str) -> dict:
    """The commands around the offline path on the e2e GBT set (the
    CSV_ROWS-row CSV at full width, the 10-tree depth-7 GBT), through the
    CLI on the card and with ``--device cpu``: (a) every export type, the
    copies' files equal, and ``export/reference/model0.gbt`` re-read
    against the native forest walked by ``tree_traverse`` on the card;
    (b) ``encode`` (one ``tree_traverse`` launch a chunk, its node-index
    walk) with ``tmp/EncodedData`` byte-equal to the CPU's, and the RF
    phase's depth-14 forest walked by ``encode`` over CUT_ROWS rows of
    the train plane; (c) ``combo`` LR:GBT; (f) the host steps."""
    from shifu_tpu_torch.data import parsepool
    card, cpu = (os.path.join(root, f"aux_gbt_{x}") for x in ("cuda", "cpu"))
    for x in (card, cpu):
        shutil.copytree(d, x)
    t_phase = time.perf_counter()
    walls = {"export": export_pair(card, cpu, "GBT")}
    roundtrip = spec_roundtrip_trees(torch, tq, card, csv)
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        tq.predict_forest_quant.launches = 0
        walls["encode"] = cli_ok(card, "encode")
        encode_launches = tq.predict_forest_quant.launches
        walls["encode_cpu"] = cli_ok(cpu, "encode", "--device", "cpu")
        combo = combo_pair(root, d, csv)
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
    chunks = -(-CSV_ROWS // CSV_CHUNK)
    enc = []
    for x in (card, cpu):
        with open(os.path.join(x, "tmp", "EncodedData"), "rb") as f:
            enc.append(f.read())
    lines = enc[0].decode().splitlines()
    if encode_launches != chunks or enc[0] != enc[1] or \
            len(lines) != CSV_ROWS + 1 or \
            lines[0] != "target|" + "|".join(f"tree{t}"
                                             for t in range(TRAIN_TREES)):
        fail(f"encode: {encode_launches} launches for {chunks} chunks, "
             f"EncodedData equal to the CPU's {enc[0] == enc[1]}, "
             f"{len(lines)} lines")
    rf_enc = rf_encode_check(torch, tq, rf_dir, rf_bins)
    walls["host_steps"] = host_steps(card, cpu)
    wall = time.perf_counter() - t_phase
    log(f"aux (GBT): export {walls['export']:.3f} s for "
        f"{len(AUX_EXPORTS)} types; spec round trip on "
        f"{roundtrip['rows']} rows complete in the forest's "
        f"{roundtrip['split_columns']} split columns within "
        f"{roundtrip['max_abs_err']:.3g} ({roundtrip['launches']} launch); "
        f"encode {walls['encode']:.3f} s on the card ({encode_launches} "
        f"tree_traverse launches), {walls['encode_cpu']:.3f} s on the "
        f"CPU, byte-equal; RF encode walk {rf_enc['ms']:.3f} ms on "
        f"{rf_enc['rows']} rows (deepest id {rf_enc['max_node_id']}, CPU "
        f"{rf_enc['cpu_ms']:.1f} ms); combo LR:GBT run {combo['walls_s']}"
        f", {combo['hist_launches']} hist and {combo['eval_launches']} "
        f"tree_traverse launches, AUCs {combo['aucs']}; host steps "
        f"{ {k: round(v, 3) for k, v in walls['host_steps'].items()} }; "
        f"phase {wall:.1f} s — [{gpu}]")
    return {"walls_s": walls, "wall_s": wall, "roundtrip": roundtrip,
            "encode_launches": encode_launches, "rf_encode": rf_enc,
            "combo": combo}


def aux_nn_phase(torch, root: str, d: str, gpu: str) -> dict:
    """The e2e NN set (``e2e_nn_phase``'s ``model0.nn`` on the CSV's norm
    plane) through the CLI: (a) every export type in two copies, files
    equal, and ``export/reference/model0.nn`` re-read by
    ``load_encog_nn`` scoring as the native net on the card; (e)
    ``varselect -recursive 2`` (SE, a net RECURSIVE_NN) on the card and
    on the CPU: the same ``ColumnConfig.json.{0,1,2}`` selections."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm, FilterBy
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.models import load_any
    from shifu_tpu_torch.models.nn import IndependentNNModel
    from shifu_tpu_torch.models.reference_import import load_encog_nn
    t_phase = time.perf_counter()
    card, cpu = (os.path.join(root, f"aux_nn_{x}") for x in ("cuda", "cpu"))
    for x in (card, cpu):
        shutil.copytree(d, x)
    walls = {"export": export_pair(card, cpu, "NN")}
    x = Shards.open(os.path.join(card, "tmp", "NormalizedData")) \
        .load_all()["x"]
    spec, params = load_encog_nn(os.path.join(card, "export", "reference",
                                              "model0.nn"))
    got = IndependentNNModel(spec, params).compute(x, device="cuda")
    want = load_any(os.path.join(card, "models", "model0.nn")).compute(
        x, device="cuda")
    nn_err = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.allclose(got, want, rtol=SPEC_RTOL,
                                                  atol=SPEC_ATOL):
        fail(f"Encog round trip of the NN differs by {nn_err}")
    sels = {}
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        for dev in ("cuda", "cpu"):
            r = os.path.join(root, f"recursive_{dev}")
            shutil.copytree(d, r)
            set_train_params(r, dict(RECURSIVE_NN))
            set_train_conf(r, algorithm=Algorithm.NN,
                           numTrainEpochs=RECURSIVE_EPOCHS)
            path = os.path.join(r, "ModelConfig.json")
            mc = ModelConfig.load(path)
            mc.varSelect.filterBy = FilterBy.SE
            mc.varSelect.filterNum = RECURSIVE_KEEP
            mc.save(path)
            walls[f"recursive_{dev}"] = cli_ok(
                r, "varselect", "-recursive", "2", "--device", dev)
            sels[dev] = []
            for i in range(3):
                with open(os.path.join(r, "varsels",
                                       f"ColumnConfig.json.{i}")) as f:
                    sels[dev].append(sorted(
                        c["columnName"] for c in json.load(f)
                        if c.get("finalSelect")))
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
    if sels["cuda"] != sels["cpu"] or \
            [len(s) for s in sels["cuda"][1:]] != [RECURSIVE_KEEP] * 2:
        fail(f"varselect -recursive 2: card {sels['cuda'][1:]} vs CPU "
             f"{sels['cpu'][1:]}")
    wall = time.perf_counter() - t_phase
    log(f"aux (NN): export {walls['export']:.3f} s, Encog round trip on "
        f"the card within {nn_err:.3g}; varselect -recursive 2 "
        f"{walls['recursive_cuda']:.3f} s on the card, "
        f"{walls['recursive_cpu']:.3f} s on the CPU, rounds select "
        f"{sels['cuda'][1:]}; phase {wall:.1f} s — [{gpu}]")
    return {"walls_s": walls, "wall_s": wall, "encog_err": nn_err,
            "recursive": sels["cuda"][1:]}


def genetic_set(root: str, name: str, src: str, plane: str, device: str,
                params: dict, *props: str) -> tuple:
    """``varsel_set`` with ``filterBy GENETIC``, ``filterNum``
    GENETIC_KEEP and wrapper ``params``.  Returns (genetic.json, selected
    names, the genetic phase's s from ``tmp/profile.json``)."""
    d = varsel_set(root, name, src, plane, np.random.default_rng(0), device,
                   "GENETIC", GENETIC_KEEP, params, props)
    with open(os.path.join(d, "varsels", "genetic.json")) as f:
        doc = json.load(f)
    with open(os.path.join(d, "ColumnConfig.json")) as f:
        sel = sorted(c["columnName"] for c in json.load(f)
                     if c.get("finalSelect"))
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        secs = json.load(f)["VARSELECT"]["phases_s"]["genetic"]
    return doc, sel, secs


def genetic_phase(torch, root: str, nn_dir: str, cut_plane: str,
                  gpu: str) -> dict:
    """``varselect`` with ``filterBy GENETIC`` through the CLI on the card
    over ``nn_phase``'s 262,144 x 256 plane (resident: the population's
    16 nets train as one stacked run, full batch), the reference's
    default WrapperSettings and filterNum GENETIC_KEEP: the wall and
    epochs a second.  Then on the plane's first CUT_ROWS rows (fewer
    epochs and generations, GENETIC_CUT) resident and streamed in windows
    of GENETIC_WINDOW, each on the card and on the CPU: the same
    ``genetic.json`` credit ranking and selection."""
    from shifu_tpu_torch.train.dvarsel import WrapperSettings
    defaults = WrapperSettings()
    t0 = time.perf_counter()
    doc, sel, secs = genetic_set(root, "gen_full", nn_dir, os.path.join(
        nn_dir, "tmp", "NormalizedData"), "cuda", {})
    wall = time.perf_counter() - t0
    epochs = defaults.generations * defaults.epochs
    if len(sel) != GENETIC_KEEP or len(doc["history"]) != \
            defaults.generations or len(doc["credit"]) != N_COLS:
        fail(f"GENETIC selected {len(sel)}, history "
             f"{len(doc['history'])}, credit {len(doc['credit'])}")
    cut, cut_walls = {}, {}
    window = f"-Dshifu.train.windowRows={GENETIC_WINDOW}"
    for mode, props in (("resident", ()), ("streamed", (
            "-Dshifu.train.streaming=on", window))):
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            cut[mode, dev] = genetic_set(root, f"gen_{mode}_{dev}", nn_dir,
                                         cut_plane, dev, GENETIC_CUT,
                                         *props)
            cut_walls[f"{mode}_{dev}"] = time.perf_counter() - t1
        (g, gs, _), (c, cs, _) = cut[mode, "cuda"], cut[mode, "cpu"]
        if list(g["credit"]) != list(c["credit"]) or gs != cs:
            fail(f"GENETIC {mode} card vs CPU: ranking equal "
                 f"{list(g['credit']) == list(c['credit'])}, selection "
                 f"equal {gs == cs}")
        fit = max(abs(a["best"] - b["best"]) / abs(b["best"])
                  for a, b in zip(g["history"], c["history"]))
        cut_walls[f"{mode}_fitness_rel"] = fit
    overlap = len(set(cut["resident", "cuda"][1])
                  & set(cut["streamed", "cuda"][1]))
    log(f"GENETIC varselect on {NN_ROWS} x {N_COLS}: {wall:.3f} s "
        f"through the CLI on the card, search {secs:.3f} s "
        f"({epochs / secs:.1f} epochs/s of {defaults.population} stacked "
        f"nets), best fitness {doc['history'][-1]['best']:.6f}; on "
        f"{CUT_ROWS} rows card = CPU for resident and streamed (windows "
        f"of {GENETIC_WINDOW}) ({ {k: round(v, 6) for k, v in cut_walls.items()} }); "
        f"resident and streamed selections share {overlap} of "
        f"{GENETIC_KEEP} — [{gpu}]")
    return {"wall_s": wall, "search_s": secs, "epochs_per_s": epochs / secs,
            "cut_walls_s": cut_walls, "overlap": overlap}


# --------------------------------------------------------- phase: members
def set_train_conf(d: str, **fields) -> None:
    """Set ``train`` section fields of model set ``d``'s ModelConfig."""
    from shifu_tpu_torch.config import ModelConfig
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    for k, v in fields.items():
        setattr(mc.train, k, v)
    mc.save(path)


def load_members(d: str, ext: str) -> list:
    """Every ``models/model*`` file of ``d`` in member order, loaded."""
    from shifu_tpu_torch.eval.scorer import discover_model_paths
    from shifu_tpu_torch.models.tree import load_model
    paths = discover_model_paths(os.path.join(d, "models"))
    if any(not p.endswith("." + ext) for p in paths):
        fail(f"{d}/models holds {paths}, not only .{ext} files")
    return [load_model(p) for p in paths]


def same_bits(a, b) -> bool:
    return all(getattr(a, k).tobytes() == getattr(b, k).tobytes()
               for k in ("split_feat", "left_mask", "leaf_value"))


def bagging_phase(torch, root: str, serve_root: str, plane, gpu: str,
                  single_chunk_ms: float) -> dict:
    """Bagged and k-fold GBT at full width through ``cli.main train`` on
    ``cuda``: the train phase's config (TreeNum 10, MaxDepth 7, Loss log)
    with ``baggingNum`` BAG_MEMBERS, then with ``isCrossValidation``,
    ``numKFold`` BAG_KFOLD.  The members of a round grow together: one
    ``hist_batch`` launch a level with TB = members (10 x 7 = 70) and one
    ``hist`` launch a tree for its leaf sums, counted from zero around
    each run.  Checks: one model file a member, each 10 depth-7 trees
    that load in the port, distinct forests (each bag draws its own
    validation split), a progress line a member tree; member 0 of the
    bagged run bit-identical to ``train_gbt`` on the card with member 0's
    settings (its validation split from seed 0 is member 0's).  Times the
    bagged members on resident tensors (ms a member tree) beside that
    single forest (ms a tree), and B2 at TB = BAG_MEMBERS for K in
    BAG_TIMED_NODES against its bound."""
    from dataclasses import replace
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.train import dt_trainer as dt
    bins, y, w, informative, is_cat, clean, cut, names = plane
    params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH, "Loss": "log",
              "LearningRate": 0.1}
    out = {}
    for name, conf, members in (
            ("bagging", {"baggingNum": BAG_MEMBERS}, BAG_MEMBERS),
            ("kfold", {"isCrossValidation": True, "numKFold": BAG_KFOLD},
             BAG_KFOLD)):
        d = write_train_set(os.path.join(root, name), serve_root, params,
                            clean)
        set_train_conf(d, **conf)
        zero_tree_counts()
        wall = train_cli(d, "cuda")
        launches = read_tree_counts()
        want = {"hist": members * TRAIN_TREES,
                "leaf_sums": members * TRAIN_TREES,
                "hist_batch": TRAIN_TREES * DEPTH, "tree_traverse": 0}
        if launches != want:
            fail(f"{name} train launched {launches}, not {want} (one "
                 f"hist_batch launch a level for the {members} members, "
                 "one hist launch a tree for its leaf sums)")
        forests = load_members(d, "gbt")
        if len(forests) != members or any(
                spec.n_trees != TRAIN_TREES or spec.depth != DEPTH
                or len(trees) != TRAIN_TREES or trees[0].split_feat[0] < 0
                for spec, trees in forests):
            fail(f"{name}: {len(forests)} model files, not {members} "
                 f"forests of {TRAIN_TREES} depth-{DEPTH} trees")
        if any(same_bits(a[1][0], b[1][0])
               for a, b in zip(forests, forests[1:])):
            fail(f"{name}: two neighbouring members grew the same tree")
        with open(os.path.join(d, "tmp", "train.progress")) as f:
            lines = re.findall(r"Bag \[(\d+)\] Tree #\d+ Train Error: (\S+)"
                               r" Validation Error: (\S+)", f.read())
        err = np.asarray([[float(a), float(b)] for _, a, b in lines])
        if len(lines) != members * TRAIN_TREES or \
                not np.isfinite(err).all():
            fail(f"{name}: {len(lines)} progress lines")
        with open(os.path.join(d, "tmp", "profile.json")) as f:
            phases = json.load(f)["TRAIN"]["phases_s"]
        last = err[TRAIN_TREES - 1::TRAIN_TREES, 1]
        log(f"main path ({name}): {members} GBT members x {TRAIN_TREES} "
            f"trees of depth {DEPTH} in {wall:.3f} s wall ({phases}); "
            f"launches {launches}; member validation errors "
            f"{[round(float(e), 6) for e in last]} — [{gpu}]")
        out[name] = {"launches": launches, "wall_s": wall,
                     "phases_s": phases, "dir": d, "forests": forests}

    # member 0 against a single train_gbt, and the members side by side
    # on resident tensors, timed
    d = out["bagging"]["dir"]
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    settings = dt.settings_from_params(params, mc.train, Algorithm.GBT)
    dev = torch.device("cuda")
    bins_d = dt.put_bins(bins, N_BINS, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = dt.train_gbt(bins_d, y, w, N_BINS, is_cat, settings,
                          device=dev)
    single_s = time.perf_counter() - t0
    member0 = out["bagging"]["forests"][0][1]
    if len(single.trees) != TRAIN_TREES or not all(
            same_bits(a, b) for a, b in zip(single.trees, member0)):
        fail("bagged member 0 differs from train_gbt on its weights")
    tw, vw = dt._tree_member_masks(mc, len(y), BAG_MEMBERS, -1, False, y,
                                   settings.seed, distinct=True)
    members = [replace(settings, seed=settings.seed + b)
               for b in range(BAG_MEMBERS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bagged = dt.train_gbt_bagged(bins_d, y, tw * w, vw * w, N_BINS, is_cat,
                                 members, device=dev)
    bagged_s = time.perf_counter() - t0
    for (_, trees), res in zip(out["bagging"]["forests"], bagged):
        if not all(same_bits(a, b) for a, b in zip(res.trees, trees)):
            fail("train_gbt_bagged on resident tensors differs from the "
                 "CLI's members")
    member_ms = bagged_s * 1e3 / (BAG_MEMBERS * TRAIN_TREES)
    single_ms = single_s * 1e3 / TRAIN_TREES
    log(f"bagged GBT on resident tensors: {member_ms:.3f} ms a member tree "
        f"({BAG_MEMBERS} members x {TRAIN_TREES} trees in {bagged_s:.3f} "
        f"s, one hist_batch launch a level for the {BAG_MEMBERS}); a single "
        f"train_gbt {single_ms:.3f} ms a tree in the same call (the train "
        f"phase's chunk: {single_chunk_ms:.3f} ms a tree); member 0 "
        f"bit-identical to the single run — [{gpu}]")
    del bins_d
    torch.cuda.empty_cache()
    rng = np.random.default_rng([TRAIN_TREES, BAG_MEMBERS])
    timed = {k: time_batch(torch, rng, gpu, BAG_MEMBERS, k, 2)
             for k in BAG_TIMED_NODES}
    for v in out.values():
        del v["forests"], v["dir"]
    out.update({"member_ms": member_ms, "single_ms": single_ms,
                "b2": timed})
    return out


class StreamLog:
    """Collects the streamed trainers' summary lines (``dt_trainer.
    _streamed_result``: windows, resident windows, disk passes, tail
    sweeps, repairs, surrender, bytes read) while it is installed."""
    PATTERN = re.compile(
        r"streamed (\w+): (\d+) trees; (\d+) windows of (\d+) rows, (\d+) "
        r"resident \((\d+) rows\); (\d+) disk passes, (\d+) tail sweeps, "
        r"(\d+) repairs, surrender at tree (-?\d+); (\d+) bytes read")
    KEYS = ("trees", "windows", "window_rows", "resident", "resident_rows",
            "disk_passes", "tail_sweeps", "repairs", "surrender",
            "bytes_read")

    def __init__(self):
        import logging
        self.runs = []
        outer = self

        class _H(logging.Handler):
            def emit(self, record):
                m = outer.PATTERN.search(record.getMessage())
                if m:
                    outer.runs.append(dict(zip(outer.KEYS, map(
                        int, m.groups()[1:]))))
        self.handler = _H()
        self.logger = logging.getLogger("shifu_tpu_torch.train.dt_trainer")

    def __enter__(self):
        import logging
        self.runs.clear()
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def stream_cli(d: str, device: str, props: dict, *extra: str):
    """``train`` through the CLI with ``-D`` properties, which are cleared
    again after the run (the CLI keeps them in the process); returns (wall
    s, the streamed runs' summaries, peak device bytes above the start)."""
    import torch
    from shifu_tpu_torch.config import environment
    argv = [f"-D{k}={v}" for k, v in props.items()]
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    try:
        with StreamLog() as sl:
            wall = train_cli(d, device, *argv, *extra)
    finally:
        for k in props:
            environment.set_property(k, "")
    peak = torch.cuda.max_memory_allocated() - base \
        if device == "cuda" else 0
    if not sl.runs:
        fail(f"train {' '.join(argv + list(extra))} on {device} logged no "
             "streamed run")
    return wall, [dict(r) for r in sl.runs], peak


def forests_equal(a, b) -> bool:
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


def stream_plane(rng, plan, root: str, names):
    """The out-of-core plane: STREAM_ROWS rows of the serving column plan
    (``train_plane``: y from the logit on N_INFORMATIVE columns, weights
    1-3) as the wire plane in shards of STREAM_WINDOW rows."""
    t0 = time.perf_counter()
    bins, y, w, informative, is_cat = train_plane(rng, plan, STREAM_ROWS,
                                                  on_card=False)
    clean = os.path.join(root, "stream_plane")
    write_plane(clean, bins, y, w, names, {"chip_smoke": "stream"},
                shard=STREAM_WINDOW)
    log(f"stream plane written in {time.perf_counter() - t0:.2f} s: "
        f"{STREAM_ROWS} rows x {N_COLS} columns in shards of "
        f"{STREAM_WINDOW} ({bins.nbytes / 1e9:.3f} GB of bins), "
        f"informative columns {informative.tolist()}, positive rate "
        f"{y.mean():.4f}")
    return bins, y, w, informative, is_cat, clean


def stream_phase(torch, root: str, serve_root: str, plan, rng, train_plane_,
                 gpu: str) -> dict:
    """The out-of-core tree trainers through ``cli.main train`` on
    ``cuda``: a STREAM_ROWS x 256 wire plane, which ``should_stream``
    streams on its own (4 * 258 bytes a row over the 2 GiB budget).

    (a) GBT (TreeNum 10, MaxDepth 7, Loss log, LearningRate 0.1) with
    ``windowRows`` STREAM_WINDOW: 8 windows, STREAM_RESIDENT resident in
    the 1 GiB device cache and 1 on the disk tail, coarse-to-fine (the
    card's default); the tree counters zeroed just before and read just
    after: B1 and B2 must both launch.  (a') the same with
    ``tailCoarseToFine=false``: bit-identical forest and progress, 10 x
    (7 + 2) tail sweeps, more than (a)'s.  (a0) the first
    STREAM_A0_TREES trees of the same GBT, cut to depth STREAM_A0_DEPTH,
    at the default geometry (no resident window), split differences from (a) counted, not gated.  (b) (a) with CheckpointInterval 5 stopped after
    6 trees (the checkpoint holds 5), ``train -resume`` to 10:
    bit-identical to (a); and the same checkpoint without its score
    sidecar: the restored trees replay through ``tree_traverse`` window by
    window, bit-identical.  (c) ``init -model``'s RF (depth 14) cut to
    STREAM_RF_TREES trees with ``windowRows`` STREAM_WINDOW: one
    super-batch (SB = 8), B2 and
    B1 launched, finite and falling out-of-bag errors.  (d) the first
    CUT_ROWS rows, windows of STREAM_CUT_WINDOW, STREAM_CUT_RESIDENT
    resident: (a)'s GBT with coarse-to-fine on and off and a
    STREAM_CUT_RF_TREES-tree depth-7 RF on ``cuda`` and ``cpu``: split
    features and masks equal, leaves and errors within STREAM_LEAF_RTOL /
    STREAM_ERR_RTOL, tail sweeps equal.  (e) streamed GBT (MEMBER_TREES
    trees) with ``baggingNum`` MEMBER_BAGS on the train phase's plane, windows of
    MEMBER_WINDOW, MEMBER_RESIDENT resident: member 1 bit-identical to a
    single ``train_gbt_streamed`` run with its mask function and seed.
    Then B2 at the tail window's path shape and B1 at the coalesced
    resident block's shape against their plain versions, timed."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import should_stream
    from shifu_tpu_torch.pipeline.create import _ALG_DEFAULT_PARAMS
    t_phase = time.perf_counter()
    names = [p[1] for p in plan]
    bins, y, w, informative, is_cat, clean = stream_plane(
        rng, plan, root, names)
    shards = Shards.open(clean)
    if not should_stream(shards):
        fail("the stream plane does not stream by the default budget")
    params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH, "Loss": "log",
              "LearningRate": 0.1}
    win = {"shifu.train.windowRows": str(STREAM_WINDOW)}
    out = {}

    # (a) coarse-to-fine on the card's default
    da = write_train_set(os.path.join(root, "stream_a"), serve_root, params,
                         clean)
    zero_tree_counts()
    wall, runs, peak = stream_cli(da, "cuda", win)
    launches = read_tree_counts()
    a = runs[-1]
    want_geom = (8, STREAM_WINDOW, STREAM_RESIDENT)
    if (a["windows"], a["window_rows"], a["resident"]) != want_geom:
        fail(f"(a) geometry {a}, not {want_geom} (windows, rows, resident)")
    if launches["hist"] < 1 or launches["hist_batch"] < 1:
        fail(f"(a) launched {launches}: B1 and B2 must both run")
    spec_a, trees_a = load_forest(da)
    err_a = progress_errors(da)
    if len(trees_a) != TRAIN_TREES or err_a.shape != (TRAIN_TREES, 2) or \
            not np.all(np.diff(err_a[:, 0]) < 0) or \
            not err_a[-1, 1] < err_a[0, 1]:
        fail(f"(a): {len(trees_a)} trees, errors {err_a.tolist()}")
    out["a"] = {"wall_s": wall, "ms_per_tree": wall * 1e3 / TRAIN_TREES,
                "launches": launches, "peak_bytes": peak, **a}
    log(f"stream (a) GBT c2f: {TRAIN_TREES} trees in {wall:.3f} s "
        f"({wall * 1e3 / TRAIN_TREES:.1f} ms a tree); {a['windows']} "
        f"windows of {a['window_rows']} rows, {a['resident']} resident; "
        f"disk passes {a['disk_passes']}, tail sweeps {a['tail_sweeps']}, "
        f"repairs {a['repairs']}, surrender at tree {a['surrender']}, "
        f"bytes read {a['bytes_read']}; launches {launches}; peak device "
        f"memory {peak / 2**30:.3f} GiB; validation error "
        f"{err_a[0, 1]:.6f} -> {err_a[-1, 1]:.6f} — [{gpu}]")

    # (a') the exact schedule: (a)'s first STREAM_EXACT_TREES trees bit
    # for bit
    dx = write_train_set(os.path.join(root, "stream_exact"), serve_root,
                         dict(params, TreeNum=STREAM_EXACT_TREES), clean)
    zero_tree_counts()
    wall, runs, peak = stream_cli(
        dx, "cuda", dict(win, **{"shifu.tree.tailCoarseToFine": "false"}))
    launches = read_tree_counts()
    x = runs[-1]
    _, trees_x = load_forest(dx)
    if not forests_equal(trees_x, trees_a[:STREAM_EXACT_TREES]):
        fail("(a') the exact schedule's forest differs from (a)'s")
    if not np.array_equal(progress_errors(dx), err_a[:STREAM_EXACT_TREES]):
        fail("(a') progress differs from (a)'s")
    if x["tail_sweeps"] != STREAM_EXACT_TREES * (DEPTH + 2) or \
            not a["tail_sweeps"] / TRAIN_TREES \
            < x["tail_sweeps"] / STREAM_EXACT_TREES:
        fail(f"(a') tail sweeps {x['tail_sweeps']} (want "
             f"{STREAM_EXACT_TREES * (DEPTH + 2)}, more a tree than (a)'s "
             f"{a['tail_sweeps']} for {TRAIN_TREES})")
    out["a_exact"] = {"wall_s": wall, "launches": launches,
                      "peak_bytes": peak, **x}
    log(f"stream (a') exact: bit-identical to (a)'s first "
        f"{STREAM_EXACT_TREES} trees, {wall:.3f} s "
        f"({wall * 1e3 / STREAM_EXACT_TREES:.1f} ms a tree), tail sweeps "
        f"{x['tail_sweeps']} against (a)'s {a['tail_sweeps']} for "
        f"{TRAIN_TREES}; launches "
        f"{launches} — [{gpu}]")

    # where a streamed tree's time goes: the device busy share of a
    # 3-tree coarse-to-fine run on (a)'s geometry, its warm pass included
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.train import dt_trainer as dt
    environment.set_property("shifu.train.windowRows", str(STREAM_WINDOW))
    try:
        out["a"]["profile"] = profile_device(
            torch, lambda: dt.train_gbt_streamed(
                dt._tree_stream(shards), N_BINS, is_cat,
                dt.DTSettings(n_trees=3, depth=DEPTH, loss="log",
                              learning_rate=0.1),
                device=torch.device("cuda")),
            "a 3-tree coarse-to-fine run of (a)'s geometry, warm pass "
            "included")
    finally:
        environment.set_property("shifu.train.windowRows", "")

    # (a0) the default geometry: the whole plane is tail (STREAM_A0_TREES
    # of (a)'s trees cut to STREAM_A0_DEPTH: each sweep is 2 x 1.1 GB of
    # copies)
    d0 = write_train_set(os.path.join(root, "stream_default"), serve_root,
                         dict(params, TreeNum=STREAM_A0_TREES,
                              MaxDepth=STREAM_A0_DEPTH), clean)
    wall, runs, peak = stream_cli(d0, "cuda", {})
    g = runs[-1]
    _, trees_0 = load_forest(d0)
    inner = 2 ** STREAM_A0_DEPTH - 1           # the split nodes, heap order
    differ = sum(int((p.split_feat[:inner] != q.split_feat[:inner]).sum())
                 for p, q in zip(trees_0, trees_a))
    if g["resident"] != 0:
        fail(f"(a0) kept {g['resident']} windows resident at the default "
             "geometry")
    out["a0"] = {"wall_s": wall, "peak_bytes": peak,
                 "nodes_differ_from_a": differ, **g}
    log(f"stream (a0) default geometry: {wall:.3f} s "
        f"({wall * 1e3 / STREAM_A0_TREES:.1f} ms a tree, {STREAM_A0_TREES} "
        f"trees of depth {STREAM_A0_DEPTH}); {g['windows']} windows "
        f"of {g['window_rows']} rows, {g['resident']} resident, tail sweeps "
        f"{g['tail_sweeps']}; {differ} nodes split on another feature than "
        f"(a) (other partitions, not gated) — [{gpu}]")

    # (b) resume, with and without the score sidecar
    db = write_train_set(os.path.join(root, "stream_resume"), serve_root,
                         dict(params, TreeNum=TRAIN_CKPT + 1,
                              CheckpointInterval=TRAIN_CKPT), clean)
    stream_cli(db, "cuda", win)
    dr = write_train_set(os.path.join(root, "stream_replay"), serve_root,
                         dict(params, CheckpointInterval=TRAIN_CKPT), clean)
    shutil.copytree(os.path.join(db, "tmp", "checkpoints"),
                    os.path.join(dr, "tmp", "checkpoints"),
                    ignore=shutil.ignore_patterns("*.scores.npz"))
    set_train_params(db, dict(params, CheckpointInterval=TRAIN_CKPT))
    wall_b, runs_b, _ = stream_cli(db, "cuda", win, "-resume")
    _, trees_b = load_forest(db)
    if not forests_equal(trees_b, trees_a):
        fail("(b) the resumed streamed forest differs from (a)'s")
    zero_tree_counts()
    wall_r, runs_r, _ = stream_cli(dr, "cuda", win, "-resume")
    replay = read_tree_counts()
    _, trees_r = load_forest(dr)
    if not forests_equal(trees_r, trees_a):
        fail("(b) the replayed streamed forest differs from (a)'s")
    if replay["tree_traverse"] != 8:
        fail(f"(b) the replay launched {replay}: one tree_traverse a "
             "window (8)")
    out["b"] = {"wall_s": wall_b, "replay_wall_s": wall_r,
                "replay_launches": replay, "tail_sweeps": runs_b[-1][
                    "tail_sweeps"]}
    log(f"stream (b) {TRAIN_CKPT} checkpointed trees + train -resume to "
        f"{TRAIN_TREES}: bit-identical to (a) with the score sidecar "
        f"({wall_b:.3f} s) and without it ({wall_r:.3f} s, the restored "
        f"trees replayed through tree_traverse: {replay}) — [{gpu}]")

    # (c) init -model's RF, cut to one super-batch
    rf_params = dict(_ALG_DEFAULT_PARAMS["RF"][1])
    if (rf_params["TreeNum"], rf_params["MaxDepth"]) != (RF_TREES, RF_DEPTH):
        fail(f"init -model's RF defaults changed: {rf_params}")
    rf_params["TreeNum"] = STREAM_RF_TREES
    dc = write_train_set(os.path.join(root, "stream_rf"), serve_root,
                         rf_params, clean, "RF")
    zero_tree_counts()
    wall, runs, peak = stream_cli(dc, "cuda", win)
    launches = read_tree_counts()
    r = runs[-1]
    spec_c, trees_c = load_forest(dc, "rf")
    err_c = progress_errors(dc)
    sb = 8
    want_sweeps = RF_DEPTH + 1                  # the warm pass rides
    if len(trees_c) != STREAM_RF_TREES or r["tail_sweeps"] != want_sweeps \
            or launches["hist_batch"] != RF_DEPTH * 8 or \
            launches["hist"] < 1:
        fail(f"(c) {len(trees_c)} trees, {r}, launches {launches} (want "
             f"{want_sweeps} tail sweeps, {RF_DEPTH * 8} hist_batch: "
             f"{RF_DEPTH} levels x 8 windows x 1 super-batch)")
    if not np.isfinite(err_c).all() or not err_c[-1, 1] < err_c[0, 1]:
        fail(f"(c) out-of-bag errors do not fall: {err_c[:, 1].tolist()}")
    out["c"] = {"wall_s": wall, "ms_per_tree": wall * 1e3 / STREAM_RF_TREES,
                "launches": launches, "peak_bytes": peak, "super_batch": sb,
                **r}
    log(f"stream (c) RF {STREAM_RF_TREES} trees depth {RF_DEPTH}: "
        f"{wall:.3f} s ({wall * 1e3 / STREAM_RF_TREES:.1f} ms a tree), "
        f"tail sweeps "
        f"{r['tail_sweeps']}, launches {launches}, peak device memory "
        f"{peak / 2**30:.3f} GiB, out-of-bag error {err_c[0, 1]:.6f} -> "
        f"{err_c[-1, 1]:.6f} — [{gpu}]")

    out["d"] = stream_cut_phase(root, serve_root, params, bins, y, w, names,
                                gpu)
    out["e"] = stream_member_phase(torch, root, serve_root, params,
                                   train_plane_, gpu)
    out["kernels"] = stream_kernels(torch, bins, y, w, trees_a[0],
                                    spec_a.init_score, gpu)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"stream phase: {out['wall_s']:.1f} s — [{gpu}]")
    return out


def stream_cut_phase(root, serve_root, params, bins, y, w, names,
                     gpu) -> dict:
    """(d): the stream plane's first STREAM_CUT_ROWS rows, windows of
    STREAM_CUT_WINDOW, a device cache that keeps STREAM_CUT_RESIDENT of
    them resident (GBT and RF alike); (a)'s GBT at STREAM_CUT_TREES trees
    with coarse-to-fine on and off, and a STREAM_CUT_RF_TREES-tree depth-7 RF, each on ``cuda``,
    the STREAM_CUT_CPU cases also on ``cpu`` (the smoke's time limit cut
    the others' CPU runs; ``tests/test_torch_tree_streaming.py`` holds
    every regime to the reference on the CPU)."""
    cut = os.path.join(root, "stream_cut_plane")
    n = STREAM_CUT_ROWS
    write_plane(cut, bins[:n], y[:n], w[:n], names,
                {"chip_smoke": "stream_cut"}, shard=STREAM_CUT_WINDOW * 3)
    budget = STREAM_CUT_RESIDENT * STREAM_CUT_WINDOW * GBT_ROW_BYTES + 1000
    base = {"shifu.train.streaming": "on",
            "shifu.train.windowRows": str(STREAM_CUT_WINDOW),
            "shifu.train.deviceCacheBytes": str(budget)}
    rf_params = {"TreeNum": STREAM_CUT_RF_TREES, "MaxDepth": DEPTH,
                 "Impurity": "entropy", "FeatureSubsetStrategy": "TWOTHIRDS",
                 "Loss": "squared"}
    gbt = dict(params, TreeNum=STREAM_CUT_TREES)
    cases = (("gbt_c2f", "GBT", gbt, "true"),
             ("gbt_exact", "GBT", gbt, "false"),
             ("rf", "RF", rf_params, None))
    got = {}
    for name, alg, p, c2f in cases:
        props = dict(base) if c2f is None else dict(
            base, **{"shifu.tree.tailCoarseToFine": c2f})
        for dev in ("cuda", "cpu") if name in STREAM_CUT_CPU else ("cuda",):
            d = write_train_set(os.path.join(root, f"stream_cut_{name}_"
                                             f"{dev}"), serve_root, p, cut,
                                alg)
            wall, runs, _ = stream_cli(d, dev, props)
            got[name, dev] = (wall, runs[-1], load_forest(d, alg.lower())[1],
                              progress_errors(d))
    out = {}
    for name, alg, _, _ in cases:
        w_card, r_card, t_card, e_card = got[name, "cuda"]
        if r_card["resident"] != STREAM_CUT_RESIDENT or \
                r_card["windows"] != n // STREAM_CUT_WINDOW:
            fail(f"(d) {name}: geometry {r_card}")
        if name not in STREAM_CUT_CPU:
            out[name] = {"wall_s": [w_card], "tail_sweeps":
                         r_card["tail_sweeps"]}
            log(f"stream (d) {name} on {n} rows on the card: "
                f"{r_card['tail_sweeps']} tail sweeps, wall {w_card:.2f} s "
                f"— [{gpu}]")
            continue
        w_cpu, r_cpu, t_cpu, e_cpu = got[name, "cpu"]
        worst = 0.0
        for t, (a, b) in enumerate(zip(t_card, t_cpu)):
            if not (np.array_equal(a.split_feat, b.split_feat)
                    and np.array_equal(a.left_mask, b.left_mask)):
                fail(f"(d) {name} tree {t}: card and CPU split otherwise")
            dl = np.abs(a.leaf_value - b.leaf_value)
            if not np.all(dl <= STREAM_LEAF_RTOL * np.abs(b.leaf_value)
                          + STREAM_LEAF_ATOL):
                fail(f"(d) {name} tree {t}: leaves differ by {dl.max()}")
            worst = max(worst, float(dl.max()))
        rel = np.abs(e_card - e_cpu) / np.abs(e_cpu)
        if len(t_card) != len(t_cpu) or not np.all(rel <= STREAM_ERR_RTOL):
            fail(f"(d) {name}: errors differ by up to {rel.max()} relative")
        if r_card["tail_sweeps"] != r_cpu["tail_sweeps"]:
            fail(f"(d) {name}: tail sweeps {r_card['tail_sweeps']} on the "
                 f"card, {r_cpu['tail_sweeps']} on the CPU")
        out[name] = {"wall_s": [w_card, w_cpu], "max_abs_leaf_diff": worst,
                     "max_rel_err": float(rel.max()),
                     "tail_sweeps": r_card["tail_sweeps"]}
        log(f"stream (d) {name} on {n} rows ({STREAM_CUT_RESIDENT} of "
            f"{n // STREAM_CUT_WINDOW} windows resident): card == CPU "
            f"in splits and masks, leaves within {worst:.3g}, errors within "
            f"{rel.max():.3g} relative, tail sweeps {r_card['tail_sweeps']} "
            f"on both; wall {w_card:.2f} s card, {w_cpu:.2f} s CPU — [{gpu}]")
    if not forests_equal(got["gbt_c2f", "cuda"][2],
                         got["gbt_exact", "cuda"][2]):
        fail("(d) coarse-to-fine differs from exact on the card")
    return out


def stream_member_phase(torch, root, serve_root, params, train_plane_,
                        gpu) -> dict:
    """(e): a streamed GBT with ``baggingNum`` MEMBER_BAGS on the train
    phase's plane (windows of MEMBER_WINDOW, MEMBER_RESIDENT resident),
    (a)'s params at MEMBER_TREES trees; member 1 against a single
    ``train_gbt_streamed`` run with its mask function
    (``_streamed_bag_mask_fn``) and seed."""
    from dataclasses import replace
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.train import dt_trainer as dt
    bins, y, w, informative, is_cat, clean, cut, names = train_plane_
    params = dict(params, TreeNum=MEMBER_TREES)
    props = {"shifu.train.streaming": "on",
             "shifu.train.windowRows": str(MEMBER_WINDOW),
             "shifu.train.deviceCacheBytes": str(
                 MEMBER_RESIDENT * MEMBER_WINDOW * GBT_ROW_BYTES + 1000)}
    d = write_train_set(os.path.join(root, "stream_members"), serve_root,
                        params, clean)
    set_train_conf(d, baggingNum=MEMBER_BAGS)
    zero_tree_counts()
    wall, runs, peak = stream_cli(d, "cuda", props)
    launches = read_tree_counts()
    forests = load_members(d, "gbt")
    if len(forests) != MEMBER_BAGS or len(runs) != MEMBER_BAGS or any(
            r["resident"] != MEMBER_RESIDENT for r in runs):
        fail(f"(e) {len(forests)} members, runs {runs}")
    mc = ModelConfig.load(os.path.join(d, "ModelConfig.json"))
    settings = dt.settings_from_params(params, mc.train, Algorithm.GBT)
    settings.stats_exact = not mc.dataSet.weightColumnName
    for k, v in props.items():
        environment.set_property(k, v)
    try:
        single = dt.train_gbt_streamed(
            dt._tree_stream(Shards.open(clean)), N_BINS, is_cat,
            replace(settings, seed=settings.seed + 1),
            mask_fn=dt._streamed_bag_mask_fn(mc, False, MEMBER_BAGS,
                                             settings.seed, 1),
            device=torch.device("cuda"))
    finally:
        for k in props:
            environment.set_property(k, "")
    if not forests_equal(single.trees, forests[1][1]):
        fail("(e) streamed member 1 differs from its single run")
    if forests_equal(forests[0][1], forests[1][1]):
        fail("(e) members 0 and 1 grew the same forest")
    log(f"stream (e) {MEMBER_BAGS} streamed GBT members on {TRAIN_ROWS} rows "
        f"({MEMBER_RESIDENT} of {TRAIN_ROWS // MEMBER_WINDOW} windows "
        f"resident): {wall:.3f} s, tail sweeps "
        f"{[r['tail_sweeps'] for r in runs]}, launches {launches}; member 1 "
        f"bit-identical to its single streamed run — [{gpu}]")
    return {"wall_s": wall, "launches": launches, "peak_bytes": peak,
            "tail_sweeps": [r["tail_sweeps"] for r in runs]}


def time_given(torch, name, launch, plain, bins, node_b, stats_b, k, gpu):
    """A histogram launch on the main path's own inputs: the kernel, the
    plain version, one ``scatter_add_`` of every active (tree, row,
    column) into a flat f32 buffer (the cell index computed beforehand),
    and the bound (``hist_batch_bytes``: the bins once, each tree's node
    ids and active stats, the output; one add per active (tree, row,
    column, channel))."""
    from shifu_tpu_torch.ops import hist
    tb, s = stats_b.shape[0], stats_b.shape[2]
    ms = device_ms(torch, launch, launches=10, repeats=5)
    plain_ms = device_ms(torch, plain, launches=1, repeats=3)
    nbytes = hist.hist_batch_bytes(bins, node_b, stats_b, k, N_BINS)
    act = (node_b >= 0).nonzero()
    n_act = int(act.shape[0])
    cols = torch.arange(N_COLS, device="cuda")
    cell = ((act[:, 0] * k + node_b[act[:, 0], act[:, 1]].long())
            * N_COLS)[:, None] + cols
    cell.mul_(N_BINS).add_(bins[act[:, 1]])
    idx = cell.reshape(-1, 1).expand(-1, s)
    src = stats_b[act[:, 0], act[:, 1]][:, None, :] \
        .expand(-1, N_COLS, -1).reshape(-1, s)
    del cell
    flat = torch.zeros((tb * k * N_COLS * N_BINS, s), device="cuda")
    library_ms = device_ms(torch, lambda: flat.scatter_add_(0, idx, src),
                           launches=2, repeats=3)
    del act, idx, src, flat
    torch.cuda.empty_cache()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_act * N_COLS * s / INT_OPS_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "active": n_act,
           "shape": f"TB={tb} N={bins.shape[0]} C={N_COLS} B={N_BINS} "
                    f"S={s} K={k} uint8"}
    log(f"{name} {out['shape']}: kernel {ms:.5f} ms, plain {plain_ms:.4f} "
        f"ms, scatter_add_ {library_ms:.4f} ms, bound "
        f"{out['bound_ms']:.6f} ms ({out['bound_by']}: {nbytes / 1e6:.3f} "
        f"MB, {n_act} active (tree, row) pairs) — [{gpu}]")
    return out


def stream_kernels(torch, bins, y, w, tree, init_score, gpu) -> dict:
    """B2 at the disk-tail window's path shape (``build_path_histograms``:
    TB = depth trees of one window sharing one stats plane, K = 2^(depth -
    1)) and B1 at the coalesced resident block's shape (STREAM_RESIDENT
    windows, the left children of level 6: K = 32), on (a)'s plane with
    (a)'s first tree as the structure and its prior as the score: each
    tree held to the plain versions (``held_to_plain``), B2's trees to B1
    launches bit for bit, then timed (``time_given``)."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops import tree as tt
    from shifu_tpu_torch.train import dt_trainer as dt
    dev = torch.device("cuda")
    sf = torch.from_numpy(tree.split_feat).to(dev)
    lm = torch.from_numpy(tree.left_mask).to(dev)

    def inputs(r0, r1):
        idx = np.arange(r0, r1)
        tw, _ = dt._stream_masks(idx, r1 - r0, w[r0:r1], 0.2, 0)
        b = torch.from_numpy(bins[r0:r1]).to(dev)
        yy = torch.from_numpy(y[r0:r1]).to(dev)
        f = torch.full((r1 - r0,), init_score, dtype=torch.float32,
                       device=dev)
        return b, dt._gbt_stats(yy, torch.from_numpy(tw).to(dev), f, "log")

    out = {}
    tail0 = STREAM_RESIDENT * STREAM_WINDOW
    b, stats = inputs(tail0, STREAM_ROWS)
    half = 1 << (DEPTH - 1)
    node_b = torch.stack([tt.node_index_at_level(sf, lm, b, 0)] + [
        tt._left_child_index(tt.node_index_at_level(sf, lm, b, lvl))
        for lvl in range(1, DEPTH)])
    stats_b = stats[None].expand(DEPTH, *stats.shape).contiguous()
    got = tt.build_histograms_batch(b, node_b, stats_b, half, N_BINS)
    hl, _ = tt.build_path_histograms(b, stats, sf, lm, DEPTH, N_BINS)
    if not torch.equal(got, hl):
        fail("B2 at the path shape != build_path_histograms")
    err = 0.0
    for t in range(DEPTH):
        if not torch.equal(got[t], tt.build_histograms(b, node_b[t],
                                                       stats_b[t], half,
                                                       N_BINS)):
            fail(f"hist_batch at the path shape: tree {t} != hist (B1)")
        err = max(err, held_to_plain(
            torch, hist, got[t], b, node_b[t], stats_b[t], half, N_BINS,
            f"the path shape, level {t}", "hist_batch"))
    del got, hl
    torch.cuda.empty_cache()
    out["path"] = time_given(
        torch, "hist_batch (path)", lambda: tt.build_histograms_batch(
            b, node_b, stats_b, half, N_BINS),
        lambda: hist.build_histograms_batch_ref(b, node_b, stats_b, half,
                                                N_BINS),
        b, node_b, stats_b, half, gpu)
    out["path"]["max_abs_err"] = err
    del b, stats, node_b, stats_b
    torch.cuda.empty_cache()

    b, stats = inputs(0, tail0)
    k = 32
    node = tt._left_child_index(tt.node_index_at_level(sf, lm, b, 6))
    got = tt.build_histograms(b, node, stats, k, N_BINS)
    err = held_to_plain(torch, hist, got, b, node, stats, k, N_BINS,
                        "the coalesced block", "hist")
    del got
    out["block"] = time_given(
        torch, "hist (block)", lambda: tt.build_histograms(
            b, node, stats, k, N_BINS),
        lambda: hist.build_histograms_ref(b, node, stats, k, N_BINS),
        b, node[None], stats[None], k, gpu)
    out["block"]["max_abs_err"] = err
    del b, stats, node
    torch.cuda.empty_cache()
    return out


def three_classes(rng, bins, informative) -> np.ndarray:
    """A three-class target on the train plane, made from ``rng``: class k
    scores the bins of informative column k (scaled to [0, 2.5]) plus
    Gumbel noise, and the top score wins."""
    cols = bins[:, informative[:MC_CLASSES]].astype(np.float32)
    score = cols / cols.max(axis=0).clip(min=1.0) * 2.5 \
        + rng.gumbel(size=cols.shape).astype(np.float32)
    return score.argmax(axis=1).astype(np.float32)


def multiclass_set(root: str, name: str, serve_root: str, params: dict,
                   clean: str, algorithm: str) -> str:
    """``write_train_set`` for a three-class target: ``posTags`` the class
    ids, no ``negTags``, EqualTotal binning (as multi-class needs)."""
    from shifu_tpu_torch.config import ModelConfig
    from shifu_tpu_torch.config.model_config import BinningMethod
    d = write_train_set(os.path.join(root, name), serve_root, params, clean,
                        algorithm)
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.dataSet.posTags = [str(k) for k in range(MC_CLASSES)]
    mc.dataSet.negTags = []
    mc.stats.binningMethod = BinningMethod.EqualTotal
    mc.save(path)
    return d


def multiclass_phase(torch, tq, root: str, serve_root: str, plane, rng,
                     gpu: str) -> dict:
    """Multi-class trees at full width on the train plane with a
    three-class target (``three_classes``, from the main path's
    generator), through ``cli.main train`` on ``cuda``: a native RF with
    ``init -model``'s params (10 trees, depth 14; S = 3 class channels:
    14 ``hist_batch`` and 38 ``hist`` launches as the binary RF) and a
    one-vs-all GBT (TreeNum 10, MaxDepth 7: one forest a class, 240
    ``hist`` launches), counts zeroed around each run.  Checks the model
    files (class-distribution leaves, ``class_index`` stamps), a falling
    out-of-bag misclassification, accuracy above the majority class's
    share on 65,536 rows;
    walks the native forest over those rows through B4's node-index walk
    (one launch, bit-equal to the plain version, timed against its
    bound); times B2 at S = 3, TB = 8, K = 4096 (the native RF's deepest
    level) against its bound."""
    from shifu_tpu_torch.eval.scorer import Scorer, load_models
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    from shifu_tpu_torch.pipeline.create import _ALG_DEFAULT_PARAMS
    bins, y, w, informative, is_cat, clean, cut, names = plane
    y3 = three_classes(rng, bins, informative)
    clean3 = os.path.join(root, "plane_mc")
    write_plane(clean3, bins, y3, w, names, {"chip_smoke": "multiclass"})
    out = {"class_rates": np.bincount(y3.astype(int)).tolist()}

    params = dict(_ALG_DEFAULT_PARAMS["RF"][1], CheckpointInterval=RF_CKPT)
    d = multiclass_set(root, "mc_rf", serve_root, params, clean3, "RF")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_tree_counts()
    wall = train_cli(d, "cuda")
    launches = read_tree_counts()
    peak = torch.cuda.max_memory_allocated() - base
    want = {"hist_batch": RF_DEPTH,
            "hist": RF_CKPT + (RF_TREES - RF_CKPT) * (RF_DEPTH + 1),
            "leaf_sums": RF_TREES, "tree_traverse": 0}
    if launches != want:
        fail(f"native multi-class RF launched {launches}, not {want}")
    (spec, trees), = load_members(d, "rf")
    nodes = (1 << (RF_DEPTH + 1)) - 1
    if spec.extra.get("n_classes") != MC_CLASSES or len(trees) != RF_TREES \
            or any(t.leaf_value.shape != (nodes, MC_CLASSES)
                   or t.split_feat[0] < 0 for t in trees):
        fail(f"model0.rf is not a {MC_CLASSES}-class forest of {RF_TREES} "
             f"trees: {spec.extra}")
    err = progress_errors(d)
    if err.shape != (RF_TREES, 2) or not err[-1, 1] < err[0, 1]:
        fail(f"native RF errors {err.tolist()} (out-of-bag "
             "misclassification must fall)")
    log(f"main path (native multi-class RF): {RF_TREES} trees of depth "
        f"{RF_DEPTH}, S = {MC_CLASSES}, in {wall:.3f} s wall; launches "
        f"{launches}; out-of-bag misclassification {err[0, 1]:.6f} -> "
        f"{err[-1, 1]:.6f}; peak device memory {peak / 2**30:.3f} GiB "
        f"— [{gpu}]")
    out["rf"] = {"launches": launches, "wall_s": wall, "peak_bytes": peak,
                 "errors": err.tolist()}

    # B4's node-index walk of the native forest
    dev = torch.device("cuda")
    model = IndependentTreeModel(spec, trees)
    forest, packed = model.quant_arrays(dev), model.quant_packed(dev)
    b = torch.from_numpy(np.ascontiguousarray(bins[:MC_WALK_ROWS])).to(dev)
    tq.predict_forest_quant.launches = 0
    got = tq.predict_forest_quant(*forest, b, RF_DEPTH, packed=packed)
    walk_launches = tq.predict_forest_quant.launches
    want_walk = tq.predict_forest_quant_ref(*forest, b, RF_DEPTH)
    torch.cuda.synchronize()
    if walk_launches != 1 or not torch.equal(got, want_walk):
        fail(f"node-index walk: {walk_launches} launches, bit-equal "
             f"{torch.equal(got, want_walk)}")
    acc = float((got.mean(dim=0).argmax(dim=1).cpu().numpy()
                 == y3[:MC_WALK_ROWS]).mean())
    majority = max(out["class_rates"]) / len(y3)
    ms = device_ms(torch, lambda: tq.predict_forest_quant(
        *forest, b, RF_DEPTH, packed=packed))
    plain_ms = device_ms(torch, lambda: tq.predict_forest_quant_ref(
        *forest, b, RF_DEPTH), launches=1, repeats=3)
    need = tq.traverse_bytes(forest[0], forest[1], b, RF_DEPTH,
                             leaf_width=MC_CLASSES)
    bytes_ms = need["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = need["split_steps"] * OPS_PER_LEVEL / INT_OPS_PER_S * 1e3
    out["walk"] = {"ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "max_abs_err": 0.0,
                   "library_ms": None, "accuracy": acc,
                   "shape": f"T={RF_TREES} depth={RF_DEPTH} N={MC_WALK_ROWS} "
                            f"C={N_COLS} B={N_BINS} S={MC_CLASSES} uint8"}
    log(f"tree_traverse node-index walk ({out['walk']['shape']}, 1 launch, "
        f"bit-equal to the plain version): kernel {ms:.5f} ms, plain "
        f"{plain_ms:.4f} ms, bound {out['walk']['bound_ms']:.6f} ms "
        f"({out['walk']['bound_by']}: {need['bytes'] / 1e6:.3f} MB); mean "
        f"vote accuracy {acc:.4f} — [{gpu}]")
    if not acc > majority:
        fail(f"native RF accuracy {acc} is no better than the majority "
             f"class's share {majority}")
    del model, forest, packed, got, want_walk

    gbt = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH, "Loss": "log",
           "LearningRate": 0.1}
    d = multiclass_set(root, "mc_ova", serve_root, gbt, clean3, "GBT")
    zero_tree_counts()
    wall = train_cli(d, "cuda")
    launches = read_tree_counts()
    want = {"hist": MC_CLASSES * TRAIN_TREES * (DEPTH + 1),
            "leaf_sums": MC_CLASSES * TRAIN_TREES, "hist_batch": 0,
            "tree_traverse": 0}
    if launches != want:
        fail(f"one-vs-all GBT launched {launches}, not {want}")
    forests = load_members(d, "gbt")
    if [s.extra.get("class_index") for s, _ in forests] != \
            list(range(MC_CLASSES)):
        fail("one-vs-all GBT: model files are not classes 0-2")
    scorer = Scorer(load_models(os.path.join(d, "models")), device=dev)
    tq.predict_forest_quant.launches = 0
    cs = scorer.score_classes(None, bins[:MC_WALK_ROWS])
    if tq.predict_forest_quant.launches != MC_CLASSES:
        fail("one-vs-all scoring did not launch tree_traverse once a model")
    ova_acc = float((cs.argmax(axis=1) == y3[:MC_WALK_ROWS]).mean())
    if not ova_acc > majority:
        fail(f"one-vs-all accuracy {ova_acc} is no better than the "
             f"majority class's share {majority}")
    log(f"main path (one-vs-all GBT): {MC_CLASSES} forests of "
        f"{TRAIN_TREES} depth-{DEPTH} trees in {wall:.3f} s wall; launches "
        f"{launches}; accuracy {ova_acc:.4f} on {MC_WALK_ROWS} rows "
        f"— [{gpu}]")
    out["ova"] = {"launches": launches, "wall_s": wall,
                  "accuracy": ova_acc}
    out["b2_s3"] = time_batch(torch, rng, gpu, HIST_BATCH, 4096, MC_CLASSES)
    return out


def write_multiclass_csv(path: str, src: str) -> list:
    """The stats phase's CSV's first MC_CLI_ROWS rows with a three-valued
    ``tag``: ``t0`` where it
    was bad, else ``t1`` or ``t2`` by the side of the first numeric column
    (informative in ``write_stats_csv``) its value lies on (``t1`` when
    the cell is empty).  Returns the class counts."""
    with open(src) as f:
        rows = [line.rstrip("\n").split("|")
                for _, line in zip(range(MC_CLI_ROWS), f)]
    first = np.array([float(r[0]) if r[0] else np.nan for r in rows])
    cut = float(np.nanmedian(first))
    counts = [0] * MC_CLASSES
    for r, v in zip(rows, first):
        k = 0 if r[-1] == "bad" else 2 if v > cut else 1
        r[-1] = MC_TAGS[k]
        counts[k] += 1
    shutil.copy(src + ".header", path + ".header")
    with open(path, "w") as f:
        f.write("\n".join("|".join(r) for r in rows) + "\n")
    return counts


def multiclass_cli_phase(torch, tq, root: str, csv: str,
                         gpu: str) -> dict:
    """The multi-class path through the CLI a user calls: the stats
    phase's CSV (its first MC_CLI_ROWS rows x 258 fields) with a
    three-valued tag
    (``write_multiclass_csv``) through ``new → init → stats → norm →
    train`` on ``cuda`` (a native RF with init -model's params, then a
    one-vs-all GBT with the train phase's), each model set through ``eval
    -new`` and ``eval -run`` on ``cuda`` and on ``cpu`` (a copy of the set).
    Checks: ``EvalPerformance.json`` accuracy and confusion matrix equal
    card vs CPU; the score files' class scores within MC_SCORE_TOL (the
    %.6f files); ``tree_traverse`` launched models x chunks times in the
    card's eval, counted from zero around it.  Every step parses inline
    (``-Dshifu.ingest.parseWorkers=0``: the parse holds the GIL, and on
    the card's host the inline pass is ~2.3x faster than eight threads,
    PERF.md §6), which keeps this phase's seven parse passes short;
    the rows parsed are the same."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm, BinningMethod
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.pipeline.create import _ALG_DEFAULT_PARAMS
    base = os.path.join(root, "mc_cli")
    os.makedirs(base)
    csv3 = os.path.join(base, "data.csv")
    counts = write_multiclass_csv(csv3, csv)
    walls = {}

    def step(name, *argv):
        t0 = time.perf_counter()
        if cli.main(["-Dshifu.ingest.parseWorkers=0", "--dir", argv[0],
                     *argv[1:]]) != 0:
            fail(f"{' '.join(argv[1:])} exited non-zero in {argv[0]}")
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0

    step("new", base, "new", "mc")
    d = os.path.join(base, "mc")
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    ds = mc.dataSet
    ds.dataPath, ds.dataDelimiter, ds.targetColumnName = csv3, "|", "tag"
    ds.posTags, ds.negTags, ds.weightColumnName = list(MC_TAGS), [], "weight"
    ds.headerPath, ds.headerDelimiter = csv3 + ".header", "|"
    mc.stats.maxNumBin = N_BINS - 1
    mc.stats.binningMethod = BinningMethod.EqualTotal
    ev = mc.evals[0].dataSet
    ev.dataPath, ev.dataDelimiter = csv3, "|"
    ev.headerPath, ev.headerDelimiter = csv3 + ".header", "|"
    mc.save(path)
    chunks = -(-MC_CLI_ROWS // CSV_CHUNK)
    out = {"class_counts": counts}
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        step("init", d, "init")
        step("stats", d, "stats", "--device", "cuda")
        step("norm", d, "norm")
        step("eval_new", d, "eval", "-new", E2E_EVAL)
        for alg, params in (
                ("RF", dict(_ALG_DEFAULT_PARAMS["RF"][1])),
                ("GBT", {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH,
                         "Loss": "log", "LearningRate": 0.1})):
            mc = ModelConfig.load(path)
            mc.train.algorithm = Algorithm[alg]
            mc.train.params = params
            mc.save(path)
            step(f"train_{alg}", d, "train", "--device", "cuda")
            cpu_dir = f"{d}_{alg}_cpu"
            shutil.copytree(d, cpu_dir)
            tq.predict_forest_quant.launches = 0
            step(f"eval_{alg}", d, "eval", "-run", E2E_EVAL, "--device",
                 "cuda")
            launches = tq.predict_forest_quant.launches
            step(f"eval_{alg}_cpu", cpu_dir, "eval", "-run", E2E_EVAL,
                 "--device", "cpu")
            n_models = len(os.listdir(os.path.join(d, "models")))
            if launches != n_models * chunks:
                fail(f"multi-class eval ({alg}) launched tree_traverse "
                     f"{launches} times for {n_models} model(s) x {chunks} "
                     "chunks")
            (card, perf), (cpu, cpu_perf) = eval_scores(d, E2E_EVAL), \
                eval_scores(cpu_dir, E2E_EVAL)
            if perf.get("nClasses") != MC_CLASSES or \
                    perf["accuracy"] != cpu_perf["accuracy"] or \
                    perf["confusionMatrix"] != cpu_perf["confusionMatrix"]:
                fail(f"multi-class eval ({alg}) card vs CPU: accuracy "
                     f"{perf.get('accuracy')} vs {cpu_perf.get('accuracy')}"
                     f", confusion {perf.get('confusionMatrix')} vs "
                     f"{cpu_perf.get('confusionMatrix')}")
            if card.shape != (MC_CLI_ROWS, 3 + MC_CLASSES) or \
                    not np.array_equal(card[:, :3], cpu[:, :3]):
                fail(f"multi-class EvalScore ({alg}) card {card.shape} vs "
                     "CPU: tag, weight or predicted tag differ")
            diff = float(np.abs(card[:, 3:].astype(float)
                                - cpu[:, 3:].astype(float)).max())
            if not diff <= MC_SCORE_TOL or not perf["accuracy"] > 0.5:
                fail(f"multi-class eval ({alg}): class scores card vs CPU "
                     f"differ by {diff}, accuracy {perf['accuracy']}")
            log(f"main path (multi-class CLI, {alg}): train "
                f"{walls[f'train_{alg}']:.3f} s, eval -run "
                f"{walls[f'eval_{alg}']:.3f} s on the card ({n_models} "
                f"model(s), {launches} tree_traverse launches), "
                f"{walls[f'eval_{alg}_cpu']:.3f} s on the CPU; accuracy "
                f"{perf['accuracy']:.6f}, macro AUC {perf['macroAuc']:.6f}, "
                f"confusion matrix equal card vs CPU, class scores within "
                f"{diff:.3g} — [{gpu}]")
            out[alg] = {"eval_launches": launches, "accuracy":
                        perf["accuracy"], "macro_auc": perf["macroAuc"],
                        "score_card_cpu": diff}
            shutil.rmtree(cpu_dir)
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
        environment.reset_for_tests()       # drop the -D parse setting
    log(f"multi-class CLI: {MC_CLI_ROWS} rows, classes {counts}; walls "
        f"{ {k: round(v, 3) for k, v in walls.items()} } — [{gpu}]")
    out["walls_s"] = walls
    return out


# ------------------------------------------------- phase: WDL and SVM
WDL_BAGS, WDL_EPOCHS = 5, 5               # baggingNum as the NN's; full batch
WDL_BATCH = 128                           # the reference's default MiniBatchs
WDL_B_ROWS = 1 << 15                      # (b)'s epoch: a cut in rows
WDL_HASH_BUCKETS = 32                     # columns past 32 categories hash
WDL_CUT_BAGS, WDL_CUT_EPOCHS = 2, 2       # card vs CPU on CUT_ROWS rows
WDL_CUT_WINDOW = CUT_ROWS // 4            # ... streamed in these windows
WDL_RESUME = (2, 4, 1024)                 # epochs, then resumed to, batch
WDL_ERR_RTOL, WDL_AUC_TOL = 1e-4, 0.005   # card vs CPU
WDL_SCORE_TOL = 1e-2                      # served / evaluated, 0-1000
WDL_E2E = {"MiniBatchs": 0, "LearningRate": 0.01}   # e2e set's WDL
WDL_E2E_EPOCHS = 10
WDL_COMBO_EPOCHS = 5                      # combo WDL:GBT's WDL member
WDL_SHARD = {"shifu.wdl.shardTables": "on"}   # the row-sharded plane
WDL_HOT_ROWS = 8                          # serveHotRows: under every card.
WDL_COPY_BUCKETS = (1, 64, 512)           # the serving copies' rungs
WDL_COPY_BATCHES = (1, 7, 64, 333, 512)   # request rows scored through them
WDL_PROFILE_STEPS = (5, 10)               # minibatch steps profiled
WDL_PROFILE_ROWS = 1 << 16                # a full-batch epoch profiled
SVM_CAP, SVM_ITERS, SVM_CUT = 16384, 2000, 2048
SVM_GAMMA = 1.0 / N_COLS                  # the trainer's default Gamma
SVM_ALPHA_TOL, SVM_F_TOL = 1e-4, 1e-3     # duals, decision values
SVM_LINEAR = {"Kernel": "linear", "Const": 1.0, "Propagation": "ADAM",
              "LearningRate": 0.01}
SVM_LINEAR_EPOCHS = 10
WDL_GBT_COMBO = {"TreeNum": COMBO_TREES, "MaxDepth": DEPTH, "Loss": "log",
                 "LearningRate": 0.1, "MiniBatchs": 0}


def wdl_set(root: str, name: str, serve_root: str, norm: str, clean: str,
            params: dict, **train) -> str:
    """A WDL model set over the dual planes: ``tmp/NormalizedData`` a link
    to ``norm``, ``tmp/CleanedData`` to ``clean``."""
    d = write_train_set(os.path.join(root, name), serve_root, params, norm,
                        "WDL", plane_dir="NormalizedData")
    os.symlink(clean, os.path.join(d, "tmp", "CleanedData"))
    set_train_conf(d, **train)
    return d


def props_cli(d: str, device: str, props: dict, *extra: str) -> float:
    """``train`` with ``-D`` properties, cleared again after the run."""
    from shifu_tpu_torch.config import environment
    try:
        return train_cli(d, device, *[f"-D{k}={v}" for k, v in
                                      props.items()], *extra)
    finally:
        for k in props:
            environment.set_property(k, "")


def wdl_members(d: str) -> list:
    from shifu_tpu_torch.eval.scorer import discover_model_paths
    from shifu_tpu_torch.models import load_any
    return [load_any(p) for p in
            discover_model_paths(os.path.join(d, "models"))]


def train_phase_s(d: str) -> float:
    """The ``train`` phase's seconds from ``tmp/profile.json``."""
    with open(os.path.join(d, "tmp", "profile.json")) as f:
        return float(json.load(f)["TRAIN"]["phases_s"]["train"])


def wdl_step_profile(torch, x_num, x_cat, y, w, spec, gpu: str) -> dict:
    """Kernel launches a minibatch step: ``torch.profiler`` over one epoch
    of ``train_wdl_ensemble`` (WDL_BAGS members, batches of WDL_BATCH) at
    two row counts; the difference over the steps' difference is one
    step's launches, the epoch's error pass cancelling out.  Host syncs
    an epoch: runs of 3 and 2 epochs under ``set_sync_debug_mode("warn")``
    differ by them.  And where a full-batch epoch's device time goes: one
    epoch over WDL_PROFILE_ROWS rows, profiled."""
    import warnings

    from shifu_tpu_torch.train.nn_trainer import TrainSettings
    from shifu_tpu_torch.train.wdl_trainer import train_wdl_ensemble

    def run(steps, epochs=1):
        n = steps * WDL_BATCH
        return train_wdl_ensemble(
            x_num[:n], x_cat[:n], y[:n], w[:n], spec,
            TrainSettings(optimizer="ADAM", learning_rate=0.002, l2=1e-5,
                          epochs=epochs, batch_size=WDL_BATCH),
            bags=WDL_BAGS, valid_rate=0.2, device="cuda")

    launches = []
    for steps in WDL_PROFILE_STEPS:
        run(steps)                                   # warm: allocator
        prof = profile_device(torch, lambda: run(steps),
                              what=f"a {steps}-step WDL epoch")
        if not prof:
            return {}
        launches.append(sum(n for _, n in prof["by_name"].values()))
    per_step = (launches[1] - launches[0]) / (WDL_PROFILE_STEPS[1]
                                              - WDL_PROFILE_STEPS[0])

    def syncs(epochs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                run(WDL_PROFILE_STEPS[0], epochs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return sum("synchroniz" in str(m.message) for m in seen)
    per_epoch = syncs(3) - syncs(2)
    if per_epoch != 1:
        fail(f"a WDL minibatch epoch made {per_epoch} host syncs, not 1")
    n = WDL_PROFILE_ROWS
    full = TrainSettings(optimizer="ADAM", learning_rate=0.002, l2=1e-5,
                         epochs=1, batch_size=0)
    fb = profile_device(torch, lambda: train_wdl_ensemble(
        x_num[:n], x_cat[:n], y[:n], w[:n], spec, full, bags=WDL_BAGS,
        device="cuda"), what=f"a full-batch WDL epoch over {n} rows "
        "(upload included)")
    kern = {k: v for k, v in fb.get("by_name", {}).items()
            if not k.startswith(("Memcpy", "Memset"))}
    full_batch = {
        "kernel_ms": sum(ms for ms, _ in kern.values()),
        "gemm_ms": sum(ms for k, (ms, _) in kern.items()
                       if "gemm" in k.lower() or "cutlass" in k.lower()),
        "sort_ms": sum(ms for k, (ms, _) in kern.items()
                       if "sort" in k.lower()),
        "top": fb.get("top", [])}
    log(f"WDL step ({WDL_BAGS} members, {WDL_BATCH} rows): {per_step:.1f} "
        f"kernel launches a step; {per_epoch} host sync an epoch (the "
        f"error fetch) — [{gpu}]")
    log(f"WDL full-batch epoch over {n} rows: kernels "
        f"{full_batch['kernel_ms']:.3f} ms, GEMMs {full_batch['gemm_ms']:.3f}"
        f" ms, radix sorts (the embedding backward) "
        f"{full_batch['sort_ms']:.3f} ms — [{gpu}]")
    return {"launches_per_step": per_step, "host_syncs_per_epoch": per_epoch,
            "launches_at_steps": dict(zip(WDL_PROFILE_STEPS, launches)),
            "full_batch_profile": full_batch}


def same_models(a: str, b: str, what: str) -> None:
    """Every model file of set ``a`` holds set ``b``'s arrays bit for
    bit."""
    names = sorted(os.listdir(os.path.join(b, "models")))
    if sorted(os.listdir(os.path.join(a, "models"))) != names:
        fail(f"{what}: model files differ")
    for f in names:
        with np.load(os.path.join(a, "models", f)) as za, \
                np.load(os.path.join(b, "models", f)) as zb:
            if za.files != zb.files or any(
                    za[k].tobytes() != zb[k].tobytes() for k in za.files):
                fail(f"{what}: {f} differs")


def wdl_serve_copies(members, x, bins, gpu: str) -> dict:
    """``shifu.wdl.serveCopy`` through the bucket scorer the server pins:
    ``full``, ``sharded`` (the process's one card: a shard of one) and
    ``hot`` (WDL_HOT_ROWS head rows exact, a mean-of-tail row) built and
    captured on the card at WDL_COPY_BUCKETS, requests of
    WDL_COPY_BATCHES rows scored through each: ``sharded`` bit for bit
    ``full``; ``hot`` within SCORE_TOL of its CPU copy and away from
    ``full`` where an id is cold; no capture forced."""
    from shifu_tpu_torch.config import environment
    from shifu_tpu_torch.serve.scorer import AOTScorer, serve_capture_count
    n = sum(WDL_COPY_BATCHES)
    scores = {}
    t0 = time.perf_counter()
    try:
        environment.set_property("shifu.wdl.serveHotRows",
                                 str(WDL_HOT_ROWS))
        for mode, devs in (("full", ("cuda",)), ("sharded", ("cuda",)),
                           ("hot", ("cuda", "cpu"))):
            environment.set_property("shifu.wdl.serveCopy", mode)
            for dev in devs:
                sc = AOTScorer(members, device=dev, buckets=WDL_COPY_BUCKETS,
                               name=f"serve.score.wdl_{mode}_{dev}")
                sc.warm()
                xs = x[:n, :sc.n_features]
                bs = bins[:n, :sc.n_bins_cols]
                cuts = np.cumsum((0,) + WDL_COPY_BATCHES)
                scores[mode, dev] = np.concatenate(
                    [sc.score_batch(xs[a:b], bs[a:b])
                     for a, b in zip(cuts[:-1], cuts[1:])])
    finally:
        for k in ("shifu.wdl.serveCopy", "shifu.wdl.serveHotRows"):
            environment.set_property(k, "")
    forced = serve_capture_count("serve.score.wdl_")
    full, hot = scores["full", "cuda"], scores["hot", "cuda"]
    diff = float(np.max(np.abs(hot - scores["hot", "cpu"])))
    moved = float(np.max(np.abs(hot - full)))
    if scores["sharded", "cuda"].tobytes() != full.tobytes():
        fail("WDL (g): the sharded serving copy differs from the full copy")
    if not diff <= SCORE_TOL or not moved > 0 or forced:
        fail(f"WDL (g): hot copy card vs CPU {diff:.3g} (tol {SCORE_TOL}), "
             f"max |hot - full| {moved:.3g}, {forced} captures forced")
    out = {"hot_card_cpu": diff, "hot_vs_full": moved,
           "captures_forced": forced, "wall_s": time.perf_counter() - t0}
    log(f"WDL (g) serve copies at rungs {WDL_COPY_BUCKETS}: sharded = full "
        f"bit for bit over {n} rows; hot ({WDL_HOT_ROWS} head rows) card vs "
        f"CPU {diff:.3g}, max |hot - full| {moved:.3g}; {forced} captures "
        f"forced; {out['wall_s']:.2f} s — [{gpu}]")
    return out


def wdl_phase(torch, root: str, serve_root: str, plan, rng, gpu: str,
              rows: int = WDL_ROWS, card: str = "cuda") -> dict:
    """The WDL slice at full width through ``cli.main train``: a norm
    plane (f32) and a clean plane (uint8 bins) of ``rows`` x N_COLS from
    the same rows (``train_plane``'s bins, the numeric columns' floats a
    function of their bins), the reference's defaults (EmbedColumnNum 8,
    [64, 32] relu, wide and deep, ADAM 0.002, L2 1e-5) x WDL_BAGS bags:
    (a) WDL_EPOCHS full-batch epochs, falling errors, ms an epoch; (b) one
    epoch at MiniBatchs WDL_BATCH, ms an epoch and a step, and the step's
    launches and the epoch's host syncs (``wdl_step_profile``); (c)
    ``-Dshifu.wdl.hashBuckets=32`` (the columns past 32 categories hash),
    its bucket ids on the card equal to the host's and its models served
    over HTTP on the card against the CPU; (d) CUT_ROWS rows, WDL_CUT_BAGS
    bags, on the card and on the CPU, resident and streamed in windows of
    WDL_CUT_WINDOW: errors within WDL_ERR_RTOL, AUCs within WDL_AUC_TOL;
    (e) WDL_RESUME:
    minibatch epochs, then ``train -resume``, bit-identical; (f)
    ``-Dshifu.wdl.shardTables=on`` (the row-sharded plane on a world of
    one) beside (d)'s card runs and (e)'s uninterrupted one: the model
    files bit for bit, full batch resident and streamed and at MiniBatchs
    1,024; (g) (c)'s models through the serving copies
    (``wdl_serve_copies``)."""
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.models import wdl as wdl_model
    from shifu_tpu_torch.ops import tree_quant as tq
    names = [p[1] for p in plan]
    t0 = time.perf_counter()
    sub_walls = {}
    mark = marker(sub_walls, t0, "wdl_phase: ")
    bins, y, w, informative, _ = train_plane(rng, plan, rows)
    x = (bins.astype(np.float32) - 31.5) / 18.5
    norm, clean = (os.path.join(root, f"wdl_{k}") for k in ("norm", "clean"))
    write_norm_plane(norm, x, y, w, names)
    write_plane(clean, bins, y, w, names, {"chip_smoke": "wdl"})
    out = {"plane_write_s": time.perf_counter() - t0}
    log(f"WDL planes written in {out['plane_write_s']:.2f} s: {rows} rows "
        f"x {N_COLS} columns, informative {informative.tolist()}")
    mark("planes")

    # (a) full batch, WDL_BAGS bags
    a = wdl_set(root, "wdl_a", serve_root, norm, clean, {"MiniBatchs": 0},
                baggingNum=WDL_BAGS, numTrainEpochs=WDL_EPOCHS)
    with LogGrab("shifu_tpu_torch.train.wdl_trainer", r"Epoch #(\d+)") \
            as clock:
        wall = train_cli(a, card)
    errs = check_falling(a, "WDL (a)")
    members = wdl_members(a)
    if len(members) != WDL_BAGS or any(
            type(m).__name__ != "IndependentWDLModel" for m in members):
        fail(f"WDL (a) wrote {len(members)} models")
    spec = members[0].spec
    if spec.numeric_dim != N_NUM or len(spec.cat_cardinalities) != N_CAT \
            or spec.embed_dim != 8 or spec.hidden_nodes != [64, 32]:
        fail(f"WDL (a) spec {spec.to_json()[:300]}")
    s = members[0].compute_full(x[:4096], bins[:4096], device=card)
    if s.shape != (4096, 1) or not np.all(np.isfinite(s)):
        fail(f"WDL (a) scores {s.shape}")
    # the first epoch has no start mark: the median of the later gaps
    out["a"] = {"ms_per_epoch": float(np.median(np.diff(clock.times))) * 1e3,
                "wall_s": wall, "errors_first": errs[0].tolist(),
                "errors_last": errs[-1].tolist(),
                "first_layer_inputs": spec.deep_spec().input_dim}
    log(f"WDL (a) {WDL_BAGS} bags, full batch on {rows} x {N_COLS} "
        f"(first layer {spec.deep_spec().input_dim} wide): "
        f"{out['a']['ms_per_epoch']:.3f} ms an epoch (CLI train {wall:.3f} "
        f"s for {WDL_EPOCHS} epochs), errors {errs[0]} -> {errs[-1]} "
        f"— [{gpu}]")
    mark("(a)")

    # (b) one minibatch epoch at the default MiniBatchs, on the plane's
    # first WDL_B_ROWS rows (a cut for the smoke's time limit)
    rows_b = min(rows, WDL_B_ROWS)
    norm_b, clean_b = norm + "_b", clean + "_b"
    write_norm_plane(norm_b, x[:rows_b], y[:rows_b], w[:rows_b], names)
    write_plane(clean_b, bins[:rows_b], y[:rows_b], w[:rows_b], names,
                {"chip_smoke": "wdl_b"})
    b = wdl_set(root, "wdl_b", serve_root, norm_b, clean_b, {},
                baggingNum=WDL_BAGS, numTrainEpochs=1)
    wall = train_cli(b, card)
    phase = train_phase_s(b)
    steps = -(-rows_b // WDL_BATCH)
    errs_b = progress_errors(b)
    if len(errs_b) != 1 or not np.all(np.isfinite(errs_b)) or \
            not errs_b[0, 0] < errs[0, 0]:
        fail(f"WDL (b) one minibatch epoch: errors {errs_b} against the "
             f"first full-batch epoch's {errs[0]}")
    spec_b = wdl_members(b)[0].spec
    mark("(b) train")
    x_num = x[:, spec_b.extra["num_feat_idx"]]
    x_cat = bins[:, spec_b.extra["cat_col_idx"]]
    prof = wdl_step_profile(torch, x_num, x_cat, y, w, spec_b, gpu) \
        if card == "cuda" else {}
    out["b"] = {"train_phase_s": phase, "wall_s": wall, "steps": steps,
                "ms_per_epoch": phase * 1e3,
                "ms_per_step": phase * 1e3 / steps,
                "errors": errs_b[0].tolist(), **prof}
    log(f"WDL (b) one epoch of {rows_b} rows at MiniBatchs {WDL_BATCH}: "
        f"{steps} steps in "
        f"{phase:.3f} s ({phase * 1e3 / steps:.4f} ms a step, the upload "
        f"and the epoch's error pass included; CLI {wall:.3f} s) "
        f"— [{gpu}]")
    mark("(b) profiles")

    # (c) hashed ids, served (trained on (b)'s rows)
    c = wdl_set(root, "wdl_c", serve_root, norm_b, clean_b,
                {"MiniBatchs": 0}, baggingNum=WDL_BAGS, numTrainEpochs=3)
    props_cli(c, card, {"shifu.wdl.hashBuckets": WDL_HASH_BUCKETS})
    check_falling(c, "WDL (c)", cols=(0,))
    hashed = wdl_members(c)
    hs = hashed[0].spec
    wide = [j for j, card_j in enumerate(
        [len(p[2]) + 1 for p in plan if p[0] == "cat"])
        if card_j > WDL_HASH_BUCKETS]
    if hs.extra.get("hashed_cols") != wide or \
            hs.extra.get("hash_buckets") != WDL_HASH_BUCKETS:
        fail(f"WDL (c) hashed {hs.extra.get('hashed_cols')}, not {wide}")
    cat = bins[:65536, hs.extra["cat_col_idx"]].astype(np.int64)
    on_card = wdl_model.apply_hash_device(
        hs, torch.from_numpy(cat).to(card)).cpu().numpy()
    if not np.array_equal(on_card, wdl_model.apply_hash_host(hs, cat)):
        fail("WDL (c): bucket ids on the card differ from the host's")
    mark("(c) train")
    sd = os.path.join(root, "wdl_serve")
    os.makedirs(sd)
    for f in ("ModelConfig.json", "ColumnConfig.json"):
        shutil.copy(os.path.join(serve_root, f), sd)
    shutil.copytree(os.path.join(c, "models"), os.path.join(sd, "models"))
    set_train_conf(sd, algorithm=Algorithm.WDL)
    served = serve_phase(torch, tq, sd, plan,
                         np.random.default_rng([rows, 9]),
                         tol=WDL_SCORE_TOL, raw_batches=GEMM_RAW_BATCHES) \
        if card == "cuda" else {}
    out["c"] = {"hashed_cols": len(wide), "served": served}
    log(f"WDL (c) hashBuckets {WDL_HASH_BUCKETS}: {len(wide)} of {N_CAT} "
        f"categorical columns hashed; bucket ids on the card equal the "
        f"host's over 65,536 rows; served max |card - cpu| "
        f"{served.get('max_abs_score_diff', float('nan')):.3g} — [{gpu}]")
    mark("(c) serve")
    if card == "cuda":
        out["g"] = wdl_serve_copies(hashed, x, bins, gpu)
        mark("(g) serve copies")

    # (d) the card against the CPU on CUT_ROWS rows, resident and streamed
    cut_n, cut_c = (os.path.join(root, f"wdl_cut_{k}")
                    for k in ("norm", "clean"))
    write_norm_plane(cut_n, x[:CUT_ROWS], y[:CUT_ROWS], w[:CUT_ROWS], names)
    write_plane(cut_c, bins[:CUT_ROWS], y[:CUT_ROWS], w[:CUT_ROWS], names,
                {"chip_smoke": "wdl_cut"})
    out["d"] = {}
    for mode, props in (("resident", {}), ("streamed", {
            "shifu.train.streaming": "on",
            "shifu.train.windowRows": WDL_CUT_WINDOW})):
        runs = []
        for i, dev in enumerate((card, "cpu")):
            dd = wdl_set(root, f"wdl_d_{mode}{i}", serve_root, cut_n, cut_c,
                         {"MiniBatchs": 0}, baggingNum=WDL_CUT_BAGS,
                         numTrainEpochs=WDL_CUT_EPOCHS)
            wall = props_cli(dd, dev, props)
            scores = np.mean([m.compute_full(x[:CUT_ROWS], bins[:CUT_ROWS],
                                             device=dev)[:, 0]
                              for m in wdl_members(dd)], axis=0)
            runs.append((wall, progress_errors(dd),
                         auc(scores, y[:CUT_ROWS])))
            if i == 0:
                # (f) the row-sharded plane on one card: the replicated
                # run's model files bit for bit
                sd = wdl_set(root, f"wdl_f_{mode}", serve_root, cut_n, cut_c,
                             {"MiniBatchs": 0}, baggingNum=WDL_CUT_BAGS,
                             numTrainEpochs=WDL_CUT_EPOCHS)
                shard_wall = props_cli(sd, dev, {**props, **WDL_SHARD})
                same_models(sd, dd, f"WDL (f) {mode} sharded")
                out.setdefault("f", {})[mode] = {"wall_s": shard_wall,
                                                 "replicated_wall_s": wall}
        (cw, ce, ca), (pw, pe, pa) = runs
        rel = float(np.max(np.abs(ce - pe) / np.abs(pe)))
        if ce.shape != pe.shape or not rel <= WDL_ERR_RTOL or \
                not abs(ca - pa) <= WDL_AUC_TOL:
            fail(f"WDL (d) {mode} card vs CPU: errors {rel:.3g} relative, "
                 f"AUC {ca:.6f} vs {pa:.6f}")
        out["d"][mode] = {"err_rel": rel, "auc_card": ca, "auc_cpu": pa,
                          "wall_card_s": cw, "wall_cpu_s": pw,
                          "epochs_logged": len(ce)}
        log(f"WDL (d) {mode} {CUT_ROWS} rows: errors card vs CPU within "
            f"{rel:.3g} relative, AUC {ca:.6f} / {pa:.6f}; train "
            f"{cw:.3f} s on the card, {pw:.3f} s on the CPU — [{gpu}]")

    mark("(d)")
    # (e) minibatch epochs, then train -resume, bit-identical
    first, total, batch = WDL_RESUME
    params = {"MiniBatchs": batch, "CheckpointInterval": 1}
    whole = wdl_set(root, "wdl_e0", serve_root, cut_n, cut_c, params,
                    baggingNum=WDL_BAGS, numTrainEpochs=total)
    train_cli(whole, card)
    # (f) the sharded plane at the minibatch size: bit for bit
    sd = wdl_set(root, "wdl_f_minibatch", serve_root, cut_n, cut_c, params,
                 baggingNum=WDL_BAGS, numTrainEpochs=total)
    out["f"]["minibatch"] = {"wall_s": props_cli(sd, card, WDL_SHARD)}
    same_models(sd, whole, "WDL (f) minibatch sharded")
    log(f"WDL (f) shardTables=on on one card: model files bit-identical "
        f"to the replicated runs, full batch resident and streamed and "
        f"MiniBatchs {batch}; walls {out['f']} — [{gpu}]")
    r = wdl_set(root, "wdl_e1", serve_root, cut_n, cut_c, params,
                baggingNum=WDL_BAGS, numTrainEpochs=first)
    train_cli(r, card)
    set_train_conf(r, numTrainEpochs=total)
    train_cli(r, card, "-resume")
    same_models(r, whole, f"WDL (e): {first} epochs + train -resume against "
                f"{total} uninterrupted")
    out["e"] = {"resume_bit_identical": True}
    log(f"WDL (e) {first} minibatch epochs + train -resume to {total} "
        f"bit-identical to the uninterrupted run — [{gpu}]")
    mark("(e)")
    out["steps_s"] = sub_walls
    return out


def wdl_e2e_phase(torch, root: str, d: str, csv: str, gpu: str) -> dict:
    """WDL on the e2e set's own planes (its ``norm`` wrote both): ``train``
    on the card (WDL_E2E, WDL_E2E_EPOCHS epochs), ``eval -run`` on the
    card and on the CPU (scores within WDL_SCORE_TOL in the %.3f files,
    AUC within WDL_AUC_TOL), and ``export -t spec``: the re-read
    ``model0.wdl`` (``load_reference_wdl``) scoring as the native model on
    the card within SPEC_RTOL / SPEC_ATOL."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data import parsepool
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.models import wdl as wdl_model
    from shifu_tpu_torch.models.reference_import import load_reference_wdl
    card = os.path.join(root, "wdl_e2e")
    shutil.copytree(d, card)
    set_train_params(card, dict(WDL_E2E))
    set_train_conf(card, algorithm=Algorithm.WDL, baggingNum=1,
                   numTrainEpochs=WDL_E2E_EPOCHS)
    cpu_dir, walls = card + "_cpu", {}
    prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
    try:
        walls["train"] = train_cli(card, "cuda")
        shutil.copytree(card, cpu_dir)
        for name, dd, dev in (("eval", card, "cuda"),
                              ("eval_cpu", cpu_dir, "cpu")):
            t0 = time.perf_counter()
            if cli.main(["--dir", dd, "eval", "-run", E2E_EVAL, "--device",
                         dev]) != 0:
                fail(f"WDL eval -run on {dev} exited non-zero")
            walls[name] = time.perf_counter() - t0
    finally:
        parsepool.CHUNK_ROWS = prev_chunk
    check_falling(card, "e2e WDL")
    got, perf = eval_scores(card, E2E_EVAL)
    want, cpu_perf = eval_scores(cpu_dir, E2E_EVAL)
    if got.shape != (CSV_ROWS, 7) or got.shape != want.shape:
        fail(f"WDL EvalScore card {got.shape} vs CPU {want.shape}")
    diff = float(np.abs(got[:, 2:].astype(float)
                        - want[:, 2:].astype(float)).max())
    auc_diff = abs(perf["areaUnderRoc"] - cpu_perf["areaUnderRoc"])
    if not diff <= WDL_SCORE_TOL or not auc_diff <= WDL_AUC_TOL or \
            not 0.55 < perf["areaUnderRoc"] <= 1.0:
        fail(f"WDL eval card vs CPU: scores {diff}, AUC "
             f"{perf['areaUnderRoc']} vs {cpu_perf['areaUnderRoc']}")
    walls["export"] = cli_ok(card, "export", "-t", "spec")
    if cli.main(["--dir", card, "export", "pmml"]) != 1:
        fail("export pmml of a WDL set did not refuse")
    spec2, params2, _ = load_reference_wdl(
        os.path.join(card, "export", "reference", "model0.wdl"))
    native = wdl_members(card)[0]
    x = Shards.open(os.path.join(card, "tmp", "NormalizedData")) \
        .load_all()["x"]
    bins = Shards.open(os.path.join(card, "tmp", "CleanedData")) \
        .load_all()["bins"]
    x_num = x[:, native.spec.extra["num_feat_idx"]]
    x_cat = np.asarray(bins)[:, native.spec.extra["cat_col_idx"]]
    a = wdl_model.IndependentWDLModel(spec2, params2).compute(
        x_num, x_cat, device="cuda")
    b = native.compute(x_num, x_cat, device="cuda")
    spec_err = float(np.abs(a - b).max())
    if a.shape != b.shape or not np.allclose(a, b, rtol=SPEC_RTOL,
                                             atol=SPEC_ATOL):
        fail(f"WDL spec round trip differs by {spec_err}")
    log(f"e2e WDL ({WDL_E2E_EPOCHS} full-batch epochs): train "
        f"{walls['train']:.3f} s, eval -run {walls['eval']:.3f} s on the "
        f"card, {walls['eval_cpu']:.3f} s on the CPU; AUC "
        f"{perf['areaUnderRoc']:.6f} (card - CPU {auc_diff:.3g}), max "
        f"|card - CPU| score {diff:.3g}; export -t spec {walls['export']:.3f}"
        f" s, the re-read spec within {spec_err:.3g} of the native model "
        f"— [{gpu}]")
    return {"walls_s": walls, "auc": perf["areaUnderRoc"],
            "auc_card_cpu": auc_diff, "score_card_cpu_files": diff,
            "spec_err": spec_err, "dir": card}


def svm_phase(torch, root: str, serve_root: str, nn_plane: str, plan,
              gpu: str, rows: int = NN_ROWS, cap: int = SVM_CAP,
              card: str = "cuda") -> dict:
    """The SVM slice on the card: (a) the rbf kernel SVM at the cap (the
    NN plane's first ``cap`` rows x N_COLS) through ``cli.main train``
    (``model0.svm``), and its dual solve alone: wall and ms an iteration
    over SVM_ITERS iterations; (b) the dual on SVM_CUT rows on the card
    and on the CPU: duals within SVM_ALPHA_TOL, decision values within
    SVM_F_TOL, support sets equal but for duals within SVM_ALPHA_TOL of
    the 1e-6 threshold; (c) the linear SVM (hinge on the NN path) on the
    NN plane's ``rows`` rows, SVM_LINEAR_EPOCHS full-batch epochs,
    falling hinge, ms an epoch; (d) (a)'s and (c)'s models served over
    HTTP on the card against the CPU."""
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.models.svm import SVMModelSpec
    from shifu_tpu_torch.ops import tree_quant as tq
    from shifu_tpu_torch.train.svm_trainer import _solve_dual
    out = {}
    data = Shards.open(nn_plane).load_all()
    x, y, w = (np.asarray(data[k][:max(rows, cap)]) for k in "xyw")
    names = [p[1] for p in plan]
    capped = os.path.join(root, "svm_cap_plane")
    write_norm_plane(capped, x[:cap], y[:cap], w[:cap], names)
    a = nn_set(root, "svm_a", serve_root, capped, "SVM",
               {"Kernel": "RBF", "Const": 1.0}, baggingNum=1)
    wall = train_cli(a, card)
    with open(os.path.join(a, "tmp", "train.progress")) as f:
        line = f.read()
    n_sv = int(re.search(r"\((\d+) SVs\)", line).group(1))
    spec = SVMModelSpec(input_dim=N_COLS, kernel="rbf", gamma=SVM_GAMMA)
    xd, yd = (torch.from_numpy(v).to(card) for v in (x[:cap], 2 * y[:cap]
                                                      - 1))
    tm = torch.ones(cap, device=card)
    _solve_dual(xd[:256], yd[:256], tm[:256], tm[:256], spec, 10)   # warm
    if card == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    alpha = _solve_dual(xd, yd, tm, tm, spec, SVM_ITERS)[0]
    alpha.cpu()
    solve = time.perf_counter() - t0
    q_bytes = 4.0 * cap * cap
    out["a"] = {"train_wall_s": wall, "n_sv": n_sv, "solve_s": solve,
                "ms_per_iter": solve * 1e3 / SVM_ITERS,
                "matvec_bound_ms": q_bytes / HBM_BYTES_PER_S * 1e3}
    log(f"SVM (a) rbf at {cap} x {N_COLS} through the CLI: {wall:.3f} s, "
        f"{n_sv} SVs; the dual solve alone {solve:.3f} s for {SVM_ITERS} "
        f"iterations ({solve * 1e3 / SVM_ITERS:.4f} ms an iteration; "
        f"reading the {q_bytes / 2**30:.2f} GiB Q once an iteration takes "
        f"{out['a']['matvec_bound_ms']:.4f} ms at 3.35 TB/s) — [{gpu}]")

    # (b) card vs CPU on SVM_CUT rows
    n = SVM_CUT
    res = [[v.cpu().numpy() for v in _solve_dual(
        *(torch.from_numpy(np.ascontiguousarray(v)).to(dev) for v in (
            x[:n], 2 * y[:n] - 1, np.ones(n, np.float32),
            np.ones(n, np.float32))), spec, SVM_ITERS)]
        for dev in (card, "cpu")]
    (ga, gf, _, _), (ca, cf, _, _) = res
    da, df = float(np.abs(ga - ca).max()), float(np.abs(gf - cf).max())
    differ = (ga > 1e-6) != (ca > 1e-6)
    if not da <= SVM_ALPHA_TOL or not df <= SVM_F_TOL or \
            not (np.abs(ca[differ] - 1e-6) <= SVM_ALPHA_TOL).all():
        fail(f"SVM (b) card vs CPU: duals {da}, decisions {df}, "
             f"{int(differ.sum())} support rows differ")
    out["b"] = {"alpha_diff": da, "decision_diff": df,
                "support_differ": int(differ.sum()),
                "n_sv": int((ca > 1e-6).sum())}
    log(f"SVM (b) {n} rows: duals card vs CPU within {da:.3g}, decisions "
        f"within {df:.3g}, {int(differ.sum())} of {out['b']['n_sv']} "
        f"support rows differ (all within {SVM_ALPHA_TOL} of the "
        f"threshold) — [{gpu}]")

    # (c) the linear SVM on the NN path
    c = nn_set(root, "svm_c", serve_root, nn_plane, "SVM", dict(SVM_LINEAR),
               baggingNum=1, numTrainEpochs=SVM_LINEAR_EPOCHS)
    with EpochClock() as clock:
        wall = train_cli(c, card)
    errs = check_falling(c, "SVM (c)")
    out["c"] = {"ms_per_epoch": clock.ms_per_epoch(), "wall_s": wall,
                "errors_first": errs[0].tolist(),
                "errors_last": errs[-1].tolist()}
    log(f"SVM (c) linear (hinge, Const 1) on {rows} x {N_COLS}: "
        f"{out['c']['ms_per_epoch']:.3f} ms an epoch, hinge {errs[0]} -> "
        f"{errs[-1]} — [{gpu}]")

    # (d) both served
    sd = os.path.join(root, "svm_serve")
    os.makedirs(os.path.join(sd, "models"))
    for f in ("ModelConfig.json", "ColumnConfig.json"):
        shutil.copy(os.path.join(serve_root, f), sd)
    shutil.copy(os.path.join(a, "models", "model0.svm"),
                os.path.join(sd, "models", "model0.svm"))
    shutil.copy(os.path.join(c, "models", "model0.svm"),
                os.path.join(sd, "models", "model1.svm"))
    set_train_conf(sd, algorithm=Algorithm.SVM)
    served = serve_phase(torch, tq, sd, plan,
                         np.random.default_rng([rows, 10]),
                         tol=NN_SCORE_TOL, raw_batches=GEMM_RAW_BATCHES) \
        if card == "cuda" else {}
    out["d"] = served
    return out


def svm_e2e_phase(torch, root: str, d: str, gpu: str) -> dict:
    """Both SVMs on the e2e set's own norm plane (CSV_ROWS rows, at the
    kernel SVM's cap): ``train`` on the card, ``eval -run`` on the card
    and on the CPU, AUC within WDL_AUC_TOL."""
    from shifu_tpu_torch import cli
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data import parsepool
    out = {}
    for kind, params, epochs in (
            ("rbf", {"Kernel": "RBF", "Const": 1.0}, 1),
            ("linear", dict(SVM_LINEAR), SVM_LINEAR_EPOCHS)):
        card = os.path.join(root, f"svm_e2e_{kind}")
        shutil.copytree(d, card)
        set_train_params(card, params)
        set_train_conf(card, algorithm=Algorithm.SVM, baggingNum=1,
                       numTrainEpochs=epochs)
        walls = {}
        prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
        try:
            walls["train"] = train_cli(card, "cuda")
            shutil.copytree(card, card + "_cpu")
            for name, dd, dev in (("eval", card, "cuda"),
                                  ("eval_cpu", card + "_cpu", "cpu")):
                t0 = time.perf_counter()
                if cli.main(["--dir", dd, "eval", "-run", E2E_EVAL,
                             "--device", dev]) != 0:
                    fail(f"SVM ({kind}) eval -run on {dev} exited non-zero")
                walls[name] = time.perf_counter() - t0
        finally:
            parsepool.CHUNK_ROWS = prev_chunk
        _, perf = eval_scores(card, E2E_EVAL)
        _, cpu_perf = eval_scores(card + "_cpu", E2E_EVAL)
        diff = abs(perf["areaUnderRoc"] - cpu_perf["areaUnderRoc"])
        if not diff <= WDL_AUC_TOL or not perf["areaUnderRoc"] > 0.55:
            fail(f"SVM ({kind}) eval AUC card {perf['areaUnderRoc']} vs CPU "
                 f"{cpu_perf['areaUnderRoc']}")
        out[kind] = {"walls_s": walls, "auc": perf["areaUnderRoc"],
                     "auc_card_cpu": diff}
        log(f"e2e SVM ({kind}): train {walls['train']:.3f} s, eval -run "
            f"{walls['eval']:.3f} s on the card, {walls['eval_cpu']:.3f} s "
            f"on the CPU; AUC {perf['areaUnderRoc']:.6f} (card - CPU "
            f"{diff:.3g}) — [{gpu}]")
    return out


def resident_phase(torch, seed: int) -> dict:
    """The port's NumericAccumulator on the card at a deployment's size:
    weighted (S = 4), RESIDENT_CHUNKS chunks of 262,144 rows x 224
    columns made on the card from ``seed``; with the default 1 GiB fused
    budget 3 chunks stay resident and 5 overflow, so both sides of
    finalize_fused run at full size.  Times each chunk update and the
    finalize, counts B3 launches (zeroed just before), reads the peak
    device memory; then holds the first two chunks against the CPU path
    (counts and boundaries equal)."""
    from shifu_tpu_torch.config.model_config import BinningMethod
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.ops.binning import NumericAccumulator
    gen = torch.Generator(device="cuda")

    def chunk(i):
        gen.manual_seed(seed * 1000 + i)
        n, c = RESIDENT_ROWS, N_NUM
        shift = torch.arange(c, device="cuda", dtype=torch.float32)
        x = torch.randn((n, c), generator=gen, device="cuda") \
            * (1.0 + shift / 16) + shift
        valid = torch.rand((n, c), generator=gen, device="cuda") > 0.05
        t = (torch.rand(n, generator=gen, device="cuda") < 0.3).float()
        w = torch.rand(n, generator=gen, device="cuda") * 2.5 + 0.5
        return x, valid, t, w

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    acc = NumericAccumulator(n_cols=N_NUM, device="cuda")
    sh.stats_histograms_cuda.launches = 0
    update_ms = []
    for i in range(RESIDENT_CHUNKS):
        args = chunk(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc.update_fused(*args)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t0) * 1e3)
        del args
    resident = len(acc._fused_chunks)
    t0 = time.perf_counter()
    acc.finalize_fused()
    sketch = acc.finalize_sketch(BinningMethod.EqualPositive, 10)
    torch.cuda.synchronize()
    finalize_ms = (time.perf_counter() - t0) * 1e3
    launches = sh.stats_histograms_cuda.launches
    peak = torch.cuda.max_memory_allocated() - base
    if launches != RESIDENT_CHUNKS or resident != 3:
        fail(f"resident accumulator: {launches} stats_hist launches, "
             f"{resident} chunks kept")
    if any(len(b) < 2 for b in sketch[0]):
        fail("resident accumulator left a column unbinned")
    del acc, sketch

    out = []
    for dev in ("cuda", "cpu"):
        acc = NumericAccumulator(n_cols=N_NUM, device=dev)
        for i in range(2):
            acc.update_fused(*(a.to(dev) for a in chunk(i)))
        acc.finalize_fused()
        out.append(acc.finalize_sketch(BinningMethod.EqualPositive, 10))
        del acc
    (bg, ag, pg, dg), (bc, ac, pc, dc) = out
    for j in range(N_NUM):
        if not (np.array_equal(bg[j], bc[j])
                and np.array_equal(ag[j][:, :2], ac[j][:, :2])):
            fail(f"resident accumulator: card vs CPU counts or boundaries "
                 f"differ at column {j}")
    if not (np.array_equal(pg, pc) and np.array_equal(dg, dc)):
        fail("resident accumulator: card vs CPU percentiles differ")
    per_chunk = float(np.median(update_ms))
    log(f"resident accumulator: {RESIDENT_CHUNKS} chunks of {RESIDENT_ROWS} "
        f"x {N_NUM} weighted, {resident} resident; update "
        f"{per_chunk:.3f} ms a chunk (median; all {[round(v, 3) for v in update_ms]}), "
        f"finalize {finalize_ms:.3f} ms, {launches} stats_hist launches, "
        f"peak device memory {peak / 2**30:.3f} GiB; first 2 chunks: "
        "card == CPU counts, boundaries, percentiles")
    return {"launches": launches, "update_ms": update_ms,
            "update_ms_median": per_chunk, "finalize_ms": finalize_ms,
            "peak_bytes": peak, "resident_chunks": resident}

# ------------------------------------------------------- phase: timing
def traverse_forest(torch, tq, rng):
    """``random_forest``'s serving forest on the card, and the keyword
    arguments that hand a version's packed form of it to
    ``predict_forest_quant`` (none for a version without one), packed once
    as a caller that pins the forest does."""
    sf, lm, lv = random_forest(rng, N_TREES, DEPTH, N_BINS, N_COLS)
    forest = [torch.from_numpy(a).to("cuda")
              for a in (sf, lm.astype(np.uint8), lv)]
    packed = {"packed": tq.pack_forest(*forest, DEPTH)} \
        if hasattr(tq, "pack_forest") else {}
    return forest, packed


def time_kernels(torch, tq, rng, gpu: str) -> dict:
    forest, packed = traverse_forest(torch, tq, rng)
    sf = forest[0]
    out = {}
    for n in TRAVERSE_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to("cuda")
        if not torch.equal(tq.predict_forest_quant(*forest, bins, DEPTH,
                                                   **packed),
                           tq.predict_forest_quant_ref(*forest, bins, DEPTH)):
            fail(f"tree_traverse != plain version at N={n} (timed)")
        ms = device_ms(torch, lambda: tq.predict_forest_quant(
            *forest, bins, DEPTH, **packed))
        plain_ms = device_ms(torch, lambda: tq.predict_forest_quant_ref(
            *forest, bins, DEPTH), launches=3 if n <= 65536 else 1,
            repeats=5 if n <= 65536 else 3)
        # what this run's data needs: each element a walk reads, once;
        # [T, N] f32 written once; integer work per split step taken
        need = tq.traverse_bytes(forest[0], forest[1], bins, DEPTH)
        whole = tq.walk_cost(
            rows=n, n_feat=N_COLS, n_bins=N_BINS, n_nodes=sf.shape[1],
            depth=DEPTH, n_trees=N_TREES)["bytes_accessed"]
        bytes_ms = need["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = need["split_steps"] * OPS_PER_LEVEL / INT_OPS_PER_S * 1e3
        out[n] = {"ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations",
                  "bytes": need["bytes"], "split_steps": need["split_steps"],
                  "whole_forest_bytes": whole}
        log(f"tree_traverse N={n} (bit-equal to the plain version): "
            f"kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, bound {out[n]['bound_ms']:.6f} ms "
            f"({out[n]['bound_by']}: {need['bytes'] / 1e6:.3f} MB read "
            f"and written, {need['split_steps']} split steps; the whole "
            f"forest and plane would be {whole / 1e6:.3f} MB) — [{gpu}]")
    return out


def time_eval_walk(torch, tq, d: str, bins: np.ndarray, gpu: str) -> dict:
    """``tree_traverse`` at the e2e phase's eval shapes: the trained GBT's
    forest, packed once as the eval scorer packs it, over the norm plane's
    bins in one eval chunk (CSV_CHUNK rows) and over EVAL_TIMED_ROWS rows
    (the eval set's bins repeated), held bit for bit to the plain version and timed beside it
    and its bound, as ``time_kernels`` does."""
    from shifu_tpu_torch.eval.scorer import load_models
    model = load_models(os.path.join(d, "models"))[0]
    dev = torch.device("cuda")
    forest = model.quant_arrays(dev)
    packed = model.quant_packed(dev)
    depth = model.trees[0].depth
    out = {}
    reps = -(-EVAL_TIMED_ROWS // len(bins))
    bins = np.concatenate([bins] * reps)
    for n in (CSV_CHUNK, EVAL_TIMED_ROWS):
        b = torch.from_numpy(np.ascontiguousarray(bins[:n])).to(dev)
        got = tq.predict_forest_quant(*forest, b, depth, packed=packed)
        want = tq.predict_forest_quant_ref(*forest, b, depth)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"tree_traverse != plain version on the eval forest at "
                 f"N={n}")
        ms = device_ms(torch, lambda: tq.predict_forest_quant(
            *forest, b, depth, packed=packed))
        plain_ms = device_ms(torch, lambda: tq.predict_forest_quant_ref(
            *forest, b, depth), launches=3, repeats=5)
        need = tq.traverse_bytes(forest[0], forest[1], b, depth)
        bytes_ms = need["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = need["split_steps"] * OPS_PER_LEVEL / INT_OPS_PER_S * 1e3
        out[n] = {"ms": ms, "plain_ms": plain_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations", "max_abs_err": 0.0,
                  "shape": f"T={forest[0].shape[0]} depth={depth} N={n} "
                           f"C={b.shape[1]} B={forest[1].shape[2]} uint8"}
        log(f"tree_traverse on the eval forest ({out[n]['shape']}, "
            f"bit-equal to the plain version): kernel {ms:.5f} ms, plain "
            f"{plain_ms:.4f} ms, bound {out[n]['bound_ms']:.6f} ms "
            f"({out[n]['bound_by']}) — [{gpu}]")
    return out


def time_parts(torch, bins, node_b, stats_b, k: int) -> dict:
    """A histogram launch's device ms by part, on [TB, N] node ids and [TB,
    N, S] stats (B1 at TB = 1): ``hist.launch_until`` stopped after the
    partition (the wrapper's channel scan and the block set-up included),
    after the row walk (staging, bin loads), after the adds, then the
    production launch whole (the flush and finalize); each part is the
    difference of two neighbours."""
    from shifu_tpu_torch.ops import hist
    steps = [(name, lambda stop=stop: hist.launch_until(
        bins, node_b, stats_b, k, N_BINS, stop)) for name, stop in
        (("partition", hist.SETUP), ("walk", hist.WALK),
         ("adds", hist.ADDS))]
    steps.append(("flush", lambda: hist.build_histograms_batch_cuda(
        bins, node_b, stats_b, k, N_BINS)))
    out, prev = {}, 0.0
    for name, launch in steps:
        cum = device_ms(torch, launch, launches=5, repeats=3)
        out[name] = cum - prev
        prev = cum
    return out


def time_hist(torch, rng, gpu: str) -> dict:
    """B1 at N=1,048,576 rows of 256 uint8 columns, 64 bins, S=2, for K in
    HIST_TIMED_NODES on ``hist_inputs``' data, each held to the plain
    versions first (``held_to_plain``): the kernel (its wrapper's device
    work included), its split by part, the plain version, and one
    ``scatter_add_`` of every active (row, column) into the flat [K*C*B,
    S] f32 buffer with the cell index computed beforehand; the bound
    counts what this data makes the build move (``hist_bytes``) and one
    add per active (row, column, channel)."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import build_histograms
    out = {}
    for k in HIST_TIMED_NODES:
        bins, node, stats = hist_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                        N_BINS, k)
        d = held_to_plain(torch, hist, build_histograms(
            bins, node, stats, k, N_BINS), bins, node, stats, k, N_BINS,
            f"N={TRAIN_ROWS} K={k} (timed)", "hist")
        ms = device_ms(torch, lambda: build_histograms(bins, node, stats, k,
                                                       N_BINS))
        parts = time_parts(torch, bins, node[None], stats[None], k)
        plain_ms = device_ms(torch, lambda: hist.build_histograms_ref(
            bins, node, stats, k, N_BINS), launches=2, repeats=3)
        act = (node >= 0).nonzero()[:, 0]
        cols = torch.arange(N_COLS, device="cuda")
        cell = ((node[act].long() * N_COLS)[:, None] + cols) * N_BINS \
            + bins[act].long()
        idx = cell.reshape(-1, 1).expand(-1, 2)
        src = stats[act][:, None, :].expand(-1, N_COLS, -1).reshape(-1, 2)
        del cell
        flat = torch.zeros((k * N_COLS * N_BINS, 2), device="cuda")
        library_ms = device_ms(torch, lambda: flat.scatter_add_(0, idx, src),
                               launches=3, repeats=5)
        nbytes = hist.hist_bytes(bins, node, stats, k, N_BINS)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = act.numel() * N_COLS * 2 / INT_OPS_PER_S * 1e3
        plan = hist.hist_plan(TRAIN_ROWS, N_COLS, 1, k, N_BINS, 2)
        out[k] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations", "bytes": nbytes,
                  "active_rows": int(act.numel()), "parts_ms": parts,
                  "plan": plan, "max_abs_err": d}
        log(f"hist N={TRAIN_ROWS} K={k}: kernel {ms:.5f} ms (by part "
            + ", ".join(f"{n} {v:.4f}" for n, v in parts.items())
            + f"), plain {plain_ms:.4f} ms, scatter_add_ {library_ms:.4f} "
            f"ms, bound {out[k]['bound_ms']:.6f} ms ({out[k]['bound_by']}: "
            f"{nbytes / 1e6:.3f} MB, {act.numel()} active rows; plan "
            f"{plan}) — [{gpu}]")
        del bins, node, stats, act, idx, src, flat
        torch.cuda.empty_cache()
    return out


def time_hist_batch(torch, rng, gpu: str) -> dict:
    """B2 at TB=8 over N=1,048,576 rows of 256 uint8 columns, 64 bins,
    S=2, for each K in HIST_BATCH_NODES (K=4096: the deepest level of a
    depth-14 tree) on ``batch_inputs``' data (``time_batch``, with the
    split by part and 8 B1 launches beside it)."""
    torch.cuda.empty_cache()
    return {k: time_batch(torch, rng, gpu, HIST_BATCH, k, 2, detail=True)
            for k in HIST_BATCH_NODES}


def time_batch(torch, rng, gpu: str, tb: int, k: int, s: int,
               detail: bool = False) -> dict:
    """B2 at TB trees, K nodes and S channels over N=1,048,576 rows of 256
    uint8 columns, 64 bins, on ``batch_inputs``' data: the kernel (its
    wrapper's device work included), the plain version, and one
    ``scatter_add_`` of every tree's active (row, column) into the flat
    [TB*K*C*B, S] f32 buffer with the cell index computed beforehand; the
    bound counts what this data makes the build move
    (``hist_batch_bytes``: the bins once, each tree's node ids and active
    stats, the output) and one add per active (tree, row, column,
    channel).  ``detail``: also its split by part and TB B1 launches.
    Otherwise (the bagged GBT's and the native multi-class RF's shapes)
    every tree is first held to a B1 launch bit for bit and tree 0 to the
    plain versions (``held_to_plain``)."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops.tree import (build_histograms,
                                          build_histograms_batch)
    bins, node, stats = batch_inputs(torch, rng, TRAIN_ROWS, N_COLS, N_BINS,
                                     k, tb, s=s)
    where = f"TB={tb} N={TRAIN_ROWS} K={k} S={s}"
    out = {"max_abs_err": None}
    if not detail:
        got = build_histograms_batch(bins, node, stats, k, N_BINS)
        for t in range(tb):
            if not torch.equal(got[t], build_histograms(bins, node[t],
                                                        stats[t], k, N_BINS)):
                fail(f"hist_batch tree {t} != hist (B1) at {where}")
        out["max_abs_err"] = held_to_plain(
            torch, hist, got[0], bins, node[0], stats[0], k, N_BINS, where,
            "hist_batch tree 0")
        del got
        torch.cuda.empty_cache()
    ms = device_ms(torch, lambda: build_histograms_batch(
        bins, node, stats, k, N_BINS), launches=10, repeats=5)
    if detail:
        # the sequential alternative: one B1 launch a tree
        out["hist_each_tree_ms"] = device_ms(torch, lambda: [
            build_histograms(bins, node[t], stats[t], k, N_BINS)
            for t in range(tb)], launches=2, repeats=3)
        out["parts_ms"] = time_parts(torch, bins, node, stats, k)
    plain_ms = device_ms(torch, lambda: hist.build_histograms_batch_ref(
        bins, node, stats, k, N_BINS), launches=1, repeats=3)
    plan = hist.hist_plan(TRAIN_ROWS, N_COLS, tb, k, N_BINS, s)
    nbytes = hist.hist_batch_bytes(bins, node, stats, k, N_BINS)
    act = (node >= 0).nonzero()                   # [M, 2] (tree, row)
    n_act = int(act.shape[0])
    cols = torch.arange(N_COLS, device="cuda")
    cell = ((act[:, 0] * k + node[act[:, 0], act[:, 1]].long())
            * N_COLS)[:, None] + cols        # [M, C] int64, in place on
    cell.mul_(N_BINS).add_(bins[act[:, 1]])  # (memory: M*C is ~1.5e9)
    idx = cell.reshape(-1, 1).expand(-1, s)
    src = stats[act[:, 0], act[:, 1]][:, None, :] \
        .expand(-1, N_COLS, -1).reshape(-1, s)
    del cell
    flat = torch.zeros((tb * k * N_COLS * N_BINS, s), device="cuda")
    library_ms = device_ms(torch, lambda: flat.scatter_add_(0, idx, src),
                           launches=2, repeats=3)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_act * N_COLS * s / INT_OPS_PER_S * 1e3
    out.update({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "active": n_act, "plan": plan})
    log(f"hist_batch {where}: kernel {ms:.5f} ms"
        + ("" if not detail else " (by part " + ", ".join(
            f"{n} {v:.4f}" for n, v in out["parts_ms"].items())
            + f"), {tb} hist (B1) launches {out['hist_each_tree_ms']:.4f} "
            "ms")
        + f", plain {plain_ms:.4f} ms, scatter_add_ {library_ms:.4f} ms, "
        f"bound {out['bound_ms']:.6f} ms ({out['bound_by']}: "
        f"{nbytes / 1e6:.3f} MB, {n_act} active (tree, row) pairs; plan "
        f"{plan})" + ("" if detail else " — every tree == hist (B1), tree "
                      f"0 == plain version (max |d| {out['max_abs_err']:.3g})")
        + f" — [{gpu}]")
    del bins, node, stats, act, idx, src, flat
    torch.cuda.empty_cache()
    return out


def time_of(torch, root: str, seed: int) -> None:
    """``--time-of DIR``, with ``shifu_tpu_torch`` imported from checkout
    DIR: B1 and B2 (TB=8) at ``time_hist``'s shapes and K on
    ``hist_inputs`` / ``batch_inputs``' data from ``seed``, each launch
    timed whole and on all-zero stats (device ms), then ``chunk_phase``
    on a training plane from ``seed`` (the column plan of
    ``write_model_set``, the rows of ``train_plane``).  Only the two
    wrappers and ``gbt_forest_chunk`` are called, so any version of the
    port can be timed; what a launch on zero stats skips is the version's
    own (the one-source kernel drops every such row in its partition).
    Prints the card, a log line a case and one JSON line."""
    from shifu_tpu_torch.ops import hist
    gpu = gpu_identity()
    print(gpu, flush=True)
    rng = np.random.default_rng(seed)
    out = {"root": os.path.abspath(root), "gpu": gpu, "cases": {}}
    for tb, k in [(0, k) for k in HIST_TIMED_NODES] \
            + [(HIST_BATCH, k) for k in HIST_BATCH_NODES]:
        if tb:
            name, fn = f"B2 TB={tb} K={k}", hist.build_histograms_batch_cuda
            bins, node, stats = batch_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                             N_BINS, k, tb)
        else:
            name, fn = f"B1 K={k}", hist.build_histograms_cuda
            bins, node, stats = hist_inputs(torch, rng, TRAIN_ROWS, N_COLS,
                                            N_BINS, k)
        row = {tag: device_ms(torch, lambda st=st: fn(bins, node, st, k,
                                                      N_BINS),
                              launches=5, repeats=3)
               for tag, st in (("ms", stats),
                               ("zero_stats_ms", torch.zeros_like(stats)))}
        out["cases"][name] = row
        log(f"{name}: {row['ms']:.4f} ms, on zero stats "
            f"{row['zero_stats_ms']:.4f} ms ({out['root']}) — [{gpu}]")
        del bins, node, stats
        torch.cuda.empty_cache()
    from shifu_tpu_torch.ops import stats_hist as sh
    for s in (4, 2):
        idx, st, exact = stats_inputs(torch, rng, RESIDENT_ROWS, N_NUM,
                                      STATS_BUCKETS, s)
        name = f"B3 S={s}"
        row = {"ms": device_ms(torch, lambda: sh.stats_histograms_cuda(
            idx, st, STATS_BUCKETS, exact))}
        if hasattr(sh, "launch_until"):          # versions with parts
            row["parts_ms"] = stats_parts(torch, sh, idx, st, exact)
        out["cases"][name] = row
        log(f"{name}: {row['ms']:.4f} ms"
            + (" (by part " + ", ".join(f"{n} {v:.4f}" for n, v in
                                         row["parts_ms"].items()) + ")"
               if "parts_ms" in row else "")
            + f" ({out['root']}) — [{gpu}]")
        del idx, st
    from shifu_tpu_torch.ops import tree_quant as tq
    forest, packed = traverse_forest(torch, tq, rng)
    for n in TRAVERSE_ROWS:
        bins = torch.from_numpy(rng.integers(
            0, N_BINS, size=(n, N_COLS)).astype(np.uint8)).to("cuda")
        name = f"B4 N={n}"
        out["cases"][name] = {"ms": device_ms(
            torch, lambda: tq.predict_forest_quant(*forest, bins, DEPTH,
                                                   **packed))}
        log(f"{name}: {out['cases'][name]['ms']:.5f} ms ({out['root']}) — "
            f"[{gpu}]")
        del bins
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        plan = write_model_set(d, np.random.default_rng([seed, 1]))["plan"]
    bins, y, w, _, is_cat = train_plane(np.random.default_rng([seed, 2]),
                                        plan, TRAIN_ROWS)
    chunk = chunk_phase(torch, bins, y, w, is_cat, "cuda")
    out["gbt_ms_per_tree"] = chunk["ms_per_tree"]
    out["gbt_quartiles_ms"] = chunk["quartiles_ms"]
    log(f"GBT: {chunk['ms_per_tree']:.3f} ms a tree ({out['root']}) — "
        f"[{gpu}]")
    print(json.dumps(out), flush=True)


def stats_parts(torch, sh, idx, st, exact) -> dict:
    """A B3 launch's device ms by part: ``stats_hist.launch_until``
    stopped after the wrapper's ``amax``, after the kernel's staging of
    the ids, after zeroing and accumulating the cells, then the production
    launch whole (the flush to f32); each part is the difference of two
    neighbours."""
    steps = [(name, lambda stop=stop: sh.launch_until(
        idx, st, STATS_BUCKETS, exact, stop)) for name, stop in
        (("amax", sh.AMAX), ("stage", sh.STAGE), ("accumulate", sh.ACCUM))]
    steps.append(("flush", lambda: sh.stats_histograms_cuda(
        idx, st, STATS_BUCKETS, exact)))
    out, prev = {}, 0.0
    for name, launch in steps:
        cum = device_ms(torch, launch, launches=10, repeats=5)
        out[name] = cum - prev
        prev = cum
    return out


def time_stats_hist(torch, rng, gpu: str) -> dict:
    """B3 at the stats path's chunk, N=262,144 x 224 columns, 4096
    buckets, for S=4 and S=2 on ``stats_inputs``' data: the kernel (its
    wrapper's id transpose included), the plain version, and one
    ``index_add_`` over the flattened (column, bucket) cell of every
    valid cell (its index computed beforehand); the bound counts the ids,
    stats and output once (``stats_hist_bytes``) and one add per valid
    cell and channel."""
    from shifu_tpu_torch.ops import stats_hist as sh
    out = {}
    n, c, b = RESIDENT_ROWS, N_NUM, STATS_BUCKETS
    for s in (4, 2):
        idx, st, exact = stats_inputs(torch, rng, n, c, b, s)
        ms = device_ms(torch, lambda: sh.stats_histograms(idx, st, b, exact))
        parts = stats_parts(torch, sh, idx, st, exact)
        plan = sh.stats_hist_plan(n, c, b, s, sum(exact))
        plain_ms = device_ms(torch, lambda: sh.stats_histograms_ref(
            idx, st, b), launches=2, repeats=3)
        ok = idx >= 0
        flat = (idx.long() + torch.arange(c, device="cuda") * b)[ok]
        src = st[:, None, :].expand(n, c, s)[ok]
        acc = torch.zeros((c * b, s), device="cuda")
        library_ms = device_ms(torch, lambda: acc.index_add_(0, flat, src),
                               launches=3, repeats=5)
        nbytes = sh.stats_hist_bytes(idx, st, b)
        valid = int(flat.numel())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = valid * s / INT_OPS_PER_S * 1e3
        out[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms
                  else "operations", "bytes": nbytes, "valid_cells": valid,
                  "parts_ms": parts, "plan": plan}
        log(f"stats_hist N={n} C={c} B={b} S={s}: kernel {ms:.5f} ms (by "
            "part " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f"), plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, "
            f"bound {out[s]['bound_ms']:.6f} ms ({out[s]['bound_by']}: "
            f"{nbytes / 1e6:.3f} MB, {valid} valid cells; plan {plan}) — "
            f"[{gpu}]")
        del idx, st, ok, flat, src, acc
    return out


def time_transform(torch, root: str, plan, rng, gpu: str) -> dict:
    """The device transform at the top rung, as the scorer runs it for a
    tree-only ensemble (bins only) and with its x blocks too: host wall
    time per call (eager ops are host-bound) and device time per call,
    the two variants in turns."""
    from shifu_tpu_torch.serve.transform import FusedTransform
    tf = FusedTransform.from_dir(root)
    packed = tf.parse_records(make_records(rng, plan, 512))[0]
    wire = torch.from_numpy(packed).to("cuda")
    out = {True: {"host_ms": [], "device_ms": []},
           False: {"host_ms": [], "device_ms": []}}
    for need_x in (True, False, False, True):
        fn = lambda: tf.apply_device(wire, need_x=need_x)      # noqa: E731
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        out[need_x]["host_ms"].append((time.perf_counter() - t0) * 20.0)
        out[need_x]["device_ms"].append(device_ms(torch, fn))
    res = {("with_x" if k else "bins_only"): {m: float(np.median(v))
                                             for m, v in d.items()}
           for k, d in out.items()}
    for name, d in res.items():
        log(f"device transform N=512 {name}: {d['host_ms']:.4f} ms wall "
            f"per call, {d['device_ms']:.4f} ms device — [{gpu}]")
    return res


# ----------------------------------------------------------------- main
# ------------------------------------------------ phase: every input kind
INPUTS_TREES = 3                           # inputs_phase's GBT
INPUTS_THRESHOLD = "0.2"                   # shifu.data.badThreshold
POISSON_RATES, POISSON_ROWS = (10.0, 37.0, 1000.0, 1e5), 1 << 14


def write_input_shards(d: str, csv: str) -> dict:
    """The stats CSV cut into shards of every compression the reference
    reads (``.gz``, ``.bz2``, ``.xz``, ``.zip`` and plain), plus a shard
    of the wrong width (its rows one field short, so their tags are empty)
    and a ``.gz`` that is not gzip (quarantined as unreadable).  Returns
    the row ranges of each kind."""
    import bz2
    import gzip
    import lzma
    import zipfile
    with open(csv) as f:
        lines = f.read().splitlines()
    os.makedirs(d)
    cuts = np.linspace(0, len(lines), 7).astype(int)
    kinds = ("gz", "bz2", "xz", "zip", "plain", "narrow")
    ranges = {}
    for i, kind in enumerate(kinds):
        part = lines[cuts[i]:cuts[i + 1]]
        ranges[kind] = (int(cuts[i]), int(cuts[i + 1]))
        if kind == "narrow":
            part = ["|".join(ln.split("|")[:-1]) for ln in part]
        data = ("\n".join(part) + "\n").encode()
        name = f"part-{i}-{kind}.csv"
        if kind == "gz":
            data, name = gzip.compress(data), name + ".gz"
        elif kind == "bz2":
            data, name = bz2.compress(data), name + ".bz2"
        elif kind == "xz":
            data, name = lzma.compress(data), name + ".xz"
        elif kind == "zip":
            buf = __import__("io").BytesIO()
            with zipfile.ZipFile(buf, "w") as zf:
                zf.writestr("inner.csv", data)
            data, name = buf.getvalue(), name + ".zip"
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)
    with open(os.path.join(d, "part-6-corrupt.csv.gz"), "wb") as f:
        f.write(b"this is not gzip data\n" * 8)
    return {"ranges": ranges, "lines": lines}


def inputs_phase(torch, root: str, csv: str, plan, gpu: str) -> dict:
    """Every input kind and config check the reference takes, through
    ``cli.main`` on the card and on the CPU: the stats CSV as shards of
    every compression with a wrong-width shard and a corrupt one
    (``-Dshifu.data.badThreshold=0.2``) and a ``filterExpressions`` with
    ``&`` and a string comparison, through ``init → stats → norm → train
    (GBT) → eval`` (the CPU twin evaluates the card's forest).  Checks:
    the quarantined shards and rows and the kept count equal a host
    count; card and CPU ColumnConfig.json equal (compare_column_configs)
    and eval scores within SCORE_TOL; ``train
    -dry`` writes no model; a config with ``baggingSampleRate`` 5 fails
    ``probe``; ``prng.poisson`` at rates 10, 37, 1000 and 1e5 on the card
    equals the CPU's bit for bit.  The smoke imports neither ``pyarrow``
    nor ``fsspec`` (the card's machine is not known to have them):
    parquet and remote sources are held by the CPU tests alone.  The
    kernel counts are zeroed just before the card's steps and read just
    after them."""
    from shifu_tpu_torch import cli, obs
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.validator import (ModelStep, ValidationError,
                                                  probe)
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.ops import stats_hist as sh
    base = os.path.join(root, "inputs")
    shards = write_input_shards(os.path.join(base, "data"), csv)
    num, cat = plan[0], plan[N_NUM]
    expr = f"{num[1]} > {num[2]:.6g} & {cat[1]} != '{cat[2][0]}'"
    header = open(csv + ".header").read().strip().split("|")
    jn, jc = header.index(num[1]), header.index(cat[1])
    keep = 0                                  # the host's count
    for kind, (a, b) in shards["ranges"].items():
        if kind == "narrow":
            continue                          # empty tags: never kept
        for ln in shards["lines"][a:b]:
            f = ln.split("|")
            keep += bool(f[jn]) and float(f[jn]) > float(f"{num[2]:.6g}") \
                and f[jc] != cat[2][0]
    if cli.main(["--dir", base, "new", "inputs"]) != 0:
        fail("new exited non-zero")
    d = os.path.join(base, "inputs")
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    for ds in (mc.dataSet, mc.evals[0].dataSet):
        ds.dataPath, ds.dataDelimiter = os.path.join(base, "data"), "|"
        ds.headerPath, ds.headerDelimiter = csv + ".header", "|"
        ds.filterExpressions = expr
    ds = mc.dataSet
    ds.targetColumnName, ds.weightColumnName = "tag", "weight"
    ds.posTags, ds.negTags = ["bad"], ["good"]
    mc.stats.maxNumBin = N_BINS - 1
    mc.train.algorithm = "GBT"
    mc.train.params = {"TreeNum": INPUTS_TREES, "MaxDepth": DEPTH,
                       "Loss": "log", "LearningRate": 0.1}
    mc.save(path)
    props = [INLINE_PARSE, f"-Dshifu.data.badThreshold={INPUTS_THRESHOLD}",
             "-Dshifu.io.retries=0"]
    if cli.main(["--dir", d, *props, "init"]) != 0:
        fail("init exited non-zero over the shards")
    cpu_dir = d + "_cpu"
    shutil.copytree(d, cpu_dir)
    walls = {}
    launches = {}
    try:
        for where, dev in ((d, "cuda"), (cpu_dir, "cpu")):
            card = where == d
            if card:
                zero_tree_counts()
                sh.stats_histograms_cuda.launches = 0
            else:        # the card's forest, so eval compares one model
                shutil.copytree(os.path.join(d, "models"),
                                os.path.join(where, "models"),
                                dirs_exist_ok=True)
            t0 = time.perf_counter()
            for argv in (["stats", "--telemetry", "--device", dev],
                         ["norm"], ["train", "--device", dev],
                         ["eval", "-run", "--device", dev]):
                if not card and argv[0] == "train":
                    continue
                if cli.main(["--dir", where, *props, *argv]) != 0:
                    fail(f"{' '.join(argv)} exited non-zero in {where}")
                obs.set_enabled(None)
            walls["card" if card else "cpu"] = time.perf_counter() - t0
            if card:
                launches = {**read_tree_counts(),
                            "stats_hist": sh.stats_histograms_cuda.launches}
    finally:
        environment.reset_for_tests()
        obs.reset_for_tests()
    for k in ("hist", "stats_hist", "tree_traverse"):
        if not launches.get(k):
            fail(f"inputs_phase launched no {k} on the card: {launches}")
    quarantined = {}
    with open(os.path.join(d, "telemetry", "trace.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("name", "").startswith("data.quarantined"):
                quarantined[rec["name"]] = rec["value"]
    want_q = {"data.quarantined_shards": 1.0, "data.quarantined_rows": 0.0}
    if quarantined != want_q:
        fail(f"quarantine counted {quarantined}, the host {want_q}")
    with open(os.path.join(d, "ColumnConfig.json")) as f:
        card = json.load(f)
    with open(os.path.join(cpu_dir, "ColumnConfig.json")) as f:
        cpu = json.load(f)
    counts = {c["columnStats"]["totalCount"] for c in card
              if c["columnBinning"].get("binBoundary")}
    if counts != {keep}:
        fail(f"stats kept {counts} rows, the host's filter {keep}")
    for a, b in zip(card, cpu):
        compare_column_configs(a, b, a["columnName"])
    card_s, perf = eval_scores(d, mc.evals[0].name)
    cpu_s, cpu_perf = eval_scores(cpu_dir, mc.evals[0].name)
    if len(card_s) != keep or card_s.shape != cpu_s.shape:
        fail(f"eval scored {len(card_s)} rows on the card, {len(cpu_s)} "
             f"on the CPU, {keep} kept by the host")
    diff = float(np.abs(card_s[:, 2:].astype(float)
                        - cpu_s[:, 2:].astype(float)).max())
    if not diff <= SCORE_TOL + 1e-9:
        fail(f"filtered eval scores card vs CPU differ by {diff}")
    # train -dry trains nothing; a rate the probe refuses fails it
    models = os.path.join(d, "models")
    shutil.rmtree(models)
    if cli.main(["--dir", d, "train", "-dry", "--device", "cuda"]) != 0 \
            or (os.path.isdir(models) and os.listdir(models)):
        fail("train -dry did not exit 0 without a model")
    mc = ModelConfig.load(path)
    mc.train.baggingSampleRate = 5.0
    try:
        probe(mc, ModelStep.TRAIN, d)
        fail("probe took baggingSampleRate 5")
    except ValidationError as e:
        if not any("baggingSampleRate" in p for p in e.problems):
            fail(f"probe refused baggingSampleRate 5 for {e.problems}")
    # jax's rejection sampler on the card, bit for bit the CPU's
    keys = [prng.prng_key(s) for s in (0, 1)]
    t0 = time.perf_counter()
    for lam in POISSON_RATES:
        on_card = prng.poisson(keys, lam, POISSON_ROWS, device="cuda").cpu()
        on_cpu = prng.poisson(keys, lam, POISSON_ROWS)
        if not torch.equal(on_card, on_cpu):
            fail(f"poisson at rate {lam}: "
                 f"{int((on_card != on_cpu).sum())} draws differ card/CPU")
    poisson_s = time.perf_counter() - t0
    log(f"inputs: {len(os.listdir(os.path.join(base, 'data')))} shards "
        f"(gz, bz2, xz, zip, plain, wrong width, corrupt), filter {expr!r}"
        f" keeps {keep} rows as the host counts, 1 shard quarantined; "
        f"card vs CPU ColumnConfig equal, scores within {diff:.3g}, AUC "
        f"{perf['areaUnderRoc']:.6f} / {cpu_perf['areaUnderRoc']:.6f}; "
        f"walls card {walls['card']:.3f} s, CPU {walls['cpu']:.3f} s; "
        f"train -dry and probe refusal checked; poisson at "
        f"{POISSON_RATES} x {POISSON_ROWS} rows bit-equal card/CPU in "
        f"{poisson_s:.2f} s; launches {launches} — [{gpu}]")
    return {"launches": launches, "kept": keep, "walls_s": walls,
            "poisson_s": poisson_s}


# ------------------------------------------- phase: the offline telemetry
TELEMETRY_TREES = 3
TELEMETRY_STEPS = ("INIT", "STATS", "NORMALIZE", "TRAIN", "EVAL")
HAND_KERNEL_NAMES = {"stats": "stats_hist_kernel",
                     "train": "hist_accum_kernel",
                     "eval": "forest_walk_kernel"}
#: each profiled step's cost-record name and the CUDA kernels one launch
#: of its hand kernel runs (the wrappers' torch ops, such as B3's ``amax``,
#: left out, so a device-time rate is if anything overstated)
HAND_KERNEL_RUNS = {
    "stats": ("stats.stats_hist", r"\bstats_hist(_finalize)?_kernel\b"),
    "train": ("pallas.hist",
              r"\b(partition|scan|hist_accum|finalize)_kernel\b"),
    "eval": ("pallas.tree_traverse",
             r"\b(forest_walk|tree_traverse)_kernel\b")}


def telemetry_phase(torch, root: str, csv: str, plan, gpu: str) -> dict:
    """The offline steps' telemetry on the card: ``new → init → stats →
    norm → train (GBT) → eval -run`` on the stats CSV through ``cli.main``
    with ``--telemetry --profile DIR``, then ``analysis --telemetry``,
    ``--utilization`` and ``--timeline`` and ``monitor --once --json``.
    Checks: every step's span tree (root, ``setup``, ``process``) is in
    the trace and ``drift.json`` exists; the cost records' launches of
    ``pallas.hist``, ``stats.stats_hist`` and ``pallas.tree_traverse``
    equal the kernels' counts over the same run (zeroed just before it,
    read just after); the utilization rows of those planes report bytes/s
    under 105% of the H100 row's peak; each step's ``torch.profiler``
    Chrome trace names its hand kernel; and each step's modelled bytes
    over its hand kernel's own device time in that trace stay under 105%
    of the peak too (the utilization rows divide by the step's wall, most
    of it host work, so only this rate could catch a model that charges
    more than the kernel can move)."""
    import contextlib
    import io
    import re
    from shifu_tpu_torch import cli, obs
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.obs.costs import resolve_peaks
    from shifu_tpu_torch.ops import stats_hist as sh
    base = os.path.join(root, "telemetry")
    os.makedirs(base)
    if cli.main(["--dir", base, "new", "tel"]) != 0:
        fail("new exited non-zero")
    d = os.path.join(base, "tel")
    prof = os.path.join(base, "profile")
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    for ds in (mc.dataSet, mc.evals[0].dataSet):
        ds.dataPath, ds.dataDelimiter = csv, "|"
        ds.headerPath, ds.headerDelimiter = csv + ".header", "|"
    ds = mc.dataSet
    ds.targetColumnName, ds.weightColumnName = "tag", "weight"
    ds.posTags, ds.negTags = ["bad"], ["good"]
    mc.stats.maxNumBin = N_BINS - 1
    mc.train.algorithm = "GBT"
    mc.train.params = {"TreeNum": TELEMETRY_TREES, "MaxDepth": DEPTH,
                       "Loss": "log", "LearningRate": 0.1}
    mc.save(path)
    flags = ["--telemetry", "--profile", prof]
    zero_tree_counts()
    sh.stats_histograms_cuda.launches = 0
    t0 = time.perf_counter()
    try:
        for argv in (["init"], ["stats", "--device", "cuda"], ["norm"],
                     ["train", "--device", "cuda"],
                     ["eval", "-run", "--device", "cuda"]):
            if cli.main(["--dir", d, INLINE_PARSE, *argv, *flags]) != 0:
                fail(f"{argv[0]} --telemetry exited non-zero")
        launches = {**read_tree_counts(),
                    "stats_hist": sh.stats_histograms_cuda.launches}
        wall = time.perf_counter() - t0
        outs = {}
        for name, argv in (
                ("report", ["analysis", "--telemetry"]),
                ("utilization", ["analysis", "--telemetry",
                                 "--utilization"]),
                ("timeline", ["analysis", "--telemetry", "--timeline",
                              os.path.join(base, "timeline.json")]),
                ("monitor", ["monitor", "--once", "--json"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--dir", d, *argv])
            if rc != 0:
                fail(f"{' '.join(argv)} exited {rc}")
            outs[name] = buf.getvalue()
    finally:
        environment.reset_for_tests()
        obs.reset_for_tests()
    steps, costs, model_bytes = {}, {}, {}
    step = None
    with open(os.path.join(d, "telemetry", "trace.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "meta":
                step = rec["step"]
                steps[step] = set()
            elif rec["kind"] == "span":
                steps[step].add((rec["name"], rec["attrs"].get("kind")))
            elif rec["kind"] == "cost":
                costs[rec["name"]] = costs.get(rec["name"], 0) \
                    + rec["launches"]
                key = (step.lower(), rec["name"])
                model_bytes[key] = model_bytes.get(key, 0.0) \
                    + rec["bytes_accessed"] * rec["launches"]
    for s in TELEMETRY_STEPS:
        if not {(s, "step"), ("setup", "phase"),
                ("process", "phase")} <= steps.get(s, set()):
            fail(f"the trace holds no span tree for {s}: {steps.get(s)}")
    if not os.path.isfile(os.path.join(d, "telemetry", "drift.json")):
        fail("no telemetry/drift.json")
    want = {"pallas.hist": launches["hist"] + launches["hist_batch"],
            "stats.stats_hist": launches["stats_hist"],
            "pallas.tree_traverse": launches["tree_traverse"]}
    if costs != want or not all(want.values()):
        fail(f"cost-record launches {costs} != kernel counts {want}")
    peak_bw = resolve_peaks({"platform": "gpu",
                             "device_kind": torch.cuda.get_device_name(0)})[1]
    util = outs["utilization"].splitlines()
    if not any(ln.startswith("device: ") and "h100" in ln.lower()
               for ln in util):
        fail(f"the utilization report has no H100 peak row: {util[:3]}")
    rates = {}
    for ln in util:
        parts = ln.split()
        if len(parts) >= 5 and parts[0] in ("pallas", "stats"):
            rates.setdefault(parts[0], []).append(float(parts[4]))
    if set(rates) != {"pallas", "stats"} or \
            max(max(v) for v in rates.values()) >= 1.05 * peak_bw:
        fail(f"utilization bytes/s {rates} against a peak of {peak_bw}")
    seen, device_rates = {}, {}
    for step_dir, kernel in HAND_KERNEL_NAMES.items():
        with open(os.path.join(prof, step_dir, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
        names = {e.get("name", "") for e in events}
        seen[step_dir] = sum(kernel in n for n in names)
        if not seen[step_dir]:
            fail(f"the {step_dir} profile names no {kernel}")
        plane, runs = HAND_KERNEL_RUNS[step_dir]
        device_us = sum(e.get("dur", 0) for e in events
                        if e.get("cat") == "kernel"
                        and re.search(runs, e.get("name", "")))
        nbytes = model_bytes.get((step_dir, plane), 0.0)
        if device_us <= 0 or nbytes <= 0:
            fail(f"the {step_dir} step: {nbytes} modelled bytes of {plane} "
                 f"over {device_us} us of its kernels' device time")
        device_rates[step_dir] = nbytes / (device_us * 1e-6)
        if device_rates[step_dir] >= 1.05 * peak_bw:
            fail(f"the {step_dir} step's {plane} model charges "
                 f"{nbytes:.0f} bytes in {device_us} us of device time: "
                 f"{device_rates[step_dir]:.3e} B/s against a peak of "
                 f"{peak_bw:.3e}")
    monitor = json.loads(outs["monitor"])
    if monitor.get("kind") != "monitor" or not monitor.get("procs"):
        fail(f"monitor --once --json gave {outs['monitor'][:200]}")
    with open(os.path.join(base, "timeline.json")) as f:
        n_events = len(json.load(f)["traceEvents"])
    log(f"telemetry: init → stats → norm → train → eval with --telemetry "
        f"--profile in {wall:.3f} s; cost launches {costs} = the kernels'; "
        f"peak bytes/s share "
        f"{max(max(v) for v in rates.values()) / peak_bw:.4f} of "
        f"{peak_bw:.3e}; profiles name {seen}; modelled bytes over the "
        f"kernels' device time "
        + ", ".join(f"{k} {v:.4e} B/s ({v / peak_bw:.4f} of peak)"
                    for k, v in device_rates.items())
        + f"; timeline {n_events} events;"
        f" monitor {len(monitor['procs'])} proc(s) — [{gpu}]")
    return {"launches": launches, "costs": costs, "wall_s": wall,
            "bytes_per_s": rates, "device_bytes_per_s": device_rates}


REFRESH_DRIFT_ROWS = 2048                  # the drifted window appended
REFRESH_SERVE_UNITS = 4                    # the in-process cycles' trees
REFRESH_BUCKETS = (1, 64, 512)             # the in-process server's rungs
REFRESH_GATE_TOL = 1e-6                    # gate AUCs, card vs CPU
REFRESH_PROBATION_TICKS = 3


def append_drifted_rows(csv: str, rng, plan, n: int) -> None:
    """``n`` fresh rows of the stats CSV's generator, every numeric column
    scaled 2x (``bench_refresh``'s drift), appended to ``csv``."""
    tmp = csv + ".drift"
    write_stats_csv(tmp, rng, plan, n)
    num = [j for j, p in enumerate(plan) if p[0] == "num"]
    with open(tmp) as src, open(csv, "a") as out:
        for line in src:
            cells = line.rstrip("\n").split("|")
            for j in num:
                if cells[j]:
                    cells[j] = f"{float(cells[j]) * 2.0:.6g}"
            out.write("|".join(cells) + "\n")
    os.remove(tmp)
    os.remove(tmp + ".header")


def window_rows(shard_rows, cursor: int) -> int:
    """The rows of the shard-aligned view from global row ``cursor``:
    ``Shards.from_row``'s rule (round down; past the end, the last
    shard), computed here on its own."""
    start = 0
    for r in shard_rows:
        if start + r > cursor:
            return sum(shard_rows) - start
        start += r
    return shard_rows[-1]


def refresh_phase(torch, root: str, src: str, csv: str, plan, rng,
                  gpu: str) -> dict:
    """The continual-refresh loop on the card, at the e2e set's full
    width, on a copy of it: a GBT incumbent (TRAIN_TREES trees of depth
    DEPTH, a checkpoint every TRAIN_CKPT) trained through ``cli.main``,
    REFRESH_DRIFT_ROWS drifted rows appended to a copy of the CSV and
    ``norm --telemetry`` run again (its ``drift.json`` the trigger);
    then (a) ``cli.main refresh`` on ``cuda`` once, in registry mode, with
    the data-window cursor where the incumbent's training stopped: the
    decisions ``trigger, train, promote, complete``, ``serving.json`` at
    generation 1, the warm retrain resumed from TRAIN_TREES trees with the
    derived units (TreeNum) appended on the first TRAIN_TREES bit for bit,
    exactly units x (DEPTH + 1) ``hist`` launches (counted from zero
    around the command) and ``tree_traverse`` launched for the restored
    forest's replay and the gate; generation 0 moved out of the
    ``<set>/models`` workspace into ``refresh/candidates/gen-0`` with the
    incumbent's trees, and a registry restarted from ``serving.json``
    rolling back to it there; the gate on the CPU over the card's
    candidate and that incumbent on the same holdout within
    REFRESH_GATE_TOL of the card's AUCs; (b) an in-process ``ServeServer`` on ``cuda`` (``sloP99Ms``
    1000, one client scoring throughout the swap) with a
    ``RefreshController(server=...)`` fed through ``observe`` with the
    drifted rows' bins: a ``refresh:promote`` fault after the retrain
    leaves the incumbent live and bit-identical; a fresh controller
    resumes at the gate with no ``hist`` launch and promotes, the swap
    capturing every rung at ``prepare`` and none at ``commit``, no SLO
    alert; the canary pinned at promotion scores bit for bit on every
    probation tick; an injected SLO alert rolls back to generation 0,
    scoring bit for bit as before."""
    from shifu_tpu_torch import cli, faults, obs
    from shifu_tpu_torch.config import ModelConfig, environment
    from shifu_tpu_torch.config.model_config import Algorithm
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.eval.gate import auc_gate, load_holdout
    from shifu_tpu_torch.eval.scorer import load_models
    from shifu_tpu_torch.models.tree import load_model
    from shifu_tpu_torch.refresh import (RefreshConfig, RefreshController,
                                         RefreshJournal, drift_columns_for)
    from shifu_tpu_torch.serve import ServeServer
    from shifu_tpu_torch.serve.registry import ModelRegistry
    from shifu_tpu_torch.serve.scorer import serve_graph_counts
    t_phase = time.perf_counter()
    base = os.path.join(root, "refresh")
    os.makedirs(base)
    data = os.path.join(base, "data.csv")
    shutil.copy(csv, data)
    shutil.copy(csv + ".header", data + ".header")
    d = os.path.join(base, "card")
    shutil.copytree(src, d, ignore=shutil.ignore_patterns(
        "models", "checkpoints", "refresh", "serving", "telemetry"))
    path = os.path.join(d, "ModelConfig.json")
    mc = ModelConfig.load(path)
    mc.dataSet.dataPath = data
    mc.dataSet.headerPath = data + ".header"
    mc.train.algorithm = Algorithm.GBT
    mc.train.params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH,
                       "Loss": "log", "LearningRate": 0.1,
                       "CheckpointInterval": TRAIN_CKPT}
    mc.save(path)
    walls = {"incumbent_train": train_cli(d, "cuda")}
    _, incumbent = load_forest(d)
    t0 = time.perf_counter()
    append_drifted_rows(data, rng, plan, REFRESH_DRIFT_ROWS)
    try:
        cli_ok(d, "norm", "--telemetry")
    finally:
        obs.set_enabled(None)
    walls["append_norm"] = time.perf_counter() - t0
    with open(os.path.join(d, "telemetry", "drift.json")) as f:
        drift = json.load(f)
    clean = Shards.open(os.path.join(d, "tmp", "CleanedData"))
    total = clean.num_rows
    if total != CSV_ROWS + REFRESH_DRIFT_ROWS:
        fail(f"re-normed plane holds {total} rows, not "
             f"{CSV_ROWS + REFRESH_DRIFT_ROWS}")
    if not drift.get("psi_max") or drift["psi_max"] < 0.25:
        fail(f"the drifted plane's PSI {drift.get('psi_max')} does not "
             "breach 0.25")
    served_dir = os.path.join(base, "served")
    shutil.copytree(d, served_dir)
    for where in (d, served_dir):           # the incumbent read CSV_ROWS
        RefreshJournal(where).set_cursor(CSV_ROWS)

    # (a) the CLI step, registry mode
    zero_tree_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-Dshifu.refresh.probationS=0.5", "--dir", d,
                   "refresh", "--poll", "0.1", "--device", "cuda"])
    walls["refresh_cli"] = time.perf_counter() - t0
    launches = read_tree_counts()
    if rc != 0:
        fail(f"refresh exited {rc}")
    decisions = RefreshJournal(d).decisions()
    kinds = [r["kind"] for r in decisions]
    if kinds != ["trigger", "train", "promote", "complete"]:
        fail(f"refresh decided {kinds}")
    train = decisions[1]
    units = TRAIN_TREES                     # derived: the set's TreeNum
    view = clean.from_row(CSV_ROWS).num_rows
    if not train["warm"] or train["resumed_from"] != TRAIN_TREES or \
            train["units"] != units or train["cursor_rows"] != CSV_ROWS \
            or train["new_rows"] != total - CSV_ROWS or \
            view != window_rows(clean.shard_rows, CSV_ROWS):
        fail(f"the warm retrain recorded {train} (a view of {view} rows)")
    with open(os.path.join(d, "serving", "serving.json")) as f:
        serving = json.load(f)[os.path.basename(d)]
    # generation 0 left the <set>/models workspace before the retrain
    gen0 = RefreshJournal(d).candidate_dir(0)
    if serving["generation"] != 1 or \
            serving["models_dir"] != train["models_dir"] or \
            [(h["generation"], h["models_dir"])
             for h in serving["history"]] != [(0, gen0)]:
        fail(f"serving.json holds {serving}, not generation 1 of "
             f"{train['models_dir']} over generation 0 in {gen0}")
    _, snap = load_model(os.path.join(gen0, "model0.gbt"))
    if len(snap) != TRAIN_TREES or \
            not all(same_bits(a, b) for a, b in zip(snap, incumbent)):
        fail(f"{gen0} does not hold the incumbent's {TRAIN_TREES} trees")
    _, cand = load_model(os.path.join(train["models_dir"], "model0.gbt"))
    if len(cand) != TRAIN_TREES + units or \
            not all(same_bits(a, b) for a, b in zip(cand, incumbent)):
        fail(f"the candidate's {len(cand)} trees do not start with the "
             f"incumbent's {TRAIN_TREES}")
    want = {"hist": units * (DEPTH + 1), "leaf_sums": units,
            "hist_batch": 0}
    if {k: launches[k] for k in want} != want or \
            launches["tree_traverse"] < 3:
        fail(f"refresh launched {launches}, not {want} and >= 3 "
             "tree_traverse (the replay, the gate's two forests)")
    gate_rec = decisions[2]["gate"]
    holdout = load_holdout(d)
    old = load_models(gen0)
    new = load_models(train["models_dir"])
    t0 = time.perf_counter()
    card = auc_gate(old, new, holdout, device="cuda")
    walls["gate"] = time.perf_counter() - t0
    cpu = auc_gate(old, new, holdout, device="cpu")
    gate_diff = max(abs(card.old_auc - cpu.old_auc),
                    abs(card.new_auc - cpu.new_auc))
    if gate_diff > REFRESH_GATE_TOL or not card.passed or \
            abs(card.old_auc - gate_rec["old_auc"]) > REFRESH_GATE_TOL or \
            abs(card.new_auc - gate_rec["new_auc"]) > REFRESH_GATE_TOL:
        fail(f"gate card {card.report()} vs CPU {cpu.report()} vs the "
             f"promote record's {gate_rec}")
    log(f"refresh CLI: {kinds}; warm retrain {train['train_s']:.3f} s "
        f"({launches['hist']} hist, {launches['tree_traverse']} "
        f"tree_traverse launches), {train['new_rows']} new rows; gate AUC "
        f"{card.old_auc:.6f} -> {card.new_auc:.6f} on {holdout.rows} rows "
        f"in {walls['gate']:.3f} s, card vs CPU {gate_diff:.3g} — [{gpu}]")
    # a restarted registry rolls back to the incumbent through the journal
    restarted = ModelRegistry(state_dir=os.path.join(d, "serving"),
                              device="cuda")
    restarted.restore(os.path.basename(d), os.path.join(d, "models"),
                      warm=False)
    restarted.rollback(os.path.basename(d), warm=False)
    if restarted.generation(os.path.basename(d)) != 0 or \
            restarted.models_dir(os.path.basename(d)) != gen0:
        fail("a restarted registry rolled back to "
             f"{restarted.models_dir(os.path.basename(d))}, not {gen0}")

    # (b) an in-process server and controller
    key = os.path.basename(served_dir)
    environment.set_property("shifu.serve.sloP99Ms", "1000")
    server = ServeServer(model_set_dir=served_dir, buckets=REFRESH_BUCKETS,
                         max_delay_ms=2.0, device="cuda")
    server.start()
    plane_bins = np.asarray(Shards.open(os.path.join(
        served_dir, "tmp", "CleanedData")).load_all()["bins"])
    probe = plane_bins[:64]

    def score():
        sc = server.registry.get(key)
        return server.score(np.zeros((len(probe), sc.n_features),
                                     np.float32),
                            probe[:, :sc.n_bins_cols]).tobytes()

    before = score()
    clock = [1000.0]
    injected = []
    cfg = RefreshConfig(psi_threshold=0.25, cooldown_s=0.0,
                        probation_s=60.0, units=REFRESH_SERVE_UNITS)

    def controller():
        return RefreshController(
            served_dir, server=server, config=cfg,
            clock=lambda: clock[0], sleep=lambda s: None,
            drift_columns=drift_columns_for(served_dir),
            slo_alerts_fn=lambda: injected + list(server.slo.alerts()))

    out = {"walls_s": walls, "cli_launches": launches,
           "gate": {"card": card.report(), "cpu": cpu.report(),
                    "diff": gate_diff}, "decisions": kinds,
           "psi_max": drift["psi_max"]}
    swap = {}
    reg = server.registry
    orig_prepare, orig_commit = reg.prepare, reg.commit

    def prepare(*a, **kw):
        c0 = serve_graph_counts()["captures"]
        t1 = time.perf_counter()
        gen = orig_prepare(*a, **kw)
        swap["prepare_s"] = time.perf_counter() - t1
        swap["prepare_captures"] = serve_graph_counts()["captures"] - c0
        return gen

    def commit(*a, **kw):
        c0 = serve_graph_counts()["captures"]
        got = orig_commit(*a, **kw)
        swap["commit_captures"] = serve_graph_counts()["captures"] - c0
        return got

    reg.prepare, reg.commit = prepare, commit
    try:
        ctrl = controller()
        for s in range(CSV_ROWS, total, 512):
            ctrl.observe(plane_bins[s:s + 512])
        out["observed_psi_max"] = ctrl._drift.summary()["psi_max"]
        environment.set_property("shifu.faults",
                                 f"refresh:promote={key}:ioerror")
        faults.reset_for_tests()
        zero_tree_counts()
        t0 = time.perf_counter()
        try:
            ctrl.tick()
            fail("the refresh:promote fault did not fire")
        except faults.InjectedFault:
            pass
        finally:
            environment.set_property("shifu.faults", "")
            faults.reset_for_tests()
        walls["served_retrain"] = time.perf_counter() - t0
        retrain = read_tree_counts()
        if reg.generation(key) != 0 or score() != before or \
                ctrl.journal.stage != "trained" or \
                retrain["hist"] != REFRESH_SERVE_UNITS * (DEPTH + 1):
            fail(f"after the promote fault: generation "
                 f"{reg.generation(key)}, stage {ctrl.journal.stage}, "
                 f"launches {retrain}")
        ctrl2 = controller()
        stop = threading.Event()
        answered = [0]

        def client():
            while not stop.is_set():
                score()
                answered[0] += 1

        load = threading.Thread(target=client, daemon=True)
        load.start()
        zero_tree_counts()
        t0 = time.perf_counter()
        try:
            rec = ctrl2.tick()
        finally:
            stop.set()
            load.join()
        walls["resume_promote"] = time.perf_counter() - t0
        resumed = read_tree_counts()
        alerts = list(server.slo.alerts())
        forced = serve_graph_counts()["captures_forced"]
        if rec is None or rec["kind"] != "promote" or \
                reg.generation(key) != 1 or resumed["hist"] != 0 or \
                swap.get("prepare_captures", 0) < 1 or \
                swap.get("commit_captures") != 0 or alerts or forced:
            fail(f"the resumed controller decided {rec}, generation "
                 f"{reg.generation(key)}, launches {resumed}, swap "
                 f"{swap}, alerts {alerts}, forced captures {forced}")
        promoted = score()
        can = ctrl2._canary
        if can is None or promoted == before:
            fail("no canary pinned, or the promotion scores as before")
        for _ in range(REFRESH_PROBATION_TICKS):
            clock[0] += 1.0
            sc = reg.get(key)
            got = np.asarray(sc.score_batch(
                can["x"], can["bins"] if sc.needs_bins else None))
            if got.tobytes() != can["expected"].tobytes() or \
                    ctrl2.tick() is not None:
                fail("the canary scored otherwise in probation")
        injected.append({"severity": "page", "budget": "latency"})
        rec = ctrl2.tick()
        if rec is None or rec["kind"] != "rollback" or \
                reg.generation(key) != 0 or score() != before:
            fail(f"the injected SLO alert decided {rec}, generation "
                 f"{reg.generation(key)}")
    finally:
        reg.prepare, reg.commit = orig_prepare, orig_commit
        server.stop()
        environment.reset_for_tests()
    out.update(swap=swap, retrain_launches=retrain,
               resume_launches=resumed, answered=answered[0],
               canary_rows=len(can["x"]))
    walls["phase"] = time.perf_counter() - t_phase
    log(f"refresh in process: promote fault survived, resumed with "
        f"{resumed['hist']} hist launches, swap prepare "
        f"{swap['prepare_s']:.3f} s ({swap['prepare_captures']} captures, "
        f"{swap['commit_captures']} at commit), {answered[0]} requests "
        f"answered across it, canary of {len(can['x'])} rows bit-equal on "
        f"{REFRESH_PROBATION_TICKS} ticks, rollback bit-identical; phase "
        f"{walls['phase']:.3f} s ({ {k: round(v, 3) for k, v in walls.items()} }) — [{gpu}]")
    return out


# ------------------------------------------------------ phase: the mesh
MESH_RANKS = 2                          # share the one card over gloo
MESH_RF_ROWS, MESH_RF_TREES = 1 << 18, 8
MESH_NN_ROWS, MESH_NN_EPOCHS, MESH_NN_BAGS = 1 << 16, 5, 2
MESH_TIMED_NODES = (1, 32)              # GBT levels 0 and 6 (left children)
MESH_TIMED_REPEATS = 3                  # all_reduces timed a sharded build
# the out-of-core mesh: the train plane's first 524,288 rows in 4 windows
# of 131,072, 2 resident under the device budget and 2 on the disk tail
MESH_STREAM_ROWS, MESH_STREAM_WINDOW = 1 << 19, 1 << 17
MESH_SGBT = {"TreeNum": 3, "MaxDepth": DEPTH, "Loss": "log",
             "LearningRate": 0.1}
MESH_STREAM_PROPS = {
    "shifu.train.streaming": "on",
    "shifu.train.windowRows": str(MESH_STREAM_WINDOW),
    "shifu.train.deviceCacheBytes": str(2 * MESH_STREAM_WINDOW
                                        * (N_COLS + 12) + (1 << 20))}
MESH_SRF_TREES, MESH_SRF_BATCH = 4, 2   # the streamed RF: 2 super-batches
MESH_SRF_BUDGET = 2 * MESH_STREAM_WINDOW * (N_COLS + 8) + (1 << 20)
MESH_SNN_WINDOW, MESH_SNN_EPOCHS = 1 << 14, 2   # the NN plane's 4 windows
# WDL on the mesh: the train plane's first 65,536 rows at full width, 2
# bags on the ensemble axis (replicated tables, a member a rank, no rows
# split), 1 bag on the data axis of 2 with its tables row-sharded by
# ``auto`` past a lowered shardMinBytes and replicated (``shard=False``),
# and 1 bag streamed in windows of 16,384; SE over the NN plane in mask
# batches of 32
MESH_WDL_ROWS, MESH_WDL_BAGS, MESH_WDL_EPOCHS = 1 << 16, 2, 3
MESH_WDL_BATCH, MESH_WDL_WINDOW = 1 << 14, 1 << 14
# params (the CPU tests hold 1e-5 on 64 rows).  The 2-bag mesh run must be
# bit-equal, member by member, to each member trained alone on one rank
# (a stack of 1); its gap to one rank's 2-bag run is then one rank's own
# gap between a stack of 2 and of 1 (the batched GEMMs over another shape
# sum in another order; 1.2e-4 on an H100, its valid errors bit-equal).
# The data-axis runs reassociate each batch's sums over the ranks (1.2e-4
# on the phases run's data, 2.6e-6 on a whole run's).  Both reach the
# params through Adam, which divides each gradient by its own size, so a
# weight whose gradient is a near-cancelling sum (an uninformative
# column's) takes that sum's rounding into its step.  A quarter of one
# step (lr 0.002) bounds both gaps.
MESH_WDL_PARAM_ATOL, MESH_WDL_ERR_RTOL = 5e-4, 1e-4
MESH_SE_BATCH = 32
# Pearson cells in [-1, 1]: a near-zero cell is the difference of two
# float64 pair sums that nearly cancel at 262,144 rows, so its relative
# error is not bounded by the sums'; the cells are held absolutely
MESH_CORR_ATOL, MESH_SE_RTOL = 1e-10, 1e-6
# the elastic sync drill: 2 controllers of parallel/elastic_demo on the
# card, one killed at dcn:step=3 and relaunched, against a control run
ELASTIC_ARGS = ["--rows", "8192", "--features", str(N_COLS), "--epochs",
                "4", "--quorum-frac", "1.0", "--timeout-ms", "120000",
                "--device", "cuda"]
ELASTIC_KILL_STEP = 3


def mesh_rf_settings():
    """The mesh phase's RF: init -model's RF params at depth 7, 8 trees in
    one batch of B2."""
    from shifu_tpu_torch.config.model_config import (Algorithm,
                                                     ModelTrainConf)
    from shifu_tpu_torch.train.dt_trainer import settings_from_params
    tc = ModelTrainConf()
    tc.validSetRate = 0.2
    return settings_from_params(
        {"TreeNum": MESH_RF_TREES, "MaxDepth": DEPTH, "Impurity": "entropy",
         "Loss": "squared", "FeatureSubsetStrategy": "TWOTHIRDS",
         "TreeBatch": MESH_RF_TREES}, tc, Algorithm.RF)


def mesh_stats_chunk(torch):
    """One stats chunk on the card from a fixed seed: 262,144 x 224
    values (~7% missing), 30% positive targets, weights in [0.5, 2)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    x = torch.randn((RESIDENT_ROWS, N_NUM), generator=gen, device="cuda") \
        * torch.linspace(1.0, 100.0, N_NUM, device="cuda")
    valid = torch.rand((RESIDENT_ROWS, N_NUM), generator=gen,
                       device="cuda") > 0.07
    target = (torch.rand(RESIDENT_ROWS, generator=gen, device="cuda")
              < 0.3).float()
    weight = 0.5 + 1.5 * torch.rand(RESIDENT_ROWS, generator=gen,
                                    device="cuda")
    return [t.cpu().numpy() for t in (x, valid, target, weight)]


def mesh_accumulate(torch, mesh):
    """NumericAccumulator over the stats chunk (two chunks of it, fused
    sweep): (boundaries, aggs, fine cells, B3 launches)."""
    from shifu_tpu_torch.config.model_config import BinningMethod
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.ops.binning import NumericAccumulator
    x, valid, target, weight = mesh_stats_chunk(torch)
    acc = NumericAccumulator(n_cols=N_NUM, num_buckets=STATS_BUCKETS,
                             device="cuda", mesh=mesh)
    before = sh.stats_histograms_cuda.launches
    half = RESIDENT_ROWS // 2
    for s, e in ((0, half), (half, RESIDENT_ROWS)):
        acc.update_fused(x[s:e], valid[s:e], target[s:e], weight[s:e])
    acc.finalize_fused()
    cells = acc._hist_dev.cpu().numpy()
    bnd, aggs, _, _ = acc.finalize_sketch(BinningMethod.EqualPositive, 10)
    return bnd, aggs, cells, sh.stats_histograms_cuda.launches - before


def mesh_nn(torch, x, y, mesh):
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble)
    from shifu_tpu_torch.train.sampling import member_masks
    tw, vw = member_masks(len(y), MESH_NN_BAGS, valid_rate=0.2,
                          sample_rate=1.0, replacement=False, targets=y,
                          seed=0)
    spec = nn_model.NNModelSpec(input_dim=x.shape[1], hidden_nodes=[64],
                                activations=["tanh"], loss="log")
    res = train_ensemble(x, y, tw, vw, spec, TrainSettings(
        optimizer="ADAM", learning_rate=0.01, epochs=MESH_NN_EPOCHS, seed=0),
        device="cuda", mesh=mesh)
    return res.valid_errors, [[{k: v.numpy() for k, v in layer.items()}
                               for layer in p] for p in res.params]


def mesh_stream_rf(torch, plane_dir: str, mesh):
    """The streamed RF over the mesh's stream plane (MESH_SRF_TREES depth-7
    trees in super-batches of MESH_SRF_BATCH, so the second starts on the
    first's last sweep and carries its out-of-bag sums; 2 of 4 windows
    resident): (forest, (disk passes, tail sweeps, bytes read),
    history)."""
    import dataclasses
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.train.dt_trainer import train_rf_streamed
    s = dataclasses.replace(mesh_rf_settings(), n_trees=MESH_SRF_TREES,
                            tail_tree_batch=MESH_SRF_BATCH)
    res = train_rf_streamed(
        ShardStream(Shards.open(plane_dir), ("bins", "y", "w"),
                    MESH_STREAM_WINDOW), N_BINS, None, s,
        cache_budget=MESH_SRF_BUDGET, device="cuda", mesh=mesh)
    return ([(t.split_feat, t.left_mask, t.leaf_value) for t in res.trees],
            (res.disk_passes, res.tail_sweeps, res.bytes_read), res.history)


def mesh_stream_nn(torch, nn_dir: str, mesh):
    """The streamed NN over the mesh's NN plane (65,536 x 256 in windows
    of 16,384, full batch): (valid errors, history)."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import (ShardStream,
                                                mask_fn_from_settings)
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.train.nn_trainer import (TrainSettings,
                                                  train_ensemble_streamed)
    res = train_ensemble_streamed(
        ShardStream(Shards.open(nn_dir), ("x", "y", "w"), MESH_SNN_WINDOW),
        nn_model.NNModelSpec(input_dim=N_COLS, hidden_nodes=[64],
                             activations=["tanh"], loss="log"),
        TrainSettings(optimizer="ADAM", learning_rate=0.01,
                      epochs=MESH_SNN_EPOCHS, seed=0), 1,
        mask_fn_from_settings(1, valid_rate=0.2, seed=0), device="cuda",
        mesh=mesh)
    return res.valid_errors, res.history


def mesh_wdl_spec(cards):
    """The reference's WDL defaults (EmbedColumnNum 8, [64, 32] relu, wide
    and deep) over the plane's 224 numeric and 32 categorical columns."""
    from shifu_tpu_torch.models.wdl import WDLModelSpec
    return WDLModelSpec(numeric_dim=N_NUM,
                        cat_cardinalities=[int(c) for c in cards])


def wdl_settings(epochs: int, batch: int):
    from shifu_tpu_torch.train.nn_trainer import TrainSettings
    return TrainSettings(optimizer="ADAM", learning_rate=0.002, l2=1e-5,
                         epochs=epochs, batch_size=batch, seed=0)


def wdl_leaves(spec, res):
    """(valid errors, every member's arrays in the model file's order)."""
    from shifu_tpu_torch.models.wdl import columns_of
    from shifu_tpu_torch.train.checkpoint import tree_leaves
    return res.valid_errors, [[np.asarray(a) for a in tree_leaves(
        columns_of(spec, p))] for p in res.params]


def mesh_wdl(torch, job: dict, mesh_of) -> dict:
    """The resident WDL scenarios on ``mesh_of(bags)``: 2 bags, full batch
    (replicated tables; on 2 ranks the ensemble axis, a member a rank, no
    rows split), and 1 bag in batches of MESH_WDL_BATCH on the data axis
    (2 ranks: each batch's rows split), its tables row-sharded by
    ``auto`` and replicated (``shard=False``: the table gradients in the
    flat all_reduce).  On one rank (``mesh_of`` gives None) the two 1-bag
    runs are one computation, run once."""
    from shifu_tpu_torch.train.wdl_shard import shard_enabled
    from shifu_tpu_torch.train.wdl_trainer import train_wdl_ensemble
    z = np.load(job["wdl"])
    spec = mesh_wdl_spec(z["cards"])
    on_mesh = mesh_of(1) is not None
    out = {"sharded": shard_enabled(spec, mesh_of(1))}
    runs = [("replicated", MESH_WDL_BAGS, 0, None),
            ("sharded_run", 1, MESH_WDL_BATCH, None)]
    if on_mesh:
        runs.append(("replicated_data", 1, MESH_WDL_BATCH, False))
    for name, bags, bs, shard in runs:
        out[name] = wdl_leaves(spec, train_wdl_ensemble(
            z["x_num"], z["x_cat"], z["y"], z["w"], spec,
            wdl_settings(MESH_WDL_EPOCHS, bs), bags=bags, device="cuda",
            shard=shard, mesh=mesh_of(bags)))
    if not on_mesh:
        out["replicated_data"] = out["sharded_run"]
    return out


def mesh_wdl_members_alone(torch, job: dict) -> list:
    """Each member of the 2-bag run trained alone on one rank, a stack of
    1 (its init and its masks sliced from the 2-bag run's): what a rank
    of the ensemble axis computes, with no collective.  Bit-equal to the
    mesh's members, it puts the mesh's gap to the 2-bag one-rank run on
    the member stack's shape (batched GEMMs over B = 2 against B = 1)."""
    from shifu_tpu_torch.train import wdl_trainer as PT
    from shifu_tpu_torch.train.optimizers import tree_map
    z = np.load(job["wdl"])
    spec = mesh_wdl_spec(z["cards"])
    init, masks = PT._init_stack, PT.member_masks
    out = []
    for i in range(MESH_WDL_BAGS):
        def one_init(spec, settings, bags, dev, i=i):
            key, opt, precision, stacked, state = init(
                spec, settings, MESH_WDL_BAGS, dev)
            take = lambda t: t[i:i + 1].clone()        # noqa: E731
            return (key, opt, precision, tree_map(take, stacked),
                    tree_map(take, state))

        def one_masks(n, bags, i=i, **kw):
            return tuple(m[i:i + 1] for m in masks(n, MESH_WDL_BAGS, **kw))
        PT._init_stack, PT.member_masks = one_init, one_masks
        try:
            va, params = wdl_leaves(spec, PT.train_wdl_ensemble(
                z["x_num"], z["x_cat"], z["y"], z["w"], spec,
                wdl_settings(MESH_WDL_EPOCHS, 0), bags=1, device="cuda"))
        finally:
            PT._init_stack, PT.member_masks = init, masks
        out.append((va[0], params[0]))
    return out


def mesh_wdl_streamed(torch, job: dict, mesh):
    """The streamed WDL (1 bag, full batch, 2 epochs) over the WDL
    planes in windows of MESH_WDL_WINDOW, each window's rows split."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import mask_fn_from_settings
    from shifu_tpu_torch.train.wdl_trainer import (ZippedPlanes,
                                                   train_wdl_streamed)
    z = np.load(job["wdl"])
    spec = mesh_wdl_spec(z["cards"])
    planes = ZippedPlanes(Shards.open(job["wdl_norm"]),
                          Shards.open(job["wdl_clean"]), MESH_WDL_WINDOW,
                          remainder_multiple=1)
    return wdl_leaves(spec, train_wdl_streamed(
        planes, spec, wdl_settings(2, 0), 1,
        mask_fn_from_settings(1, valid_rate=0.2, seed=0), z["num_idx"],
        z["cat_idx"], device="cuda", mesh=mesh))


def mesh_correlation(torch, mesh) -> np.ndarray:
    """``stats -correlation``'s accumulator over the stats chunk (two
    halves; each rank its block of each): the [224, 224] Pearson
    matrix."""
    from shifu_tpu_torch.ops.correlation import CorrelationAccumulator
    x, valid, _, _ = mesh_stats_chunk(torch)
    with np.errstate(invalid="ignore"):
        off = np.nanmean(np.where(valid, x, np.nan), axis=0)
    acc = CorrelationAccumulator(n_cols=N_NUM, offset=np.nan_to_num(off),
                                 device="cuda", mesh=mesh)
    half = RESIDENT_ROWS // 2
    for s, e in ((0, half), (half, RESIDENT_ROWS)):
        acc.update(np.where(valid[s:e], x[s:e], 0.0), valid[s:e])
    return acc.finalize()


def mesh_sensitivity(torch, nn_dir: str, mesh):
    """SE over the NN plane (windows of MESH_SNN_WINDOW) for a seeded
    256 -> [64] tanh net, one candidate a column: (frozen MSEs, base
    MSE)."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.models import nn as nn_model
    from shifu_tpu_torch.ops import prng
    from shifu_tpu_torch.ops import sensitivity as sens
    spec = nn_model.NNModelSpec(input_dim=N_COLS, hidden_nodes=[64],
                                activations=["tanh"], loss="log")
    params = [{k: v.numpy() for k, v in layer.items()}
              for layer in nn_model.init_params(prng.prng_key(6), spec)]
    mse, base, _ = sens.streamed_sensitivity(
        ShardStream(Shards.open(nn_dir), ("x", "y"), MESH_SNN_WINDOW), spec,
        params, sens.mask_matrix(N_COLS, [[i] for i in range(N_COLS)]),
        mask_batch=MESH_SE_BATCH, device="cuda", mesh=mesh)
    return mse, base


def mesh_window_checks(torch, plane_dir: str, mesh, tree) -> dict:
    """The window loop's sharded launches held to their plain versions on
    the card, on the stream plane's first window: this rank's block
    through ``ops.tree.build_histograms`` (B1, the exact schedule's level
    6 left children along ``tree``), ``build_path_histograms`` (B2 at TB =
    depth, the c2f tail pass, and its leaf sums) and
    ``build_histograms_batch`` (B2 at the streamed RF's super-batch, TB =
    MESH_SRF_BATCH and K = 32, bag-weighted stats from a fixed seed), each
    bit-equal to the fixed-point plain version over the whole window
    (``hist.build_histograms_fixed_ref``)."""
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.data.streaming import ShardStream
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops import tree as T
    from shifu_tpu_torch.train.dt_trainer import _gbt_stats
    win = next(ShardStream(Shards.open(plane_dir), ("bins", "y", "w"),
                           MESH_STREAM_WINDOW).windows())
    bins = torch.from_numpy(np.ascontiguousarray(win.arrays["bins"])).cuda()
    y = torch.from_numpy(np.asarray(win.arrays["y"], np.float32)).cuda()
    w = torch.from_numpy(np.asarray(win.arrays["w"], np.float32)).cuda()
    stats = _gbt_stats(y, w, torch.zeros_like(y), "log")
    sf = torch.from_numpy(tree[0]).cuda()
    lm = torch.from_numpy(tree[1]).cuda()
    b0, b1 = mesh.row_block(bins.shape[0])
    blk = (bins[b0:b1].contiguous(), stats[b0:b1].contiguous())
    out = {}
    node = T._left_child_index(T.node_index_at_level(sf, lm, bins, DEPTH - 1))
    got = T.build_histograms(blk[0], node[b0:b1].contiguous(), blk[1], 32,
                             N_BINS, mesh)
    if not torch.equal(got, hist.build_histograms_fixed_ref(
            bins, node, stats, 32, N_BINS)):
        fail("mesh: a sharded window level (B1, K = 32) differs from the "
             "fixed-point plain version over the whole window")
    out["b1_level"] = list(got.shape)
    half = 1 << (DEPTH - 1)
    hl, raw = T.build_path_histograms(blk[0], blk[1], sf, lm, DEPTH, N_BINS,
                                      mesh=mesh)
    idx = torch.zeros(bins.shape[0], dtype=torch.int32, device="cuda")
    want = [hist.build_histograms_fixed_ref(bins, idx, stats, half, N_BINS)]
    for level in range(1, DEPTH + 1):
        base, width = (1 << (level - 1)) - 1, 1 << (level - 1)
        idx = T._descend(bins, idx, sf[base:base + width],
                         lm[base:base + width])
        if level < DEPTH:
            want.append(hist.build_histograms_fixed_ref(
                bins, T._left_child_index(idx), stats, half, N_BINS))
    zero = torch.zeros((bins.shape[0], 1), dtype=torch.uint8, device="cuda")
    want_raw = hist.build_histograms_fixed_ref(
        zero, idx, stats, 1 << DEPTH, 1)[:, 0, 0].T
    if not torch.equal(hl, torch.stack(want)) or \
            not torch.equal(raw, want_raw):
        fail("mesh: the sharded path histograms (B2 at TB = depth) or their "
             "leaf sums differ from the fixed-point plain version over the "
             "whole window")
    out["b2_path"] = list(hl.shape)
    _, node_b, stats_b = batch_inputs(torch, np.random.default_rng(37),
                                      bins.shape[0], 1, 1, 32,
                                      MESH_SRF_BATCH)
    got = T.build_histograms_batch(blk[0], node_b[:, b0:b1].contiguous(),
                                   stats_b[:, b0:b1].contiguous(), 32,
                                   N_BINS, mesh)
    want = torch.stack([hist.build_histograms_fixed_ref(
        bins, node_b[t], stats_b[t], 32, N_BINS)
        for t in range(MESH_SRF_BATCH)])
    if not torch.equal(got, want):
        fail(f"mesh: the sharded RF super-batch (B2 at TB = {MESH_SRF_BATCH},"
             " K = 32) differs from the fixed-point plain version over the "
             "whole window")
    out["b2_superbatch"] = list(got.shape)
    return out


def mesh_time_one(torch, mesh, launch, meta, flush, nbytes: int) -> dict:
    """One sharded build's parts on this rank: ``launch()`` (the kernel's
    raw mode) and ``flush(cells)`` timed with CUDA events, ``meta()`` (the
    meta all_reduce) and the cells' all_reduce with the host clock around
    a synchronised call (gloo blocks the host), the median of
    MESH_TIMED_REPEATS."""
    from shifu_tpu_torch.parallel import mesh as meshlib
    cells = launch()
    out = {"kernel_ms": device_ms(torch, launch, launches=5, repeats=3),
           "flush_ms": device_ms(torch, lambda: flush(cells), launches=5,
                                 repeats=3)}
    walls = {"meta": [], "cells": []}
    for _ in range(MESH_TIMED_REPEATS):
        for part, fn in (("meta", meta), ("cells", lambda: meshlib.all_reduce(
                mesh, cells.clone()))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[part].append((time.perf_counter() - t0) * 1e3)
    out.update(meta_allreduce_ms=float(np.median(walls["meta"])),
               cells_allreduce_ms=float(np.median(walls["cells"])),
               allreduce_bytes=nbytes)
    return out


def mesh_time_parts(torch, mesh, bins) -> dict:
    """This rank's parts of one sharded build (:func:`mesh_time_one`) on
    its block of the plane: B1 at GBT levels 0 and 6, B2 at the mesh RF's
    deepest batched level (TB = 8, K = 32) on its half of the RF's rows,
    B3 on its half of a 262,144 x 224 x 4096 x 4 chunk; and at the window
    loop's shapes on its half of a 131,072-row window: the c2f tail's path
    histograms (B2, TB = 7, K = 64), the streamed RF's super-batch (B2,
    TB = MESH_SRF_BATCH, K = 32) and a window's leaf sums (B1, K = 128,
    one column of one bin)."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops import stats_hist as sh
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)

    def tree_stats(tb, n):
        w = torch.randint(1, 4, (tb, n), generator=gen,
                          device="cuda").float()
        return torch.stack([w, w * torch.randn((tb, n), generator=gen,
                                               device="cuda")], 2)

    def b12(tb, k, rows, b=None, n_bins=N_BINS):
        b = bins[:rows] if b is None else b
        node = torch.randint(0, k, (tb, rows), generator=gen,
                             device="cuda", dtype=torch.int32)
        stats = tree_stats(tb, rows)
        m = hist.global_channel_meta(stats, mesh)
        return mesh_time_one(
            torch, mesh,
            lambda: hist._launch(("node_idx_b", "stats_b"), b, node, stats,
                                 k, n_bins, meta=m),
            lambda: hist.global_channel_meta(stats, mesh),
            lambda c: hist._flush_cuda(c, m[0], m[2]),
            hist.sharded_bytes(tb, k, b.shape[1], n_bins, 2))
    out = {"hist": {k: b12(1, k, bins.shape[0]) for k in MESH_TIMED_NODES},
           "hist_batch": {32: b12(HIST_BATCH, 32, MESH_RF_ROWS // 2)},
           # out of core, on a rank's block of a 131,072-row window: the
           # c2f tail's path histograms (TB = depth, K = 64) and the
           # streamed RF's super-batch at its deepest level (K = 32)
           "path": b12(DEPTH, 1 << (DEPTH - 1), MESH_STREAM_WINDOW // 2),
           "superbatch": b12(MESH_SRF_BATCH, 32, MESH_STREAM_WINDOW // 2),
           # a window's depth-7 leaf sums: one all-zero column of one bin
           "leaf_sums": b12(1, 1 << DEPTH, MESH_STREAM_WINDOW // 2,
                            torch.zeros((MESH_STREAM_WINDOW // 2, 1),
                                        dtype=torch.uint8, device="cuda"),
                            1)}
    n = RESIDENT_ROWS // 2
    idx = torch.randint(0, STATS_BUCKETS, (n, N_NUM), generator=gen,
                        device="cuda", dtype=torch.int32)
    pos = (torch.rand(n, generator=gen, device="cuda") < 0.3).float()
    w = 0.5 + 2.5 * torch.rand(n, generator=gen, device="cuda")
    st = torch.stack([pos, 1 - pos, w * pos, w * (1 - pos)], 1)
    exact = (True, True, False, False)
    m = sh.global_stats_meta(st, mesh)
    out["stats_hist"] = mesh_time_one(
        torch, mesh,
        lambda: sh._launch(idx, st, STATS_BUCKETS, exact, meta=m),
        lambda: sh.global_stats_meta(st, mesh),
        lambda c: sh.flush_cuda(c, m[0], m[1], 2),
        8 * N_NUM * STATS_BUCKETS * 4)
    return out


def mesh_rank_main(torch, rank: str, mesh_dir: str) -> None:
    """A rank of the mesh phase (``--mesh-rank``): join the world from the
    ``SHIFU_*`` variables its parent set, run every scenario on its block
    and write what the parent compares to ``rank<r>.pkl``."""
    import pickle
    import torch.distributed as dist
    from shifu_tpu_torch.data.shards import Shards
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.parallel import mesh as meshlib
    from shifu_tpu_torch.train.dt_trainer import train_rf
    with open(os.path.join(mesh_dir, "job.json")) as f:
        job = json.load(f)
    if rank == "nccl":                  # a world of one over NCCL
        backend = meshlib.initialize_distributed()
        t = torch.tensor([(1 << 40) + 3, -7], dtype=torch.int64,
                         device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        with open(os.path.join(mesh_dir, "nccl.json"), "w") as f:
            json.dump({"backend": backend, "sum": t.cpu().tolist()}, f)
        dist.destroy_process_group()
        return
    r = int(rank)
    t0 = time.perf_counter()
    backend = meshlib.initialize_distributed()
    mesh = meshlib.device_mesh()
    res = {"backend": backend, "shape": mesh.shape, "launches": {},
           "allreduces": {}, "walls_s": {"join": time.perf_counter() - t0}}

    def walled(name, fn):
        """``fn()``, its wall in ``walls_s`` (no kernel counts)."""
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["walls_s"][name] = time.perf_counter() - t0
        return out

    def counted(name, fn):
        zero_tree_counts()
        sh.stats_histograms_cuda.launches = 0
        before = (hist.build_histograms_batch_sharded.allreduces,
                  sh.stats_histograms_sharded.allreduces)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res["walls_s"][name] = time.perf_counter() - t0
        res["launches"][name] = dict(
            read_tree_counts(), stats_hist=sh.stats_histograms_cuda.launches)
        res["allreduces"][name] = {
            "hist": hist.build_histograms_batch_sharded.allreduces
            - before[0],
            "stats_hist": sh.stats_histograms_sharded.allreduces - before[1]}
        return out

    d = job["gbt_dirs"][r]
    counted("gbt", lambda: train_cli(d, "cuda"))
    _, trees = load_forest(d)
    res["gbt"] = [(t.split_feat, t.left_mask, t.leaf_value) for t in trees]
    plane = walled("load", lambda: Shards.open(job["clean"]).load_all())
    r0, r1 = mesh.row_block(len(plane["y"]))
    block = torch.from_numpy(np.ascontiguousarray(
        plane["bins"][r0:r1])).cuda()
    res["timed"] = walled("timed", lambda: mesh_time_parts(torch, mesh,
                                                           block))
    del block
    rf = np.load(os.path.join(mesh_dir, "rf.npz"))
    res["rf"] = [(t.split_feat, t.left_mask, t.leaf_value) for t in counted(
        "rf", lambda: train_rf(rf["bins"], rf["y"], rf["w"], N_BINS, None,
                               mesh_rf_settings(), device="cuda",
                               mesh=mesh)).trees]
    res["stats"] = counted("stats", lambda: mesh_accumulate(torch, mesh))[:3]
    model = IndependentTreeModel.load(os.path.join(d, "models",
                                                   "model0.gbt"))
    res["scores"] = counted("score", lambda: Scorer(
        [model], device="cuda", mesh=mesh).score(None,
                                                 plane["bins"]).scores)
    del plane
    nn = np.load(os.path.join(mesh_dir, "nn.npz"))
    nn_mesh = meshlib.device_mesh(n_ensemble=MESH_NN_BAGS)
    res["nn_shape"] = nn_mesh.shape
    res["nn"] = counted("nn", lambda: mesh_nn(torch, nn["x"], nn["y"],
                                               nn_mesh))
    # out of core: each window's rows split over the ranks
    sd = job["sgbt_dirs"][r]
    res["sgbt_runs"] = counted("sgbt", lambda: stream_cli(
        sd, "cuda", MESH_STREAM_PROPS))[1]
    _, strees = load_forest(sd)
    res["sgbt"] = [(t.split_feat, t.left_mask, t.leaf_value)
                   for t in strees]
    res["srf"] = counted("srf", lambda: mesh_stream_rf(
        torch, job["stream_plane"], mesh))
    res["snn"] = counted("snn", lambda: mesh_stream_nn(
        torch, job["nn_plane"], mesh))
    res["window_checks"] = walled(
        "window_checks", lambda: mesh_window_checks(
            torch, job["stream_plane"], mesh, res["sgbt"][0]))
    # WDL on the mesh (``auto`` shards past a lowered threshold), then
    # stats -correlation's accumulator and SE
    from shifu_tpu_torch.config import environment
    environment.set_property("shifu.wdl.shardMinBytes", "1")
    res["wdl"] = walled("wdl", lambda: mesh_wdl(
        torch, job, lambda bags: meshlib.device_mesh(n_ensemble=bags)))
    res["swdl"] = walled("swdl", lambda: mesh_wdl_streamed(torch, job,
                                                           mesh))
    environment.set_property("shifu.wdl.shardMinBytes", "")
    res["corr"] = walled("corr", lambda: mesh_correlation(torch, mesh))
    res["se"] = walled("se", lambda: mesh_sensitivity(
        torch, job["nn_plane"], mesh))
    with open(os.path.join(mesh_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(torch, root: str, serve_root: str, plane, gbt_dir: str,
               gpu: str) -> dict:
    """stats -> train -> eval across ranks: MESH_RANKS rank processes of
    this script (``--mesh-rank``) share the card over gloo and run, each on
    its block of the rows, the CLI's GBT train (the train phase's set),
    an RF of 8 depth-7 trees, the stats accumulator, the Scorer's B4 walk
    and a 2-bag NN on the ensemble axis, then out of core (each window's
    rows split): the CLI's streamed c2f GBT, a streamed RF and a streamed
    NN, and the window loop's sharded launches held to their plain
    versions; a third process joins a world of one over NCCL, and the
    elastic sync drill's five controller processes run beside them
    (:class:`ElasticDrill`).  Meanwhile this process checks the int64 mode
    of B1, B2 and B3 against their fixed-point plain versions on the card
    and computes the one-rank results; then every rank's forests, cells,
    boundaries, counts and scores must equal one rank's bit for bit, the
    NN within the reference's tolerance.  Each step of this process is
    marked (``mesh_phase: ...``); each rank logs its own walls."""
    import pickle
    t_phase = time.perf_counter()
    steps = {}
    mark = marker(steps, t_phase, "mesh_phase: ")
    mdir = os.path.join(root, "mesh")
    os.makedirs(mdir)
    bins, y, w, _, is_cat, clean, _, names = plane
    # the elastic drill's controllers start first: they take longest
    drill = ElasticDrill(mdir)
    params = {"TreeNum": TRAIN_TREES, "MaxDepth": DEPTH, "Loss": "log",
              "LearningRate": 0.1, "CheckpointInterval": TRAIN_CKPT}
    dirs = [write_train_set(os.path.join(mdir, f"gbt{r}"), serve_root,
                            params, clean) for r in range(MESH_RANKS)]
    np.savez(os.path.join(mdir, "rf.npz"), bins=bins[:MESH_RF_ROWS],
             y=y[:MESH_RF_ROWS], w=w[:MESH_RF_ROWS])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    nn_x = torch.randn((MESH_NN_ROWS, N_COLS), generator=gen,
                       device="cuda")
    nn_y = (nn_x[:, :8].sum(1) + torch.randn(MESH_NN_ROWS, generator=gen,
                                             device="cuda") > 0).float()
    nn_x, nn_y = nn_x.cpu().numpy(), nn_y.cpu().numpy()
    np.savez(os.path.join(mdir, "nn.npz"), x=nn_x, y=nn_y)
    stream_plane_dir = os.path.join(mdir, "stream_plane")
    write_plane(stream_plane_dir, bins[:MESH_STREAM_ROWS],
                y[:MESH_STREAM_ROWS], w[:MESH_STREAM_ROWS], names,
                {"chip_smoke": "mesh_stream"})
    nn_plane = os.path.join(mdir, "nn_plane")
    write_norm_plane(nn_plane, nn_x, nn_y, np.ones(len(nn_y), np.float32),
                     names)
    sdirs = [write_train_set(os.path.join(mdir, f"sgbt{r}"), serve_root,
                             MESH_SGBT, stream_plane_dir)
             for r in list(range(MESH_RANKS)) + ["one"]]
    # the WDL planes: the train plane's first rows, numerics a function of
    # their bins (as wdl_phase's), categorical bins as ids
    wb = bins[:MESH_WDL_ROWS]
    wx = (wb.astype(np.float32) - 31.5) / 18.5
    num_idx, cat_idx = np.flatnonzero(~is_cat), np.flatnonzero(is_cat)
    job = {"gbt_dirs": dirs, "clean": clean, "sgbt_dirs": sdirs,
           "stream_plane": stream_plane_dir, "nn_plane": nn_plane,
           "wdl": os.path.join(mdir, "wdl.npz"),
           "wdl_norm": os.path.join(mdir, "wdl_norm"),
           "wdl_clean": os.path.join(mdir, "wdl_clean")}
    np.savez(job["wdl"], x_num=wx[:, num_idx],
             x_cat=wb[:, cat_idx].astype(np.int32), y=y[:MESH_WDL_ROWS],
             w=w[:MESH_WDL_ROWS], num_idx=num_idx, cat_idx=cat_idx,
             cards=wb[:, cat_idx].max(axis=0).astype(np.int64) + 1)
    write_norm_plane(job["wdl_norm"], wx, y[:MESH_WDL_ROWS],
                     w[:MESH_WDL_ROWS], names)
    write_plane(job["wdl_clean"], wb, y[:MESH_WDL_ROWS], w[:MESH_WDL_ROWS],
                names, {"chip_smoke": "mesh_wdl"})
    with open(os.path.join(mdir, "job.json"), "w") as f:
        json.dump(job, f)
    script = os.path.abspath(__file__)
    gloo_port, nccl_port = free_port(), free_port()
    procs = []
    for rank, world, port in [(str(r), MESH_RANKS, gloo_port)
                              for r in range(MESH_RANKS)] \
            + [("nccl", 1, nccl_port)]:
        env = dict(os.environ, SHIFU_COORDINATOR=f"127.0.0.1:{port}",
                   SHIFU_NUM_PROCESSES=str(world),
                   SHIFU_PROCESS_ID="0" if rank == "nccl" else rank)
        logf = open(os.path.join(mdir, f"rank{rank}.log"), "w")
        procs.append((rank, logf, subprocess.Popen(
            [sys.executable, script, "--mesh-rank", rank, "--mesh-dir", mdir],
            stdout=logf, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(script))))
    mark("planes and sets written, ranks and drill started")
    try:
        kernels = mesh_kernel_checks(torch)
        mark("int64 kernel checks")
        one = mesh_one_rank(torch, bins, y, w, nn_x, nn_y, gbt_dir)
        mark("one rank's resident results")
        one.update(mesh_one_rank_streamed(torch, sdirs[-1],
                                          stream_plane_dir, nn_plane))
        mark("one rank's streamed results")
        one.update(wdl=mesh_wdl(torch, job, lambda bags: None),
                   wdl_alone=mesh_wdl_members_alone(torch, job),
                   swdl=mesh_wdl_streamed(torch, job, None),
                   corr=mesh_correlation(torch, None),
                   se=mesh_sensitivity(torch, nn_plane, None))
        mark("one rank's WDL, correlation and SE")
        elastic = drill.finish()
        mark("elastic drill finished")
        for rank, logf, p in procs:
            try:
                rc = p.wait(timeout=MESH_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rc = "timeout"
            logf.close()
            if rc != 0:
                with open(logf.name) as f:
                    tail = f.read()[-3000:]
                fail(f"mesh rank {rank} exited {rc}:\n{tail}")
        mark("ranks finished")
    finally:
        drill.stop()
        for _, logf, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            logf.close()
    with open(os.path.join(mdir, "nccl.json")) as f:
        nccl = json.load(f)
    if nccl != {"backend": "nccl", "sum": [(1 << 40) + 3, -7]}:
        fail(f"the NCCL world of one gave {nccl}")
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(mdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    out = mesh_compare(ranks, one)
    out.update(kernels=kernels, nccl=nccl, elastic=elastic,
               wall_s=time.perf_counter() - t_phase, steps_s=steps)
    t = ranks[0]["timed"]
    parts = [(f"B1 K={k}", t["hist"][k]) for k in MESH_TIMED_NODES] + [
        ("B2 TB=8 K=32", t["hist_batch"][32]), ("B3", t["stats_hist"]),
        (f"B2 path TB={DEPTH} K={1 << (DEPTH - 1)}", t["path"]),
        (f"B2 super-batch TB={MESH_SRF_BATCH} K=32", t["superbatch"]),
        (f"B1 leaf sums K={1 << DEPTH}", t["leaf_sums"])]
    log(f"mesh: {MESH_RANKS} ranks over {ranks[0]['backend']} on one card, "
        f"phase {out['wall_s']:.1f} s; rank 0's sharded builds, ms (raw "
        f"launch / flush / meta all_reduce / cells all_reduce, bytes): "
        + "; ".join(f"{name} {p['kernel_ms']:.3f} / {p['flush_ms']:.3f} / "
                    f"{p['meta_allreduce_ms']:.3f} / "
                    f"{p['cells_allreduce_ms']:.3f}, {p['allreduce_bytes']}"
                    for name, p in parts)
        + f"; rank walls {[{k: round(v, 3) for k, v in g['walls_s'].items()}
                           for g in ranks]} — [{gpu}]")
    return out


MESH_TIMEOUT_S = 240


#: the relaunched controller: started with the others, it imports torch and
#: makes its CUDA context, then waits for the victim's death before it runs
#: the demo (so the drill does not wait for a second start-up)
STANDBY = """import os, sys, time, torch
torch.zeros(1, device=sys.argv[2])
while not os.path.exists(sys.argv[1]):
    time.sleep(0.02)
from shifu_tpu_torch.parallel.elastic_demo import main
sys.exit(main(sys.argv[3:]))
"""


class ElasticDrill:
    """The elastic sync drill on the card: an uninterrupted control job of
    2 controllers (``python -m shifu_tpu_torch.parallel.elastic_demo
    --device cuda``, world of one each) and a job whose controller 1 exits
    hard at ``dcn:step=3`` and is relaunched with the same ``--proc``: a
    standby process (:data:`STANDBY`) that a thread of this process
    releases as soon as the victim died.  Heartbeats every 300 s, so the
    dead controller stays in the live set and the sync step waits for its
    rejoin.  Every controller logs to a file of its own."""

    def __init__(self, mdir: str):
        self.root = os.path.join(mdir, "elastic")
        self.control = os.path.join(self.root, "control")
        self.job = os.path.join(self.root, "job")
        os.makedirs(self.root)
        self.t0 = time.perf_counter()
        self.released = os.path.join(self.root, "victim_died")
        self.procs = {}
        for name, out, proc, fault in (
                ("control0", self.control, 0, None),
                ("control1", self.control, 1, None),
                ("survivor", self.job, 0, None),
                ("victim", self.job, 1,
                 f"dcn:step={ELASTIC_KILL_STEP}:kill"),
                ("rejoiner", self.job, 1, None)):
            self.procs[name] = self._launch(name, out, proc, fault)
        self.thread = threading.Thread(target=self._release, daemon=True)
        self.thread.start()

    def _launch(self, name: str, out: str, proc: int, fault):
        env = dict(os.environ, SHIFU_TPU_HEARTBEAT_S="300")
        for k in ("SHIFU_COORDINATOR", "SHIFU_TPU_FAULTS"):
            env.pop(k, None)
        if fault:
            env["SHIFU_TPU_FAULTS"] = fault
        argv = ["--out", out, "--proc", str(proc), "--nproc", "2",
                *ELASTIC_ARGS]
        cmd = [sys.executable, "-c", STANDBY, self.released,
               ELASTIC_ARGS[ELASTIC_ARGS.index("--device") + 1], *argv] \
            if name == "rejoiner" else \
            [sys.executable, "-m", "shifu_tpu_torch.parallel.elastic_demo",
             *argv]
        logf = open(os.path.join(self.root, f"{name}.log"), "w")
        p = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT,
                             env=env,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        p.logf = logf
        return p

    def _release(self) -> None:
        self.procs["victim"].wait()
        self.victim_s = time.perf_counter() - self.t0
        with open(self.released, "w"):
            pass

    def finish(self) -> dict:
        """Wait for every controller and check the drill: the victim died
        at the injected step, the rejoiner replayed at least the committed
        steps before it, and both of the job's controllers hold the
        control's params bit for bit."""
        self.thread.join(timeout=MESH_TIMEOUT_S)
        for name in ("control0", "control1", "survivor", "victim",
                     "rejoiner"):
            p = self.procs[name]
            try:
                p.wait(timeout=MESH_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"elastic drill: {name} hung")
            p.logf.close()
            want = 137 if name == "victim" else 0
            if p.returncode != want:
                with open(p.logf.name) as f:
                    fail(f"elastic drill: {name} exited {p.returncode}, not "
                         f"{want}:\n{f.read()[-3000:]}")
        with open(self.procs["victim"].logf.name) as f:
            if "injected hard exit at dcn:step" not in f.read():
                fail("elastic drill: the victim did not die at dcn:step")

        def params(out, proc):
            with np.load(os.path.join(out, f"params-{proc}.npz")) as z:
                return {k: z[k] for k in z.files}

        def result(out, proc):
            with open(os.path.join(out, f"result-{proc}.json")) as f:
                return json.load(f)
        want = params(self.control, 0)
        for out, proc in ((self.control, 1), (self.job, 0), (self.job, 1)):
            got = params(out, proc)
            if got.keys() != want.keys() or any(
                    got[k].tobytes() != want[k].tobytes() for k in want):
                fail(f"elastic drill: controller {proc} of {out} differs "
                     "from the uninterrupted control")
        rj = result(self.job, 1)
        if not rj["dcn"]["rejoined"] or rj["dcn"]["incarnation"] != 2 or \
                rj["dcn"]["catchup_steps"] < ELASTIC_KILL_STEP:
            fail(f"elastic drill: the rejoiner's record {rj['dcn']}")
        out = {"wall_s": time.perf_counter() - self.t0,
               "victim_died_s": self.victim_s, "rejoiner": rj["dcn"],
               "survivor": result(self.job, 0)["dcn"],
               "control_train_s": result(self.control, 0)["train_s"],
               "auc": result(self.job, 0)["auc"],
               "device": result(self.job, 0)["device"]}
        log(f"elastic sync drill on the card: controller 1 killed at "
            f"dcn:step={ELASTIC_KILL_STEP} ({out['victim_died_s']:.1f} s "
            f"in), relaunched, caught up {rj['dcn']['catchup_steps']} steps "
            f"from the journal; both controllers bit-identical to the "
            f"uninterrupted control (AUC {out['auc']}); survivor waited "
            f"{out['survivor']['step_wait_s']:.3f} s in steps; drill "
            f"{out['wall_s']:.1f} s")
        return out

    def stop(self) -> None:
        for p in list(self.procs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()
            p.logf.close()


def mesh_one_rank_streamed(torch, sdir: str, plane_dir: str,
                           nn_plane: str) -> dict:
    """One rank's out-of-core results on the card, each run's launches
    counted from zero around it."""
    out = {"stream_launches": {}}
    zero_tree_counts()
    out["sgbt_runs"] = stream_cli(sdir, "cuda", MESH_STREAM_PROPS)[1]
    out["stream_launches"]["sgbt"] = read_tree_counts()
    _, trees = load_forest(sdir)
    out["sgbt"] = [(t.split_feat, t.left_mask, t.leaf_value) for t in trees]
    zero_tree_counts()
    out["srf"] = mesh_stream_rf(torch, plane_dir, None)
    out["stream_launches"]["srf"] = read_tree_counts()
    out["snn"] = mesh_stream_nn(torch, nn_plane, None)
    return out


def mesh_kernel_checks(torch) -> dict:
    """The int64 mode of B1, B2 and B3 on the card: each of two row
    blocks' cells at the scale of all the rows equals the fixed-point plain
    version's (run on the card), and the flush of their sum is bit-equal
    to one launch over all the rows."""
    from shifu_tpu_torch.ops import hist
    from shifu_tpu_torch.ops import stats_hist as sh
    from shifu_tpu_torch.parallel.mesh import Mesh, row_block
    rng = np.random.default_rng(31)
    out = {}
    for name, (n, k, tb) in (("hist", (1 << 18, 32, 1)),
                             ("hist_batch", (1 << 16, 32, HIST_BATCH))):
        bins, node_b, stats_b = batch_inputs(torch, rng, n, N_COLS, N_BINS,
                                             k, tb)
        one = hist.build_histograms_batch_cuda(bins, node_b, stats_b, k,
                                               N_BINS)
        meta = hist.global_channel_meta(stats_b, Mesh())
        total = None
        for r0, r1 in (row_block(n, 2, i) for i in range(2)):
            blk = (bins[r0:r1].contiguous(), node_b[:, r0:r1].contiguous(),
                   stats_b[:, r0:r1].contiguous())
            cells = hist._launch(("node_idx_b", "stats_b"), *blk, k, N_BINS,
                                 meta=meta)
            for t in range(tb):
                if not torch.equal(cells[t], hist.hist_fixed_cells(
                        blk[0], blk[1][t], blk[2][t], k, N_BINS,
                        meta[0][t], n)):
                    fail(f"{name}: int64 cells of tree {t} differ from "
                         "the fixed-point plain version")
            total = cells if total is None else total + cells
        if not torch.equal(hist._flush_cuda(total, meta[0], meta[2]), one):
            fail(f"{name}: the flush of the summed blocks is not one "
                 "launch's bits")
        out[name] = {"rows": n, "nodes": k, "trees": tb}
    idx, st, exact = stats_inputs(torch, rng, RESIDENT_ROWS, N_NUM,
                                  STATS_BUCKETS, 4)
    one = sh.stats_histograms_cuda(idx, st, STATS_BUCKETS, exact)
    amax = st.abs().amax(dim=0)
    n_scale = torch.tensor([RESIDENT_ROWS], dtype=torch.int64,
                           device="cuda")
    total = None
    for r0, r1 in (row_block(RESIDENT_ROWS, 2, i) for i in range(2)):
        cells = sh._launch(idx[r0:r1], st[r0:r1], STATS_BUCKETS, exact,
                           meta=(amax, n_scale))
        if not torch.equal(cells, sh.stats_fixed_cells(
                idx[r0:r1], st[r0:r1], STATS_BUCKETS, sum(exact), amax,
                RESIDENT_ROWS)):
            fail("stats_hist: int64 cells differ from the fixed-point "
                 "plain version")
        total = cells if total is None else total + cells
    if not torch.equal(sh.stats_histograms_sharded(
            idx, st, STATS_BUCKETS, Mesh(), exact), one) or \
            not torch.equal(sh.stats_flush_ref(total, amax, RESIDENT_ROWS,
                                               sum(exact)), one):
        fail("stats_hist: the flush of the summed blocks is not one "
             "launch's bits")
    out["stats_hist"] = {"rows": RESIDENT_ROWS, "cols": N_NUM}
    log(f"mesh kernels: int64 cells of two row blocks equal the fixed-point "
        f"plain versions and their flush one launch's bits: {out}")
    return out


def mesh_one_rank(torch, bins, y, w, nn_x, nn_y, gbt_dir: str) -> dict:
    """What one rank computes for the mesh phase's scenarios."""
    from shifu_tpu_torch.eval.scorer import Scorer
    from shifu_tpu_torch.models.tree import IndependentTreeModel
    from shifu_tpu_torch.train.dt_trainer import train_rf
    _, trees = load_forest(gbt_dir)
    rf = train_rf(bins[:MESH_RF_ROWS], y[:MESH_RF_ROWS], w[:MESH_RF_ROWS],
                  N_BINS, None, mesh_rf_settings(), device="cuda")
    model = IndependentTreeModel.load(os.path.join(gbt_dir, "models",
                                                   "model0.gbt"))
    return {"gbt": [(t.split_feat, t.left_mask, t.leaf_value)
                    for t in trees],
            "rf": [(t.split_feat, t.left_mask, t.leaf_value)
                   for t in rf.trees],
            "stats": mesh_accumulate(torch, None)[:3],
            "scores": Scorer([model], device="cuda").score(None,
                                                           bins).scores,
            "nn": mesh_nn(torch, nn_x, nn_y, None)}


def mesh_compare_wdl(ranks, one) -> dict:
    """Every rank's WDL runs within MESH_WDL_PARAM_ATOL (params) and
    MESH_WDL_ERR_RTOL (valid errors) of one rank's, the sharded one
    really sharded; the 2-bag run's members (a rank each, no rows split)
    bit-equal to each member trained alone on one rank; the correlation
    cells within MESH_CORR_ATOL and the SE sums within MESH_SE_RTOL of
    one rank's.  Every comparison is logged before any fails."""
    worst, failed = {}, []

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and \
            a.tobytes() == b.tobytes()
    # one rank's own gap between the 2-bag stack and its members alone
    stack = max(float(np.max(np.abs(a - b))) for (_, alone), member in zip(
        one["wdl_alone"], one["wdl"]["replicated"][1])
        for a, b in zip(alone, member))

    def close(what, got, want):
        (va, params), (va1, params1) = got, want
        err = float(np.max(np.abs(va - va1) / np.abs(va1)))
        diffs = [np.abs(a - b) for pg, pw in zip(params, params1)
                 for a, b in zip(pg, pw)]
        par = max(float(d.max()) for d in diffs)
        worst[what] = max(worst.get(what, (0.0, 0.0)), (err, par))
        if len(params) != len(params1) or not err <= MESH_WDL_ERR_RTOL \
                or not par <= MESH_WDL_PARAM_ATOL:
            failed.append(
                f"{what}: valid errors {err:.3g} relative, params {par:.3g}"
                f" ({sum(int((d > 1e-5).sum()) for d in diffs)} of "
                f"{sum(d.size for d in diffs)} past 1e-5)")
    for r, got in enumerate(ranks):
        if not got["wdl"]["sharded"]:
            failed.append(f"rank {r}: the 1-bag WDL was not row-sharded")
        for name in ("replicated", "sharded_run", "replicated_data"):
            close(f"WDL {name}", got["wdl"][name], one["wdl"][name])
        va, members = got["wdl"]["replicated"]
        for i, (va1, alone) in enumerate(one["wdl_alone"]):
            if not (va[i] == va1 and len(alone) == len(members[i]) and all(
                    same(a, b) for a, b in zip(members[i], alone))):
                failed.append(f"rank {r}: WDL member {i} of the 2-bag mesh "
                              f"run differs from it trained alone")
        close("streamed WDL", got["swdl"], one["swdl"])
        corr = float(np.nanmax(np.abs(got["corr"] - one["corr"])))
        se = max(float(np.max(np.abs(got["se"][0] - one["se"][0])
                              / np.abs(one["se"][0]))),
                 abs(got["se"][1] - one["se"][1]) / abs(one["se"][1]))
        worst["corr"] = max(worst.get("corr", 0.0), corr)
        worst["se"] = max(worst.get("se", 0.0), se)
        if not (np.isnan(got["corr"]) == np.isnan(one["corr"])).all() or \
                not corr <= MESH_CORR_ATOL or not se <= MESH_SE_RTOL:
            failed.append(f"rank {r}: correlation cells {corr:.3g} absolute, "
                          f"SE {se:.3g} relative from one rank's")
    walls = [{k: round(g["walls_s"][k], 3) for k in
              ("wdl", "swdl", "corr", "se")} for g in ranks]
    log(f"mesh WDL, correlation and SE: {MESH_RANKS} ranks against one "
        f"(WDL valid-error rel, params abs; correlation abs; SE rel): "
        f"{worst}; one rank's 2-bag stack against its members alone: "
        f"params {stack:.3g} abs; rank walls {walls}")
    if failed:
        fail("mesh: " + "; ".join(failed))
    return {"worst": worst, "stack_gap": stack, "walls_s": walls}


def mesh_compare(ranks, one) -> dict:
    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and \
            a.tobytes() == b.tobytes()

    def same_forest(a, b):
        return len(a) == len(b) and all(
            same(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb))
    out = {"launches": [], "allreduces": []}
    for r, got in enumerate(ranks):
        if got["backend"] != "gloo" or got["shape"] != {
                "ensemble": 1, "data": MESH_RANKS} or \
                got["nn_shape"] != {"ensemble": MESH_NN_BAGS, "data": 1}:
            fail(f"mesh rank {r}: backend {got['backend']}, meshes "
                 f"{got['shape']} / {got['nn_shape']}")
        for what in ("gbt", "rf"):
            if not same_forest(got[what], one[what]):
                fail(f"mesh rank {r}: the {what} forest differs from one "
                     "rank's")
        bnd, aggs, cells = got["stats"]
        if not same(cells, one["stats"][2]) or any(
                not same(a, b) for a, b in zip(bnd, one["stats"][0])) or any(
                not same(a[:-1], b[:-1]) or not same(a[-1, :2], b[-1, :2])
                for a, b in zip(aggs, one["stats"][1])):
            fail(f"mesh rank {r}: stats boundaries, counts or cells differ "
                 "from one rank's")
        if not same(got["scores"], one["scores"]):
            fail(f"mesh rank {r}: scores differ from one rank's")
        va, params = got["nn"]
        if not np.allclose(va, one["nn"][0], rtol=1e-4, atol=1e-6) or any(
                not np.allclose(lg[k], lw[k], rtol=1e-3, atol=1e-5)
                for pg, pw in zip(params, one["nn"][1])
                for lg, lw in zip(pg, pw) for k in ("w", "b")):
            fail(f"mesh rank {r}: NN beyond the reference's tolerance of "
                 "one rank's")
        ln, ar = got["launches"], got["allreduces"]
        want = {"gbt": ({"hist": TRAIN_TREES * (DEPTH + 1),
                         "leaf_sums": TRAIN_TREES},
                        {"hist": TRAIN_TREES * (DEPTH + 1)}),
                # 7 B2 levels, then each tree's leaf sums through B1
                "rf": ({"hist_batch": DEPTH, "hist": MESH_RF_TREES,
                        "leaf_sums": MESH_RF_TREES},
                       {"hist": DEPTH + MESH_RF_TREES}),
                "stats": ({"stats_hist": 2}, {"stats_hist": 2}),
                "score": ({"tree_traverse": 1}, {})}
        for part, (wl, wa) in want.items():
            if any(ln[part][k] != v for k, v in wl.items()) or \
                    any(ar[part][k] != v for k, v in wa.items()):
                fail(f"mesh rank {r} {part}: launches {ln[part]}, "
                     f"all_reduces {ar[part]}; want {wl} and {wa}")
        # out of core: the one-rank forests and pass schedule, each sharded
        # B1/B2 launch the one-rank run's and one all_reduce
        def passes(runs):
            return [(x["windows"], x["resident"], x["disk_passes"],
                     x["tail_sweeps"], x["bytes_read"]) for x in runs]
        if not same_forest(got["sgbt"], one["sgbt"]) or \
                passes(got["sgbt_runs"]) != passes(one["sgbt_runs"]):
            fail(f"mesh rank {r}: the streamed GBT ({passes(got['sgbt_runs'])}"
                 f") differs from one rank's ({passes(one['sgbt_runs'])})")
        if not same_forest(got["srf"][0], one["srf"][0]) or \
                got["srf"][1] != one["srf"][1]:
            fail(f"mesh rank {r}: the streamed RF ({got['srf'][1]}) differs "
                 f"from one rank's ({one['srf'][1]})")
        va, hist_nn = got["snn"]
        if not np.allclose(va, one["snn"][0], rtol=1e-4, atol=1e-6) or \
                not np.allclose(hist_nn, one["snn"][1], rtol=1e-4):
            fail(f"mesh rank {r}: the streamed NN {va} / {hist_nn} beyond "
                 f"1e-4 of one rank's {one['snn']}")
        for part in ("sgbt", "srf"):
            lw = one["stream_launches"][part]
            if any(ln[part][k] != lw[k] for k in ("hist", "leaf_sums",
                                                   "hist_batch")) or \
                    ln[part]["hist"] < 1 or ln[part]["hist_batch"] < 1 or \
                    ar[part]["hist"] != ln[part]["hist"] \
                    + ln[part]["hist_batch"]:
                fail(f"mesh rank {r} {part}: launches {ln[part]}, "
                     f"all_reduces {ar[part]}; one rank launched {lw}")
        out["launches"].append(ln)
        out["allreduces"].append(ar)
    geo = one["sgbt_runs"][-1]
    if (geo["windows"], geo["resident"]) != (MESH_STREAM_ROWS
                                             // MESH_STREAM_WINDOW, 2):
        fail(f"mesh: the streamed GBT's geometry {geo}: want 4 windows, 2 "
             "resident")
    # two super-batches of D + 2 passes each (D levels, the leaf sums, the
    # out-of-bag votes), the first's first pass the warm pass that fills
    # the cache (not a tail sweep); one B2 launch a level, window and
    # super-batch
    n_win = MESH_STREAM_ROWS // MESH_STREAM_WINDOW
    n_sb = -(-MESH_SRF_TREES // MESH_SRF_BATCH)
    srf_sweeps = one["srf"][1][1]
    srf_b2 = one["stream_launches"]["srf"]["hist_batch"]
    if n_sb != 2 or srf_sweeps != (DEPTH + 1) + (DEPTH + 2) or \
            srf_b2 != n_sb * DEPTH * n_win:
        fail(f"mesh: the streamed RF took {srf_sweeps} tail sweeps and "
             f"{srf_b2} hist_batch launches; want {(DEPTH + 1) + (DEPTH + 2)}"
             f" and {n_sb * DEPTH * n_win} ({n_sb} super-batches)")
    out["stream"] = {"sgbt": one["sgbt_runs"][-1], "srf": one["srf"][1],
                     "snn": [np.asarray(g["snn"][0]).tolist()
                             for g in ranks],
                     "window_checks": [g["window_checks"] for g in ranks]}
    log(f"mesh out of core: {MESH_RANKS} ranks' streamed GBT (c2f, "
        f"{geo['windows']} windows of {geo['window_rows']}, "
        f"{geo['resident']} resident; {geo['disk_passes']} disk passes, "
        f"{geo['tail_sweeps']} tail sweeps, {geo['repairs']} repairs, "
        f"{geo['bytes_read']} bytes read) and streamed RF (passes, sweeps, "
        f"bytes {one['srf'][1]}) equal one rank's bit for bit, the "
        f"streamed NN within 1e-4; a rank's launches / all_reduces: GBT "
        f"{ranks[0]['launches']['sgbt']} / {ranks[0]['allreduces']['sgbt']},"
        f" RF {ranks[0]['launches']['srf']} / "
        f"{ranks[0]['allreduces']['srf']}; window checks "
        f"{ranks[0]['window_checks']}; rank walls "
        f"{[{k: round(g['walls_s'][k], 3) for k in ('sgbt', 'srf', 'snn')}
            for g in ranks]}")
    out["wdl"] = mesh_compare_wdl(ranks, one)
    out["timed"] = [g["timed"] for g in ranks]
    out["walls_s"] = [g["walls_s"] for g in ranks]
    log(f"mesh: {MESH_RANKS} ranks' GBT and RF forests, stats boundaries, "
        f"counts and cells and scores equal one rank's bit for bit, the NN "
        f"within rtol 1e-4/1e-3; launches {out['launches'][0]}, "
        f"all_reduces {out['allreduces'][0]}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-of", metavar="DIR",
                    help="only time B1, B2 and a GBT chunk of the checkout "
                    "in DIR")
    ap.add_argument("--mesh-rank", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_of:
        sys.path.insert(0, os.path.abspath(args.time_of))
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available — this smoke runs on an NVIDIA GPU")
    if args.time_of:
        time_of(torch, args.time_of, args.seed)
        return
    if args.mesh_rank is not None:       # a rank of mesh_phase
        mesh_rank_main(torch, args.mesh_rank, args.mesh_dir)
        return
    try:
        from shifu_tpu_torch.ops import cuda_lib
        from shifu_tpu_torch.ops import tree_quant as tq
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    gpu = gpu_identity()
    print(gpu, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
    rng = np.random.default_rng(args.seed)         # checks and timings
    path_rng = np.random.default_rng([args.seed, 1])   # the main path's data
    t_all = time.perf_counter()

    walls = {}                           # the smoke's time budget, a phase
    mark = marker(walls, t_all)

    t0 = time.perf_counter()
    built = cuda_lib.build(["tree_traverse", "hist", "stats_hist"])
    for name, (path, build_log) in built.items():
        log(f"built {name} -> {os.path.relpath(path)}")
        for line in build_log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    mark("kernels built")

    errs = check_kernels(torch, tq, rng)
    mark("check_kernels")
    errs.update(check_hist(torch, rng))
    mark("check_hist")
    errs.update(check_stats_hist(torch, rng))
    mark("check_stats_hist")
    errs.update(check_hist_batch(torch, rng))
    mark("check_hist_batch")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        serve_root = os.path.join(root, "serve")
        os.makedirs(serve_root)
        plan = write_model_set(serve_root, path_rng)["plan"]
        served = serve_phase(torch, tq, serve_root, plan, path_rng)
        mark("serve_phase")
        splane = serve_plane_phase(torch, tq, root, serve_root, plan,
                                  np.random.default_rng([args.seed, 9]),
                                  gpu)
        mark("serve_plane_phase")
        fleet = fleet_phase(torch, root, serve_root, plan,
                            np.random.default_rng([args.seed, 11]), gpu)
        mark("fleet_phase")
        time_transform(torch, serve_root, plan, rng, gpu)
        mark("time_transform")
        trained = train_phase(torch, root, serve_root, plan, path_rng)
        mark("train_phase")
        plane = trained.pop("plane")
        forest = rf_phase(torch, root, serve_root, plane)
        mark("rf_phase")
        mesh = mesh_phase(torch, root, serve_root, plane, trained["dir"],
                          gpu)
        mark("mesh_phase")
        bagging = bagging_phase(torch, root, serve_root, plane, gpu,
                                trained["chunk"]["ms_per_tree"])
        mark("bagging_phase")
        multi = multiclass_phase(torch, tq, root, serve_root, plane,
                                 np.random.default_rng([args.seed, 2]), gpu)
        mark("multiclass_phase")
        stream = stream_phase(torch, root, serve_root, plan,
                              np.random.default_rng([args.seed, 5]), plane,
                              gpu)
        mark("stream_phase")
        rf_cut_bins = plane[0][:CUT_ROWS].copy()     # aux_tree_phase's RF walk
        del plane
        nn_walls = {}
        t0 = time.perf_counter()
        nn = nn_phase(torch, root, serve_root,
                      np.random.default_rng([args.seed, 3]), gpu)
        nn_walls["nn_phase"] = time.perf_counter() - t0
        mark("nn_phase")
        t0 = time.perf_counter()
        nn_stream = nn_stream_phase(torch, root, serve_root,
                                    np.random.default_rng([args.seed, 6]),
                                    gpu)
        nn_walls["nn_stream_phase"] = time.perf_counter() - t0
        mark("nn_stream_phase")
        t0 = time.perf_counter()
        varsel = varselect_phase(
            torch, root, os.path.dirname(nn["models_dir"]),
            os.path.join(root, "nn_cut_plane"),
            np.random.default_rng([args.seed, 7]), gpu)
        nn_walls["varselect_phase"] = time.perf_counter() - t0
        mark("varselect_phase")
        t0 = time.perf_counter()
        genetic = genetic_phase(torch, root, os.path.dirname(nn["models_dir"]),
                                os.path.join(root, "nn_cut_plane"), gpu)
        nn_walls["genetic_phase"] = time.perf_counter() - t0
        mark("genetic_phase")
        t0 = time.perf_counter()
        nn_served = nn_serve_phase(torch, tq, root, serve_root,
                                   nn.pop("models_dir"), plan,
                                   np.random.default_rng([args.seed, 4]))
        nn_walls["nn_serve_phase"] = time.perf_counter() - t0
        mark("nn_serve_phase")
        t0 = time.perf_counter()
        wdl = wdl_phase(torch, root, serve_root, plan,
                        np.random.default_rng([args.seed, 8]), gpu)
        nn_walls["wdl_phase"] = time.perf_counter() - t0
        mark("wdl_phase")
        t0 = time.perf_counter()
        svm = svm_phase(torch, root, serve_root,
                        os.path.join(root, "nn_plane"), plan, gpu)
        nn_walls["svm_phase"] = time.perf_counter() - t0
        mark("svm_phase")
        stats = stats_phase(torch, root, plan, path_rng)
        mark("stats_phase")
        stats_x = stats_extra_phase(torch, root, stats["dir"], plan, gpu)
        mark("stats_extra_phase")
        e2e = e2e_phase(torch, stats["dir"], stats["csv"], gpu)
        mark("e2e_phase")
        eval_times = time_eval_walk(torch, tq, stats["dir"],
                                    e2e.pop("bins"), gpu)
        mark("time_eval_walk")
        cache_walls = raw_cache_phase(stats["dir"], gpu)
        mark("raw_cache_phase")
        post = posttrain_phase(torch, tq, stats["dir"], gpu)
        mark("posttrain_phase")
        aux = aux_tree_phase(torch, tq, root, stats["dir"], stats["csv"],
                             os.path.join(root, "rf"), rf_cut_bins, gpu)
        mark("aux_tree_phase")
        mc_cli = multiclass_cli_phase(torch, tq, root, stats["csv"], gpu)
        mark("multiclass_cli_phase")
        t0 = time.perf_counter()
        e2e_nn = e2e_nn_phase(torch, stats["dir"], stats["csv"], gpu)
        nn_walls["e2e_nn_phase"] = time.perf_counter() - t0
        mark("e2e_nn_phase")
        aux_nn = aux_nn_phase(torch, root, stats["dir"], gpu)
        nn_walls["aux_nn_phase"] = aux_nn["wall_s"]
        mark("aux_nn_phase")
        t0 = time.perf_counter()
        wdl_e2e = wdl_e2e_phase(torch, root, stats["dir"], stats["csv"],
                                gpu)
        mark("wdl_e2e_phase")
        svm_e2e = svm_e2e_phase(torch, root, stats["dir"], gpu)
        mark("svm_e2e_phase")
        from shifu_tpu_torch.data import parsepool
        prev_chunk, parsepool.CHUNK_ROWS = parsepool.CHUNK_ROWS, CSV_CHUNK
        try:
            wdl_combo = combo_pair(root, stats["dir"], stats["csv"],
                                   "WDL:GBT", params=WDL_GBT_COMBO,
                                   epochs=WDL_COMBO_EPOCHS)
        finally:
            parsepool.CHUNK_ROWS = prev_chunk
        nn_walls["wdl_svm_e2e_combo"] = time.perf_counter() - t0
        mark("wdl_combo")
        inputs = inputs_phase(torch, root, stats["csv"], plan, gpu)
        mark("inputs_phase")
        tel = telemetry_phase(torch, root, stats["csv"], plan, gpu)
        mark("telemetry_phase")
        refresh = refresh_phase(torch, root, stats["dir"], stats["csv"],
                                plan, np.random.default_rng([args.seed, 12]),
                                gpu)
        mark("refresh_phase")
        log(f"combo WDL:GBT on {COMBO_ROWS} rows: run "
            f"{wdl_combo['walls_s']['run_cuda']:.3f} s on the card, "
            f"{wdl_combo['walls_s']['run_cpu']:.3f} s on the CPU; "
            f"{wdl_combo['hist_launches']} hist and "
            f"{wdl_combo['eval_launches']} tree_traverse launches; AUCs "
            f"card vs CPU {wdl_combo['aucs']} — [{gpu}]")
    mark("temporary directory removed")
    resident = resident_phase(torch, args.seed)
    mark("resident_phase")
    times = time_kernels(torch, tq, rng, gpu)
    mark("time_kernels")
    hist_times = time_hist(torch, rng, gpu)
    mark("time_hist")
    stats_times = time_stats_hist(torch, rng, gpu)
    mark("time_stats_hist")
    batch_times = time_hist_batch(torch, rng, gpu)
    mark("time_hist_batch")
    ms_tree = trained["chunk"]["ms_per_tree"]
    ph = trained["phases_s"]
    log(f"full-width train: {ms_tree:.3f} ms per tree device-resident, "
        f"{ph['train'] * 1e3 / TRAIN_TREES:.3f} ms per tree through the "
        f"CLI's train phase of {ph['train']:.3f} s: upload "
        f"{ph['train/upload']:.3f} s, grow {ph['train/grow']:.3f} s "
        f"({ph['train/grow'] * 1e3 / TRAIN_TREES:.3f} ms a tree), "
        f"checkpoints {ph['train/checkpoint']:.3f} s, other "
        f"{ph['train/other']:.3f} s — [{gpu}]")

    top = times[512]
    h32 = hist_times[32]
    # the telemetry cost models' bytes at the timed shapes beside the
    # bounds' (this data's): a model charges every row active and every
    # node's record, so it is the bound's count at full occupancy and an
    # upper bound otherwise; logged, not on the kernels line
    from shifu_tpu_torch.ops import hist as hist_ops
    from shifu_tpu_torch.ops import stats_hist as sh_ops
    model_vs_bound = {
        "tree_traverse": (tq.walk_cost(512, N_COLS, N_BINS,
                                       (1 << (DEPTH + 1)) - 1, DEPTH,
                                       N_TREES), top),
        "hist": (hist_ops.hist_kernel_cost(TRAIN_ROWS, N_COLS, N_BINS, 32,
                                           2), h32),
        "stats_hist": (sh_ops.stats_hist_cost(RESIDENT_ROWS, N_NUM,
                                              STATS_BUCKETS, 4),
                       stats_times[4]),
        "hist_batch": (hist_ops.hist_kernel_cost(
            TRAIN_ROWS, N_COLS, N_BINS, 32, 2, n_trees=HIST_BATCH),
            batch_times[32])}
    for name, (model, timed) in model_vs_bound.items():
        if model["bytes_accessed"] < timed["bytes"]:
            fail(f"{name}: the cost model's {model['bytes_accessed']} bytes "
                 f"fall below the {timed['bytes']} this data moves")
    log("cost models vs bounds at the timed shapes (MB, model / this "
        "data's bound): " + "; ".join(
            f"{name} {model['bytes_accessed'] / 1e6:.3f} / "
            f"{timed['bytes'] / 1e6:.3f}"
            for name, (model, timed) in model_vs_bound.items())
        + f" — [{gpu}]")
    kernels = [{
        "name": "tree_traverse", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/tree_traverse.cu",
        "replaces": "shifu_tpu/ops/tree_quant.py:159",
        "launches": served["launches"]["tree_traverse"],
        "serve_plane_launches": splane["launches"],
        "serve_plane_replays": splane["replays"],
        "serve_plane_warm_launches": splane["warm_launches"],
        "serve_plane_batches": splane["batches"],
        "fleet_launches": fleet["launches"],
        "fleet_replays": fleet["replays"],
        "fleet_warm_launches": fleet["warm_launches"],
        "train_replay_launches":
            trained["replay"]["launches"]["tree_traverse"],
        "eval_launches": e2e["eval_launches"],
        "inputs_launches": inputs["launches"]["tree_traverse"],
        "telemetry_launches": tel["launches"]["tree_traverse"],
        "telemetry_cost_launches": tel["costs"]["pallas.tree_traverse"],
        "max_abs_err": errs["tree_traverse"],
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": None,
        **{f"at_{n}_rows": {k: times[n][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by")}
           for n in TRAVERSE_ROWS[1:]},
        **{f"eval_forest_at_{n}_rows": eval_times[n] for n in eval_times},
        "multiclass_eval_launches": {alg: mc_cli[alg]["eval_launches"]
                                     for alg in ("RF", "GBT")},
        "posttrain_launches": post["launches_cuda"],
        "encode_launches": aux["encode_launches"],
        "export_roundtrip_launches": aux["roundtrip"]["launches"],
        "combo_eval_launches": aux["combo"]["eval_launches"],
        "wdl_combo_eval_launches": wdl_combo["eval_launches"],
        "rf_encode_launches": aux["rf_encode"]["launches"],
        "stream_replay_launches":
            stream["b"]["replay_launches"]["tree_traverse"],
        "refresh_launches": refresh["cli_launches"]["tree_traverse"],
        "mesh_rank_launches": [ln["score"]["tree_traverse"]
                               for ln in mesh["launches"]],
        f"node_index_walk_at_{MC_WALK_ROWS}_rows": multi["walk"],
        "gpu": gpu}, {
        "name": "hist", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/hist.cu",
        "leaf_sum_launches": trained["launches"]["leaf_sums"],
        "inputs_launches": inputs["launches"]["hist"],
        "telemetry_launches": tel["launches"]["hist"],
        "telemetry_cost_launches": tel["costs"]["pallas.hist"],
        "combo_launches": aux["combo"]["hist_launches"],
        "refresh_launches": refresh["cli_launches"]["hist"],
        "refresh_served_launches": refresh["retrain_launches"]["hist"],
        "mesh_rank_launches": [ln["gbt"]["hist"] for ln in mesh["launches"]],
        "mesh_rank_allreduces": [a["gbt"]["hist"]
                                 for a in mesh["allreduces"]],
        "mesh_levels": [t["hist"] for t in mesh["timed"]],
        "mesh_stream_launches": [
            {k: ln[k]["hist"] for k in ("sgbt", "srf")}
            for ln in mesh["launches"]],
        "mesh_leaf_sums": [t["leaf_sums"] for t in mesh["timed"]],
        "mesh_stream_leaf_sum_launches": [
            {k: ln[k]["leaf_sums"] for k in ("sgbt", "srf")}
            for ln in mesh["launches"]],
        "wdl_combo_launches": wdl_combo["hist_launches"],
        "rf_launches": forest["launches"]["hist"],
        "rf_leaf_sum_launches": forest["launches"]["leaf_sums"],
        "bagging_launches": bagging["bagging"]["launches"]["hist"],
        "kfold_launches": bagging["kfold"]["launches"]["hist"],
        "multiclass_launches": {"native_rf": multi["rf"]["launches"]["hist"],
                                "ova_gbt": multi["ova"]["launches"]["hist"]},
        "stream_launches": {k: stream[k]["launches"]["hist"]
                            for k in ("a", "a_exact", "c")},
        "stream_leaf_sum_launches": {
            k: stream[k]["launches"]["leaf_sums"]
            for k in ("a", "a_exact", "c")},
        "at_stream_block": {m: stream["kernels"]["block"][m] for m in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "shape")},
        "replaces": "shifu_tpu/ops/hist_pallas.py:75",
        "launches": trained["launches"]["hist"],
        "max_abs_err": max([errs["hist"]] + [hist_times[k]["max_abs_err"]
                                             for k in HIST_TIMED_NODES]),
        "ms": h32["ms"], "plain_ms": h32["plain_ms"],
        "bound_ms": h32["bound_ms"], "bound_by": h32["bound_by"],
        "library_ms": h32["library_ms"],
        "shape": f"N={TRAIN_ROWS} C={N_COLS} B={N_BINS} S=2 K=32 uint8",
        "parts_ms": h32["parts_ms"],
        **{f"at_{k}_node{'s' if k > 1 else ''}": {
            m: hist_times[k].get(m) for m in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "parts_ms")}
           for k in (1, 4096)},
        "gpu": gpu}, {
        "name": "stats_hist", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/stats_hist.cu",
        "replaces": "shifu_tpu/ops/hist_pallas.py:534",
        "launches": stats["launches"]["stats_hist"],
        "resident_launches": resident["launches"],
        "stats_extra_launches": stats_x["launches"],
        "inputs_launches": inputs["launches"]["stats_hist"],
        "telemetry_launches": tel["launches"]["stats_hist"],
        "telemetry_cost_launches": tel["costs"]["stats.stats_hist"],
        "mesh_rank_launches": [ln["stats"]["stats_hist"]
                               for ln in mesh["launches"]],
        "mesh_rank_allreduces": [a["stats"]["stats_hist"]
                                 for a in mesh["allreduces"]],
        "mesh_launch": [t["stats_hist"] for t in mesh["timed"]],
        "max_abs_err": errs["stats_hist"],
        "ms": stats_times[4]["ms"], "plain_ms": stats_times[4]["plain_ms"],
        "bound_ms": stats_times[4]["bound_ms"],
        "bound_by": stats_times[4]["bound_by"],
        "library_ms": stats_times[4]["library_ms"],
        "shape": f"N={RESIDENT_ROWS} C={N_NUM} B={STATS_BUCKETS} S=4",
        "parts_ms": stats_times[4]["parts_ms"],
        "at_2_channels": {k: stats_times[2][k] for k in
                          ("ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_by", "parts_ms")},
        "gpu": gpu}, {
        "name": "hist_batch", "route": "cuda",
        "source": "shifu_tpu_torch/csrc/hist.cu",
        "replaces": "shifu_tpu/ops/hist_pallas.py:161",
        "launches": forest["launches"]["hist_batch"],
        "bagging_launches": bagging["bagging"]["launches"]["hist_batch"],
        "kfold_launches": bagging["kfold"]["launches"]["hist_batch"],
        "multiclass_launches": multi["rf"]["launches"]["hist_batch"],
        "mesh_rank_launches": [ln["rf"]["hist_batch"]
                               for ln in mesh["launches"]],
        "mesh_rank_allreduces": [a["rf"]["hist"] for a in mesh["allreduces"]],
        "mesh_level": [t["hist_batch"] for t in mesh["timed"]],
        "mesh_stream_launches": [
            {k: ln[k]["hist_batch"] for k in ("sgbt", "srf")}
            for ln in mesh["launches"]],
        "mesh_stream_allreduces": [
            {k: a[k]["hist"] for k in ("sgbt", "srf")}
            for a in mesh["allreduces"]],
        "mesh_path": [t["path"] for t in mesh["timed"]],
        "mesh_superbatch": [t["superbatch"] for t in mesh["timed"]],
        "stream_launches": {k: stream[k]["launches"]["hist_batch"]
                            for k in ("a", "a_exact", "c")},
        "at_stream_path": {m: stream["kernels"]["path"][m] for m in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "shape")},
        "max_abs_err": max([errs["hist_batch"], multi["b2_s3"]["max_abs_err"]]
                           + [bagging["b2"][k]["max_abs_err"]
                              for k in BAG_TIMED_NODES]),
        "ms": batch_times[32]["ms"], "plain_ms": batch_times[32]["plain_ms"],
        "bound_ms": batch_times[32]["bound_ms"],
        "bound_by": batch_times[32]["bound_by"],
        "library_ms": batch_times[32]["library_ms"],
        "shape": f"TB={HIST_BATCH} N={TRAIN_ROWS} C={N_COLS} B={N_BINS} S=2 "
                 "K=32 uint8",
        "hist_each_tree_ms": batch_times[32]["hist_each_tree_ms"],
        "parts_ms": batch_times[32]["parts_ms"],
        **{f"at_{k}_node{'s' if k > 1 else ''}": {
            m: batch_times[k].get(m) for m in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "hist_each_tree_ms", "parts_ms")}
           for k in (1, 4096)},
        "rf_levels_ms": forest["chunk"]["batch"]["levels_ms"].get(
            "build_histograms_batch"),
        "rf_leaf_ms_per_tree_max": forest["chunk"]["batch"][
            "leaf_ms_per_tree_max"],
        **{f"at_tb{BAG_MEMBERS}_{k}_node{'s' if k > 1 else ''}": {
            m: bagging["b2"][k][m] for m in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
           for k in BAG_TIMED_NODES},
        f"at_s{MC_CLASSES}_4096_nodes": {
            m: multi["b2_s3"][m] for m in
            ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "bagged_member_tree_ms": bagging["member_ms"],
        "single_tree_ms": bagging["single_ms"],
        "gpu": gpu}]
    rf_chunk = forest["chunk"]
    log(f"full-width RF ({RF_TREES} trees, depth {RF_DEPTH}): "
        f"{rf_chunk['batch']['ms_per_tree']:.1f} ms per tree in the "
        f"{RF_CKPT}-tree batch (hist_batch), "
        f"{rf_chunk['remainder']['ms_per_tree']:.1f} ms per tree one by one "
        f"(hist), bags {rf_chunk['bag_ms']:.1f} ms; CLI train phase "
        f"{forest['phases_s']['train']:.3f} s ({forest['phases_s']}); peak "
        f"device memory {forest['peak_bytes'] / 2**30:.3f} GiB — [{gpu}]")
    sa, sc = stream["a"], stream["c"]
    log(f"stream: {STREAM_ROWS} x {N_COLS} plane, GBT c2f "
        f"{sa['ms_per_tree']:.1f} ms a tree ({sa['tail_sweeps']} tail "
        f"sweeps, {sa['repairs']} repairs; exact "
        f"{stream['a_exact']['tail_sweeps']}), default geometry "
        f"{stream['a0']['wall_s']:.3f} s, RF {sc['ms_per_tree']:.1f} ms a "
        f"tree ({sc['tail_sweeps']} tail sweeps, peak "
        f"{sc['peak_bytes'] / 2**30:.3f} GiB); phase "
        f"{stream['wall_s']:.1f} s — [{gpu}]")
    log(f"stats: {CSV_ROWS} rows x {N_COLS + 2} fields through new/init/"
        f"stats in {stats['init_s'] + stats['wall_s']:.2f} s (stats "
        f"{stats['wall_s']:.3f} s, host parse {stats['parse_us_per_cell']:.3f}"
        f" us a cell); resident accumulator {resident['update_ms_median']:.3f}"
        f" ms a 262,144-row chunk, finalize {resident['finalize_ms']:.3f} ms, "
        f"peak {resident['peak_bytes'] / 2**30:.3f} GiB — [{gpu}]")
    w = e2e["walls_s"]
    log(f"e2e: {CSV_ROWS} rows x {N_COLS + 2} fields through norm "
        f"{w['norm']:.3f} s, train {w['train']:.3f} s, eval -run "
        f"{w['eval']:.3f} s ({e2e['rows_per_s']:.0f} rows/s, "
        f"{e2e['eval_launches']} tree_traverse launches), AUC "
        f"{e2e['auc']:.6f} — [{gpu}]")
    log(f"raw cache: norm {np.median(cache_walls['on']['norm']):.3f} s "
        f"with it, {np.median(cache_walls['off']['norm']):.3f} s without; "
        f"eval -run {np.median(cache_walls['on']['eval']):.3f} / "
        f"{np.median(cache_walls['off']['eval']):.3f} s "
        f"({len(CACHE_TURNS) // 2} turn(s) each); posttrain "
        f"{post['wall_cuda_s']:.3f} s on the card "
        f"({post['launches_cuda']} tree_traverse launch(es)) — [{gpu}]")
    ns = nn_stream
    log(f"NN streamed on {NN_STREAM_ROWS} x {N_COLS} ({ns['plane_gb']:.2f} "
        f"GB): {ns['a']['windows']} windows of {ns['a']['window_rows']} "
        f"rows, {ns['a']['ms_per_epoch']:.1f} ms an epoch, device busy "
        f"{100 * ns['e'].get('busy_share', float('nan')):.1f}%; card vs CPU "
        f"errors within {ns['d']['err_rel']:.3g}; varselect SE "
        f"{varsel['wall_s']:.3f} s on {NN_ROWS} rows, card vs CPU SE "
        f"within {varsel['se_diff']:.3g}; GENETIC {genetic['wall_s']:.3f} s"
        f" ({genetic['epochs_per_s']:.1f} epochs/s) — [{gpu}]")
    log(f"members: bagged GBT {bagging['member_ms']:.3f} ms a member tree "
        f"against {bagging['single_ms']:.3f} ms a single forest's tree; "
        f"native multi-class RF train {multi['rf']['wall_s']:.3f} s, "
        f"one-vs-all GBT {multi['ova']['wall_s']:.3f} s; multi-class CLI "
        f"accuracy RF {mc_cli['RF']['accuracy']:.6f}, GBT "
        f"{mc_cli['GBT']['accuracy']:.6f} — [{gpu}]")
    log(f"NN/LR on {NN_ROWS} x {N_COLS} ({nn['plane_gb']:.2f} GB "
        f"plane): (a) {nn['a']['ms_per_epoch']:.3f} ms an epoch of "
        f"{NN_BAGS} bags, (b) {nn['b']['ms_per_epoch']:.3f} ms an epoch, "
        f"{nn['b']['ms_per_step']:.4f} ms a step, "
        f"{100 * nn['b']['fp32_peak_share']:.2f}% of dense FP32 peak, (c) "
        f"LR {nn['c']['ms_per_epoch']:.3f} ms an epoch; (d) errors within "
        f"{nn['d']['err_rel']:.3g}, AUC diff {nn['d']['auc_diff']:.3g}; "
        f"NN serve max |card - cpu| {nn_served['max_abs_score_diff']:.3g};"
        f" e2e NN eval AUC {e2e_nn['auc']:.6f} (card - CPU "
        f"{e2e_nn['auc_card_cpu']:.3g}); phase walls "
        f"{ {k: round(v, 3) for k, v in nn_walls.items()} } — [{gpu}]")
    wa, wb = wdl["a"], wdl["b"]
    log(f"WDL on {WDL_ROWS} x {N_COLS}, {WDL_BAGS} bags: "
        f"{wa['ms_per_epoch']:.3f} ms a full-batch epoch, "
        f"{wb['ms_per_epoch']:.1f} ms a minibatch epoch "
        f"({wb['ms_per_step']:.4f} ms a step, "
        f"{wb.get('launches_per_step', float('nan')):.1f} launches a step, "
        f"{wb.get('host_syncs_per_epoch')} host sync an epoch); card vs CPU "
        f"errors within {wdl['d']['resident']['err_rel']:.3g} resident, "
        f"{wdl['d']['streamed']['err_rel']:.3g} streamed; e2e WDL AUC "
        f"{wdl_e2e['auc']:.6f} (card - CPU {wdl_e2e['auc_card_cpu']:.3g}); "
        f"kernel SVM at {SVM_CAP} rows {svm['a']['solve_s']:.3f} s "
        f"({svm['a']['ms_per_iter']:.4f} ms an iteration), linear SVM "
        f"{svm['c']['ms_per_epoch']:.3f} ms an epoch; e2e SVM AUCs "
        f"{ {k: round(v['auc'], 6) for k, v in svm_e2e.items()} } "
        f"— [{gpu}]")
    log(f"phase walls (s): {json.dumps(walls)}")
    log(f"served {served['batches']} batches; max |card - cpu| "
        f"{served['max_abs_score_diff']:.3g}; trained {TRAIN_TREES} GBT and "
        f"{RF_TREES} RF trees; "
        f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
