"""Drive graphsage_torch's serving and training paths on one NVIDIA card and
hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each of which fails the run (non-zero exit) if its check fails:

1. Build the kernels from graphsage_torch/csrc with nvcc, one process per
   source, all at once, and the native host engine (csrc/gs_native.cpp)
   with g++ beside them (build seconds and nvcc's register report printed);
   time one warp's chain of dependent bfloat16 adds (the latency that
   bounds a long row of the scatter, ADD_NS).
2. A small graph through the kernels against a float64 numpy oracle of the
   reference semantics (MEAN/MAX x gcn).
3. Serving at full width: the 100,000-node, 1,000,000-edge power-law graph
   with 602 features, a width-32 sampled adjacency, a 2-layer GraphSAGE with
   hidden 128, weights from a seeded torch.Generator; for MEAN float32, MEAN
   bfloat16, MAX bfloat16 and LSTM float32 (a cell a layer, layer 1's 602
   wide), and, after phase 7, the cached-LSTM hybrid that (d) trained and
   exported (served with lstm_hybrid, from its bundle):
   - launch counts set to 0, then the main path a user calls:
     InferenceSession.embeddings(), predict/log_probs on three node
     batches, score_pairs, and an export_bundle -> from_bundle round trip
     that must give identical embeddings and predictions; counts read and
     held equal to those the code's rule predicts (one gather_mean /
     gather_max a MEAN / MAX layer; one gather_rows a block of an LSTM
     layer, infer.card_block's blocks; one pretransform a bfloat16 MEAN
     layer);
   - embed-all time (host clock around a synchronised call, warm; median,
     min and max of 20, of 5 for LSTM), and the device's busy time by
     kernel over one embed-all (torch.profiler);
   - the full embedding table against the same session run through the
     plain versions on the card;
   - each kernel alone at that layer's shapes against its plain version,
     timed three ways (graphsage_torch.microbench.times): ``ms``, CUDA
     events over many warm launches of the wrapper; ``device_ms``, the
     kernel's own device time a launch (torch.profiler); ``host_us``, the
     wrapper's host time a call; beside its byte bound, the plain version's
     time and a one-call library yardstick (its ms and device_ms); for LSTM
     gather_rows at one layer-1 block.

4. Training at full width (compact pipeline, the CLI's default), on the
   same graph: 2-layer MEAN GraphSAGE, hidden 128, fanout 10, b_sz 20, lr
   0.7, seed 824, float32.  Two cuts, both of scale only: the train split
   is cut to its first 1,000 nodes, so an epoch is 50 steps; negatives are
   "uniform" (GS_EXACT_NEG_BUDGET_S=0), because "auto" chooses by the
   host's core count.  The graph, the features and the widths are not cut.
   For plus_unsup (normal loss, 100 negatives) and sup MEAN, sup MAX gcn,
   and plus_unsup LSTM:
   - launch counts set to 0, then one epoch through Trainer.fit
     (train_epoch + evaluate); counts read and held equal to the
     prediction of compact_launches: the layer kernel (gather_mean,
     gather_max, or gather_rows for the LSTM's slot gather) 2 a step plus 2
     per embedding of val (and of test, when val F1 improved), pair_scores
     1 a step under plus_unsup, and for MAX one gather_max_bwd (the tie
     split of layer 2's backward) a step;
   - the same epoch through the plain versions on the card, from the same
     initial params and RandomState (so the same host batches), in
     lockstep: each plain step starts from the kernel run's params of that
     step, and its loss and updated params are held to the tolerances
     below (the last step's are the final params); for MEAN a
     free-running plain epoch is printed beside it, not asserted;
   - ms/step (host clock around each synchronised step; median of steps 6
     to 50, min, max), the loss curve, val F1, and the device's busy time
     by kernel and idle share over a 5-step epoch (torch.profiler).
5. The pair-score kernel at the step's own shape (20 targets over the
   step's padded rows, H=128), at [512 x 2048] H=128 and at a ragged
   [3 x 1000] H=100 case with zero rows: forward (float32 and bfloat16)
   and gradient through PairScores against the plain version, and a kernel
   row like the aggregate kernels' (yardstick: torch.mm of F.normalize'd
   rows); cached (c)'s step shape has its own row in phase 7.
   gather_mean at the step's two layer shapes: the forward kernel
   row and the scatter-add gradient against autograd through the plain
   version.  gather_max at the MAX step's two layer shapes (exact), and
   its tie-splitting backward in two rows: the gather_max_bwd kernel (the
   tie split) against max_tie_split_plain, bit for bit, and the whole
   backward (agg.max_aggregate_backward: the kernel, then the scatter)
   against autograd through the plain version, with the composition the
   kernel replaced (the gather_rows tie gather, the tie test, the scatter)
   timed as its ``earlier``; gather_rows at the LSTM step's layer-1 slot
   gather.
6. End to end through the entry points, on powerlaw:2000:10000: the CLI
   trains plus_unsup for one epoch on the card and exports a bundle
   (graphsage_torch.cli.run, what ``main`` runs); the bundle's params equal
   the trainer's best-val snapshot exactly; InferenceSession.from_bundle
   serves it, its table equal to infer.full_graph_embeddings of those
   params; val micro-F1 printed.  Then the CLI with ``--pipeline cached
   --table_cap 8`` trains plus_unsup for two epochs on the card, through
   gather_rows, gather_mean and pair_scores.
7. Cached training at full width (``--pipeline cached``, CachedTrainer) on
   the same graph and features, table_cap 32 (``RandomState(824)``), 2
   layers, hidden 128, fanout 10, lr 0.7, seed 824, float32, four
   configurations:
   (a) sup MEAN, plain batches of 32768 over the whole train split (2 steps
       an epoch, the tail wrap-padded and masked), 3 epochs with
       refresh_every 2: the full-table layer-1 branch;
   (b) sup MAX gcn, plain batches of 512, the train split cut to its first
       5,120 nodes (10 steps): the per-occurrence branch, gather_max in the
       refresh;
   (c) plus_unsup MEAN, extended batches of 20, the train split cut to
       1,000 nodes (50 steps), uniform negatives: the full-table branch and
       the pair_scores block;
   (d) sup LSTM, the cached-LSTM hybrid (MEAN leaf cache, the live layer-2
       cell over the tree-contiguous [32768, 11, 128] sequence), plain
       batches of 32768 over the whole train split, 2 epochs: the JAX
       bench's powerlaw100k_b32768_cached_bfloat16_lstm_hybrid row in
       float32.  Its layer-0 cell must come out of the fit unchanged; the
       trained model is exported for phase 3.
   For each: launch counts set to 0, then CachedTrainer.fit, every step,
   refresh and sampler draw recorded; counts read and held equal to the
   counts predicted from the code; the first refresh against its plain
   version on the same samples (MAX exact); every step again through the
   plain versions in lockstep (from the kernel run's params, cache and
   draws of that step); refresh_ms (median of 5, min, max); ms_per_step
   (median of 20 steps on one cache, min, max); the device time by kernel
   and the idle share over one epoch (torch.profiler); val F1.  Then
   gather_mean / gather_max kernel rows at the refresh shape (idx [100000,
   10] over [100000, 602]), gather_rows rows at (a)'s full-table and (b)'s
   per-occurrence gathers, equal to index_select bit for bit, and a
   pair_scores row at (c)'s own step shape (the score block one recorded
   step hands the kernel: B from its target_rows, U from its batch, with
   (c)'s launch count), with phase 5's checks.
8. The port's microbench (graphsage_torch.microbench) at
   tools/pallas_microbench.py's shapes: row gather, gather+mean,
   scatter-add (unsorted and presorted) and the [512 x 2048] score block,
   and at the cached pipeline's 602-wide shapes (a row gather of 5,632 ids,
   gather+mean at the refresh's [100000, 10]); its row gather (45,056 x 11
   ids over [100000, 128], equal to index_select bit for bit) is
   gather_rows' kernel row at that shape.
9. bfloat16 training at full width (float32 master params, the feature
   table and the leaf cache in bfloat16; the table_cap-32 adjacency of
   phase 7; weights from a torch.Generator seeded 824, the sampler's seeded
   825), on the JAX bench's bfloat16 rows:
   (e) cached sup MEAN, batches of 65536 (the headline row,
       powerlaw100k_b65536_cached_bfloat16): one refresh, then 20 steps of
       RandomState(0).randint(0, N, (20, 65536)) through
       cached.cached_epoch_reuse (the full-table branch);
   (h) cached sup MAX, batches of 32768, 10 steps; (i) the cached-LSTM
       hybrid, batches of 32768, 5 steps (fewer than (e), for time);
   (f) the dense pipeline, sup MEAN, batches of 4096: 20 steps of
       train.dense.make_dense_sup_epoch;
   (g) compact plus_unsup MEAN through Trainer, 50 steps over the
       1,000-node split, as phase 4 runs it in float32; (j) compact sup
       MAX gcn the same way (its layer-2 tie backward in bfloat16); and
       gather_max's backward rows (phase 5's) at the dense layer-2 shape,
       idx [4096, 11] over the relu of (f)'s [45056, 128] layer-2 input,
       in float32 and bfloat16, 0 launches (no path trains dense MAX).
   For each: launch counts set to 0, the main path, counts read and held
   equal to those predicted from the code (in bfloat16 every gradient of
   a row gather is one scatter_rows launch: bf16_scatters, and one a step
   on the cached full-table branch); the refresh and every step
   again through the plain versions on the recorded draws, in lockstep
   from the kernel run's params (bfloat16 tolerances below);
   refresh_ms, ms_per_step (median, min, max), edges_per_batch over the
   step time as edges/s, the epoch's idle share (torch.profiler).  For (e)
   and (f) the device time of the float32 upcast of the bfloat16 table and
   of the float32 GEMM on it; for (e) the layer-1 gather's bfloat16
   scatter backward (720,896 rows into [100000, 128]) against a float64
   sum: the port's (scatter_rows, JAX's order), index_add_'s bfloat16
   atomics and float32.  Kernel rows in bfloat16: gather_mean / gather_max
   at the refresh shape, gather_rows and scatter_rows at the three
   full-table gathers and their backward, gather_mean at the dense and
   compact layers with their gradient and a scatter_rows row at its
   shape, pair_scores at (g)'s step, gather_max and its backward
   composition at (j)'s layers.
10. Checkpoints, --config, --resume and the wedge-and-relaunch loop at full
   width (files under build/chip_smoke_resume), through the entry points a
   user runs:
   (k) the headline bf16 cached configuration through the CLI
       (powerlaw:100000:1000000, a HOCON --config giving 2 layers and
       hidden 128, --pipeline cached --table_cap 32 --no_extend --b_sz
       32768 --compute_dtype bfloat16, sup, 3 epochs, --export): once
       unbroken in this process (launch counts read: gather_rows,
       gather_mean and scatter_rows each > 0; checkpoint writes timed),
       then under ``python -m graphsage_torch.supervise`` with a wedge
       injected at epoch 1 (GS_TEST_WEDGE_SENTINEL): launch, exit 17,
       restart with --resume of model_best_k_ep0_*, launch, exit 0.  Epochs
       1-2's mean_loss and val_f1 and the exported params must equal the
       unbroken run's bit for bit (every gradient scatter on the path is
       scatter_rows, deterministic); so must the final params and the last
       epoch's step losses of the CLI resumed in this process from the
       checkpoint the supervisor resumed from.  Printed: the time to
       recover, from the child's exit 17 to the end of the relaunched
       child's first epoch, and its parts; the checkpoint writes' ms and
       bytes.
   (l) float32 compact sup on powerlaw:2000:10000, the same ways, held to
       the float32 lockstep bars (float32 gathers' backward is index_add_,
       whose atomics add in varying order): epochs 1-2's mean losses, the
       last epoch's step losses and the final params.
   (m) in a subprocess, a fetch_with_deadline behind 5 s of queued device
       time (torch.cuda._sleep) must raise FetchDeadlineError after its 1 s
       deadline (within 3 s), and the CLI's exit path must end the process
       with code 17 within 10 s.  Then a real step: the CLI trains compact
       sup at full width (powerlaw:100000:1000000, 2 layers, hidden 128)
       with 30 s of device sleep queued inside its 20th step, between the
       encode and the update, and a 2 s deadline; the process must end
       with code 17, the step's loss fetch named, within 3 deadlines of
       the sleep.
11. Distribution at world 1 on NCCL (parallel.multihost.initialize: the real
   collectives, no shortcut), on the same graph, 2 layers, hidden 128,
   fanout 10, lr 0.7, seed 824:
   (n) cached_dist sup MEAN bf16 on (e)'s bench batches (b_sz 65536, 20
       steps, one refresh): local_refresh and cached_epoch_reuse over a
       CachedDistStep, counted (gather_mean 1; gather_rows and scatter_rows
       one a step); its loss curve must equal (e)'s bit for bit (the same
       draws and batches; at world 1 the all_gather, the reduce-scatter and
       the gradient all-reduce are copies); the refresh and every step
       against the plain versions in bf16 lockstep; refresh_ms,
       ms_per_step, edges/s, busy and idle share beside (e)'s, and the
       world-1 all_gather and reduce-scatter of the [100000, 128] table
       timed alone, and (e) and (n) epochs in turns; then cached_dist sup
       MAX bf16 on (h)'s batches (b_sz 32768, 10 steps): equal to (h) bit
       for bit, in lockstep, its refresh a gather_max launch;
   (o) dist sup MEAN bf16, b_loc 4096, the pretransform on (a [., 2H]
       payload): 8 host-built batches (build_dist_batch's host ms printed),
       make_dist_sup_step counted (a step: gather_rows 3, gather_mean 2,
       scatter_rows 7), bf16 lockstep; dist_step_ms against a local oracle
       with identical frontiers and no exchange (the layer-0 rows gathered
       by their x0 ids), whose first step's loss must equal the exchange's
       bit for bit; the halo overhead in ms and %;
   (p) dist plus_unsup MEAN f32, b_loc 128 (at 512 the score rule,
       ops/sddmm.py dense_block_pays, takes the gathered cosines and
       pair_scores would not run): counted (a pair_scores a step), float32
       lockstep;
   (q) full_graph_embeddings_sharded, MEAN f32 and MAX bf16, against
       full_graph_embeddings (kernel tolerances; bit-for-bit equality
       reported), launches, embed_all_ms and its profile;
   (r) the CLI through torchrun --standalone --nproc_per_node 1 -m
       graphsage_torch.cli, --pipeline dist and cached_dist (--table_cap 8
       --no_extend), bf16, 3 epochs on powerlaw:2000:10000 with --export
       (served through InferenceSession.from_bundle, equal to
       full_graph_embeddings), then resumed from its epoch-0 checkpoint:
       epochs 1-2's mean loss and val F1 must equal the unbroken run's bit
       for bit.  Files under build/chip_smoke_dist.
   Kernel rows: gather_mean / gather_max at (n)'s refreshes, gather_rows
   and scatter_rows at (n)'s h1_full gather and (o)'s three exchange
   gathers, pair_scores at (p)'s step, gather_mean / gather_max at (q)'s
   layer 1.
12. The tensor-parallel ``model`` axis (parallel/mesh.py) at world 1 on
   NCCL (a (1 x 1) mesh: the column all-gather, the reduce-scatter of its
   backward, the partial logits' all-reduce and the norm's all-reduce are
   copies):
   (s) the tensor-parallel dense step (train.dense.make_dense_sup_step
       with the mesh) at (f)'s configuration, sup MEAN, batches of
       DENSE_B, TP_STEPS steps of the bench batches, float32 and bfloat16:
       launches counted by shape against the code's prediction (a step:
       gather_mean 2; in bfloat16 scatter_rows 4: both layers' aggregate
       and self-row gradients; gather_rows 0, the self rows are
       index_select); the loss curve and the final params equal
       make_dense_sup_step's without the mesh bit for bit, from the same
       params and generator state (deterministic algorithms on for both
       runs, so float32 index_add_ adds in a fixed order); ms_per_step and
       edges/s of both steps, the world-1 column all-gather and
       reduce-scatter of [DENSE_B·11, 128] float32, the idle share of an
       epoch; one step under utils.obs.profile, its trace's path and
       breakdown (trace_breakdown) printed;
   (t) the shapes a model rank of a 2-way model axis launches, which one
       card cannot run as two ranks (NCCL refuses two ranks on one
       device): gather_mean over the [100000, 64] agg half of layer 1's
       pretransform at row stride 128, idx [45056, 11], float32 and
       bfloat16, with its backward (the bfloat16 scatter_rows row at its
       shape); gather_rows on the 64-wide self half, float32 and bfloat16,
       and the bfloat16 scatter of its backward; held against the plain
       versions as the other rows are (launches 0: world 1 launches the
       128-wide shapes);
   (u) entry.dryrun_multichip(1): the four parallel programs' asserts.
13. The benchmark suites' row functions, in this process, on the same
   graph (graphsage_torch.bench and .infer_bench, the ports of bench.py and
   tools/infer_bench.py): the training rows powerlaw100k_b65536_cached_
   bfloat16 (the headline), powerlaw100k_b32768_cached_bfloat16_unsup and
   powerlaw100k_b32768_cached_float32 (bench.run_spec: a warm epoch, then
   three timed epochs, the refresh inside each), and the serving row
   powerlaw100k_cap32_bf16_max (infer_bench.serve_row).  Each row printed;
   its time finite and its launches (counted over one timed epoch, or one
   embed-all) equal to those predicted from the code (bench_launches,
   serving_launches); the serving row's embeddings finite; the headline's
   step_ms beside (e)'s ms_per_step and epoch time.  Kernel row:
   gather_rows at the float32 row's full-table gather (360,448 ids of its
   first batch's frontier over a [100000, 128] float32 table), with that
   row's launch count.
14. BASELINE.json's config 5 on the card, through the ports of the JAX
   system's four 1M-node tools, in this process: the graph
   (graphsage_torch.bigscale_bench.load_1m: 1,000,000 nodes, 10,000,000
   edges, 602 features, the width-32 table) generated once and timed, the
   [1000000, 602] bfloat16 feature table drawn on the card; hidden 128,
   fanout 10, the bench's seeds and batches:
   - bigscale_bench's rows 65536 (T 8) and 131072 (T 4), the direct
     refresh_every=4 cycle at 131072 (its k 8 runs in the module only, for
     time) and unsup at 32768 (T 16): each row's launches of a timed epoch
     equal to those the code predicts (big_launches: the layer-1 rule
     picks the full table at all three batches, so a step is one
     gather_rows and one scatter_rows, a refresh one gather_mean);
   - profile_bigscale (B 65536, 20 steps: the refresh, the steps alone,
     forward only, the first layer's gradient stopped, the device's busy
     time by kernel over a step-only epoch), its launches predicted;
   - step_anatomy's 1m workload at B 65536 on the same graph and table
     (phase 15's checks);
   - refresh_locality (the refresh under the raw and the BFS labeling);
   - infer_bench's powerlaw1M_cap16_bf16 serving row, its launches
     predicted;
   - train_1m_e2e with 2 epochs instead of 6 (a cut of scale only: epoch 1
     still reuses epoch 0's cache under refresh_every=4; the graph, the 64
     features, the batch of 65536 and the evaluation of every val and test
     node are not cut), on a second, 64-wide generation (timed), then
     the module's idle probe (one more train epoch, traced): its launches
     equal to trainer_launches' prediction (per occurrence at D 64: two
     gather_rows a step, no scatter), its losses finite and falling, its
     val F1 printed.
   Held against the plain versions on the main path's own inputs: the
   first refresh, in blocks of 50,000 rows (its plain [U, S, D] gather
   would not fit whole); each recorded full-table gather_rows (equal to
   index_select) and the scatter_rows of its recorded gradient (equal to
   the plain version on the card and on the CPU), whole.  Kernel rows:
   gather_mean at both refreshes and at the serving row's layers (plain_ms
   the sum of its blocks), gather_rows and scatter_rows at the three
   full-table shapes, gather_rows at train_1m_e2e's per-occurrence gather.
15. The ports of the JAX system's anatomy tools, in this process, on phase
   3's graph, before phase 14 (and step_anatomy's 1m workload inside it):
   - step_anatomy (the 100k workload, B 65536, bfloat16: each slice of the
     cached step a warm call and 20 timed calls): every slice finite and
     above 0, the derived slices equal to the JAX tool's formulas, each
     slice's launches equal to those the code predicts
     (anatomy_launches);
   - profile_cached (B 32768, both compute dtypes, 30 iterations a call;
     the isolated rows at 360,448 uniform rolled ids): every row's time
     finite, its launches as predicted;
   - profile_unsup ([4096 x 32768] pair-loss blocks, H 128, bfloat16, and
     the sup and unsup epochs at batch 32768): the three blocks' loss and
     gradient within the bfloat16 bars of one another (loss rtol 1e-2,
     gradient within 2e-2 of its largest element), launches as predicted.
   Kernel rows: pair_scores at [4096 x 32768], H 128, bfloat16, with
   dense_pair_scores' device time beside it (the input of
   dense_block_pays); gather_rows (float32 and bfloat16) and the bfloat16
   scatter_rows at profile_cached's 360,448 uniform ids over [100000, 128].
   step_anatomy's scatter_bound is printed beside its chain bound: its
   rows are all ones, and the frontier's padding slots all name row 0.
16. The ports of the JAX system's scaling tools, in this process, on phase
   3's graph, after phase 15:
   - halo_overhead chip (b_loc 4096, bfloat16, world 1 over NCCL): the
     dist step and the JAX tool's local oracle (the layer-0 rows gathered
     from the raw table, no exchange), its row beside phase 11 (o)'s
     overhead; the first losses of the two programs within
     BF16_LOSS_RTOL, each chain's launches equal to those the code
     predicts (halo_chip_launches);
   - scaling_bench halo and cached at their defaults (float32, b_loc
     256), world 1 over NCCL: edges/s, launches as predicted
     (scaling_launches);
   - pairs_scale_bench in full, GS_EXACT_NEG_BUDGET_S at its default
     (the auto rule's estimate logged first): auto picks exact.
   Kernel rows: every launch of gather_rows, gather_mean and scatter_rows
   in those three runs is recorded by kernel and shapes (kernel_calls);
   each shape gets a row on the arguments of its first launch, with the
   launches at that shape, all timed on a cold L2 (the paths rewrite
   their tables between launches, and the smaller working sets would
   otherwise stay in the 50 MB L2 between timed launches).
17. The ports of the JAX system's quality and ablation tools, in this
   process, after phase 16, on stand-ins of Cora's shape (2,708 nodes,
   5,429 edges drawn, 1,433 features, 7 classes) and Pubmed's (19,717,
   44,338, 500, 3) from synthetic_power_law(seed 824), 40% of their labels
   redrawn (LABEL_NOISE) so that F1 stays below 1, exact negatives at
   their default budget; every F1 printed is a stand-in's.  The tools'
   widths (2 layers, hidden 128, the full feature width), batches and
   protocols; cut: max_seed_study's epochs, 25 of 50 (STUDY_EPOCHS):
   - validate_cached in float32 and bfloat16 (b_sz 512, 50 epochs);
   - staleness_quality at k 1, 2, 4, 8 on both stand-ins (50 epochs);
   - max_seed_study over its five seeds (compact MAX, b_sz 20);
   - prefetch_bench sup and unsup at depths 0 and 2 (b_sz 128, a warm and
     3 timed epochs), then once more under deterministic algorithms,
     where both depths must end with bit-equal params;
   - profile_dense at its defaults (cap 32, b 512, 50 steps).
   Every best val F1 lies below 1 and above the floor halfway between the
   most common val label's share and the share of val labels left as the
   features say (standin); validate_cached's float32 and bfloat16 best
   val F1s within DTYPE_F1_GAP.  Each run's launches, counted from 0,
   equal those predicted from the code (validate_launches,
   trainer_launches, compact_launches over the batches the Trainers
   built, profile_dense's one gather_mean a layer a step).  Kernel rows
   as in phase 16, now also for gather_max, its gather_max_bwd (two rows:
   the tie split and the whole backward) and pair_scores: every launch
   shape of the five runs, on a cold L2.
18. The bfloat16 pretransform (csrc/pretransform.cu), after phase 3:
   the kernel against its plain version at serving's two MEAN layers on
   config 5, [1M, 602] and [1M, 128] -> 256 (three_piece_check: each
   element within one bfloat16 ulp plus 2^-20 of |h| @ |w|.T), with its
   row (library_ms: the upcast, float32 SGEMM and cast it replaced;
   bf16_mm_ms: a one-piece bfloat16 torch.mm); then a 1M-node MEAN
   bfloat16 serving pass over a width-16 table: launches equal to one
   pretransform and one gather_mean a layer, its table within a row gap
   of 0.01 of the same pass through the float32 path, and the two passes
   timed in turns.
19. The pool transform's bias-and-relu epilogue, after phase 18: the
   epilogue kernel against pretransform_plain with the bias at serving's
   two POOL layers on sage_pool_reddit, [232965, 602] and [232965, 256]
   -> 512, under phase 18's bar, with its row (library_ms: upcast, float32
   SGEMM, bias, relu and cast; the bound counts the algorithm's products
   and bytes, as the benchmark's pool_roofline.embed does); then a
   232,965-node POOL bfloat16 serving pass over a width-25 table: launches
   equal to one pretransform and one gather_max a layer, its table within
   a row gap of 0.01 of the same pass through the float32 pool transform,
   and the two passes timed in turns.

Tolerances: float32 rtol=atol=1e-5; bfloat16 within 2 bf16 ulps of the
reference value (the two versions may sum in different orders); MAX and the
row gather exact;
bfloat16 pair scores within 2 ulps plus 1e-5 (SCORES_BF16_ATOL).
Gradients: float32 rtol=atol=1e-5 (float32 scatters are index_add_,
atomics in no fixed order); bfloat16 scatter-adds keep JAX's order
(ops/scatter.py), so a bfloat16 gradient on the card equals the same one
on the CPU bit for bit.  Training, kernels against plain versions in lockstep:
float32 step losses rtol LOSS_RTOL, params after each step atol PARAM_ATOL;
bfloat16 losses rtol BF16_LOSS_RTOL, each step's update within
BF16_UPDATE_RTOL of its largest element (see those constants).

The last lines are a JSON object of per-kernel results, the card's name and
power limit from nvidia-smi, and the result line
{"ok": true, "device": {...}}.  Matrix products run in full float32
(TF32 off).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import signal
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from graphsage_torch import (bench, bigscale_bench, cli, halo_overhead,
                             infer, infer_bench, max_seed_study, microbench,
                             pairs_scale_bench, prefetch_bench,
                             profile_bigscale, profile_cached, profile_dense,
                             profile_unsup, refresh_locality, scaling_bench,
                             staleness_quality, step_anatomy, train_1m_e2e,
                             validate_cached)
from graphsage_torch.convert import flatten_params, params_to_numpy
from graphsage_torch.data import (CSRGraph, PaddedAdjacency,
                                  synthetic_power_law)
from graphsage_torch.microbench import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                        HBM_BYTES_PER_S, cold_ms, cuda_ms,
                                        device_ms, times)
from graphsage_torch.models import (GraphSageConfig, graphsage,
                                    init_classifier, init_graphsage, layers,
                                    lstm_agg)
from graphsage_torch.native import build as native_build
from graphsage_torch.ops import aggregate as agg
from graphsage_torch.models.layers import mean_pretransform
from graphsage_torch.ops import build, gather, scatter, sddmm
from graphsage_torch.ops import pretransform as pt
from graphsage_torch.entry import dryrun_multichip
from graphsage_torch.parallel import comm, halo, multihost
from graphsage_torch.parallel import mesh as pmesh
from graphsage_torch.sampler import PairSampler
from graphsage_torch.sampler.compact import _bucket
from graphsage_torch.sampler.device import HopSampler
from graphsage_torch.train import (CachedTrainer, Trainer, TrainConfig,
                                   cached, cached_dist, dense, distributed,
                                   micro_f1)
from graphsage_torch.train.optim import tree_leaves
from graphsage_torch.train.trainer import _leaf_params
from graphsage_torch.utils import obs

NODES, EDGES, FEATS, CLASSES, WIDTH, HIDDEN = (100_000, 1_000_000, 602, 16,
                                               32, 128)
CONFIGS = (("MEAN", "float32"), ("MEAN", "bfloat16"), ("MAX", "bfloat16"),
           ("LSTM", "float32"))
SOURCE = "graphsage_torch/csrc/aggregate.cu"
SCORE_SOURCE = "graphsage_torch/csrc/sddmm.cu"
GATHER_SOURCE = "graphsage_torch/csrc/gather.cu"
SCATTER_SOURCE = "graphsage_torch/csrc/scatter.cu"
# scatter_rows: the XLA scatter of the Pallas aggregates' VJP
# (_pallas_mean_bwd), which jnp.take's VJP shares
REPLACES = {"gather_mean": "graphsage_tpu/ops/pallas_aggregate.py:60",
            "gather_max": "graphsage_tpu/ops/pallas_aggregate.py:76",
            "pair_scores": "graphsage_tpu/ops/sddmm.py:156",
            "gather_rows": "tools/pallas_microbench.py:87",
            "scatter_rows": "graphsage_tpu/ops/pallas_aggregate.py:147",
            "gather_max_bwd": "graphsage_tpu/ops/pallas_aggregate.py:173"}
TRAIN_NODES, B_SZ, LR, FANOUT, SEED = 1000, 20, 0.7, 10, 824
# kernels against plain versions, step by step from the same params (see
# train_method): the pair-score kernel sums in another order than
# torch.matmul and index_add_ adds with atomics, so a step's loss and
# update differ in the last bits (PERF.md, training section)
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
# bfloat16 scores: both versions sum in float32 (in other orders, up to
# ~1e-5 apart at H=128) and round once; near 0, where the sum cancels,
# that difference is many bf16 ulps, so 2 ulps plus this absolute term
SCORES_BF16_ATOL = 1e-5
# bfloat16 training, kernels against plain versions in lockstep: the plain
# versions' autograd scatters bfloat16 contributions in other orders than
# JAX's (index_add_'s atomics, or a sort and float32 sums), so a step's
# update differs by bfloat16 roundings; the bars the CPU tests hold the
# port's bfloat16 step to against the JAX package's
BF16_LOSS_RTOL, BF16_UPDATE_RTOL = 1e-2, 2e-2
# ns of one dependent bfloat16 add on the card (add_latency, phase 1): the
# chain bound of a scatter_rows row
ADD_NS = 0.0
# the git-ignored directory the script's bundles and checkpoints go to
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def launch_counts(**counts: int) -> dict:
    """A launch count for every kernel of ``agg.LAUNCHES``: 0 where not
    given."""
    return {name: counts.get(name, 0) for name in agg.LAUNCHES}


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at |x| (8 significant bits)."""
    mag = x.abs().float().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                exact: bool = False, bf16_atol: float = 0.0) -> float:
    """Max abs error of got vs want; raises outside the stated tolerance.
    bf16_atol widens the bf16 tolerance where both sides round a float32
    result of cancelling sums (dot products near 0)."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if exact:
        ok = bool(torch.equal(got, want))
    elif want.dtype == torch.bfloat16:
        ok = bool((diff <= 2 * bf16_ulp(want) + bf16_atol).all())
    else:
        ok = bool((diff <= 1e-5 + 1e-5 * want.float().abs()).all())
    if not ok:
        raise AssertionError(f"{name}: max abs error {err} outside "
                             f"tolerance")
    return err


@contextlib.contextmanager
def patched(module, **attrs):
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


@contextlib.contextmanager
def keep_gathers(module, seen: list):
    """``module.gather_rows`` recording (table, idx, incoming gradient) of
    every call whose output carries a gradient."""
    def gather_rec(table, idx):
        out = gather.gather_rows(table, idx)
        if out.requires_grad:
            out.register_hook(lambda g: seen.append(
                (table.detach(), idx, g.detach())))
        return out

    with patched(module, gather_rows=gather_rec):
        yield


def plain_take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_rows' plain version: indexing, differentiated by autograd."""
    return table[idx.long()]


def plain_pretransform(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``ops.pretransform.pretransform``'s plain version on any device."""
    return pt.pretransform_plain(h, pt.split_weight(w))


@contextlib.contextmanager
def routed_pretransforms(into: list):
    """Records the calls of ``models.graphsage``'s mean_pretransform that
    its rule sends to the pretransform kernel: a bfloat16 table in a call
    autograd would not record.  One pretransform launch each."""
    real = graphsage.mean_pretransform

    def rec(w, h, gcn=False):
        if h.dtype == torch.bfloat16 and not (torch.is_grad_enabled() and (
                h.requires_grad or w.requires_grad)):
            into.append(tuple(h.shape))
        return real(w, h, gcn=gcn)

    with patched(graphsage, mean_pretransform=rec):
        yield


@contextlib.contextmanager
def plain_aggregates():
    """Serving through the plain versions on the card (the reference run):
    the LSTM's slot gather through index_select."""
    with patched(infer, mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain), \
            patched(lstm_agg, gather_rows=gather.gather_rows_plain):
        yield


# ------------------------------------------------------------ small oracle

def numpy_oracle(params, cfg, feats, g: CSRGraph) -> np.ndarray:
    """Layer-wise propagation over full neighbour sets in float64 (the
    reference's aggregation semantics, src/models.py:291-330)."""
    h = feats.astype(np.float64)
    for layer in range(cfg.num_layers):
        w = params["layers"][layer]["weight"].double().numpy()
        out = np.zeros((g.num_nodes, w.shape[0]))
        for v in range(g.num_nodes):
            neigh = [u for u in g.neighbors(v) if u != v]
            members = ([v] + neigh) if cfg.gcn else neigh
            agg_v = np.zeros(h.shape[1])
            if members:
                rows = h[np.asarray(members)]
                agg_v = rows.mean(0) if cfg.agg_func == "MEAN" else rows.max(0)
            combined = agg_v if cfg.gcn else np.concatenate([h[v], agg_v])
            out[v] = np.maximum(combined @ w.T, 0.0)
        h = out
    return h


def small_graph_check(dev: torch.device) -> None:
    rng = np.random.RandomState(3)
    n = 37
    src = np.concatenate([np.arange(n), rng.randint(0, n, 90), [5]])
    dst = np.concatenate([(np.arange(n) + 1) % n, rng.randint(0, n, 90), [5]])
    g = CSRGraph.from_edges(n, src, dst)
    feats = rng.randn(n, 12).astype(np.float32)
    for agg_func in ("MEAN", "MAX"):
        for gcn in (False, True):
            cfg = GraphSageConfig(num_layers=2, input_size=12, out_size=8,
                                  agg_func=agg_func, gcn=gcn)
            params = init_graphsage(torch.Generator().manual_seed(0), cfg)
            got = infer.full_graph_embeddings(params, cfg, feats,
                                              g.to_padded(), device=dev)
            want = numpy_oracle(params, cfg, feats, g)
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    log("small graph: MEAN/MAX x gcn on the card match the float64 oracle "
        "(rtol 2e-4, atol 2e-5)")


# ------------------------------------------------------------ kernel rows

def kernel_row(name: str, label: str, embed: torch.Tensor,
               idx: torch.Tensor, mask: torch.Tensor,
               launches: int, block: int | None = None,
               cold: bool = False) -> dict:
    """The kernel against its plain version, and its row.  With ``block``
    the plain version runs on blocks of that many rows of idx (its
    [U, S, D] gather would not fit whole): the check goes block by block
    and ``plain_ms`` is the sum of the blocks' times.  With ``cold`` every
    time is taken on a cold L2 (``microbench.times``)."""
    kernel = agg.mean_aggregate if name == "gather_mean" else agg.max_aggregate
    plain = (agg.mean_aggregate_plain if name == "gather_mean"
             else agg.max_aggregate_plain)
    got = kernel(embed, idx, mask)
    torch.cuda.synchronize()
    u = idx.shape[0]
    blocks = [(lo, min(lo + (block or u), u))
              for lo in range(0, u, block or u)]
    err = max(check_close(f"{name} {label} rows {lo}:{hi}", got[lo:hi],
                          plain(embed, idx[lo:hi], mask[lo:hi]),
                          exact=name == "gather_max")
              for lo, hi in blocks)

    valid = mask > 0
    u, s = idx.shape
    d = embed.shape[1]
    rows_read = int(torch.unique(idx[valid]).numel())
    n_valid = int(valid.sum())
    nbytes = (rows_read * d * embed.element_size() + idx.numel() * 4
              + mask.numel() * 4 + u * d * embed.element_size())
    ops = n_valid * d * (2 if name == "gather_mean" else 1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S

    if name == "gather_mean":
        weights = (mask / mask.sum(1, keepdim=True).clamp_min(1.0)).to(
            embed.dtype)
        library = lambda: F.embedding_bag(idx, embed, mode="sum",
                                          per_sample_weights=weights)
        library_note = "F.embedding_bag(mode='sum', per_sample_weights)"
    else:
        flat = idx[valid]
        offsets = torch.zeros(u, dtype=idx.dtype, device=idx.device)
        offsets[1:] = valid.sum(1).cumsum(0)[:-1].to(idx.dtype)
        library = lambda: F.embedding_bag(flat, embed, offsets, mode="max")
        library_note = "F.embedding_bag(mode='max') over the valid slots"
    library_err = float((library().float() - got.float()).abs().max())

    timer = cold_ms if cold else cuda_ms
    row = {
        "name": f"{name} ({label})",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": err,
        **times(lambda: kernel(embed, idx, mask), "gather_reduce_kernel",
                library=library, reps=20, cold=cold),
        "plain_ms": (timer(lambda: plain(embed, idx, mask), reps=5)
                     if block is None else
                     sum(timer(lambda: plain(embed, idx[lo:hi],
                                             mask[lo:hi]), reps=1,
                               warmup=1) for lo, hi in blocks)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    if block is not None:
        row["plain_blocks"] = len(blocks)
    log(f"kernel {row['name']}: embed {tuple(embed.shape)} stride "
        f"{embed.stride(0)} {embed.dtype}, idx {tuple(idx.shape)}, "
        f"{n_valid} valid slots, {rows_read} rows read, {nbytes} bytes; "
        f"{timing_note(row)}"
        f"{'' if block is None else f' (plain in {len(blocks)} blocks)'} "
        f"[{library_note}, max abs diff to the kernel {library_err}] "
        f"max_abs_err {err}")
    return row


def timing_note(row: dict) -> str:
    library = ("library_ms none" if row["library_ms"] is None else
               f"library_ms {row['library_ms']:.6f} library_device_ms "
               f"{row['library_device_ms']:.6f}")
    return (f"ms {row['ms']:.6f} device_ms {row['device_ms']:.6f} host_us "
            f"{row['host_us']:.3f} bound_ms {row['bound_ms']:.6f} "
            f"({row['bound_ms'] / row['device_ms']:.0%} of it) plain_ms "
            f"{row['plain_ms']:.6f} {library}")


# ------------------------------------------------------------ serving

def profile_device(fn, wall_ms: float, what: str = "embed_all_ms",
                      top: int = 8) -> float | None:
    """Device kernel time by kernel over one call of fn (torch.profiler),
    and the device's idle share against the warm wall time of that call.
    The port's own kernels are listed even when they are not in the top.
    Returns the busy ms (None when the profiler recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(evt.self_device_time_total, evt.key, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total]
    if not rows:
        log("  profile: no device time recorded (not measured)")
        return None
    busy = sum(t for t, _, _ in rows) / 1e3
    log(f"  profile: device busy {busy:.6f} ms of {what} "
        f"{wall_ms:.6f} (idle share {1 - busy / wall_ms:.4f}); by kernel:")
    ours = ("gather_reduce_kernel", "gather_max_bwd_kernel",
            "pair_scores_kernel", "gather_rows_kernel", "count_kernel",
            "place_kernel", "sum_kernel")
    for rank, (t, key, count) in enumerate(sorted(rows, reverse=True)):
        if rank < top or any(name in key for name in ours):
            log(f"    {t / 1e3:10.6f} ms  x{count:<3d} {key[:100]}")
    return busy


def serving_launches(cfg: GraphSageConfig, lstm_hybrid: bool) -> dict:
    """The launches of one embeddings() call, from the code's rule: one
    gather_mean / gather_max a MEAN / MAX layer, and a gather_rows a block
    of an LSTM layer (infer.card_block at the layer's input width); a
    bfloat16 MEAN layer's pretransform one pretransform."""
    want = launch_counts()
    itemsize = graphsage.compute_dtype(cfg).itemsize
    for layer in range(cfg.num_layers):
        agg_func = "MEAN" if lstm_hybrid and layer == 0 else cfg.agg_func
        if agg_func == "LSTM":
            block = infer.card_block("LSTM", NODES, WIDTH + cfg.gcn,
                                     cfg.layer_input_size(layer), itemsize)
            want["gather_rows"] += -(-NODES // block)
        else:
            want["gather_mean" if agg_func == "MEAN" else "gather_max"] += 1
        if agg_func == "MEAN" and cfg.compute_dtype == "bfloat16":
            want["pretransform"] += 1
    return want


def serve_config(tag: str, cfg: GraphSageConfig, params: dict,
                 feats: torch.Tensor, pad, n_valid: int, dev: torch.device,
                 lstm_hybrid: bool = False) -> tuple[dict, list]:
    """Phase 3 for one model: the counted main path, embed_all_ms, the
    device profile, the table against the plain versions, and the kernel
    rows at its layers' shapes."""
    dtype = cfg.compute_dtype
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, NODES, size) for size in (1, 64, 4096)]

    # -------- the main path, counted
    agg.reset_launches()
    t0 = time.perf_counter()
    sess = infer.InferenceSession(params, cfg, feats, pad,
                                  lstm_hybrid=lstm_hybrid, device=dev)
    emb = sess.embeddings()
    preds = []
    for nodes in batches:
        lp = sess.log_probs(nodes)
        preds.append(sess.predict(nodes))
        assert lp.shape == (len(nodes), CLASSES) and np.isfinite(lp).all()
        np.testing.assert_allclose(np.exp(lp).sum(1), 1.0, rtol=1e-4)
        np.testing.assert_array_equal(preds[-1], lp.argmax(1))
    scores = sess.score_pairs(batches[2][:100], batches[2][100:200])
    assert scores.shape == (100,) and (np.abs(scores) <= 1 + 1e-5).all()
    bundle = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "chip_smoke_bundles", tag.replace(" ", "_"))
    infer.export_bundle(bundle, params, cfg, CLASSES,
                        meta={"lstm_hybrid": True} if lstm_hybrid else None)
    again = infer.InferenceSession.from_bundle(bundle, feats, pad,
                                               device=dev)
    assert again.lstm_hybrid == lstm_hybrid
    np.testing.assert_array_equal(again.embeddings(), emb)
    for nodes, want in zip(batches, preds):
        np.testing.assert_array_equal(again.predict(nodes), want)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    # two embeddings() calls, two sessions
    want = {k: 2 * v for k, v in serving_launches(cfg, lstm_hybrid).items()}
    log(f"[{tag}] main path: 2 sessions, 3 batches, score_pairs, bundle "
        f"round trip in {serve_s:.3f} s; launches {launches}; predicted "
        f"from the code {want}")
    assert emb.shape == (NODES, HIDDEN) and np.isfinite(emb).all()
    assert np.abs(emb).sum() > 0
    assert launches == want, (launches, want)

    # -------- embed-all time (warm, device-resident inputs)
    def embed_all():
        return infer.full_graph_embeddings(sess.params["sage"], cfg,
                                           sess.feats, sess.pad, fetch=False,
                                           lstm_hybrid=lstm_hybrid,
                                           device=dev)

    embed_all()
    times = []
    for _ in range(5 if cfg.agg_func == "LSTM" else 20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        embed_all()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    log(f"[{tag}] embed_all_ms {ms:.6f} (median of {len(times)}; min "
        f"{min(times) * 1e3:.6f}, max {max(times) * 1e3:.6f}) nodes_per_s "
        f"{NODES / ms * 1e3:.1f} edge_slots_per_s "
        f"{2 * n_valid / ms * 1e3:.1f}")
    profile_device(embed_all, ms)

    # -------- whole table against the plain versions on the card
    table = embed_all()
    with plain_aggregates():
        ref = embed_all()
    err = check_close(f"[{tag}] embedding table vs plain", table, ref)
    log(f"[{tag}] embedding table vs plain versions on the card: max abs "
        f"error {err}")

    # -------- each kernel alone at its layer's shapes
    summary = {"config": tag, "embed_all_ms": ms}
    if lstm_hybrid:
        return summary, []    # its kernels have rows at MEAN's and LSTM's
    idx, mask = infer._slot_table(sess.pad.neighbors, sess.pad.degrees,
                                  cfg.gcn)
    h0 = sess.feats.to(getattr(torch, dtype))
    rows = []
    with torch.no_grad():
        if cfg.agg_func == "MEAN":
            from graphsage_torch.models.layers import mean_pretransform
            z = mean_pretransform(sess.params["sage"]["layers"][0]["weight"],
                                  h0)
            rows.append(kernel_row("gather_mean", f"{dtype}, both layers",
                                   z[:, HIDDEN:], idx, mask,
                                   launches["gather_mean"]))
        elif cfg.agg_func == "MAX":
            h1 = infer._layer_full(cfg, sess.params["sage"], 0, h0, idx,
                                   mask, NODES, "MAX")
            for layer, h in ((1, h0), (2, h1)):
                rows.append(kernel_row("gather_max", f"{dtype}, layer "
                                       f"{layer}", h, idx, mask,
                                       launches["gather_max"]))
        else:
            block = infer.card_block("LSTM", NODES, idx.shape[1], FEATS,
                                     h0.element_size())
            rows.append(gather_row(
                f"serving LSTM layer-1 block, {block} x {idx.shape[1]} ids "
                f"over [{NODES}, {FEATS}]", h0, idx[:block].reshape(-1),
                launches["gather_rows"]))
    return summary, rows


# ------------------------------------------------------------ training

@contextlib.contextmanager
def plain_training():
    """Training through the plain versions on the card (the reference
    run): autograd differentiates them (max_aggregate_plain's amax splits
    ties equally; the LSTM's slot gather is index_select); a bfloat16
    evaluation's pretransform takes the three pieces' plain product."""
    with patched(graphsage, mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain,
                 take_rows=plain_take), \
            patched(layers, pretransform=plain_pretransform), \
            patched(scatter, take_rows=plain_take), \
            patched(lstm_agg, gather_rows=gather.gather_rows_plain), \
            patched(sddmm, pair_scores=sddmm.dense_pair_scores):
        yield


def make_trainer(ds, method: str, dev: torch.device, agg_func: str = "MEAN",
                 gcn: bool = False, dtype: str = "float32") -> Trainer:
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          agg_func=agg_func, gcn=gcn, compute_dtype=dtype)
    tcfg = TrainConfig(learn_method=method, unsup_loss="normal", epochs=1,
                       b_sz=B_SZ, lr=LR, fanout=FANOUT, seed=SEED,
                       verbose=False)
    return Trainer(ds, cfg, tcfg, device=dev)


def bf16_scatters(cfg: GraphSageConfig, n: int, u0: int,
                  frontier_rows: list[int]) -> int:
    """scatter_rows launches of one bfloat16 training step through
    graphsage_apply_gathered (the compact and dense pipelines; float32
    scatters are index_add_): a layer whose input carries a gradient
    scatters its aggregate's backward once and, unless gcn, its self-row
    gather's once.  Layer 1 reads the constant feature table [n, FEATS]
    through u0 gathered rows; its input carries a gradient only where it is
    transformed first (the whole table, or the MEAN pretransform of the
    gathered rows, by the models' own rules); every later layer's does."""
    if cfg.compute_dtype != "bfloat16":
        return 0
    per_layer = 1 if cfg.gcn else 2
    table = (cfg.agg_func == "MEAN" and cfg.mean_pretransform != "never"
             and cfg.impl != "pallas"
             and (cfg.mean_pretransform == "always" or n <= 2 * u0))
    first = table or graphsage._use_pretransform(
        cfg, torch.empty(u0, FEATS, device="meta"),
        graphsage.Frontier(idx=torch.empty(frontier_rows[0], 1,
                                           device="meta"),
                           mask=None, self_idx=None))
    return per_layer * (int(first) + cfg.num_layers - 1)


def compact_launches(cfg: GraphSageConfig, method: str, step_args: list,
                     evals: int, pretransforms: int = 0) -> dict:
    """What the compact Trainer launches in a fit: per encode (each step,
    and each evaluation embedding) one aggregate kernel a layer
    (gather_mean, gather_max, or gather_rows for the LSTM's slot gather);
    per step under an unsupervised loss one pair_scores where
    sddmm.dense_block_pays picks the score block for the step's pair batch;
    and for MAX one gather_max_bwd (the backward's tie split) a
    differentiated layer a step (every layer above the first: the first
    aggregates constant feature rows); in bfloat16, the backward's
    scatter_rows by bf16_scatters, and one pretransform for each of the
    evaluations' pretransforms (``pretransforms``, routed_pretransforms'
    count)."""
    steps = len(step_args)
    want = launch_counts(pretransform=pretransforms)
    kernel = {"MEAN": "gather_mean", "MAX": "gather_max",
              "LSTM": "gather_rows"}[cfg.agg_func]
    want[kernel] += cfg.num_layers * (steps + evals)
    if cfg.agg_func == "MAX":
        want["gather_max_bwd"] += (cfg.num_layers - 1) * steps
    for pb, cb, _, _ in step_args:
        want["scatter_rows"] += bf16_scatters(
            cfg, NODES, len(cb.x0_ids), [f.idx.shape[0] for f in cb.frontiers])
        if method != "sup":
            want["pair_scores"] += sddmm.dense_block_pays(
                pb.target_rows.shape[0], cb.out_rows,
                pb.pos_q.size + pb.neg_q.size, cfg.out_size)
    return want


def fit_timed(tr: Trainer, before=None, after=None,
              step_args: list | None = None) -> tuple[list[float], float]:
    """Trainer.fit for one epoch, with each step synchronised and timed on
    the host clock; before(i) / after(i) run around step i, outside the
    timed window, and each step's host batch is appended to ``step_args``
    when given.  Returns (step ms, fit seconds)."""
    step_ms = []
    step = tr._step

    def timed_step(*args):
        i = len(step_ms)
        if step_args is not None:
            step_args.append(args)
        if before is not None:
            before(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(*args)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if after is not None:
            after(i)
        return loss

    tr._step = timed_step
    try:
        t0 = time.perf_counter()
        tr.fit()
        fit_s = time.perf_counter() - t0
    finally:
        tr._step = step
    return step_ms, fit_s


def snapshot(params) -> list[torch.Tensor]:
    return [p.detach().clone() for p in tree_leaves(params)]


def param_snapshot(tr: Trainer) -> list[torch.Tensor]:
    return snapshot(tr.params)


def max_abs_diff(a: list[torch.Tensor], b: list[torch.Tensor]) -> float:
    return max(float((x.detach() - y).abs().max()) for x, y in zip(a, b))


def update_error(got: list, want: list, before: list) -> float:
    """How far the update ``got - before`` lies from ``want - before``,
    relative to the largest element of the latter, the worst leaf."""
    worst = 0.0
    for g, w, b in zip(got, want, before):
        scale = float((w - b).abs().max())
        err = float((g.detach() - w).abs().max())
        worst = max(worst, err / scale if scale else
                    (0.0 if err == 0 else float("inf")))
    return worst


def assert_lockstep(tag: str, dtype: str, loss_rel: list, abs_errs: list,
                    upd_errs: list) -> None:
    """float32: step losses within LOSS_RTOL and params after each step
    within PARAM_ATOL; bfloat16: losses within BF16_LOSS_RTOL and each
    step's update within BF16_UPDATE_RTOL of its largest element."""
    bf16 = dtype == "bfloat16"
    log(f"{tag} lockstep, kernels vs plain versions over {len(loss_rel)} "
        f"steps: step loss max relative difference {max(loss_rel):.3e} "
        f"(step {int(np.argmax(loss_rel)) + 1}; tolerance "
        f"{BF16_LOSS_RTOL if bf16 else LOSS_RTOL}); params after each step "
        f"max abs difference {max(abs_errs):.3e}"
        f"{'' if bf16 else f' (tolerance {PARAM_ATOL})'}; update max "
        f"difference {max(upd_errs):.3e} of its largest element"
        f"{f' (tolerance {BF16_UPDATE_RTOL})' if bf16 else ''}")
    if bf16:
        assert max(loss_rel) <= BF16_LOSS_RTOL, loss_rel
        assert max(upd_errs) <= BF16_UPDATE_RTOL, upd_errs
    else:
        assert max(loss_rel) <= LOSS_RTOL, loss_rel
        assert max(abs_errs) <= PARAM_ATOL, abs_errs


def capture_step_inputs(tr: Trainer) -> dict:
    """The tensors each kernel of one training step is called with: one
    more batch built and stepped (after the counted run) with recorders in
    front of the kernels' wrappers."""
    seen = {"gather_mean": [], "gather_max": [], "pair_scores": [],
            "gather_rows": []}

    def mean_rec(embed, idx, mask):
        seen["gather_mean"].append((embed.detach(), idx, mask))
        return agg.mean_aggregate(embed, idx, mask)

    def max_rec(embed, idx, mask):
        seen["gather_max"].append((embed.detach(), idx, mask))
        return agg.max_aggregate(embed, idx, mask)

    def rows_rec(table, idx):
        seen["gather_rows"].append((table.detach(), idx))
        return gather.gather_rows(table, idx)

    def scores_rec(emb, target_rows, eps=1e-8):
        seen["pair_scores"].append((emb.detach(), target_rows))
        return sddmm.PairScores.apply(emb, target_rows, eps)

    nodes = tr.ds.train_nodes[:B_SZ]
    with patched(graphsage, mean_aggregate=mean_rec, max_aggregate=max_rec), \
            patched(lstm_agg, gather_rows=rows_rec), \
            patched(sddmm, pair_scores=scores_rec):
        tr._step(*tr._build_train_batch(nodes))
    torch.cuda.synchronize()
    return seen


def train_method(method: str, ds, dev: torch.device, agg_func: str = "MEAN",
                 gcn: bool = False, free_running: bool = True,
                 dtype: str = "float32") -> dict:
    """One epoch of `method` through the kernels (counted), held step by
    step against the plain versions; returns what the kernel rows need.

    The plain run is in lockstep: before each of its steps it takes the
    kernel run's params from before that step, so each step's loss and
    update are compared from the same params and the same host batch.
    A free-running plain epoch (MEAN only) is printed beside it, not
    asserted: under plus_unsup, SGD at lr 0.7 can carry a last-bit
    difference (index_add_'s atomics, another order of the score sums) to
    an O(1) one within 50 steps."""
    tag = (f"[train {method}{'' if agg_func == 'MEAN' else ' ' + agg_func}"
           f"{' gcn' if gcn else ''}{' bf16' if dtype == 'bfloat16' else ''}"
           f"]")
    tr = make_trainer(ds, method, dev, agg_func, gcn, dtype)
    snaps, step_args, routed = [], [], []
    agg.reset_launches()
    with routed_pretransforms(routed):
        step_ms, fit_s = fit_timed(tr, before=lambda i: snaps.append(
            param_snapshot(tr)), step_args=step_args)
    launches = dict(agg.LAUNCHES)
    snaps.append(param_snapshot(tr))
    steps = len(step_ms)
    assert steps == TRAIN_NODES // B_SZ, steps
    val_f1 = tr.history[-1]["val_f1"]
    evals = 1 + ("test_f1" in tr.history[-1])
    want = compact_launches(tr.mcfg, method, step_args, evals, len(routed))
    log(f"{tag} main path: Trainer.fit, {steps} steps + {evals} evaluation "
        f"embeddings in {fit_s:.3f} s; launches {launches}; predicted from "
        f"the code {want}")
    assert launches == want, (launches, want)

    ref = make_trainer(ds, method, dev, agg_func, gcn, dtype)
    step_errs, upd_errs = [], []

    def load(i):
        with torch.no_grad():
            for p, q in zip(tree_leaves(ref.params), snaps[i]):
                p.copy_(q)

    agg.reset_launches()
    def compare(i):
        got = tree_leaves(ref.params)
        step_errs.append(max_abs_diff(got, snaps[i + 1]))
        upd_errs.append(update_error(got, snaps[i + 1], snaps[i]))

    with plain_training():
        plain_ms, plain_s = fit_timed(ref, before=load, after=compare)
    assert sum(agg.LAUNCHES.values()) == 0, agg.LAUNCHES
    losses = np.asarray(tr.step_losses)
    ref_losses = np.asarray(ref.step_losses)
    assert np.isfinite(losses).all() and losses.shape == (steps,)
    rel = np.abs(losses - ref_losses) / np.abs(ref_losses)
    assert_lockstep(tag, dtype, list(rel), step_errs, upd_errs)
    del ref

    if free_running:
        free = make_trainer(ds, method, dev, agg_func, gcn)
        with plain_training():
            fit_timed(free)
        free_rel = (np.abs(losses - np.asarray(free.step_losses))
                    / np.abs(np.asarray(free.step_losses)))
        first = np.flatnonzero(free_rel > LOSS_RTOL)
        log(f"{tag} free-running plain epoch (not asserted): step loss "
            f"max relative difference {free_rel.max():.3e} (first above "
            f"{LOSS_RTOL}: step "
            f"{int(first[0]) + 1 if first.size else 'none'}); final params "
            f"max abs difference "
            f"{max_abs_diff(tree_leaves(free.params), snaps[-1]):.3e}; val "
            f"F1 {free.history[-1]['val_f1']:.6f}")
        del free

    tail = step_ms[5:]
    ref_tail = plain_ms[5:]
    log(f"{tag} ms_per_step {statistics.median(tail):.6f} (median of steps "
        f"6-{steps}; min {min(tail):.6f}, max {max(tail):.6f}); first step "
        f"{step_ms[0]:.6f}; plain versions "
        f"{statistics.median(ref_tail):.6f}; epoch + evaluation "
        f"{fit_s:.3f} s (plain versions {plain_s:.3f} s)")
    log(f"{tag} loss curve: " + " ".join(f"{x:.6f}" for x in losses))
    log(f"{tag} val F1 {val_f1:.6f}; history {tr.history}")

    # device busy and idle share over a 5-step epoch (same trainer, the
    # train split cut to 100 nodes), wall time from an unprofiled epoch
    tr.ds = dataclasses.replace(tr.ds, train_nodes=ds.train_nodes[:100])
    tr.train_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag} 5-step epoch {wall:.6f} ms (warm, prefetch on)")
    profile_device(tr.train_epoch, wall, what="5-step epoch ms", top=12)
    tr.ds = ds
    return {"trainer": tr, "launches": launches,
            "ms_per_step": statistics.median(tail)}


# ------------------------------------------------------------ pair scores

def scores_row(label: str, emb: torch.Tensor, target_rows: torch.Tensor,
               launches: int, cold: bool = False) -> dict:
    """The pair-score kernel against its plain version (forward in float32
    and bfloat16, gradient through PairScores), and its kernel row (with
    ``cold``, timed on a cold L2)."""
    got = sddmm.pair_scores_kernel(emb, target_rows)
    torch.cuda.synchronize()
    err = check_close(f"pair_scores {label}", got,
                      sddmm.dense_pair_scores(emb, target_rows),
                      bf16_atol=SCORES_BF16_ATOL)
    e16 = emb.bfloat16()
    err16 = check_close(f"pair_scores {label} bf16",
                        sddmm.pair_scores_kernel(e16, target_rows),
                        sddmm.dense_pair_scores(e16, target_rows),
                        bf16_atol=SCORES_BF16_ATOL)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(5)
                    ).to(emb.device)
    grads = []
    for fn in (sddmm.PairScores.apply, sddmm.dense_pair_scores):
        leaf = emb.detach().clone().requires_grad_(True)
        (fn(leaf, target_rows) * g).sum().backward()
        grads.append(leaf.grad)
    # bfloat16: both compute in float32 and round once; near 0 a float32
    # difference of the cancelling sums is many bf16 ulps
    grad_err = check_close(f"pair_scores {label} gradient", grads[0],
                           grads[1], bf16_atol=1e-5 * float(
                               grads[1].float().abs().max()))

    b, (u, h) = target_rows.shape[0], emb.shape
    es = emb.element_size()
    nbytes = u * h * es + b * 4 + b * u * es
    ops = 2 * b * u * h + 3 * (u + b) * h
    # the peak of the inputs' type: bfloat16 at the tensor cores' rate
    rate = BF16_OPS_PER_S if emb.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    t_long = target_rows.long()
    library = lambda: torch.mm(F.normalize(emb[t_long], eps=1e-8),
                               F.normalize(emb, eps=1e-8).T)
    library_err = float((library() - got).abs().max())
    row = {
        "name": f"pair_scores ({label})",
        "route": "cuda",
        "source": SCORE_SOURCE,
        "replaces": REPLACES["pair_scores"],
        "launches": launches,
        "max_abs_err": err,
        **times(lambda: sddmm.pair_scores_kernel(emb, target_rows),
                "pair_scores_kernel", library=library,
                reps=20 if cold else 100, cold=cold),
        "plain_ms": (cold_ms if cold else cuda_ms)(
            lambda: sddmm.dense_pair_scores(emb, target_rows),
            reps=20 if cold else 50),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    log(f"kernel {row['name']}: emb {tuple(emb.shape)} stride "
        f"{emb.stride(0)} {emb.dtype}, {b} targets, {nbytes} bytes, {ops} "
        f"operations ({row['bound_by']}); {timing_note(row)} [torch.mm of "
        f"F.normalize'd rows, max abs diff to the kernel {library_err}] "
        f"max_abs_err {err} bf16 max_abs_err {err16} gradient max_abs_err "
        f"{grad_err}")
    return row


def score_rows(step_inputs: dict, launches: int, dev: torch.device) -> list:
    (emb, target_rows), = step_inputs["pair_scores"]
    rows = [scores_row(f"training step, {target_rows.shape[0]} x "
                       f"{emb.shape[0]}, H {emb.shape[1]}", emb,
                       target_rows, launches)]
    rng = np.random.RandomState(11)
    big = torch.from_numpy(rng.randn(2048, 128).astype(np.float32)).to(dev)
    rows.append(scores_row("512 x 2048, H 128", big, torch.from_numpy(
        rng.randint(0, 2048, 512).astype(np.int32)).to(dev), launches))
    ragged = rng.randn(1000, 100).astype(np.float32)
    ragged[[0, 17, 999]] = 0.0
    t = rng.randint(0, 1000, 3).astype(np.int32)
    t[0] = 17                                      # a zero-norm target
    rows.append(scores_row("ragged 3 x 1000, H 100, zero rows",
                           torch.from_numpy(ragged).to(dev),
                           torch.from_numpy(t).to(dev), launches))
    return rows


def on_cpu(fn, *args):
    """fn on CPU copies of the tensors in args (the plain versions run)."""
    return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                for a in args))


def add_latency(dev: torch.device) -> float:
    """ns of one dependent bfloat16 add on this card: one warp's chain of
    2**20 add.rn.bf16x2, timed by clock64 and %globaltimer
    (gs_scatter_add_latency, csrc/scatter.cu), the second of two calls."""
    lib = build.load_library("scatter")
    one = torch.ones(2, dtype=torch.bfloat16).view(torch.int32).item()
    inp = torch.tensor([0, one], dtype=torch.int32, device=dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    n = 1 << 20
    for _ in range(2):
        rc = lib.gs_scatter_add_latency(
            dev.index or 0, inp.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gs_scatter_add_latency: CUDA error {rc}")
    torch.cuda.synchronize()
    cycles, ns, _ = out.tolist()
    log(f"bf16 add latency: a chain of {n} dependent add.rn.bf16x2 in "
        f"{cycles} cycles, {ns} ns: {cycles / n:.4f} cycles, {ns / n:.6f} ns "
        f"an add (SM clock {cycles / ns:.4f} GHz)")
    return ns / n


def scatter_row(label: str, g: torch.Tensor, idx: torch.Tensor, m: int,
                launches: int, cold: bool = False) -> dict:
    """scatter_rows against its plain version on the card and on the CPU
    (bit for bit: both add in JAX's order), and its kernel row: the bound
    is the larger of the bytes (g read once, since the zero test reads
    every row, the ids, the output written once) over the HBM rate and the
    chain of the longest row's dependent adds at ADD_NS each (bound_by
    "operations"); the library call is index_add_ of the same rows
    (bfloat16 atomics, in another order), the plain version the
    rank-by-rank adds on the card.  With ``cold`` every time is taken on a
    cold L2 (``microbench.times``)."""
    g, idx = g.contiguous(), idx.reshape(-1).int().contiguous()
    got = scatter.scatter_rows_kernel(g, idx, m)
    torch.cuda.synchronize()
    assert torch.equal(got, scatter.scatter_rows_plain(g, idx, m)), label
    assert torch.equal(got.cpu(), on_cpu(scatter.scatter_rows_plain, g, idx,
                                         m)), label
    nonzero = (g != 0).any(dim=1)
    chain = int(torch.bincount(idx[nonzero].long(), minlength=m).max())
    j, d = g.shape
    nbytes = j * d * 2 + j * 4 + m * d * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    chain_ms = chain * ADD_NS / 1e6
    long_idx = idx.long()
    row = {
        "name": f"scatter_rows ({label})",
        "route": "cuda",
        "source": SCATTER_SOURCE,
        "replaces": REPLACES["scatter_rows"],
        "launches": launches,
        "max_abs_err": 0.0,
        **times(lambda: scatter.scatter_rows_kernel(g, idx, m), None,
                library=lambda: torch.zeros(m, d, dtype=g.dtype,
                                            device=g.device).index_add_(
                                                0, long_idx, g), reps=20,
                cold=cold),
        "plain_ms": (cold_ms if cold else cuda_ms)(
            lambda: scatter.scatter_rows_plain(g, idx, m), reps=2,
            warmup=1),
        "bound_ms": max(bytes_ms, chain_ms),
        "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
        "bytes_ms": bytes_ms,
        "chain_ms": chain_ms,
    }
    log(f"kernel {row['name']}: g {tuple(g.shape)} {g.dtype} into [{m}, "
        f"{d}], {int(nonzero.sum())} nonzero rows, {nbytes} bytes "
        f"({bytes_ms:.6f} ms), the longest row {chain} adds ({chain_ms:.6f} "
        f"ms at {ADD_NS:.6f} ns an add); the whole call (memset, count, "
        f"place, sum) {timing_note(row)} [index_add_, bfloat16 atomics]; "
        f"equal to the plain version on the card and on the CPU")
    return row


def bf16_backward_check(name: str, fn, embed: torch.Tensor, args: tuple,
                        g: torch.Tensor) -> None:
    """The bfloat16 gradient of sum(fn(embed, *args) * g) through the
    kernels equals the same from CPU copies (the plain versions) bit for
    bit."""
    grads = []
    for dev in (embed.device, torch.device("cpu")):
        leaf = embed.detach().to(dev).clone().requires_grad_(True)
        (fn(leaf, *(a.to(dev) for a in args)).float()
         * g.to(dev).float()).sum().backward()
        grads.append(leaf.grad)
    if not torch.equal(grads[0].cpu(), grads[1]):
        raise AssertionError(f"{name}: the card's bf16 gradient differs "
                             f"from the CPU's")


def mean_step_rows(step_inputs: dict, launches: int,
                   what: str = "training",
                   scatter_launches: int | None = None,
                   first_layer: int = 1) -> list:
    """gather_mean at the training step's layer shapes (the first is layer
    ``first_layer``): the kernel row, and the scatter-add gradient against
    autograd through the plain version (float32) or against the same
    gradient on the CPU (bfloat16, bit for bit), with a scatter_rows row at
    the backward's shape when ``scatter_launches`` is given."""
    rows = []
    for layer, (embed, idx, mask) in enumerate(step_inputs["gather_mean"],
                                               start=first_layer):
        bf16 = embed.dtype == torch.bfloat16
        label = f"{'bf16' if bf16 else 'f32'} {what} layer {layer}"
        rows.append(kernel_row("gather_mean", label, embed, idx, mask,
                               launches))
        g = torch.randn(idx.shape[0], embed.shape[1],
                        generator=torch.Generator().manual_seed(layer)
                        ).to(embed.device, embed.dtype)
        if bf16:
            bf16_backward_check(f"gather_mean {label}", agg.mean_aggregate,
                                embed, (idx, mask), g)
            err = 0.0
        else:
            grads = []
            for fn in (agg.mean_aggregate, agg.mean_aggregate_plain):
                leaf = embed.detach().clone().requires_grad_(True)
                (fn(leaf, idx, mask).float() * g.float()).sum().backward()
                grads.append(leaf.grad)
            err = check_close(f"gather_mean {label} gradient", grads[0],
                              grads[1])
        bwd = lambda: agg.mean_aggregate_backward(g, idx, mask, embed.shape,
                                                  embed.dtype)
        leaf = embed.detach().clone().requires_grad_(True)
        plain_out = agg.mean_aggregate_plain(leaf, idx, mask)
        plain_bwd = lambda: torch.autograd.grad(plain_out, leaf, g,
                                                retain_graph=True)
        against = ("equal to the CPU's bit for bit" if bf16 else
                   "max_abs_err against autograd through the plain version")
        log(f"  gather_mean {label} backward (scatter-add into "
            f"{list(embed.shape)}): {against} {err}; "
            f"{cuda_ms(bwd, reps=20):.6f} ms, device {device_ms(bwd):.6f} "
            f"ms; plain (autograd) device {device_ms(plain_bwd):.6f} ms")
        if bf16 and scatter_launches is not None:
            w = (mask / mask.sum(1, keepdim=True).clamp_min(1.0)).to(g.dtype)
            rows.append(scatter_row(
                f"{label} backward, {idx.numel()} rows into "
                f"{list(embed.shape)}",
                (g[:, None, :] * w[:, :, None]).reshape(-1, embed.shape[1]),
                idx, embed.shape[0], scatter_launches))
    return rows


def max_backward_composition(g: torch.Tensor, embed: torch.Tensor,
                             idx: torch.Tensor, mask: torch.Tensor,
                             out: torch.Tensor) -> torch.Tensor:
    """gather_max's backward as it was composed on the card before the
    gather_max_bwd kernel, the ``earlier`` of its rows: the tie gather
    through the gather_rows kernel, the tie test and the division in
    PyTorch, then scatter_rows."""
    u, s = idx.shape
    d = embed.shape[1]
    flat = idx.reshape(-1)
    gathered = gather.gather_rows_kernel(embed, flat).view(u, s, d)
    is_max = ((gathered == out[:, None, :])
              & (mask[..., None] > 0)).to(g.dtype)
    denom = is_max.sum(dim=1, keepdim=True).clamp_min(1.0)
    contrib = (g[:, None, :] * is_max / denom).to(embed.dtype)
    return scatter.scatter_rows(contrib.reshape(-1, d), flat, embed.shape[0])


def max_backward_rows(label: str, embed: torch.Tensor, idx: torch.Tensor,
                      mask: torch.Tensor, launches: int,
                      cold: bool = False) -> list:
    """gather_max's backward at one shape, two rows.  The gather_max_bwd
    kernel (the tie split, contrib [U*S, D]) against max_tie_split_plain
    on the card and on the CPU, bit for bit; its bound the bytes it must
    move (the valid slots' distinct rows, idx, mask, g, out, contrib).
    The whole backward (agg.max_aggregate_backward: the kernel, then
    index_add_ in float32 or scatter_rows in bfloat16) against autograd
    through the plain version (bfloat16: against the same backward on the
    CPU, bit for bit); its bound the bytes (g, out, idx, mask, the rows
    referenced, the [M, D] output) and, in bfloat16, the longest row's
    chain of tied adds at ADD_NS each; its ``earlier`` the composition the
    kernel replaced (max_backward_composition).  No one PyTorch call
    computes either: library_ms is null.  With ``cold`` the ms and device
    ms of both rows, their plain versions' and the composition's ms are
    taken on a cold L2 (the composition's and the scatter's device ms stay
    warm)."""
    g = torch.randn(idx.shape[0], embed.shape[1],
                    generator=torch.Generator().manual_seed(11)
                    ).to(embed.device, embed.dtype)
    with torch.no_grad():
        out = agg.max_aggregate(embed, idx, mask)
    (u, s), (m, d) = idx.shape, embed.shape
    es = embed.element_size()
    bf16 = embed.dtype == torch.bfloat16
    timer = cold_ms if cold else cuda_ms

    # -------- the tie split alone
    split = lambda: agg.gather_max_bwd_kernel(g, embed, idx, mask, out)
    contrib = split()
    torch.cuda.synchronize()
    assert torch.equal(contrib, agg.max_tie_split_plain(
        g, embed, idx, mask, out)), label
    assert torch.equal(contrib.cpu(), on_cpu(agg.max_tie_split_plain, g,
                                             embed, idx, mask, out)), label
    valid = mask > 0
    read = int(torch.unique(idx[valid]).numel())
    split_bytes = (read * d * es + 2 * u * s * 4 + 2 * u * d * es
                   + u * s * d * es)
    split_ops = int(valid.sum()) * d + 2 * u * s * d
    bound, bound_by = microbench.bound_ms(split_bytes, split_ops)
    ties = contrib.reshape(u, s, d) != 0
    kernel = {
        "name": f"gather_max_bwd ({label})",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES["gather_max_bwd"],
        "launches": launches,
        "max_abs_err": 0.0,
        **times(split, "gather_max_bwd_kernel", reps=20, cold=cold),
        "plain_ms": timer(lambda: agg.max_tie_split_plain(
            g, embed, idx, mask, out), reps=20),
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
        "library_device_ms": None,
    }
    log(f"kernel {kernel['name']}: embed {tuple(embed.shape)} "
        f"{embed.dtype}, idx {tuple(idx.shape)}, {int(valid.sum())} valid "
        f"slots, {read} rows read, {int(ties.any(2).sum())} slots tied in "
        f"some column, {split_bytes} bytes; contrib [{u * s}, {d}] "
        f"{timing_note(kernel)} [plain: max_tie_split_plain on the card] "
        f"equal to the plain version on the card and on the CPU")

    # -------- the whole backward
    got = agg.max_aggregate_backward(g, embed, idx, mask, out)
    leaf = embed.detach().clone().requires_grad_(True)
    plain_out = agg.max_aggregate_plain(leaf, idx, mask)
    torch.cuda.synchronize()
    if bf16:
        # JAX's order of the bfloat16 adds: the CPU's result, bit for bit
        want = on_cpu(agg.max_aggregate_backward, g, embed, idx, mask, out)
        assert torch.equal(got.cpu(), want), label
        err = 0.0
    else:
        want, = torch.autograd.grad(plain_out, leaf, g, retain_graph=True)
        err = check_close(f"gather_max backward {label}", got, want)
    earlier = max_backward_composition(g, embed, idx, mask, out)
    torch.cuda.synchronize()
    assert torch.equal(earlier, got) or not bf16, label
    rows_read = int(torch.unique(idx).numel())
    nbytes = (2 * u * d * es + 2 * u * s * 4 + rows_read * d * es
              + m * d * es)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    nonzero = contrib.ne(0).any(dim=1)
    chain = int(torch.bincount(idx.reshape(-1)[nonzero].long(),
                               minlength=m).max()) if bf16 else 0
    chain_ms = chain * ADD_NS / 1e6
    whole = {
        "name": f"gather_max backward ({label})",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES["gather_max_bwd"],
        "launches": launches,
        "max_abs_err": err,
        **times(lambda: agg.max_aggregate_backward(g, embed, idx, mask, out),
                None, reps=20, cold=cold),
        "plain_ms": timer(lambda: torch.autograd.grad(
            plain_out, leaf, g, retain_graph=True), reps=20),
        "bound_ms": max(bytes_ms, chain_ms),
        "bound_by": "bytes" if bytes_ms >= chain_ms else "operations",
        "library_ms": None,
        "library_device_ms": None,
        "bytes_ms": bytes_ms,
        "chain_ms": chain_ms,
    }
    composed = lambda: max_backward_composition(g, embed, idx, mask, out)
    whole["earlier_ms"] = timer(composed, reps=20)
    whole["earlier_device_ms"] = device_ms(composed)
    # the scatter alone: what the whole backward adds to the tie split
    whole["scatter_device_ms"] = device_ms(lambda: scatter.scatter_rows(
        contrib, idx.reshape(-1), m))
    log(f"kernel {whole['name']}: embed {tuple(embed.shape)} {embed.dtype}, "
        f"idx {tuple(idx.shape)}, {rows_read} rows read, {nbytes} bytes "
        f"({bytes_ms:.6f} ms), the longest row {chain} tied adds "
        f"({chain_ms:.6f} ms at {ADD_NS:.6f} ns an add); gather_max_bwd, "
        f"then {'scatter_rows' if bf16 else 'index_add_'} into [{m}, {d}]: "
        f"{timing_note(whole)} [plain: autograd through "
        f"max_aggregate_plain's amax] earlier (the composition: tie "
        f"gather, tie test, scatter) ms {whole['earlier_ms']:.6f} device_ms "
        f"{whole['earlier_device_ms']:.6f}; the scatter alone device_ms "
        f"{whole['scatter_device_ms']:.6f}; max_abs_err {err}")
    return [kernel, whole]


def max_step_rows(step_inputs: dict, launches: dict) -> list:
    """gather_max at the compact MAX step's two layer shapes (forward,
    exact) and its backward at both; only layer 2's runs in training (layer
    1 aggregates constant feature rows), so layer 1's backward row counts 0
    launches."""
    rows = []
    for layer, (embed, idx, mask) in enumerate(step_inputs["gather_max"],
                                               start=1):
        dtype = "bf16" if embed.dtype == torch.bfloat16 else "f32"
        label = f"{dtype} compact layer {layer}"
        rows.append(kernel_row("gather_max", label, embed, idx, mask,
                               launches["gather_max"]))
        rows.extend(max_backward_rows(
            f"{label}, idx {list(idx.shape)} over {list(embed.shape)}",
            embed, idx, mask, launches["gather_max_bwd"] if layer > 1
            else 0))
    return rows


def lstm_step_rows(step_inputs: dict, launches: dict) -> list:
    """gather_rows at the compact LSTM step's layer-1 slot gather."""
    (table, idx), _ = step_inputs["gather_rows"]
    return [gather_row(f"compact LSTM layer-1 slots, {idx.shape[0]} ids "
                       f"over {list(table.shape)}", table, idx,
                       launches["gather_rows"])]


# ------------------------------------------------------------ cached training

# (label, learn_method, agg_func, gcn, b_sz, extend_batches, train nodes
#  kept (None: the whole split), epochs, refresh_every)
CACHED_CONFIGS = (
    ("a", "sup", "MEAN", False, 32768, False, None, 3, 2),
    ("b", "sup", "MAX", True, 512, False, 5120, 1, 1),
    ("c", "plus_unsup", "MEAN", False, 20, True, 1000, 1, 1),
    ("d", "sup", "LSTM", False, 32768, False, None, 2, 1),
)
TABLE_CAP = 32
TIMED_STEPS = 20


class RecordingHop:
    """The trainer's hop sampler, with every draw kept in order."""

    def __init__(self, hop):
        self.hop = hop
        self.draws = []

    def __call__(self, nodes, fanout):
        out = self.hop(nodes, fanout)
        self.draws.append(out)
        return out


class ReplayHop:
    """Gives back recorded draws in order (the plain run's sampler)."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, nodes, fanout):
        samples, valid = self.draws.pop(0)
        assert samples.shape == (nodes.shape[0], fanout), samples.shape
        return samples, valid


@contextlib.contextmanager
def plain_cached():
    """The cached pipeline through the plain versions on the card."""
    with patched(cached, gather_rows=gather.gather_rows_plain,
                 mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain), \
            patched(sddmm, pair_scores=sddmm.dense_pair_scores):
        yield


def predicted_launches(tr: CachedTrainer, records: list,
                       epochs: int) -> dict:
    """What the code launches in the counted fit: per refresh one
    gather_mean / gather_max launch; per step one gather_rows launch on the
    full-table branch and two per occurrence, by cached.layer1_full_table
    at the step's m1; one pair_scores per unsupervised step whose score
    block sddmm.dense_block_pays picks; per evaluation embedding (val, and
    test when val F1 improved) one refresh and the layer-1 gathers at
    m1 = bucket(nodes) x (K + 1); in bfloat16 one scatter_rows a step on
    the full-table branch (the other gathers read constant tables)."""
    k = tr.tcfg.fanout

    def rows_at(m1):
        return 1 if cached.layer1_full_table(NODES, FEATS, m1, HIDDEN) else 2

    every = tr.tcfg.refresh_every
    refreshes = sum(1 for ep in range(epochs) if ep % every == 0)
    want = launch_counts()
    bf16 = tr.mcfg.compute_dtype == "bfloat16"
    for rec in records:
        batch, _, _, pairs = rec["args"]
        want["gather_rows"] += rows_at(batch.shape[0] * (k + 1))
        full = rows_at(batch.shape[0] * (k + 1)) == 1
        want["scatter_rows"] += int(bf16 and full)
        if pairs is not None:
            b, u = pairs["target_rows"].shape[0], batch.shape[0]
            n_pairs = pairs["pos_q"].numel() + pairs["neg_q"].numel()
            want["pair_scores"] += sddmm.dense_block_pays(b, u, n_pairs,
                                                          HIDDEN)
    for entry in tr.history:
        for nodes, key in ((tr.ds.val_nodes, "val_f1"),
                           (tr.ds.test_nodes, "test_f1")):
            if key in entry:
                refreshes += 1
                want["gather_rows"] += rows_at(_bucket(len(nodes)) * (k + 1))
    want["gather_max" if tr.mcfg.agg_func == "MAX" else "gather_mean"] = (
        refreshes)
    return want


def gather_row(label: str, table: torch.Tensor, idx: torch.Tensor,
               launches: int, cold: bool = False) -> dict:
    """gather_rows against index_select (exact), and its kernel row (with
    ``cold``, timed on a cold L2)."""
    got = gather.gather_rows_kernel(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather.gather_rows_plain(table, idx)), label
    j, d = idx.shape[0], table.shape[1]
    es = table.element_size()
    rows_read = int(torch.unique(idx).numel())
    nbytes = rows_read * d * es + j * 4 + j * d * es
    row = {
        "name": f"gather_rows ({label})",
        "route": "cuda",
        "source": GATHER_SOURCE,
        "replaces": REPLACES["gather_rows"],
        "launches": launches,
        "max_abs_err": 0.0,
        **times(lambda: gather.gather_rows_kernel(table, idx),
                "gather_rows_kernel",
                library=lambda: table.index_select(0, idx), cold=cold),
        "plain_ms": (cold_ms if cold else cuda_ms)(
            lambda: gather.gather_rows_plain(table, idx), reps=50),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    log(f"kernel {row['name']}: table {tuple(table.shape)} stride "
        f"{table.stride(0)} {table.dtype}, {j} ids, {rows_read} rows read, "
        f"{nbytes} bytes ({nbytes / row['device_ms'] / 1e9:.3f} TB/s of "
        f"device time); {timing_note(row)} [index_select with the int32 "
        f"ids]; equal to index_select")
    return row


def cached_config(label: str, method: str, agg_func: str, gcn: bool,
                  b_sz: int, extend: bool, keep, epochs: int, every: int,
                  ds, dev: torch.device) -> dict:
    """One cached configuration: the counted fit, its predicted launches,
    the lockstep check against the plain versions, the refresh against
    its plain version, refresh_ms, ms_per_step, the device profile of one
    epoch and val F1.  LSTM is the cached-LSTM hybrid: its layer-0 cell
    must come out of the fit unchanged, and the trained model is exported
    as a bundle for the hybrid's serving phase."""
    if keep is not None:
        ds = dataclasses.replace(ds, train_nodes=ds.train_nodes[:keep])
    hybrid = agg_func == "LSTM"
    tag = (f"[cached {label}: {method} {agg_func}"
           f"{' hybrid' if hybrid else ''}{' gcn' if gcn else ''} "
           f"b_sz {b_sz}{' extended' if extend else ''}]")
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          agg_func=agg_func, gcn=gcn)
    tcfg = TrainConfig(learn_method=method, unsup_loss="normal",
                       epochs=epochs, b_sz=b_sz, lr=LR, fanout=FANOUT,
                       seed=SEED, verbose=False, refresh_every=every)
    t0 = time.perf_counter()
    tr = CachedTrainer(ds, cfg, tcfg, table_cap=TABLE_CAP,
                       extend_batches=extend, lstm_hybrid=hybrid, device=dev)
    log(f"{tag} trainer: {len(ds.train_nodes)} train nodes, table "
        f"{tuple(tr.neighbors.shape)}, built in "
        f"{time.perf_counter() - t0:.3f} s")
    cells = ([{k: v.detach().clone() for k, v in cell.items()}
              for cell in tr.params["sage"]["agg"]] if hybrid else None)

    # -------- the main path, counted and recorded
    step, refresh, hop = tr._step, tr._refresh, RecordingHop(tr.hop)
    records, refreshes = [], []

    def recording_step(params, feats, cache_feats, cache_count, hop_, *args):
        before = param_snapshot(tr)
        first = len(hop.draws)
        loss = step(params, feats, cache_feats, cache_count, hop_, *args)
        records.append({"before": before, "after": param_snapshot(tr),
                        "cache": (cache_feats, cache_count), "args": args,
                        "draws": hop.draws[first:], "loss": loss})
        return loss

    def recording_refresh():
        first = len(hop.draws)
        out = refresh()
        refreshes.append({"draws": hop.draws[first:], "cache": out})
        return out

    tr._step, tr._refresh, tr.hop = recording_step, recording_refresh, hop
    agg.reset_launches()
    t0 = time.perf_counter()
    tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    tr._step, tr._refresh, tr.hop = step, refresh, hop.hop
    steps = len(records)
    assert steps == epochs * -(-len(ds.train_nodes) // b_sz), steps
    want = predicted_launches(tr, records, epochs)
    log(f"{tag} main path: CachedTrainer.fit, {epochs} epochs of "
        f"{steps // epochs} steps, {len(refreshes)} refreshes (evaluation "
        f"included) in {fit_s:.3f} s; launches {launches}; predicted "
        f"from the code {want}")
    assert launches == want, (launches, want)
    losses = np.asarray([float(r["loss"]) for r in records])
    assert np.isfinite(losses).all()
    bundle = None
    if hybrid:
        for k, v in tr.params["sage"]["agg"][0].items():
            assert torch.equal(v.detach(), cells[0][k]), k
        assert not torch.equal(tr.params["sage"]["agg"][1]["w_ih"].detach(),
                               cells[1]["w_ih"])
        bundle = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "chip_smoke_bundles",
                              f"cached_{label}_hybrid")
        infer.export_bundle(bundle, params_to_numpy(tr.params), cfg, CLASSES,
                            meta={"lstm_hybrid": True})
        log(f"{tag} the layer-0 cell is unchanged after the fit (the "
            f"layer-2 cell trained); exported the hybrid to {bundle}")

    # -------- the refresh against its plain version, same samples
    first = refreshes[0]
    with plain_cached():
        ref_feats, ref_cnt = cached.refresh_leaf_cache(
            ReplayHop(first["draws"]), tr.feats, FANOUT, agg=agg_func)
    got_feats, got_cnt = first["cache"]
    err = check_close(f"{tag} refresh vs plain", got_feats, ref_feats,
                      exact=agg_func == "MAX")
    assert torch.equal(got_cnt, ref_cnt)
    log(f"{tag} refresh vs {'max' if agg_func == 'MAX' else 'mean'}"
        f"_aggregate_plain on the same samples: max abs error {err}; counts "
        f"equal")

    # -------- lockstep: each plain step from the kernel run's params,
    # cache and draws of that step
    ref = _leaf_params(tr.params, dev)
    loss_rel, param_err = [], []
    agg.reset_launches()
    with plain_cached():
        for rec in records:
            with torch.no_grad():
                for p, q in zip(tree_leaves(ref), rec["before"]):
                    p.copy_(q)
            loss = step(ref, tr.feats, *rec["cache"],
                        ReplayHop(rec["draws"]), *rec["args"])
            loss_rel.append(abs(float(loss) - float(rec["loss"]))
                            / abs(float(rec["loss"])))
            param_err.append(max_abs_diff(tree_leaves(ref), rec["after"]))
    assert sum(agg.LAUNCHES.values()) == 0, agg.LAUNCHES
    log(f"{tag} lockstep, kernels vs plain versions over {steps} steps: "
        f"loss max relative difference {max(loss_rel):.3e} (tolerance "
        f"{LOSS_RTOL}); params after each step max abs difference "
        f"{max(param_err):.3e} (tolerance {PARAM_ATOL})")
    assert max(loss_rel) <= LOSS_RTOL and max(param_err) <= PARAM_ATOL
    del ref

    # -------- refresh_ms and ms_per_step on one cache
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    refresh_ms = statistics.median(times)
    log(f"{tag} refresh_ms {refresh_ms:.6f} (median of 5; min "
        f"{min(times):.6f}, max {max(times):.6f})")
    cache = tr._stale_cache
    last = [rec["args"] for rec in records[-(steps // epochs):]]
    times = []
    for i in range(TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(tr.params, tr.feats, *cache, tr.hop, *last[i % len(last)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[2:]
    ms_per_step = statistics.median(times)
    log(f"{tag} ms_per_step {ms_per_step:.6f} (median of {len(times)} "
        f"steps on one cache; min {min(times):.6f}, max {max(times):.6f}); "
        f"fit loss curve " + " ".join(f"{x:.6f}" for x in losses))

    # -------- the gathers and the score block one step makes, for the
    # kernel rows
    seen, scores_seen = [], []

    def gather_rec(table, idx):
        seen.append((table.detach(), idx))
        return gather.gather_rows(table, idx)

    def scores_rec(emb, target_rows, eps=1e-8):
        scores_seen.append((emb.detach(), target_rows))
        return sddmm.PairScores.apply(emb, target_rows, eps)

    with patched(cached, gather_rows=gather_rec), \
            patched(sddmm, pair_scores=scores_rec):
        step(tr.params, tr.feats, *cache, tr.hop, *last[0])
    torch.cuda.synchronize()
    batch, _, _, pairs = last[0]
    if launches["pair_scores"]:
        # B and U as predicted_launches reads them from the step
        (emb, target_rows), = scores_seen
        assert (target_rows.shape[0], emb.shape[0]) == (
            pairs["target_rows"].shape[0], batch.shape[0])

    # -------- device profile of one epoch (with its refresh)
    tr.train_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag} one epoch {wall:.6f} ms (warm, host batch building and "
        f"the refresh included)")
    profile_device(tr.train_epoch, wall, what="epoch ms", top=12)
    val_f1 = tr.history[-1]["val_f1"]
    log(f"{tag} val F1 {val_f1:.6f}; history {tr.history}")
    return {"label": label, "launches": launches, "refresh": first,
            "gathers": seen, "scores": scores_seen, "feats": tr.feats,
            "bundle": bundle,
            "summary": {"refresh_ms": refresh_ms, "ms_per_step": ms_per_step,
                        "val_f1": val_f1, "steps": steps}}


def cached_rows(results: dict) -> list:
    """gather_mean / gather_max at the refresh shape, gather_rows at (a)'s
    full-table and (b)'s per-occurrence shapes, pair_scores at (c)'s step
    shape."""
    rows = []
    for label, name in (("a", "gather_mean"), ("b", "gather_max")):
        res = results[label]
        (samples, valid), = res["refresh"]["draws"]
        own = torch.arange(NODES, dtype=torch.int32, device=samples.device)
        mask = (valid & (samples != own[:, None])).float()
        rows.append(kernel_row(name, f"f32 refresh ({label}), idx "
                               f"[{NODES}, {FANOUT}] over [{NODES}, {FEATS}]",
                               res["feats"], samples, mask,
                               res["launches"][name]))
    for label, what in (("a", "full table"), ("b", "per occurrence")):
        res = results[label]
        table, idx = res["gathers"][0]
        rows.append(gather_row(f"cached ({label}) {what}, {idx.shape[0]} ids "
                               f"over {list(table.shape)}", table, idx,
                               res["launches"]["gather_rows"]))
    (emb, target_rows), = results["c"]["scores"]
    rows.append(scores_row(f"cached (c) step, {target_rows.shape[0]} x "
                           f"{emb.shape[0]}, H {emb.shape[1]}", emb,
                           target_rows,
                           results["c"]["launches"]["pair_scores"]))
    return rows


# ------------------------------------------------------------ bfloat16 training

# (label, agg_func, b_sz, steps): the JAX bench's bfloat16 cached rows
# (bench.py:278-289), sup on bench-style batches; (h) and (i) run fewer
# steps than (e) to keep the run short
BF16_CACHED = (("e", "MEAN", 65536, 20), ("h", "MAX", 32768, 10),
               ("i", "LSTM", 32768, 5))
DENSE_B, DENSE_STEPS = 4096, 20


def bf16_config(agg_func: str = "MEAN") -> GraphSageConfig:
    return GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                           agg_func=agg_func, compute_dtype="bfloat16")


def bf16_params(cfg: GraphSageConfig, dev: torch.device) -> dict:
    """float32 master params from a torch.Generator seeded with SEED."""
    gen = torch.Generator().manual_seed(SEED)
    return _leaf_params({"sage": init_graphsage(gen, cfg),
                         "clf": init_classifier(gen, HIDDEN, CLASSES)}, dev)


def bench_batches(b: int, steps: int, labels: torch.Tensor):
    """The JAX bench's batch stack (bench.py _setup):
    RandomState(0).randint(0, N, (steps, b)), and its labels."""
    ids = np.random.RandomState(0).randint(0, NODES, (steps, b))
    batches = torch.from_numpy(ids.astype(np.int32)).to(labels.device)
    return batches, labels[batches.long()]


class SnapshotHop(RecordingHop):
    """A RecordingHop that also snapshots ``params`` at the first hop of
    every step (a step samples before it updates anything)."""

    def __init__(self, hop, params, hops_a_step: int):
        super().__init__(hop)
        self.params = params
        self.every = hops_a_step
        self.snaps = []

    def __call__(self, nodes, fanout):
        if len(self.draws) % self.every == 0:
            self.snaps.append(snapshot(self.params))
        return super().__call__(nodes, fanout)


def replay_lockstep(tag: str, step, params: dict, records: list, plain,
                    args_of, dtype: str = "bfloat16") -> None:
    """Each recorded step again through the plain versions, from the kernel
    run's params before that step and on its draws (``args_of(rec)``: the
    step's arguments after the params); the lockstep tolerances of
    ``dtype``."""
    ref = _leaf_params(params, params["clf"]["weight"].device)
    loss_rel, abs_errs, upd_errs = [], [], []
    agg.reset_launches()
    with plain():
        for rec in records:
            with torch.no_grad():
                for p, q in zip(tree_leaves(ref), rec["before"]):
                    p.copy_(q)
            loss = float(step(ref, *args_of(rec)))
            loss_rel.append(abs(loss - float(rec["loss"]))
                            / abs(float(rec["loss"])))
            got = tree_leaves(ref)
            abs_errs.append(max_abs_diff(got, rec["after"]))
            upd_errs.append(update_error(got, rec["after"], rec["before"]))
    assert sum(agg.LAUNCHES.values()) == 0, agg.LAUNCHES
    assert_lockstep(tag, dtype, loss_rel, abs_errs, upd_errs)


def timed_steps(tag: str, run_step, steps: int, edges: int) -> float:
    """ms_per_step over TIMED_STEPS synchronised steps (after two warm
    ones), with min, max and edges/s; returns the median."""
    times = []
    for i in range(TIMED_STEPS + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(i % steps)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[2:]
    ms = statistics.median(times)
    log(f"{tag} ms_per_step {ms:.6f} (median of {len(times)} steps; min "
        f"{min(times):.6f}, max {max(times):.6f}); edges_per_batch {edges}, "
        f"{edges / ms * 1e3:.1f} edges/s")
    return ms


def epoch_profile(tag: str, epoch, steps: int) -> tuple:
    """A warm epoch's wall time (host clock, synchronised) and the device
    profile of another; returns (wall ms, device busy ms or None)."""
    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    log(f"{tag} one epoch of {steps} steps {wall:.6f} ms ({wall / steps:.6f} "
        f"ms a step, no synchronisation inside)")
    return wall, profile_device(epoch, wall, what="epoch ms", top=12)


def upcast_costs(tag: str, table: torch.Tensor, w: torch.Tensor) -> None:
    """Device time of the float32 upcast of a bfloat16 table and of the
    float32 GEMM the port takes on it (TF32 off), beside a bfloat16
    tensor-core GEMM of the same operands, which the port does not run."""
    up = device_ms(lambda: table.float())
    t32, w32 = table.float(), w.float()
    gemm = device_ms(lambda: torch.matmul(t32, w32.T))
    gemm16 = device_ms(lambda: torch.matmul(table, w.T))
    ops = 2 * table.shape[0] * table.shape[1] * w.shape[0]
    bound = ops / F32_OPS_PER_S * 1e3
    log(f"{tag} upcast of the bf16 table {list(table.shape)} to float32: "
        f"{up:.6f} ms device ({table.numel() * 6 / up / 1e9:.3f} TB/s); "
        f"float32 GEMM x {list(w.shape)}^T {gemm:.6f} ms device "
        f"({ops / gemm / 1e9:.1f} TFLOP/s, bound {bound:.6f} ms); a bf16 "
        f"GEMM of the same operands (not run by the port) {gemm16:.6f} ms "
        f"device")


def scatter_deviation(tag: str, g: torch.Tensor, idx: torch.Tensor,
                      m: int) -> None:
    """The layer-1 gather's bf16 backward, d_table = the scatter-add of g
    [J, D] into [m, D], against the float64 sum of the same contributions:
    the port's (scatter_rows, JAX's order; the CPU's plain version equals
    it bit for bit, see scatter_row), index_add_'s bfloat16 atomics on the
    card (not run by the port) and a float32 index_add_ on the card."""
    exact = torch.zeros(m, g.shape[1], dtype=torch.float64,
                        device=g.device).index_add_(0, idx.long(),
                                                    g.double())
    # contributions that are not all zero (masked slots, such as the
    # sampler's padding ids, send zero rows)
    counts = torch.bincount(idx[(g != 0).any(dim=1)].long(), minlength=m)
    hub = int(counts.argmax())
    scale = float(exact.abs().max())
    hub_scale = float(exact[hub].abs().max())
    zeros = torch.zeros(m, g.shape[1], dtype=g.dtype, device=g.device)
    outs = {"card bf16 (scatter_rows, JAX's order)":
            scatter.scatter_rows(g, idx, m),
            "card bf16 (index_add_ atomics)":
            zeros.index_add_(0, idx.long(), g),
            "card float32": scatter.scatter_rows(g.float(), idx, m)}
    busy = counts >= 256
    for name, d in outs.items():
        dev = (d.double() - exact).abs()
        busy_dev = float(dev[busy].max()) if busy.any() else 0.0
        log(f"{tag} bf16 scatter of {idx.shape[0]} rows into [{m}, "
            f"{g.shape[1]}]: {name}: max abs deviation from the float64 sum "
            f"{float(dev.max()):.6e} ({float(dev.max()) / scale:.3e} of the "
            f"largest |sum|); hub row {hub} ({int(counts[hub])} nonzero "
            f"contributions): {float(dev[hub].max()):.6e} "
            f"({float(dev[hub].max()) / hub_scale:.3e} of its largest "
            f"|sum|); {int(busy.sum())} rows with >= 256 nonzero "
            f"contributions, "
            f"their max deviation {busy_dev:.6e}")


def bf16_cached(label: str, agg_func: str, b: int, steps: int, feats16,
                tables, labels, dev: torch.device) -> dict:
    """A bfloat16 cached configuration on the library path the JAX bench
    times (refresh, then cached_epoch_reuse over bench batches): the
    counted epoch, its predicted launches, the refresh and every step
    against the plain versions on the recorded draws, refresh_ms,
    ms_per_step, edges/s, the epoch's idle share, and one more step whose
    layer-1 gather and its incoming gradient are kept for the kernel rows
    and the scatter deviation."""
    cfg = bf16_config(agg_func)
    hybrid = agg_func == "LSTM"
    tag = (f"[bf16 cached {label}: sup {agg_func}{' hybrid' if hybrid else ''}"
           f" b_sz {b}]")
    params = bf16_params(cfg, dev)
    batches, batch_labels = bench_batches(b, steps, labels)
    hop = RecordingHop(HopSampler(*tables, torch.Generator(
        device=dev).manual_seed(SEED + 1)))
    step = cached.CachedStep(cfg, fanout=FANOUT, lr=LR)
    records = []

    def recording_step(params_, feats, cache_feats, cache_count, hop_,
                       *args):
        before, first = snapshot(params_), len(hop.draws)
        loss = step(params_, feats, cache_feats, cache_count, hop_, *args)
        records.append({"before": before, "after": snapshot(params_),
                        "args": args, "draws": hop.draws[first:],
                        "loss": loss})
        return loss

    # -------- the main path, counted
    agg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
    refresh_draws = list(hop.draws)
    losses = cached.cached_epoch_reuse(recording_step, params, feats16,
                                       *cache, hop, batches, batch_labels)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    full = cached.layer1_full_table(NODES, FEATS, b * (FANOUT + 1), HIDDEN)
    want = launch_counts(gather_mean=int(agg_func != "MAX"),
                         gather_max=int(agg_func == "MAX"),
                         gather_rows=steps * (1 if full else 2),
                         scatter_rows=steps * int(full))
    log(f"{tag} main path: refresh_leaf_cache + cached_epoch_reuse, "
        f"{steps} steps in {run_s:.3f} s; launches {launches}; predicted "
        f"from the code {want}; loss curve "
        + " ".join(f"{x:.6f}" for x in losses.tolist()))
    assert launches == want, (launches, want)
    assert cache[0].dtype == torch.bfloat16
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))

    # -------- the refresh and every step against the plain versions
    with plain_cached():
        ref_f, ref_c = cached.refresh_leaf_cache(
            ReplayHop(refresh_draws), feats16, FANOUT, agg=agg_func)
    err = check_close(f"{tag} refresh vs plain", cache[0], ref_f,
                      exact=agg_func == "MAX")
    assert torch.equal(cache[1], ref_c)
    log(f"{tag} refresh vs plain on the same samples: max abs error {err}")
    replay_lockstep(tag, step, params, records, plain_cached,
                    lambda rec: (feats16, *cache, ReplayHop(rec["draws"]),
                                 *rec["args"]))
    del records

    # -------- refresh_ms, ms_per_step, the epoch's idle share
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    refresh_ms = statistics.median(times)
    log(f"{tag} refresh_ms {refresh_ms:.6f} (median of 5; min "
        f"{min(times):.6f}, max {max(times):.6f})")
    edges = dense.edges_per_batch(b, 2, FANOUT)
    ms = timed_steps(tag, lambda t: step(params, feats16, *cache, hop,
                                         batches[t], batch_labels[t]),
                     steps, edges)

    def epoch():
        c = cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
        return cached.cached_epoch_reuse(step, params, feats16, *c, hop,
                                         batches, batch_labels)

    wall, busy = epoch_profile(tag, epoch, steps)

    # -------- one more step, its layer-1 gather and incoming gradient kept
    seen = []
    with keep_gathers(cached, seen):
        step(params, feats16, *cache, hop, batches[0], batch_labels[0])
    torch.cuda.synchronize()
    table, idx, g = seen[0]
    assert g.dtype == torch.bfloat16 and idx.shape[0] == b * (FANOUT + 1)
    return {"label": label, "agg": agg_func, "launches": launches,
            "cache": cache, "refresh_draws": refresh_draws, "params": params,
            "gather": (table, idx, g),
            "losses": losses.tolist(),
            "summary": {"refresh_ms": refresh_ms, "ms_per_step": ms,
                        "edges_per_s": edges / ms * 1e3, "epoch_ms": wall,
                        "busy_ms": busy, "steps": steps}}


def bf16_dense(feats16, tables, labels, dev: torch.device) -> dict:
    """(f) the dense pipeline, sup MEAN bfloat16, batches of DENSE_B:
    make_dense_sup_epoch counted over DENSE_STEPS bench batches, every step
    against the plain versions on its recorded draws, ms_per_step, edges/s,
    the epoch's idle share, and one more step's gather_mean inputs for the
    kernel rows."""
    cfg = bf16_config()
    tag = f"[bf16 dense f: sup MEAN b_sz {DENSE_B}]"
    params = bf16_params(cfg, dev)
    batches, batch_labels = bench_batches(DENSE_B, DENSE_STEPS, labels)
    hop = SnapshotHop(HopSampler(*tables, torch.Generator(
        device=dev).manual_seed(SEED + 1)), params, cfg.num_layers)
    epoch = dense.make_dense_sup_epoch(cfg, fanout=FANOUT, lr=LR)
    agg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = epoch(params, feats16, hop, batches, batch_labels)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    # one gather_mean a MEAN layer a step, whichever layer form
    k = FANOUT + 1
    want = launch_counts(
        gather_mean=cfg.num_layers * DENSE_STEPS,
        scatter_rows=DENSE_STEPS * bf16_scatters(
            cfg, NODES, DENSE_B * k * k, [DENSE_B * k, DENSE_B]))
    log(f"{tag} main path: make_dense_sup_epoch, {DENSE_STEPS} steps in "
        f"{run_s:.3f} s; launches {launches}; predicted from the code "
        f"{want}; loss curve " + " ".join(f"{x:.6f}" for x in
                                          losses.tolist()))
    assert launches == want, (launches, want)
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    snaps = hop.snaps + [snapshot(params)]
    k = cfg.num_layers
    records = [{"before": snaps[t], "after": snaps[t + 1],
                "loss": losses[t], "draws": hop.draws[k * t:k * (t + 1)],
                "args": (batches[t], batch_labels[t])}
               for t in range(DENSE_STEPS)]
    step = dense.make_dense_sup_step(cfg, fanout=FANOUT, lr=LR)
    replay_lockstep(tag, step, params, records, plain_training,
                    lambda rec: (feats16, ReplayHop(rec["draws"]),
                                 *rec["args"]))
    del records, snaps
    hop = hop.hop
    edges = dense.edges_per_batch(DENSE_B, 2, FANOUT)
    ms = timed_steps(tag, lambda t: step(params, feats16, hop, batches[t],
                                         batch_labels[t]),
                     DENSE_STEPS, edges)
    wall, busy = epoch_profile(tag, lambda: epoch(params, feats16, hop,
                                                  batches, batch_labels),
                               DENSE_STEPS)
    seen = []

    def mean_rec(embed, idx, mask):
        seen.append((embed.detach(), idx, mask))
        return agg.mean_aggregate(embed, idx, mask)

    with patched(graphsage, mean_aggregate=mean_rec):
        step(params, feats16, hop, batches[0], batch_labels[0])
    torch.cuda.synchronize()
    return {"launches": launches, "params": params, "inputs": seen,
            "summary": {"ms_per_step": ms, "edges_per_s": edges / ms * 1e3,
                        "epoch_ms": wall, "busy_ms": busy,
                        "steps": DENSE_STEPS}}


def bf16_phase(ds, train_ds, dev: torch.device, phase_mark) -> tuple:
    """Phase 9: bfloat16 training at full width, (e)-(i); returns the
    bfloat16 kernel rows, and (e)'s and (h)'s summaries and loss curves
    (phase 11 (n) runs their configurations sharded)."""
    log(f"bf16: torch.backends.cuda.matmul."
        f"allow_bf16_reduced_precision_reduction is "
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f" (set False when graphsage_torch.models is imported)")
    feats16 = torch.from_numpy(ds.features).to(dev, torch.bfloat16)
    pad = ds.graph.to_padded_sampled(TABLE_CAP,
                                     np.random.RandomState(SEED))
    tables = (torch.from_numpy(pad.neighbors).to(dev),
              torch.from_numpy(pad.degrees).to(dev))
    labels = torch.from_numpy(ds.labels.astype(np.int32)).to(dev)
    rows, summaries = [], {}

    results = {}
    for label, agg_func, b, steps in BF16_CACHED:
        res = results[label] = bf16_cached(label, agg_func, b, steps,
                                           feats16, tables, labels, dev)
        summaries[label] = res["summary"]
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    e = results["e"]
    runs = {label: {"summary": results[label]["summary"],
                    "losses": results[label]["losses"]}
            for label in ("e", "h")}
    w1 = dense.cast_compute(e["params"]["sage"]["layers"][0]["weight"],
                            bf16_config())
    upcast_costs("[bf16 cached e]",
                 torch.cat([feats16, e["cache"][0]], dim=-1), w1)
    table, idx, g = e["gather"]
    scatter_deviation("[bf16 cached e]", g, idx, table.shape[0])
    for label, name in (("e", "gather_mean"), ("h", "gather_max")):
        res = results[label]
        (samples, valid), = res["refresh_draws"]
        own = torch.arange(NODES, dtype=torch.int32, device=dev)
        mask = (valid & (samples != own[:, None])).float()
        rows.append(kernel_row(name, f"bf16 refresh ({label}), idx [{NODES}, "
                               f"{FANOUT}] over [{NODES}, {FEATS}]", feats16,
                               samples, mask, res["launches"][name]))
    for label in ("e", "h", "i"):
        res = results[label]
        table, idx, g = res["gather"]
        rows.append(gather_row(f"bf16 cached ({label}) full table, "
                               f"{idx.shape[0]} ids over {list(table.shape)}",
                               table, idx, res["launches"]["gather_rows"]))
        rows.append(scatter_row(f"bf16 cached ({label}) layer-1 backward, "
                                f"{idx.shape[0]} rows into "
                                f"{list(table.shape)}", g, idx,
                                table.shape[0],
                                res["launches"]["scatter_rows"]))
    del results, e, table, idx, g
    phase_mark("phase 9 (e), (h), (i): bf16 cached")

    f = bf16_dense(feats16, tables, labels, dev)
    summaries["f"] = f["summary"]
    # the pretransform's [2H, D] stack of the layer-1 weight's halves
    w1 = dense.cast_compute(f["params"]["sage"]["layers"][0]["weight"],
                            bf16_config())
    upcast_costs("[bf16 dense f]", feats16,
                 torch.cat([w1[:, :FEATS], w1[:, FEATS:]]))
    rows.extend(mean_step_rows({"gather_mean": f["inputs"]},
                               f["launches"]["gather_mean"], what="dense",
                               scatter_launches=f["launches"]["scatter_rows"]))
    # gather_max's backward at the dense layer-2 shape, over the relu of
    # (f)'s layer-2 input on its frontier (each id once): no path here
    # trains dense MAX, so 0 launches
    embed, idx, mask = f["inputs"][1]
    h = torch.relu(embed.float())
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        rows.extend(max_backward_rows(
            f"{name} dense layer 2, idx {list(idx.shape)} over "
            f"{list(h.shape)}", h.to(dtype), idx, mask, 0))
    del f, embed, idx, mask, h
    phase_mark("phase 9 (f): bf16 dense")

    unsup = train_method("plus_unsup", train_ds, dev, free_running=False,
                         dtype="bfloat16")
    summaries["g"] = {"ms_per_step": unsup["ms_per_step"]}
    step_inputs = capture_step_inputs(unsup["trainer"])
    rows.extend(mean_step_rows(
        step_inputs, unsup["launches"]["gather_mean"],
        scatter_launches=unsup["launches"]["scatter_rows"]))
    (emb, target_rows), = step_inputs["pair_scores"]
    assert emb.dtype == torch.bfloat16
    rows.append(scores_row(f"bf16 training step, {target_rows.shape[0]} x "
                           f"{emb.shape[0]}, H {emb.shape[1]}", emb,
                           target_rows, unsup["launches"]["pair_scores"]))
    del unsup, step_inputs
    phase_mark("phase 9 (g): bf16 compact plus_unsup")

    # (j) compact sup MAX gcn: gather_max forward, and layer 2's backward
    # (gather_max_bwd, then scatter_rows)
    res = train_method("sup", train_ds, dev, "MAX", True, free_running=False,
                       dtype="bfloat16")
    summaries["j"] = {"ms_per_step": res["ms_per_step"]}
    rows.extend(max_step_rows(capture_step_inputs(res["trainer"]),
                              res["launches"]))
    log(json.dumps({"bf16": summaries}))
    return rows, runs


def microbench_rows(dev: torch.device, launches: int) -> list:
    """Phase 8: the port's microbench at tools/pallas_microbench.py's
    shapes (it checks gather_rows against index_select, exact); its
    gather_rows row becomes that kernel's row at the microbench shape."""
    bench = {row["op"]: row for row in microbench.run(dev)}
    row = bench["gather_rows_cuda_w128_f32"]
    n, h, u, s = microbench.N, microbench.H, microbench.U, microbench.S
    return [{"name": f"gather_rows (microbench, {u} x {s} ids over "
                     f"[{n}, {h}] f32)",
             "route": "cuda", "source": GATHER_SOURCE,
             "replaces": REPLACES["gather_rows"], "launches": launches,
             **{key: row[key] for key in (
                 "max_abs_err", "ms", "device_ms", "host_us", "plain_ms",
                 "bound_ms", "bound_by", "library_ms",
                 "library_device_ms")}}]


# ------------------------------------------------------------ CLI round trip

def cli_cached(dev: torch.device) -> None:
    """The CLI's cached pipeline on the card: every layer-1 gather through
    gather_rows, every refresh through gather_mean."""
    argv = ["--dataSet", "powerlaw:2000:10000", "--pipeline", "cached",
            "--table_cap", "8", "--learn_method", "plus_unsup", "--epochs",
            "2", "--device", str(dev), "--quiet", "--checkpoint_dir",
            os.path.join(BUILD_DIR, "chip_smoke_ck", "cli_cached")]
    agg.reset_launches()
    t0 = time.perf_counter()
    trainer, _ = cli.run(argv)
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    log(f"[cli] graphsage_torch.cli {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; best val "
        f"F1 {trainer.max_vali_f1:.6f}")
    assert isinstance(trainer, CachedTrainer)
    assert np.isfinite(trainer.step_losses).all()
    assert (launches["gather_rows"] > 0 and launches["gather_mean"] > 0
            and launches["pair_scores"] > 0), launches


def cli_round_trip(dev: torch.device) -> None:
    out = os.path.join(BUILD_DIR, "chip_smoke_bundles", "cli_plus_unsup")
    argv = ["--dataSet", "powerlaw:2000:10000", "--learn_method",
            "plus_unsup", "--epochs", "1", "--export", out, "--device",
            str(dev), "--quiet", "--checkpoint_dir",
            os.path.join(BUILD_DIR, "chip_smoke_ck", "cli_plus_unsup")]
    agg.reset_launches()
    t0 = time.perf_counter()
    trainer, best = cli.run(argv)
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    log(f"[cli] graphsage_torch.cli {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; best val "
        f"F1 {trainer.max_vali_f1:.6f}")
    assert launches["gather_mean"] > 0 and launches["pair_scores"] > 0
    params, mcfg, _, meta = infer.load_bundle(out)
    assert meta["params"] == "best-val", meta
    flat_want = flatten_params(best["params"])
    flat_got = flatten_params(params)
    assert flat_want.keys() == flat_got.keys()
    for key in flat_want:
        np.testing.assert_array_equal(flat_got[key], flat_want[key])

    ds = trainer.ds
    pad = ds.graph.to_padded()
    agg.reset_launches()
    sess = infer.InferenceSession.from_bundle(out, ds.features, pad,
                                              device=dev)
    table = sess.embeddings()
    pred = sess.predict(ds.val_nodes)
    launches = dict(agg.LAUNCHES)
    assert launches["gather_mean"] == 2, launches
    want = infer.full_graph_embeddings(best["params"]["sage"], mcfg,
                                       ds.features, pad, device=dev)
    err = check_close("[cli] served table vs full_graph_embeddings",
                      torch.from_numpy(table), torch.from_numpy(want))
    f1 = micro_f1(ds.labels[ds.val_nodes], pred)
    log(f"[cli] bundle params equal the best-val snapshot (epoch "
        f"{best['epoch']}); served table vs full_graph_embeddings max abs "
        f"error {err}; serving launches {launches}; served val micro-F1 "
        f"{f1:.6f}")


# ------------------------------------------------------------ resume

# phase 10 (k): the headline bf16 cached configuration through the CLI
RESUME_K = ["--dataSet", f"powerlaw:{NODES}:{EDGES}", "--pipeline", "cached",
            "--table_cap", "32", "--no_extend", "--b_sz", "32768",
            "--compute_dtype", "bfloat16", "--learn_method", "sup",
            "--epochs", "3", "--name", "k", "--quiet"]
# (l): float32 compact sup on a small graph
RESUME_L = ["--dataSet", "powerlaw:2000:10000", "--learn_method", "sup",
            "--epochs", "3", "--name", "l", "--quiet"]
HOCON = "setting {\n  num_layers = 2\n  hidden_emb_size = 128\n}\n"
# (m): device time queued ahead of the guarded fetch, and its deadline
SLEEP_S, DEADLINE_S = 5.0, 1.0
# (m) in a real compact step through the CLI: device time queued inside
# step STEP_WEDGE_AT, far longer than the deadline.  A kernel's first
# launch waits for the kernels running (CUDA loads it then), so the step
# comes late enough that its kernels (cuBLAS's picks for its bucketed
# shapes among them) have been launched before
STEP_SLEEP_S, STEP_DEADLINE_S, STEP_WEDGE_AT = 30.0, 2.0, 20
STEP_WEDGE_ARGS = ["--dataSet", f"powerlaw:{NODES}:{EDGES}", "--learn_method",
                   "sup", "--epochs", "1", "--name", "m", "--quiet"]


def run_dirs(root: str, tag: str) -> tuple[dict, list]:
    """A fresh checkpoint dir, metrics file and bundle dir under root/tag,
    and the CLI flags that name them."""
    base = os.path.join(root, tag)
    paths = {"ck": os.path.join(base, "ck"),
             "metrics": os.path.join(base, "metrics.jsonl"),
             "bundle": os.path.join(base, "bundle")}
    os.makedirs(base)
    return paths, ["--checkpoint_dir", paths["ck"], "--metrics",
                   paths["metrics"], "--export", paths["bundle"]]


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def unbroken_run(argv: list, root: str, tag: str, dev: torch.device):
    """The CLI in this process, its launches counted and its checkpoint
    writes timed."""
    from graphsage_torch.utils import checkpoint
    paths, flags = run_dirs(root, tag)
    writes = []
    save = checkpoint.save_checkpoint

    def timed_save(path, *args, **kw):
        t0 = time.perf_counter()
        save(path, *args, **kw)
        writes.append(((time.perf_counter() - t0) * 1e3,
                       os.path.getsize(path)))

    agg.reset_launches()
    t0 = time.perf_counter()
    with patched(checkpoint, save_checkpoint=timed_save):
        trainer, _ = cli.run(argv + flags + ["--device", str(dev)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    log(f"[resume {tag}] graphsage_torch.cli in this process: "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; "
        f"checkpoint writes (ms, bytes) {writes}")
    return paths, launches, writes, trainer


def supervised_run(argv: list, root: str, tag: str, dev: torch.device,
                   timeout_s: float = 600.0):
    """python -m graphsage_torch.supervise with an injected wedge at epoch 1;
    the supervisor's event lines stamped with this process's clock as they
    arrive.  Returns the paths and the stamped events."""
    paths, flags = run_dirs(root, tag)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["GS_TEST_WEDGE_SENTINEL"] = os.path.join(root, tag, "wedge")
    cmd = [sys.executable, "-u", "-m", "graphsage_torch.supervise",
           "--max_restarts", "2", "--log",
           os.path.join(root, tag, "events.jsonl"), "--", *argv, *flags,
           "--device", str(dev)]
    events, other = [], []
    t0 = time.perf_counter()
    with open(os.path.join(root, tag, "stdout.txt"), "w") as out:
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=out,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        killer = threading.Timer(timeout_s, os.killpg,
                                 (proc.pid, signal.SIGKILL))
        killer.start()
        try:
            for line in proc.stderr:
                if line.startswith("[supervisor] "):
                    rec = json.loads(line[len("[supervisor] "):])
                    rec["wall"] = time.time()
                    events.append(rec)
                else:
                    other.append(line.rstrip())
            rc = proc.wait()
        finally:
            killer.cancel()
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"[resume {tag}] supervisor rc {rc}; "
                             f"stderr tail {other[-20:]}")
    log(f"[resume {tag}] python -m graphsage_torch.supervise: "
        f"{seconds:.3f} s; events "
        f"{[(e['event'], e.get('rc', e.get('resume'))) for e in events]}")
    kinds = [e["event"] for e in events]
    assert kinds == ["launch", "exit", "restart", "launch", "exit"], kinds
    assert events[1]["rc"] == 17 and events[4]["rc"] == 0, events
    name = os.path.basename(events[2]["resume"] or "")
    assert name.startswith(f"model_best_{argv[argv.index('--name') + 1]}"
                           "_ep0_"), events[2]
    return paths, events


def epoch_records(path: str) -> dict:
    """{epoch: (mean_loss, val_f1)} of a metrics file."""
    recs = read_jsonl(path)
    loss = {r["epoch"]: r["mean_loss"] for r in recs if r["event"] == "epoch"}
    f1 = {r["epoch"]: r["val_f1"] for r in recs if r["event"] == "eval"}
    return {e: (loss[e], f1.get(e)) for e in loss}


def bundle_params(path: str) -> dict:
    params, _, _, meta = infer.load_bundle(path)
    return flatten_params(params), meta


def recovery(paths: dict, events: list) -> dict:
    """Time to recover, from the first child's rc 17 to the end of the
    relaunched child's first epoch, and its parts."""
    recs = read_jsonl(paths["metrics"])
    i = next(i for i, r in enumerate(recs) if r["event"] == "resume")
    res, after = recs[i], recs[i + 1:]
    base = res["wall"] - res["t"]    # this child's logger clock
    first, second = [r for r in after if r["event"] == "epoch"][:2]
    # the second epoch starts after the first one's evaluation records
    second_start = max(r["t"] for r in after
                       if r.get("epoch") == first["epoch"])
    t17, relaunch = events[1]["wall"], events[3]["wall"]
    epoch_end = base + first["t"]
    parts = {"relaunch_s": relaunch - t17,
             "process_start_s": res["ready_wall"] - relaunch,
             "data_s": res["data_s"], "setup_s": res["setup_s"],
             "restore_s": res["restore_s"],
             "first_epoch_s": epoch_end - res["wall"],
             "second_epoch_s": second["t"] - second_start}
    parts["kernel_load_and_warmup_s"] = (parts["first_epoch_s"]
                                         - parts["second_epoch_s"])
    parts["total_s"] = epoch_end - t17
    return parts


def final_state(trainer) -> dict:
    """A trainer's final params (flattened, on the host) and its last
    epoch's step losses."""
    return {"params": flatten_params(params_to_numpy(trainer.params)),
            "losses": list(trainer.step_losses)}


def resumed_run(argv: list, root: str, tag: str, events: list,
                dev: torch.device) -> dict:
    """The CLI in this process resumed from the checkpoint that the
    supervisor's relaunch resumed from; its final state."""
    _, flags = run_dirs(root, tag)
    trainer, _ = cli.run(argv + flags + ["--resume", events[2]["resume"],
                                         "--device", str(dev)])
    return final_state(trainer)


def resume_equal(tag: str, unbroken: dict, supervised: dict, final: dict,
                 resumed: dict) -> None:
    """Epochs 1-2's losses and val F1s and the exported params of the
    supervised run, and the last epoch's step losses and the final params
    of the resumed one, equal the unbroken run's bit for bit."""
    a, b = epoch_records(unbroken["metrics"]), epoch_records(
        supervised["metrics"])
    for e in (1, 2):
        assert a[e] == b[e], (tag, e, a[e], b[e])
    pa, meta_a = bundle_params(unbroken["bundle"])
    pb, meta_b = bundle_params(supervised["bundle"])
    assert pa.keys() == pb.keys()
    for key in pa:
        np.testing.assert_array_equal(pb[key], pa[key], err_msg=key)
    assert meta_a == meta_b, (meta_a, meta_b)
    assert resumed["losses"] == final["losses"], (resumed, final)
    assert resumed["params"].keys() == final["params"].keys()
    for key in final["params"]:
        np.testing.assert_array_equal(resumed["params"][key],
                                      final["params"][key], err_msg=key)
    log(f"[resume {tag}] epochs 1-2 (mean_loss, val_f1) equal: {a[1]}, "
        f"{a[2]}; exported params equal bit for bit (best-val epoch "
        f"{meta_a['epoch']}); resumed in this process: final params and "
        f"the last epoch's {len(final['losses'])} step losses equal bit "
        f"for bit")


def resume_close(tag: str, unbroken: dict, supervised: dict, final: dict,
                 resumed: dict, loss_rtol: float, param_atol: float) -> dict:
    """Epochs 1-2's mean losses and the last epoch's step losses within
    loss_rtol, the exported and the final params within param_atol;
    returns the largest differences."""
    a, b = epoch_records(unbroken["metrics"]), epoch_records(
        supervised["metrics"])
    pa, meta_a = bundle_params(unbroken["bundle"])
    pb, meta_b = bundle_params(supervised["bundle"])
    assert pa.keys() == pb.keys()
    assert resumed["params"].keys() == final["params"].keys()
    assert len(resumed["losses"]) == len(final["losses"])
    diffs = {"loss_rel": max(abs(b[e][0] - a[e][0]) / abs(a[e][0])
                             for e in (1, 2)),
             "step_loss_rel": max(abs(r - f) / abs(f) for r, f in zip(
                 resumed["losses"], final["losses"])),
             "final_param_abs": max(
                 float(np.abs(resumed["params"][k] - final["params"][k])
                       .max()) for k in final["params"]),
             "bundle_param_abs": max(float(np.abs(pb[k] - pa[k]).max())
                                     for k in pa),
             "val_f1_equal": all(a[e][1] == b[e][1] for e in (1, 2)),
             "best_epoch": (meta_a["epoch"], meta_b["epoch"]),
             "steps": len(final["losses"])}
    log(f"[resume {tag}] against the unbroken run: {diffs} (loss rtol "
        f"{loss_rtol}, params atol {param_atol})")
    assert (diffs["loss_rel"] <= loss_rtol
            and diffs["step_loss_rel"] <= loss_rtol
            and diffs["final_param_abs"] <= param_atol
            and diffs["bundle_param_abs"] <= param_atol), diffs
    return diffs


DEADLINE_CHILD = r"""
import json, sys, time
import torch
from graphsage_torch import cli
from graphsage_torch.utils.obs import FetchDeadlineError, fetch_with_deadline

class Wedged:
    def fit(self):
        # load the sleep and add kernels first: CUDA loads a kernel at its
        # first launch, and that load waits for the kernels running
        x = torch.ones((), device="cuda")
        torch.cuda._sleep(1000)
        fetch_with_deadline(x + 1, timeout_s=60.0)
        torch.cuda._sleep(int(sys.argv[1]))
        y = x + 1
        t0 = time.perf_counter()
        try:
            fetch_with_deadline(y, label="a sleeping kernel's output",
                                timeout_s=float(sys.argv[2]))
        except FetchDeadlineError:
            print(json.dumps({"raised_after_s": time.perf_counter() - t0}),
                  flush=True)
            raise
        raise AssertionError("the fetch returned before its deadline")

cli.fit_or_exit(Wedged())
"""


def deadline_check() -> dict:
    """(m): a fetch behind SLEEP_S of queued device time raises
    FetchDeadlineError after DEADLINE_S, and the CLI's exit path ends the
    process with code 17 soon after."""
    cycles = 10**8
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: torch.cuda._sleep(cycles), 3)
    cycles = int(cycles * SLEEP_S * 1e3 / ms)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", DEADLINE_CHILD, str(cycles),
         str(DEADLINE_S)], cwd=here, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        line = proc.stdout.readline()
        raised_wall = time.perf_counter()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    exit_s = time.perf_counter() - raised_wall
    err = proc.stderr.read()
    res = {"sleep_cycles": cycles, "sleep_ms_per_1e8_cycles": ms,
           "raised_after_s": json.loads(line)["raised_after_s"]
           if line.startswith("{") else None,
           "rc": rc, "exit_after_raise_s": exit_s,
           "process_s": time.perf_counter() - t0}
    log(f"[resume m] {json.dumps(res)}; child stderr: "
        f"{err.strip().splitlines()[:4]}")
    assert res["raised_after_s"] is not None, (line, err)
    assert DEADLINE_S <= res["raised_after_s"] <= 3 * DEADLINE_S, res
    assert rc == cli.WEDGE_EXIT and exit_s <= 10.0, res
    return res


STEP_WEDGE_CHILD = r"""
import json, sys, time
import torch
from graphsage_torch import cli
from graphsage_torch.train import trainer as trainer_mod

cycles, at = int(sys.argv[1]), int(sys.argv[2])
encode = trainer_mod.graphsage_apply_gathered
update = trainer_mod.apply_gradients
calls = {"encode": 0, "update": 0}

def encode_then_sleep(*args, **kw):
    out = encode(*args, **kw)
    calls["encode"] += 1
    if calls["encode"] == at:
        # a kernel that runs far past the deadline, inside the step
        torch.cuda._sleep(cycles)
        print(json.dumps({"slept_at": time.time()}), flush=True)
    return out

def update_then_report(*args, **kw):
    update(*args, **kw)
    calls["update"] += 1
    if calls["update"] == at:
        # the step's launches after the sleep did not wait for it
        print(json.dumps({"updated_at": time.time()}), flush=True)

torch.cuda._sleep(1000)     # load the sleep kernel while nothing runs
trainer_mod.graphsage_apply_gathered = encode_then_sleep
trainer_mod.apply_gradients = update_then_report
cli.main(sys.argv[3:])
"""


def step_wedge_check(ms_per_1e8_cycles: float, root: str,
                     dev: torch.device) -> dict:
    """(m) in a real step: the CLI's compact Trainer at full width, with
    device sleep queued inside step STEP_WEDGE_AT, must end with code 17
    within 3 deadlines of the sleep, having named that step's loss fetch."""
    cycles = int(1e8 * STEP_SLEEP_S * 1e3 / ms_per_1e8_cycles)
    _, flags = run_dirs(root, "m_step")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    env["GS_FETCH_TIMEOUT_S"] = str(STEP_DEADLINE_S)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", STEP_WEDGE_CHILD, str(cycles),
         str(STEP_WEDGE_AT), *STEP_WEDGE_ARGS, *flags, "--device", str(dev)],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=STEP_SLEEP_S + 120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    ended = time.time()
    marks = {k: v for line in out.splitlines() if line.startswith('{"')
             for k, v in json.loads(line).items()}
    fatal = [line for line in out.splitlines() if line.startswith("FATAL")]
    slept = marks.get("slept_at")
    res = {"rc": proc.returncode, "sleep_cycles": cycles,
           "step_done_after_sleep_s": marks["updated_at"] - slept
           if "updated_at" in marks and slept else None,
           "exit_after_sleep_s": ended - slept if slept else None,
           "process_s": time.perf_counter() - t0, "fatal": fatal}
    log(f"[resume m] a real step: {json.dumps(res)}; child stderr: "
        f"{err.strip().splitlines()[:4]}")
    assert slept, (out, err)
    assert res["rc"] == cli.WEDGE_EXIT, (res, err)
    assert res["exit_after_sleep_s"] <= 3 * STEP_DEADLINE_S, res
    assert fatal and f"step {STEP_WEDGE_AT} loss fetch" in fatal[0], res
    return res


def resume_phase(dev: torch.device) -> None:
    """Phase 10: checkpoints, --config, --resume and the supervisor's
    wedge-and-relaunch loop at full width, and the fetch deadline on real
    device work."""
    import shutil
    root = os.path.join(BUILD_DIR, "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    conf = os.path.join(root, "k.conf")
    with open(conf, "w") as f:
        f.write(HOCON)
    t0 = time.perf_counter()

    # (k) the headline bf16 cached configuration
    argv = RESUME_K + ["--config", conf]
    unbroken, launches, writes, trainer = unbroken_run(argv, root, "k",
                                                       dev)
    assert trainer.mcfg.num_layers == 2 and trainer.mcfg.out_size == 128
    for name in ("gather_rows", "gather_mean", "scatter_rows"):
        assert launches[name] > 0, launches
    final = final_state(trainer)
    del trainer
    if dev.type == "cuda":
        # the children need the card's memory that this process caches
        torch.cuda.empty_cache()
    supervised, events = supervised_run(argv, root, "k_supervised", dev)
    parts = recovery(supervised, events)
    log(f"[resume k] time to recover (s): {json.dumps(parts)}")
    log(f"[resume k] checkpoint write ms {[w[0] for w in writes]}, bytes "
        f"{[w[1] for w in writes]}")
    # every gradient scatter on this path is scatter_rows, deterministic
    # by design, so the resumed run must equal the unbroken one exactly
    resumed = resumed_run(argv, root, "k_resumed", events, dev)
    resume_equal("k", unbroken, supervised, final, resumed)
    # (l) float32 compact sup: index_add_'s atomics add in varying order
    unbroken_l, _, _, trainer = unbroken_run(RESUME_L, root, "l", dev)
    final = final_state(trainer)
    del trainer
    supervised_l, events = supervised_run(RESUME_L, root, "l_supervised",
                                          dev)
    resumed = resumed_run(RESUME_L, root, "l_resumed", events, dev)
    resume_close("l", unbroken_l, supervised_l, final, resumed, LOSS_RTOL,
                 PARAM_ATOL)
    if dev.type == "cuda":
        res = deadline_check()
        step_wedge_check(res["sleep_ms_per_1e8_cycles"], root, dev)
    log(f"[resume] phase 10 took {time.perf_counter() - t0:.3f} s")


# ------------------------------------------------------------ distribution

# phase 11 (o) and (p): the halo pipeline's batch per rank and step counts
DIST_O_B, DIST_O_STEPS = 4096, 8
DIST_P_B, DIST_P_STEPS = 128, 5
# phase 11 (r): the CLI under torchrun, world 1
DIST_CLI = ["--dataSet", "powerlaw:2000:10000", "--epochs", "3", "--b_sz",
            "256", "--compute_dtype", "bfloat16", "--name", "r"]


@contextlib.contextmanager
def plain_cached_dist():
    """The sharded cached pipeline through the plain versions on the card."""
    with patched(cached_dist, gather_rows=gather.gather_rows_plain,
                 mean_aggregate=agg.mean_aggregate_plain,
                 max_aggregate=agg.max_aggregate_plain), \
            plain_cached():
        yield


@contextlib.contextmanager
def plain_dist():
    """The halo pipeline through the plain versions on the card: the
    exchange's row gathers are index_select, the aggregates and the self
    and pair gathers autograd's."""
    with patched(halo, gather_rows=gather.gather_rows_plain), \
            patched(distributed, mean_aggregate=agg.mean_aggregate_plain,
                    take_rows=plain_take), \
            plain_training():
        yield


def local_oracle(x_local, t, group):
    """The halo exchange's stand-in with identical frontiers and no
    exchange: the layer-0 rows by their global ids (``t["x0"]``; at world
    1 the local table is the whole table)."""
    return gather.gather_rows(x_local, t["x0"].int())


@contextlib.contextmanager
def oracle_exchange():
    """``train.distributed`` with the halo exchange swapped for
    :func:`local_oracle`."""
    with patched(distributed, _halo=local_oracle):
        yield


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def in_turns(a, b, rounds: int) -> tuple[list, list]:
    """(a's, b's) synchronised host ms over ``rounds`` rounds of a, b, b,
    a."""
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(wall_ms(a))
        tb.extend([wall_ms(b), wall_ms(b)])
        ta.append(wall_ms(a))
    return ta, tb


@contextlib.contextmanager
def launches_by_call(module, name: str, key, into: collections.Counter):
    """``module.name`` wrapped so that the launches each call makes (the
    wrappers' own counts in ``agg.LAUNCHES``) are credited to (kernel,
    ``key(*args)``): the launches of one shape on a path that launches a
    kernel at several."""
    fn = getattr(module, name)

    def counted(*args):
        before = dict(agg.LAUNCHES)
        out = fn(*args)
        for kernel, n in agg.LAUNCHES.items():
            if n != before[kernel]:
                into[(kernel, key(*args))] += n - before[kernel]
        return out

    with patched(module, **{name: counted}):
        yield


def row_key(table: torch.Tensor, idx: torch.Tensor) -> tuple:
    return tuple(table.shape), table.stride(0), tuple(idx.shape)


COLLECTIVE_OPS = ("AllGatherRows", "AllGatherCols", "SumPartials",
                  "AllToAllRows", "allreduce", "all_gather", "reduce_scatter",
                  "all_to_all")


def trace_breakdown(events: list) -> tuple[dict, collections.Counter]:
    """Where a traced call's wall time went, from the complete ("X") events
    of a torch.profiler Chrome trace: the span from the first event to the
    last, the device's busy time and the gaps between its kernels, the host
    time of the top-level ops on each host thread (the main thread and
    autograd's), the host time of the top-level ops that issue collectives
    (``COLLECTIVE_OPS``), the CUDA runtime and driver calls that took the
    most host time, and the host events that overlap the longest device
    gap (what the host was inside while the device waited); with the host
    ms by top-level op.  ({}, ...) when the trace holds no device time."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy"))
    if not dev:
        return {}, collections.Counter()
    t0 = min(e["ts"] for e in events)
    span = (max(e["ts"] + e["dur"] for e in events) - t0) / 1e3
    busy, gaps, end = 0.0, [], dev[0][0]
    for s, e in dev:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end)) / 1e3
        end = max(end, e)
    lo, hi = max(gaps, key=lambda g: g[1] - g[0], default=(0.0, 0.0))
    gaps = [(b - a) / 1e3 for a, b in gaps]
    threads = collections.defaultdict(list)
    runtime = collections.defaultdict(lambda: [0, 0.0, 0.0])
    in_gap = collections.Counter()
    for e in events:
        if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                            "cuda_driver"):
            threads[e["tid"]].append(e)
            overlap = min(hi, e["ts"] + e["dur"]) - max(lo, e["ts"])
            if overlap > 0:
                in_gap[e["name"][:60]] += overlap / 1e3
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            r = runtime[e["name"]]
            r[0] += 1
            r[1] += e["dur"] / 1e3
            r[2] = max(r[2], e["dur"] / 1e3)
    per_thread, collective_ms_, top_ops = [], 0.0, collections.Counter()
    for ops in threads.values():
        ops.sort(key=lambda e: (e["ts"], -e["dur"]))
        total, end = 0.0, -1.0
        for e in ops:
            if e["ts"] < end:
                continue                 # inside a top-level op
            end = e["ts"] + e["dur"]
            total += e["dur"] / 1e3
            top_ops[e["name"][:70]] += e["dur"] / 1e3
            if any(c in e["name"] for c in COLLECTIVE_OPS):
                collective_ms_ += e["dur"] / 1e3
        per_thread.append(total)
    per_thread.sort(reverse=True)
    return {"span_ms": span, "busy_ms": busy, "device_gaps_ms": sum(gaps),
            "longest_gap_ms": max(gaps, default=0.0),
            "gaps_over_50us": sum(g > 0.05 for g in gaps),
            "host_top_level_ms": per_thread,
            "collectives_host_ms": collective_ms_,
            "runtime_calls_n_ms_max": dict(sorted(
                runtime.items(), key=lambda kv: -kv[1][1])[:6]),
            "in_longest_gap_ms": dict(in_gap.most_common(8))}, top_ops


def host_profile(tag: str, fn) -> dict:
    """:func:`trace_breakdown` of one call of fn, traced by torch.profiler
    (its Chrome JSON written to a temporary directory and read back)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out, top_ops = trace_breakdown(
                [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"])
    if not out:
        log(f"{tag} host profile: no device time recorded (not measured)")
        return out
    log(f"{tag} host profile: {json.dumps(out)}; top host ops (ms): "
        + "; ".join(f"{k} {v:.3f}" for k, v in top_ops.most_common(8)))
    return out


def collective_ms(tag: str, h: torch.Tensor) -> None:
    """CUDA-event time of the world-1 collectives at the table's shape:
    all_gather_rows forward, and the SUM reduce-scatter of its backward."""
    gathered = cuda_ms(lambda: comm.all_gather_rows(h), reps=20)
    scattered = cuda_ms(lambda: comm._reduce_scatter_sum(h, None), reps=20)
    log(f"{tag} world-1 NCCL collectives on {list(h.shape)} {h.dtype} "
        f"({h.numel() * h.element_size()} bytes): all_gather "
        f"{gathered:.6f} ms, reduce-scatter {scattered:.6f} ms (events, "
        f"mean of 20)")


def dist_cached_n(label: str, feats16, tables, labels, ref_run: dict,
                  dev: torch.device) -> tuple:
    """(n) cached_dist sup bf16 on the batches of phase 9's run ``label``
    ((e) MEAN, timed; (h) MAX): local_refresh and cached_epoch_reuse over a
    CachedDistStep, counted; the loss curve against that run's (world 1:
    the same draws, the collectives copies); the refresh and every step
    against the plain versions on the recorded draws.  For (e) also
    refresh_ms, ms_per_step, edges/s, busy and idle share beside (e)'s,
    and the h1_full gather and its backward's kernel rows.  Returns
    (summary, kernel rows)."""
    _, agg_func, b, steps = next(c for c in BF16_CACHED if c[0] == label)
    cfg = bf16_config(agg_func)
    rank, world = comm.rank_world()
    tag = (f"[dist n: cached_dist sup {agg_func} bf16 b_sz {b} on ({label})'s"
           f" batches, world {world} {torch.distributed.get_backend()}]")
    params = bf16_params(cfg, dev)
    batches, batch_labels = bench_batches(b, steps, labels)
    hop = RecordingHop(HopSampler(*tables, torch.Generator(
        device=dev).manual_seed(SEED + 1)))
    step = cached_dist.CachedDistStep(cfg, fanout=FANOUT, lr=LR)
    x_local = cached_dist.local_rows(feats16, rank, world)
    records = []

    def recording_step(params_, xl, cl, cnt, hop_, *args):
        before, first = snapshot(params_), len(hop.draws)
        loss = step(params_, xl, cl, cnt, hop_, *args)
        records.append({"before": before, "after": snapshot(params_),
                        "args": args, "draws": hop.draws[first:],
                        "loss": loss})
        return loss

    # -------- the main path, counted
    agg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = cached_dist.local_refresh(hop, feats16, FANOUT, agg_func, rank,
                                      world)
    refresh_draws = list(hop.draws)
    losses = cached.cached_epoch_reuse(recording_step, params, x_local,
                                       *cache, hop, batches, batch_labels)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(agg.LAUNCHES)
    # one refresh; a step takes its layer-1 rows out of the all-gathered
    # table (gather_rows) and scatters their bf16 gradient (scatter_rows)
    want = launch_counts(gather_mean=int(agg_func == "MEAN"),
                         gather_max=int(agg_func == "MAX"),
                         gather_rows=steps, scatter_rows=steps)
    log(f"{tag} main path: local_refresh + cached_epoch_reuse over "
        f"CachedDistStep, {steps} steps in {run_s:.3f} s; launches "
        f"{launches}; predicted from the code {want}; loss curve "
        + " ".join(f"{x:.6f}" for x in losses.tolist()))
    assert launches == want, (launches, want)
    assert torch.isfinite(losses).all()
    same = losses.tolist() == ref_run["losses"]
    log(f"{tag} loss curve equal to ({label})'s bit for bit (world "
        f"{world}: the same draws and batches, the collectives copies): "
        f"{same}")
    if world == 1:
        assert same, (losses.tolist(), ref_run["losses"])

    # -------- the refresh and every step against the plain versions
    with plain_cached_dist():
        ref_f, ref_c = cached_dist.local_refresh(
            ReplayHop(refresh_draws), feats16, FANOUT, agg_func, rank, world)
    err = check_close(f"{tag} refresh vs plain", cache[0], ref_f,
                      exact=agg_func == "MAX")
    assert torch.equal(cache[1], ref_c)
    log(f"{tag} refresh vs plain on the same samples: max abs error {err}")
    replay_lockstep(tag, step, params, records, plain_cached_dist,
                    lambda rec: (x_local, *cache, ReplayHop(rec["draws"]),
                                 *rec["args"]))
    del records
    (samples, valid), = refresh_draws
    own = torch.arange(NODES, dtype=torch.int32, device=dev)
    mask = (valid & (samples != own[:, None])).float()
    name = "gather_max" if agg_func == "MAX" else "gather_mean"
    rows = [kernel_row(name, f"bf16 cached_dist ({label}'s batches) local "
                       f"refresh, idx [{NODES}, {FANOUT}] over [{NODES}, "
                       f"{FEATS}]", feats16, samples, mask, launches[name])]
    if label != "e":
        return {"steps": steps, "equal": same}, rows

    # -------- refresh_ms, ms_per_step, the epoch's idle share
    times_ = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cached_dist.local_refresh(hop, feats16, FANOUT, agg_func, rank,
                                  world)
        torch.cuda.synchronize()
        times_.append((time.perf_counter() - t0) * 1e3)
    refresh_ms = statistics.median(times_)
    log(f"{tag} refresh_ms {refresh_ms:.6f} (median of 5; min "
        f"{min(times_):.6f}, max {max(times_):.6f})")
    edges = dense.edges_per_batch(b, 2, FANOUT)
    ms = timed_steps(tag, lambda t: step(params, x_local, *cache, hop,
                                         batches[t], batch_labels[t]),
                     steps, edges)

    def epoch():
        c = cached_dist.local_refresh(hop, feats16, FANOUT, agg_func, rank,
                                      world)
        return cached.cached_epoch_reuse(step, params, x_local, *c, hop,
                                         batches, batch_labels)

    wall, busy = epoch_profile(tag, epoch, steps)
    summary = {"refresh_ms": refresh_ms, "ms_per_step": ms,
               "edges_per_s": edges / ms * 1e3, "epoch_ms": wall,
               "busy_ms": busy, "steps": steps}
    log(f"{tag} beside (e): "
        f"{json.dumps({'n': summary, 'e': ref_run['summary']})}")
    # (e) and (n) epochs in turns in this process (phase 9's (e) ran in
    # another state of it), each from its own params
    e_params, e_step = bf16_params(cfg, dev), cached.CachedStep(
        cfg, fanout=FANOUT, lr=LR)

    def e_epoch():
        c = cached.refresh_leaf_cache(hop, feats16, FANOUT, agg=agg_func)
        return cached.cached_epoch_reuse(e_step, e_params, feats16, *c, hop,
                                         batches, batch_labels)

    te, tn = in_turns(e_epoch, epoch, 2)
    summary["turns_ms"] = {"e": statistics.median(te),
                           "n": statistics.median(tn)}
    log(f"{tag} epochs in turns (e, n, n, e) x 2, host ms: (e) "
        f"{' '.join(f'{x:.3f}' for x in te)}; (n) "
        f"{' '.join(f'{x:.3f}' for x in tn)}")
    # where (n)'s extra wall time goes on the host, beside (e)'s
    summary["host_profile"] = {"e": host_profile(f"{tag} (e) epoch", e_epoch),
                               "n": host_profile(f"{tag} (n) epoch", epoch)}

    # -------- one more step: the h1_full gather and its incoming gradient
    seen = []
    with keep_gathers(cached_dist, seen):
        step(params, x_local, *cache, hop, batches[0], batch_labels[0])
    torch.cuda.synchronize()
    table, idx, g = seen[0]
    assert g.dtype == torch.bfloat16 and idx.shape[0] == b * (FANOUT + 1)
    collective_ms(tag, table)
    rows += [gather_row(f"bf16 cached_dist (n) rows of the all-gathered "
                        f"h1_full, {idx.shape[0]} ids over "
                        f"{list(table.shape)}", table, idx,
                        launches["gather_rows"]),
             scatter_row(f"bf16 cached_dist (n) h1_full backward, "
                         f"{idx.shape[0]} rows into {list(table.shape)}", g,
                         idx, table.shape[0], launches["scatter_rows"])]
    return summary, rows


def dist_batches(ds, b_loc: int, steps: int, dev: torch.device,
                 pair_sampler=None) -> tuple:
    """``steps`` halo-pipeline batches of b_loc train nodes a rank (sup, or
    plus_unsup with ``pair_sampler``), built on the host as the trainer
    builds them, and this rank's rows on the device; with the host ms of
    each build."""
    rank, world = comm.rank_world()
    order = np.random.RandomState(SEED).permutation(ds.train_nodes)
    built, host_ms = [], []
    for t in range(steps):
        batch = order[t * world * b_loc:(t + 1) * world * b_loc].reshape(
            world, b_loc)
        t0 = time.perf_counter()
        if pair_sampler is None:
            db, pairs = distributed.build_dist_batch(
                ds.graph, ds.labels, batch, 2, FANOUT, seed=SEED + t), None
        else:
            db, pairs = distributed.build_dist_unsup_batch(
                ds.graph, ds.labels, pair_sampler, batch, 2, FANOUT, 100,
                seed=SEED + t)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        args = distributed.dist_batch_to_device(db, dev)
        args["x0"] = torch.from_numpy(db.x0_ids[rank]).to(dev)
        args = ((args,) if pairs is None else
                (args, distributed.pairs_to_device(pairs, dev)))
        built.append((db, args))
    return built, host_ms


def dist_counted(tag: str, step, params: dict, feats_local, built: list,
                 want: dict) -> list:
    """The halo pipeline's counted steps: each recorded for the lockstep;
    returns the records."""
    records = []
    agg.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, args in built:
        before = snapshot(params)
        loss = step(params, feats_local, *args)
        records.append({"before": before, "after": snapshot(params),
                        "args": args, "loss": loss})
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    losses = [float(r["loss"]) for r in records]
    log(f"{tag} main path: {len(built)} steps in "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}; predicted "
        f"from the code {want}; losses "
        + " ".join(f"{x:.6f}" for x in losses))
    assert launches == want, (launches, want)
    assert np.isfinite(losses).all()
    return records


def dist_halo_o(ds, feats16, dev: torch.device) -> tuple:
    """(o) dist sup MEAN bf16, b_loc DIST_O_B, the pretransform on: the
    counted steps (make_dist_sup_step), their lockstep against the plain
    versions, dist_step_ms against the local oracle's (identical frontiers,
    no exchange), the epoch's idle share, and kernel rows of the exchange's
    gathers and their bf16 backward."""
    cfg = bf16_config()
    rank, world = comm.rank_world()
    tag = (f"[dist o: dist sup MEAN bf16 b_loc {DIST_O_B}, pretransform, "
           f"world {world} {torch.distributed.get_backend()}]")
    params = bf16_params(cfg, dev)
    rows_per = halo.partition_bounds(NODES, world)
    feats_local = feats16[rank * rows_per:(rank + 1) * rows_per]
    built, host_ms = dist_batches(ds, DIST_O_B, DIST_O_STEPS, dev)
    log(f"{tag} host build_dist_batch (every rank's frontiers and the halo "
        f"plan) ms: median {statistics.median(host_ms):.3f}, min "
        f"{min(host_ms):.3f}, max {max(host_ms):.3f}; halo cap "
        f"{built[0][0].requests.shape[-1]}, local share of slots "
        f"{float(built[0][0].addr_is_local.mean()):.4f}")
    step = distributed.make_dist_sup_step(cfg, lr=LR)
    steps = DIST_O_STEPS
    # a step: the exchange's three row gathers (served, received, local),
    # two gather_mean layers, and in bf16 a scatter_rows for each gather's
    # gradient: the three of the exchange, both aggregates' and both
    # self-row gathers' (take_rows)
    want = launch_counts(gather_mean=2 * steps, gather_rows=3 * steps,
                         scatter_rows=7 * steps)
    # the exchange's launches by shape: its gathers, and their backward
    # (GatherRows' scatter_rows, keyed by the table it scatters into)
    by_shape = collections.Counter()
    with launches_by_call(halo, "gather_rows", row_key, by_shape), \
            launches_by_call(gather, "scatter_rows", lambda g, idx, m: (
                (m, g.shape[1]), g.shape[1], (g.shape[0],)), by_shape):
        records = dist_counted(tag, step, params, feats_local, built, want)
    log(f"{tag} the exchange's launches by (kernel, (table shape, row "
        f"stride, ids shape)): {dict(by_shape)}")
    # the oracle's first step from the same params: the same loss, bit for
    # bit (at world 1 the exchange only moves zero gradients besides)
    ref = _leaf_params(params, dev)
    with torch.no_grad():
        for p, q in zip(tree_leaves(ref), records[0]["before"]):
            p.copy_(q)
    with oracle_exchange():
        oracle_loss = float(step(ref, feats_local, *built[0][1]))
    log(f"{tag} the local oracle's first step: loss {oracle_loss!r}, the "
        f"exchange's {float(records[0]['loss'])!r}")
    if world == 1:
        assert oracle_loss == float(records[0]["loss"])
    replay_lockstep(tag, step, params, records, plain_dist,
                    lambda rec: (feats_local, *rec["args"]))
    del records

    edges = dense.edges_per_batch(world * DIST_O_B, 2, FANOUT)
    dist_ms = timed_steps(f"{tag} dist_step_ms", lambda i: step(
        params, feats_local, *built[i][1]), steps, edges)
    with oracle_exchange():
        oracle_ms = timed_steps(f"{tag} local oracle", lambda i: step(
            params, feats_local, *built[i][1]), steps, edges)
    log(f"{tag} dist_step_ms {dist_ms:.6f}, local_oracle_ms "
        f"{oracle_ms:.6f}: halo overhead {dist_ms - oracle_ms:.6f} ms "
        f"({(dist_ms - oracle_ms) / oracle_ms:.2%}); at world {world} the "
        f"plan is all-local, so this is the exchange's fixed cost (two "
        f"all_to_alls, the request tables, the three gathers and the "
        f"select), not a cost of remote rows")
    wall, busy = epoch_profile(tag, lambda: [step(
        params, feats_local, *args) for _, args in built], steps)

    # -------- one more step: the exchange's gathers and their gradients
    seen = []
    with keep_gathers(halo, seen):
        step(params, feats_local, *built[0][1])
    torch.cuda.synchronize()
    rows = []
    wire = built[0][1][0]["requests"].numel()      # P * cap
    for table, idx, g in seen:
        what = ("rows out of the received buffer" if table.shape[0] == wire
                else "serving the requests" if idx.shape[0] == wire
                else "local rows")
        assert g.dtype == torch.bfloat16
        n_gather = by_shape[("gather_rows", row_key(table, idx))]
        n_scatter = by_shape[("scatter_rows", (tuple(table.shape),
                                               table.shape[1],
                                               tuple(idx.shape)))]
        assert n_gather > 0 and n_scatter > 0, (what, dict(by_shape))
        rows.append(gather_row(f"bf16 dist (o) halo {what}, {idx.shape[0]} "
                               f"ids over {list(table.shape)}", table, idx,
                               n_gather))
        rows.append(scatter_row(f"bf16 dist (o) halo {what} backward, "
                                f"{idx.shape[0]} rows into "
                                f"{list(table.shape)}", g, idx,
                                table.shape[0], n_scatter))
    summary = {"dist_step_ms": dist_ms, "local_oracle_ms": oracle_ms,
               "halo_overhead_ms": dist_ms - oracle_ms,
               "halo_overhead_pct": (dist_ms - oracle_ms) / oracle_ms * 100,
               "edges_per_s": edges / dist_ms * 1e3, "epoch_ms": wall,
               "busy_ms": busy, "host_build_ms": statistics.median(host_ms)}
    return summary, rows


def dist_unsup_p(ds, dev: torch.device) -> tuple:
    """(p) dist plus_unsup MEAN f32, b_loc DIST_P_B: the counted steps
    (make_dist_unsup_step, the pair_scores block), float32 lockstep, and
    the score block's kernel row at the step's shape."""
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN)
    rank, world = comm.rank_world()
    tag = (f"[dist p: dist plus_unsup MEAN f32 b_loc {DIST_P_B}, world "
           f"{world} {torch.distributed.get_backend()}]")
    gen = torch.Generator().manual_seed(SEED)
    params = _leaf_params({"sage": init_graphsage(gen, cfg),
                           "clf": init_classifier(gen, HIDDEN, CLASSES)}, dev)
    rows_per = halo.partition_bounds(NODES, world)
    feats_local = torch.from_numpy(ds.features[
        rank * rows_per:(rank + 1) * rows_per]).to(dev)
    ps = PairSampler(ds.graph, ds.train_nodes)
    built, host_ms = dist_batches(ds, DIST_P_B, DIST_P_STEPS, dev, ps)
    log(f"{tag} host build_dist_unsup_batch ms: median "
        f"{statistics.median(host_ms):.3f} ({ps.negative_mode} negatives)")
    step = distributed.make_dist_unsup_step(
        cfg, learn_method="plus_unsup", lr=LR, q=ps.q, margin=ps.margin)
    steps = DIST_P_STEPS
    blocks = 0
    for db, (t, pairs) in built:
        b, u = pairs["target_rows"].shape[0], db.x0_ids.shape[1] // (
            FANOUT + 1) ** 2
        blocks += sddmm.dense_block_pays(
            b, u, pairs["pos_q"].numel() + pairs["neg_q"].numel(), HIDDEN)
    want = launch_counts(gather_mean=2 * steps, pair_scores=blocks,
                         gather_rows=3 * steps)
    assert blocks > 0
    records = dist_counted(tag, step, params, feats_local, built, want)
    replay_lockstep(tag, step, params, records, plain_dist,
                    lambda rec: (feats_local, *rec["args"]),
                    dtype="float32")
    del records
    seen = []

    def scores_rec(emb, target_rows, eps=1e-8):
        seen.append((emb.detach(), target_rows))
        return pair_scores(emb, target_rows, eps)

    pair_scores = sddmm.pair_scores
    with patched(sddmm, pair_scores=scores_rec):
        step(params, feats_local, *built[0][1])
    torch.cuda.synchronize()
    (emb, target_rows), = seen
    return [scores_row(f"dist (p) plus_unsup step, {target_rows.shape[0]} "
                       f"x {emb.shape[0]}, H {emb.shape[1]}", emb,
                       target_rows, blocks)]


def sharded_serving_q(ds, dev: torch.device) -> tuple:
    """(q) full_graph_embeddings_sharded, MEAN f32 and MAX bf16, against
    full_graph_embeddings on the same inputs: launches, the tables, and
    embed_all_ms; kernel rows at layer 1."""
    rank, world = comm.rank_world()
    pad = ds.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    feats = torch.from_numpy(ds.features).to(dev)
    pad = PaddedAdjacency(neighbors=torch.from_numpy(pad.neighbors).to(dev),
                          degrees=torch.from_numpy(pad.degrees).to(dev),
                          true_degrees=pad.true_degrees,
                          truncated=pad.truncated)
    summaries, rows = {}, []
    for agg_func, dtype in (("MEAN", "float32"), ("MAX", "bfloat16")):
        tag = (f"[dist q: full_graph_embeddings_sharded {agg_func} {dtype}, "
               f"world {world}]")
        cfg = GraphSageConfig(num_layers=2, input_size=FEATS,
                              out_size=HIDDEN, agg_func=agg_func,
                              compute_dtype=dtype)
        gen = torch.Generator().manual_seed(824)
        sage = init_graphsage(gen, cfg)
        run_ = lambda: infer.full_graph_embeddings_sharded(
            sage, cfg, feats, pad, device=dev, fetch=False)
        agg.reset_launches()
        by_shape = collections.Counter()
        key = lambda embed, idx, mask: row_key(embed, idx)
        with launches_by_call(infer, "mean_aggregate", key, by_shape), \
                launches_by_call(infer, "max_aggregate", key, by_shape):
            got = run_()
        torch.cuda.synchronize()
        launches = dict(agg.LAUNCHES)
        name = "gather_mean" if agg_func == "MEAN" else "gather_max"
        want = launch_counts(**{name: cfg.num_layers})
        assert launches == want, (launches, want)
        single = infer.full_graph_embeddings(sage, cfg, feats, pad,
                                             device=dev, fetch=False)
        err = check_close(f"{tag} vs full_graph_embeddings", got, single)
        equal = torch.equal(got, single)
        times_ = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_()
            torch.cuda.synchronize()
            times_.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times_)
        log(f"{tag} launches {launches}, by (kernel, (table shape, row "
            f"stride, ids shape)) {dict(by_shape)}; table vs "
            f"full_graph_embeddings: "
            f"max abs error {err}, equal bit for bit: {equal}; embed_all_ms "
            f"{ms:.6f} (median of 20; min {min(times_):.6f}, max "
            f"{max(times_):.6f})")
        busy = profile_device(run_, ms)
        summaries[f"{agg_func} {dtype}"] = {"embed_all_ms": ms,
                                            "busy_ms": busy, "equal": equal}
        params = infer.params_from_jax(sage, dev)
        h = feats.to(graphsage.compute_dtype(cfg))
        idx, mask = infer._slot_table(pad.neighbors, pad.degrees, cfg.gcn)
        # MEAN's two layers gather at one shape (z[:, H:] of [N, 2H]),
        # MAX's layer 1 over the raw table
        if agg_func == "MEAN":
            table = mean_pretransform(params["layers"][0]["weight"],
                                      h)[:, HIDDEN:]
            what = (f"f32 sharded serving (q) layers 1-2, idx "
                    f"{list(idx.shape)} over z[:, H:] {list(table.shape)}")
        else:
            table = h
            what = (f"bf16 sharded serving (q) layer 1, idx "
                    f"{list(idx.shape)} over {list(table.shape)}")
        n = by_shape[(name, row_key(table, idx))]
        assert n > 0, dict(by_shape)
        rows.append(kernel_row(name, what, table, idx, mask, n))
    log(json.dumps({"sharded_serving": summaries}))
    return summaries, rows


def run_torchrun(args: list, timeout_s: float = 600):
    """``python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    graphsage_torch.cli ARGS`` from the repository root."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "graphsage_torch.cli", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=timeout_s,
                          env={**os.environ, "PYTHONPATH": root})
    log(f"[dist r] torchrun --standalone --nproc_per_node 1 -m "
        f"graphsage_torch.cli {' '.join(args)}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.3f} s")
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise AssertionError(f"torchrun exited {proc.returncode}")
    return proc


def cli_dist_r(dev: torch.device) -> dict:
    """(r) the CLI under torchrun at world 1, both distributed pipelines, on
    powerlaw:2000:10000 in bf16: 3 epochs with --export, served through
    InferenceSession.from_bundle; then resumed from its epoch-0
    checkpoint, whose epochs 1-2 must equal the unbroken run's bit for bit
    (every gradient scatter of a bf16 run is scatter_rows)."""
    import glob
    import shutil

    root = os.path.join(BUILD_DIR, "chip_smoke_dist")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    from graphsage_torch.data import load_dataset
    ds = load_dataset("powerlaw:2000:10000", seed=824)
    pad = ds.graph.to_padded()
    out = {}
    for pipeline, extra in (("dist", []),
                            ("cached_dist", ["--table_cap", "8",
                                             "--no_extend"])):
        base = DIST_CLI + ["--pipeline", pipeline, *extra]

        def run(tag, *more):
            metrics = os.path.join(root, f"{pipeline}_{tag}.jsonl")
            proc = run_torchrun(base + ["--checkpoint_dir", os.path.join(
                root, f"{pipeline}_{tag}"), "--metrics", metrics, *more])
            recs = read_jsonl(metrics)
            f1 = {r["epoch"]: r["val_f1"] for r in recs
                  if r["event"] == "eval"}
            return proc, {r["epoch"]: (r["mean_loss"], f1.get(r["epoch"]))
                          for r in recs if r["event"] == "epoch"}

        bundle = os.path.join(root, f"{pipeline}_bundle")
        proc, epochs = run("unbroken", "--export", bundle)
        assert proc.stdout.count("Best validation F1") == 1
        ckpt = glob.glob(os.path.join(root, f"{pipeline}_unbroken",
                                      "model_best_r_ep0_*"))
        assert len(ckpt) == 1, ckpt
        proc, resumed = run("resumed", "--resume", ckpt[0])
        assert "resumed from" in proc.stdout
        equal = resumed == {e: epochs[e] for e in (1, 2)}
        log(f"[dist r] {pipeline}: epochs (mean_loss, val F1) unbroken "
            f"{epochs}, resumed {resumed}: epochs 1-2 equal bit for bit: "
            f"{equal}")
        assert equal
        params, mcfg, _, meta = infer.load_bundle(bundle)
        assert mcfg.compute_dtype == "bfloat16"
        sess = infer.InferenceSession.from_bundle(bundle, ds.features, pad,
                                                  device=dev)
        table = sess.embeddings()
        want = infer.full_graph_embeddings(params["sage"], mcfg,
                                           ds.features, pad, device=dev)
        assert np.array_equal(table, want)
        f1 = micro_f1(ds.labels[ds.val_nodes], sess.predict(ds.val_nodes))
        log(f"[dist r] {pipeline}: bundle ({meta['params']} params, epoch "
            f"{meta['epoch']}) served through from_bundle, equal to "
            f"full_graph_embeddings; val micro-F1 {f1:.6f}")
        out[pipeline] = {"epochs": epochs, "served_val_f1": f1}
    return out


def dist_phase(ds, runs: dict, dev: torch.device, phase_mark) -> list:
    """Phase 11: distribution at world 1 on NCCL: (n) cached_dist, (o) and
    (p) the halo pipeline, (q) sharded serving, then (r) the CLI under
    torchrun; returns the kernel rows and each run's summary."""
    dev = multihost.initialize(dev)
    rank, world = comm.rank_world()
    log(f"dist: process group rank {rank} of {world}, backend "
        f"{torch.distributed.get_backend()}, device {dev}")
    rows, summaries = [], {}
    try:
        feats16 = torch.from_numpy(ds.features).to(dev, torch.bfloat16)
        pad = ds.graph.to_padded_sampled(TABLE_CAP,
                                         np.random.RandomState(SEED))
        tables = (torch.from_numpy(pad.neighbors).to(dev),
                  torch.from_numpy(pad.degrees).to(dev))
        labels = torch.from_numpy(ds.labels.astype(np.int32)).to(dev)
        for label in ("e", "h"):
            summaries[f"n on {label}"], n_rows = dist_cached_n(
                label, feats16, tables, labels, runs[label], dev)
            rows.extend(n_rows)
        phase_mark("phase 11 (n): cached_dist")
        summaries["o"], o_rows = dist_halo_o(ds, feats16, dev)
        rows.extend(o_rows)
        del feats16, tables, labels
        phase_mark("phase 11 (o): dist bf16")
        rows.extend(dist_unsup_p(ds, dev))
        phase_mark("phase 11 (p): dist plus_unsup")
        summaries["q"], q_rows = sharded_serving_q(ds, dev)
        rows.extend(q_rows)
        phase_mark("phase 11 (q): sharded serving")
    finally:
        multihost.shutdown()
    torch.cuda.empty_cache()
    summaries["r"] = cli_dist_r(dev)
    log(json.dumps({"dist": summaries}))
    return rows, summaries


TP_STEPS = 5


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block (float32 index_add_
    then adds in a fixed order; ops without a deterministic form warn)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def tp_launches(cfg: GraphSageConfig) -> collections.Counter:
    """What TP_STEPS tensor-parallel dense steps launch at world 1, by
    (kernel, shape): the gathered encoder's two gather_mean (layer 1 over
    the pretransformed table's agg half, layer 2 over layer 1's output)
    and, in bfloat16, scatter_rows for the gradient of both layers'
    aggregates and self-row gathers (bf16_scatters)."""
    k = FANOUT + 1
    u1, u2 = DENSE_B * k, DENSE_B
    want = collections.Counter({
        ("gather_mean", ((NODES, HIDDEN), 2 * HIDDEN, (u1, k))): TP_STEPS,
        ("gather_mean", ((u1, HIDDEN), HIDDEN, (u2, k))): TP_STEPS})
    if cfg.compute_dtype == "bfloat16":
        assert bf16_scatters(cfg, NODES, u1 * k, [u1, u2]) == 4
        for rows, into in ((u1 * k, NODES), (u1, NODES), (u2 * k, u1),
                           (u2, u1)):
            want["scatter_rows", ((into, HIDDEN), (rows,))] += TP_STEPS
    return want


def tp_step_s(dtype: str, feats, tables, labels, mesh,
              dev: torch.device) -> tuple:
    """(s) one dtype: the counted tensor-parallel steps, equal bit for bit
    to the dense step without the mesh (both under ``deterministic()``:
    the timed steps after them run as a user runs them, with float32
    index_add_'s atomics); times, the idle share, a profiled step; returns
    (summary, layer 1's gather ids, mask, self ids and weight of one more
    batch for (t), the main path's kernel inputs for :func:`tp_s_rows`)."""
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          compute_dtype=dtype)
    tag = (f"[tp s: sup MEAN {dtype} b_sz {DENSE_B}, mesh "
           f"({mesh.n_data} x {mesh.n_model}) "
           f"{torch.distributed.get_backend()}]")
    params = bf16_params(cfg, dev)
    sharded = pmesh.shard_params(params, mesh)
    batches, batch_labels = bench_batches(DENSE_B, TP_STEPS, labels)

    def hop():
        return HopSampler(*tables, torch.Generator(device=dev).manual_seed(
            SEED + 1))

    step = dense.make_dense_sup_step(cfg, fanout=FANOUT, lr=LR, mesh=mesh)
    plain_step = dense.make_dense_sup_step(cfg, fanout=FANOUT, lr=LR)
    by_shape = collections.Counter()
    seen = []

    def mean_rec(embed, idx, mask):
        # the first step's input of each layer, for the kernel rows
        if len(seen) < cfg.num_layers:
            seen.append((embed.detach(), idx, mask))
        return agg.mean_aggregate(embed, idx, mask)

    tp_hop = hop()
    with deterministic():
        agg.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with patched(graphsage, mean_aggregate=mean_rec), \
                launches_by_call(graphsage, "mean_aggregate",
                              lambda e, i, m: row_key(e, i), by_shape), \
                launches_by_call(scatter, "scatter_rows", lambda g, idx, m: (
                    (m, g.shape[1]), (g.shape[0],)), by_shape):
            losses = torch.stack([step(sharded, feats, tp_hop, batches[t],
                                       batch_labels[t])
                                  for t in range(TP_STEPS)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(agg.LAUNCHES)
        want = tp_launches(cfg)
        log(f"{tag} main path: {TP_STEPS} tensor-parallel steps in "
            f"{run_s:.3f} s; launches {launches}; by (kernel, (table shape, "
            f"row stride, ids shape)) {dict(by_shape)}; predicted from the "
            f"code {dict(want)}; loss curve "
            + " ".join(f"{x:.6f}" for x in losses.tolist()))
        assert by_shape == want, (dict(by_shape), dict(want))
        assert launches["gather_rows"] == 0 and launches["gather_max"] == 0
        assert torch.isfinite(losses).all()
        ref = _leaf_params(params, dev)
        ref_hop = hop()
        ref_losses = torch.stack([plain_step(ref, feats, ref_hop, batches[t],
                                             batch_labels[t])
                                  for t in range(TP_STEPS)])
    same_params = all(torch.equal(a, b) for a, b in
                      zip(tree_leaves(sharded), tree_leaves(ref)))
    log(f"{tag} against make_dense_sup_step without the mesh, from the same "
        f"params and generator state: losses equal bit for bit "
        f"{torch.equal(losses, ref_losses)}, final params equal bit for bit "
        f"{same_params}")
    assert torch.equal(losses, ref_losses) and same_params

    edges = dense.edges_per_batch(DENSE_B, 2, FANOUT)
    tp_hop = ref_hop = hop()
    ms = timed_steps(f"{tag} tensor-parallel", lambda t: step(
        sharded, feats, tp_hop, batches[t], batch_labels[t]), TP_STEPS, edges)
    plain_ms = timed_steps(f"{tag} without the mesh", lambda t: plain_step(
        ref, feats, ref_hop, batches[t], batch_labels[t]), TP_STEPS, edges)
    h = torch.randn(DENSE_B * (FANOUT + 1), HIDDEN, device=dev)
    joined = cuda_ms(lambda: comm.all_gather_cols(h, mesh.model_group),
                     reps=20)
    scattered = cuda_ms(lambda: comm._reduce_scatter_sum(h, mesh.model_group),
                        reps=20)
    log(f"{tag} world-1 NCCL column all-gather of {list(h.shape)} float32 "
        f"({h.numel() * 4} bytes) {joined:.6f} ms, reduce-scatter "
        f"{scattered:.6f} ms (events, mean of 20)")
    wall, busy = epoch_profile(tag, lambda: [step(
        sharded, feats, tp_hop, batches[t], batch_labels[t])
        for t in range(TP_STEPS)], TP_STEPS)
    with obs.profile(os.path.join(BUILD_DIR, "chip_smoke_tp")) as path:
        step(sharded, feats, tp_hop, batches[0], batch_labels[0])
        torch.cuda.synchronize()
    with open(path) as f:
        breakdown, top_ops = trace_breakdown(
            [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"])
    log(f"{tag} one step under utils.obs.profile: trace {path}; "
        f"{json.dumps(breakdown)}; top host ops (ms): "
        + "; ".join(f"{k} {v:.3f}" for k, v in top_ops.most_common(8)))
    # layer 1's table ids of one more batch's frontier, as the gathered
    # encoder composes them
    x0_ids, frontiers = dense.sample_frontiers_dense(
        tp_hop, batches[0], num_layers=2, fanout=FANOUT)
    idx_t = x0_ids.long()[frontiers[0].idx.long()].to(torch.int32)
    self_t = x0_ids[frontiers[0].self_idx.long()]
    summary = {"ms_per_step": ms, "edges_per_s": edges / ms * 1e3,
               "dense_ms_per_step": plain_ms, "epoch_ms": wall,
               "busy_ms": busy,
               "idle_share": None if busy is None else 1 - busy / wall,
               "column_all_gather_ms": joined,
               "reduce_scatter_ms": scattered,
               "collectives_host_ms": breakdown.get("collectives_host_ms")}
    w1 = dense.cast_compute(params["sage"]["layers"][0]["weight"], cfg)
    main = {"by_shape": by_shape, "gather_mean": seen,
            "self_ids": [self_t, frontiers[1].self_idx]}
    return summary, (idx_t, frontiers[0].mask, self_t, w1.detach()), main


def tp_s_rows(dtype: str, main: dict) -> list:
    """(s)'s kernel rows at every shape its main path launched, each with
    (s)'s launches of that shape: gather_mean at both layers on the first
    step's inputs, against its plain version with its backward, and in
    bfloat16 scatter_rows at the four shapes of the backward (each layer's
    aggregate and self rows; the self ids are one more batch's, of the
    same shape)."""
    by_shape = main["by_shape"]
    bf16 = dtype == "bfloat16"
    rows, covered = [], set()
    for layer, ((embed, idx, mask), self_ids) in enumerate(
            zip(main["gather_mean"], main["self_ids"]), start=1):
        key = ("gather_mean", row_key(embed, idx))
        m, d = embed.shape
        agg_key = ("scatter_rows", ((m, d), (idx.numel(),)))
        self_key = ("scatter_rows", ((m, d), (self_ids.shape[0],)))
        covered.add(key)
        if not bf16:
            label = f"f32 tp (s) layer {layer}"
            rows.append(kernel_row("gather_mean", label, embed, idx, mask,
                                   by_shape[key]))
            f32_backward_check(f"gather_mean {label}", embed, idx, mask)
            continue
        rows.extend(mean_step_rows({"gather_mean": [(embed, idx, mask)]},
                                   by_shape[key], what="tp (s)",
                                   scatter_launches=by_shape[agg_key],
                                   first_layer=layer))
        g = torch.randn(self_ids.shape[0], d, generator=torch.Generator(
            ).manual_seed(3 + layer)).to(embed.device, torch.bfloat16)
        rows.append(scatter_row(
            f"bf16 tp (s) layer {layer} self rows backward, "
            f"{self_ids.shape[0]} rows into [{m}, {d}]", g, self_ids, m,
            by_shape[self_key]))
        covered |= {agg_key, self_key}
    assert covered == set(by_shape), (covered, set(by_shape))
    return rows


def f32_backward_check(label: str, embed: torch.Tensor, idx: torch.Tensor,
                       mask: torch.Tensor) -> None:
    """gather_mean's float32 gradient where rows gather many slots (the
    hubs of the power-law graph: index_add_'s atomics and autograd's
    sorted scatter add in different orders, so the two differ by more
    than 1e-5): the kernel path's and the plain version's, each against
    the float64 sum of the same float32 contributions, within the a-priori
    bound of summing them in any order, gamma_(n+1) times the sum of their
    magnitudes (u = 2^-24, n the longest row's count, the 1 the product's
    own rounding)."""
    m, d = embed.shape
    g = torch.randn(idx.shape[0], d, generator=torch.Generator().manual_seed(
        1)).to(embed.device)
    w = mask / mask.sum(1, keepdim=True).clamp_min(1.0)
    contrib = (g[:, None, :] * w[:, :, None]).reshape(-1, d).double()
    flat = idx.reshape(-1).long()
    exact = torch.zeros(m, d, dtype=torch.float64, device=embed.device)
    exact.index_add_(0, flat, contrib)
    mag = torch.zeros_like(exact).index_add_(0, flat, contrib.abs())
    n = int(torch.bincount(flat[mask.reshape(-1) > 0], minlength=m).max())
    gamma = (n + 1) * 2.0**-24 / (1 - (n + 1) * 2.0**-24)
    errs = {}
    for name, fn in (("kernel", agg.mean_aggregate),
                     ("plain", agg.mean_aggregate_plain)):
        leaf = embed.detach().clone().requires_grad_(True)
        (fn(leaf, idx, mask) * g).sum().backward()
        diff = (leaf.grad.double() - exact).abs()
        if not bool((diff <= gamma * mag).all()):
            raise AssertionError(f"{label} gradient ({name}): outside the "
                                 f"summation bound")
        errs[name] = float(diff.max())
    log(f"  {label} backward (index_add_ into [{m}, {d}], the longest row "
        f"{n} contributions): max abs error to the float64 sum, kernel "
        f"path {errs['kernel']}, plain {errs['plain']}; both within "
        f"gamma_(n+1) = {gamma:.6g} of the terms' magnitudes (largest "
        f"{float(mag.max()):.6g})")


def two_way_rows(feats, inputs, dtype: str) -> list:
    """(t) the layer-1 shapes of a rank of a 2-way model axis: its
    pretransform of the table by the first half of the weight's rows,
    gather_mean over the [N, H/2] agg half (row stride H) and its
    backward, gather_rows over the self half and, in bfloat16, the
    scatter of its backward."""
    idx, mask, self_idx, w1 = inputs
    half = HIDDEN // 2
    with torch.no_grad():
        h_cat = mean_pretransform(w1[:half], feats)          # [N, H]
    bf16 = dtype == "bfloat16"
    what = f"2-way model rank, agg half [{NODES}, {half}] stride {HIDDEN}"
    if bf16:
        rows = mean_step_rows({"gather_mean": [(h_cat[:, half:], idx,
                                                mask)]},
                              0, what=what, scatter_launches=0)
    else:
        rows = [kernel_row("gather_mean", f"f32 {what} layer 1",
                           h_cat[:, half:], idx, mask, 0)]
        f32_backward_check(f"gather_mean f32 {what} layer 1",
                           h_cat[:, half:], idx, mask)
    table = h_cat[:, :half]
    label = (f"{'bf16' if bf16 else 'f32'} 2-way model rank self half, "
             f"{self_idx.shape[0]} ids over [{NODES}, {half}] stride "
             f"{HIDDEN}")
    rows.append(gather_row(label, table, self_idx, 0))
    if bf16:
        g = torch.randn(self_idx.shape[0], half, generator=torch.Generator(
            ).manual_seed(3)).to(table.device, table.dtype)
        rows.append(scatter_row(f"{label} backward", g, self_idx, NODES, 0))
    return rows


def tp_phase(ds, dev: torch.device, phase_mark) -> list:
    """Phase 12: the tensor-parallel model axis at world 1 on NCCL, (s),
    (t) and (u); returns the kernel rows."""
    dev = multihost.initialize(dev)
    rows, summaries = [], {}
    try:
        mesh = pmesh.make_mesh()
        pad = ds.graph.to_padded_sampled(TABLE_CAP,
                                         np.random.RandomState(SEED))
        tables = (torch.from_numpy(pad.neighbors).to(dev),
                  torch.from_numpy(pad.degrees).to(dev))
        labels = torch.from_numpy(ds.labels.astype(np.int32)).to(dev)
        for dtype in ("float32", "bfloat16"):
            feats = torch.from_numpy(ds.features).to(
                dev, graphsage.compute_dtype(GraphSageConfig(
                    compute_dtype=dtype)))
            summaries[f"s {dtype}"], inputs, main = tp_step_s(
                dtype, feats, tables, labels, mesh, dev)
            rows.extend(tp_s_rows(dtype, main))
            rows.extend(two_way_rows(feats, inputs, dtype))
            del feats, inputs, main
        phase_mark("phase 12 (s), (t): the tensor-parallel step")
        t0 = time.perf_counter()
        lines = dryrun_multichip(1, device=dev)    # rank 0 prints them
        summaries["u_s"] = time.perf_counter() - t0
        assert len(lines) == 4, lines
        log(f"[tp u] dryrun_multichip(1): the four programs' asserts passed "
            f"in {summaries['u_s']:.3f} s")
    finally:
        multihost.shutdown()
    torch.cuda.empty_cache()
    log(json.dumps({"tensor_parallel": summaries}))
    return rows


# ------------------------------------------------------------ bench rows

BENCH_ROWS = (bench.HEADLINE_ROW, "powerlaw100k_b32768_cached_bfloat16_unsup",
              "powerlaw100k_b32768_cached_float32")
SERVE_ROW = "powerlaw100k_cap32_bf16_max"


def bench_launches(spec: dict) -> dict:
    """One timed epoch of a cached bench row, from the code's rule
    (big_launches; float32 gradients take index_add_, not scatter_rows,
    and a MAX row's refresh is a gather_max)."""
    want = big_launches(NODES, FEATS, spec["batch"], spec.get("steps", 20),
                        unsup=spec["kind"] == "unsup",
                        backward=spec["dtype"] == "bfloat16")
    if spec.get("agg") == "MAX":
        want["gather_max"], want["gather_mean"] = want["gather_mean"], 0
    return want


def bench_phase(ds, e_summary: dict, dev: torch.device) -> list:
    """Phase 13: the bench suites' rows in this process; returns the
    kernel row of the float32 row's gather."""
    pad = ds.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    specs = {s["name"]: s for s in bench._row_specs()}
    done = {}
    for name in BENCH_ROWS:
        t0 = time.perf_counter()
        row = done[name] = bench.run_spec(specs[name], ds, pad, dev)
        want = bench_launches(specs[name])
        log(f"[bench] {json.dumps(row)} ({time.perf_counter() - t0:.3f} s "
            f"with its setup); launches predicted from the code {want}")
        assert np.isfinite(row["step_ms"]) and row["step_ms"] > 0, row
        assert row["launches"] == want, (name, row["launches"], want)
    head = done[bench.HEADLINE_ROW]
    log(f"[bench] headline step_ms {head['step_ms']:.6f} (epoch timing, "
        f"refresh inside, median of {bench.TIMED_REPS}) beside (e) "
        f"ms_per_step {e_summary['ms_per_step']:.6f} (a step between two "
        f"synchronisations) and (e) epoch {e_summary['epoch_ms']:.6f} ms / "
        f"{e_summary['steps']} steps = "
        f"{e_summary['epoch_ms'] / e_summary['steps']:.6f}")

    spec = next(s for s in infer_bench._row_specs() if s["name"] == SERVE_ROW)
    t0 = time.perf_counter()
    row, emb = infer_bench.serve_row(
        SERVE_ROW, ds, infer_bench.padded(ds, spec["width"]), spec["dtype"],
        spec["agg"], spec["note"], dev)
    cfg = GraphSageConfig(num_layers=2, input_size=FEATS, out_size=HIDDEN,
                          agg_func=spec["agg"], compute_dtype=spec["dtype"])
    want = serving_launches(cfg, lstm_hybrid=False)
    log(f"[bench] {json.dumps(row)} ({time.perf_counter() - t0:.3f} s); "
        f"launches predicted from the code {want}")
    assert np.isfinite(row["embed_all_ms"]) and row["embed_all_ms"] > 0, row
    assert row["launches"] == want, (row["launches"], want)
    assert emb.shape == (NODES, HIDDEN) and np.isfinite(emb).all()

    # the float32 row's full-table gather: its first batch's frontier
    name = "powerlaw100k_b32768_cached_float32"
    f32 = specs[name]
    batch = np.random.RandomState(0).randint(0, NODES, (f32["steps"],
                                                        f32["batch"]))[0]
    hop = HopSampler(torch.from_numpy(pad.neighbors).to(dev),
                     torch.from_numpy(pad.degrees).to(dev),
                     torch.Generator(device=dev).manual_seed(SEED))
    ids, _ = cached.sample_cached_frontiers(
        hop, torch.from_numpy(batch.astype(np.int32)).to(dev),
        GraphSageConfig(num_layers=2), FANOUT)
    table = torch.randn(NODES, HIDDEN, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED))
    kernel = gather_row(f"bench {name} full table, {ids.shape[0]} ids over "
                        f"{list(table.shape)}", table, ids,
                        done[name]["launches"]["gather_rows"])
    return [kernel]


# ------------------------------------------------------------ anatomy tools

# phase 15: the ports of tools/step_anatomy.py, profile_cached.py and
# profile_unsup.py; step_anatomy's batch (the JAX tool's default)
ANATOMY_BATCH = 65536


def anatomy_launches(n: int, d: int, batch: int, reps: int) -> dict:
    """Each bfloat16 slice's launches over its timed calls, from the code's
    rules (big_launches: the frontier's gathers by the layer-1 rule; the
    full-table gather's backward one scatter_rows)."""
    step = big_launches(n, d, batch, reps, 0)
    return {"timing_floor": launch_counts(), "sampling": launch_counts(),
            "l1_gemm": launch_counts(),
            "l1_gemm_plus_gather": launch_counts(gather_rows=reps),
            "fwd": big_launches(n, d, batch, reps, 0, backward=False),
            "fwd_bwd": step, "step": step,
            "scatter_bound": launch_counts(scatter_rows=reps),
            "gather_bound": launch_counts(gather_rows=reps)}


def check_anatomy(tag: str, res: dict, n: int, d: int,
                  ids: torch.Tensor) -> None:
    """A step_anatomy row: its slices finite and above 0, the derived
    slices by the JAX tool's formulas, the launches predicted; the
    scatter_bound slice beside its chain bound (its dout is all ones, so
    no contribution is skipped: the longest row of ``ids`` is its
    chain)."""
    log(f"[anatomy {tag}] {json.dumps(res)}")
    counts = torch.bincount(ids.long())
    chain = int(counts.max())
    log(f"[anatomy {tag}] scatter_bound: all-ones dout over the frontier's "
        f"{ids.shape[0]} ids, the longest row (id {int(counts.argmax())}) "
        f"{chain} contributions, chain bound {chain * ADD_NS / 1e6:.6f} ms "
        f"at {ADD_NS:.6f} ns an add, against "
        f"{res['scatter_bound_ms']:.6f} ms")
    assert ids.shape[0] == res["frontier_rows"], tag
    for name in step_anatomy.SLICES:
        ms = res[f"{name}_ms"]
        assert np.isfinite(ms) and ms > 0, (tag, name, ms)
    assert res["h1_gather_ms"] == (res["l1_gemm_plus_gather_ms"]
                                   - res["l1_gemm_ms"]), tag
    assert res["upper_plus_head_fwd_ms"] == (
        res["fwd_ms"] - res["l1_gemm_plus_gather_ms"] - res["sampling_ms"]
        + res["timing_floor_ms"]), tag
    assert res["backward_ms"] == res["fwd_bwd_ms"] - res["fwd_ms"], tag
    assert res["opt_ms"] == res["step_ms"] - res["fwd_bwd_ms"], tag
    want = anatomy_launches(n, d, res["batch"], step_anatomy.REPS)
    assert res["launches"] == want, (tag, res["launches"], want)
    log(f"[anatomy {tag}] launches of every slice equal the code's "
        f"prediction; step idle share "
        f"{res['step_profile']['idle_share']}")


def cached_row_launches(op: str, n: int, d: int) -> dict:
    """A profile_cached row's launches in one call of its program."""
    b, iters = profile_cached.B, profile_cached.ITERS
    bf16 = op.endswith("bfloat16")
    if op.startswith("refresh_leaf_cache"):
        return launch_counts(gather_mean=iters)
    if op.startswith(("full_step", "fwd_bwd")):
        return big_launches(n, d, b, iters, 0, backward=bf16)
    if op.startswith("forward_only"):
        return big_launches(n, d, b, iters, 0, backward=False)
    if op.startswith("gather_"):
        return launch_counts(gather_rows=iters)
    if op.startswith("scatter_add_"):
        return launch_counts(scatter_rows=iters * int(bf16))
    return launch_counts()   # the GEMM, the sampling, sort + index_add_


def anatomy_phase(ds, dev: torch.device, phase_mark) -> list:
    """Phase 15: the three anatomy tools on the 100k graph; returns their
    kernel rows."""
    pad = ds.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    t0 = time.perf_counter()
    keep = {}
    check_anatomy("100k", step_anatomy.anatomy(ds, pad, ANATOMY_BATCH, dev,
                                               log=log, keep=keep), NODES,
                  FEATS, keep["ids"])
    log(f"[anatomy] step_anatomy 100k in {time.perf_counter() - t0:.3f} s")
    phase_mark("phase 15: step_anatomy 100k")

    t0 = time.perf_counter()
    record = profile_cached.run(ds, pad, dev, log=log)
    log(f"[anatomy] profile_cached {json.dumps(record)} "
        f"({time.perf_counter() - t0:.3f} s)")
    rows = {r["op"]: r for r in record["rows"]}
    for op, row in rows.items():
        assert np.isfinite(row["ms"]) and row["ms"] > 0, row
        want = cached_row_launches(op, NODES, FEATS)
        assert row["launches"] == want, (op, row["launches"], want)
    log("[anatomy] profile_cached launches of every row equal the code's "
        "prediction")
    phase_mark("phase 15: profile_cached")

    t0 = time.perf_counter()
    res = profile_unsup.run(ds, pad, dev, log=log)
    log(f"[anatomy] profile_unsup {json.dumps(res)} "
        f"({time.perf_counter() - t0:.3f} s)")
    u, steps = profile_unsup.U, profile_unsup.STEPS
    want = {"block_sddmm_pallas_ms": launch_counts(pair_scores=1),
            "block_sddmm_xla_ms": launch_counts(),
            "block_gathered_ms": launch_counts(),
            "sup_step_ms": big_launches(NODES, FEATS, u, steps),
            "unsup_step_ms": big_launches(NODES, FEATS, u, steps,
                                          unsup=True)}
    assert res["launches"] == want, (res["launches"], want)
    for name in want:
        assert np.isfinite(res[name]) and res[name] > 0, (name, res[name])
    pairs, emb = profile_unsup.block_inputs(dev)
    ref_loss, ref_grad = profile_unsup.block_fn("sddmm_xla", pairs)(emb)
    for variant in ("sddmm_pallas", "gathered"):
        loss, grad = profile_unsup.block_fn(variant, pairs)(emb)
        dl = abs(float(loss) - float(ref_loss))
        dg = float((grad.float() - ref_grad.float()).abs().max())
        bar_l = 1e-2 * abs(float(ref_loss))
        bar_g = 2e-2 * float(ref_grad.float().abs().max())
        log(f"[anatomy] block {variant} against sddmm_xla: dloss {dl} "
            f"(bar {bar_l}), dgrad_max {dg} (bar {bar_g})")
        assert dl <= bar_l and dg <= bar_g, (variant, dl, dg)
    phase_mark("phase 15: profile_unsup")

    # -------- kernel rows at the tools' shapes, against the plain versions
    targets = pairs["target_rows"]
    kernels = [scores_row(
        f"profile_unsup block, {targets.shape[0]} x {u}, H "
        f"{profile_unsup.H}, bf16", emb, targets,
        res["launches"]["block_sddmm_pallas_ms"]["pair_scores"])]
    kernels[0]["plain_device_ms"] = device_ms(
        lambda: sddmm.dense_pair_scores(emb, targets))
    b, n_pairs = targets.shape[0], targets.numel() * (profile_unsup.P
                                                      + profile_unsup.M)
    log(f"kernel {kernels[0]['name']}: dense_pair_scores device_ms "
        f"{kernels[0]['plain_device_ms']:.6f}; dense_block_pays({b}, {u}, "
        f"{n_pairs}, {profile_unsup.H}) is "
        f"{sddmm.dense_block_pays(b, u, n_pairs, profile_unsup.H)}")
    del pairs, emb, targets
    m = profile_cached.B * (FANOUT + 1)
    ids = torch.from_numpy(profile_cached.uniform_ids(NODES, m)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        table = torch.randn(NODES, HIDDEN, generator=gen, device=dev).to(
            dtype)
        kernels.append(gather_row(
            f"profile_cached uniform ids, {m} over [{NODES}, {HIDDEN}], "
            f"{name}", table, ids,
            rows[f"gather_{m}x{HIDDEN}_{name}"]["launches"]["gather_rows"]))
    g = torch.randn(m, HIDDEN, generator=gen, device=dev).bfloat16()
    kernels.append(scatter_row(
        f"profile_cached uniform ids, {m} rows into [{NODES}, {HIDDEN}]", g,
        ids, NODES,
        rows[f"scatter_add_{m}x{HIDDEN}_bfloat16"]["launches"][
            "scatter_rows"]))
    del table, g, ids
    torch.cuda.empty_cache()
    phase_mark("phase 15: kernel rows")
    return kernels


# ------------------------------------------------------------ scaling tools

# phase 16: the ports of tools/halo_overhead.py, scaling_bench.py and
# pairs_scale_bench.py; halo_overhead chip's batch a rank (the JAX tool's)
HALO_B_LOC = 4096


@contextlib.contextmanager
def exact_negatives_budget():
    """``GS_EXACT_NEG_BUDGET_S`` at its default (main sets it to 0 for the
    other phases' uniform negatives), restored after."""
    saved = os.environ.pop("GS_EXACT_NEG_BUDGET_S", None)
    try:
        yield
    finally:
        if saved is not None:
            os.environ["GS_EXACT_NEG_BUDGET_S"] = saved


def halo_chip_launches(reps: int) -> dict:
    """halo_overhead chip's launches over each chain of ``reps`` bf16
    steps, from the code: the dist step as phase 11 (o) counts it (the
    exchange's three gathers, two gather_mean layers, a scatter_rows for
    each gather's gradient: the exchange's three, both aggregates' and
    both self-row gathers'); the local oracle one gather_rows of the
    feature table, two gather_mean layers, and scatter_rows only for layer
    2's aggregate and self-row gather (layer 1 reads rows of the feature
    table, which takes no gradient)."""
    return {"dist_step": launch_counts(gather_mean=2 * reps,
                                       gather_rows=3 * reps,
                                       scatter_rows=7 * reps),
            "local_oracle": launch_counts(gather_mean=2 * reps,
                                          gather_rows=reps,
                                          scatter_rows=2 * reps)}


def scaling_launches(pipeline: str, steps: int, t_steps: int) -> dict:
    """scaling_bench's launches in world 1's timed part, float32 (every
    backward is index_add_): halo, each step the exchange's three
    gathers and two gather_mean layers; cached, each of the 3 timed epochs
    a refresh (one gather_mean) and per step the layer-1 row gather (layer
    2 aggregates the dense tree by a reshape, no kernel)."""
    if pipeline == "halo":
        return launch_counts(gather_mean=2 * steps, gather_rows=3 * steps)
    reps = scaling_bench.CACHED_REPS
    return launch_counts(gather_mean=reps, gather_rows=reps * t_steps)


def scaling_phase(ds, o_summary: dict, dev: torch.device,
                  phase_mark) -> list:
    """Phase 16: halo_overhead chip, scaling_bench halo and cached at world
    1 and pairs_scale_bench on the 100k graph; returns the kernel rows at
    the new shapes."""
    calls, counts = {}, collections.Counter()
    # -------- halo_overhead chip: the dist step against the local oracle
    t0 = time.perf_counter()
    first = {}
    with kernel_calls("halo_overhead chip", calls, counts):
        (row,) = halo_overhead.run_chip(ds, dev, b_loc=HALO_B_LOC,
                                        first_losses=first)
    log(f"[scaling] halo_overhead chip {json.dumps(row)} "
        f"({time.perf_counter() - t0:.3f} s)")
    log(f"[scaling] halo_overhead chip overhead {row['halo_overhead_ms']} ms "
        f"({row['halo_overhead_pct']}%) against phase 11 (o)'s patched "
        f"exchange {o_summary['halo_overhead_ms']:.6f} ms "
        f"({o_summary['halo_overhead_pct']:.3f}%): (o) swaps only the "
        f"exchange for a gather of the pretransformed rows, the module's "
        f"oracle is the JAX tool's program over the raw 602-wide rows")
    rel = abs(first["local_oracle"] - first["dist_step"]) / abs(
        first["dist_step"])
    log(f"[scaling] first losses: dist step {first['dist_step']!r}, local "
        f"oracle {first['local_oracle']!r}, relative {rel:.3e} (bar "
        f"{BF16_LOSS_RTOL})")
    assert rel <= BF16_LOSS_RTOL, first
    want = halo_chip_launches(halo_overhead.REPS)
    assert row["launches"] == want, (row["launches"], want)
    for name in ("dist_step_ms", "local_oracle_ms"):
        assert np.isfinite(row[name]) and row[name] > 0, row
    phase_mark("phase 16: halo_overhead chip")

    # -------- scaling_bench at its defaults, world 1
    for pipeline in ("halo", "cached"):
        t0 = time.perf_counter()
        with kernel_calls(f"scaling_bench {pipeline}", calls, counts):
            record = scaling_bench.run(ds, dev, pipeline, edges=EDGES,
                                       log=log)
        log(f"[scaling] scaling_bench {pipeline} {json.dumps(record)} "
            f"({time.perf_counter() - t0:.3f} s)")
        (res,) = record["results"]
        assert res["devices"] == 1 and res["edges_per_sec"] > 0, res
        steps = record["workload"]["steps"]
        b_loc = record["workload"]["b_loc"]
        t_steps = min(steps, -(-len(ds.train_nodes) // b_loc))
        want = scaling_launches(pipeline, steps, t_steps)
        assert res["launches"] == want, (pipeline, res["launches"], want)
        log(f"[scaling] scaling_bench {pipeline} world 1: "
            f"{res['edges_per_sec']} edges/s, {res['step_ms']} ms a step; "
            f"launches {res['launches']} as predicted")
    phase_mark("phase 16: scaling_bench halo, cached")

    # -------- pairs_scale_bench with the exact-negative budget at its
    # default
    with exact_negatives_budget():
        cores = os.cpu_count() or 1
        est = (len(ds.train_nodes) * len(ds.graph.indices)
               / (300e6 * cores))
        log(f"[scaling] pairs_scale_bench: {cores} cores; the auto rule's "
            f"estimate {est:.3f} s against the budget "
            f"{os.environ.get('GS_EXACT_NEG_BUDGET_S', '180')} s")
        t0 = time.perf_counter()
        pairs = pairs_scale_bench.run(ds, EDGES, log=log)
    log(f"[scaling] pairs_scale_bench {json.dumps(pairs)} "
        f"({time.perf_counter() - t0:.3f} s)")
    assert pairs["auto_rule"]["decision_here"] == "exact", pairs
    assert pairs["first_epoch_steps"] == -(-len(ds.train_nodes)
                                           // pairs_scale_bench.B), pairs
    phase_mark("phase 16: pairs_scale_bench")

    # -------- a kernel row at each shape the three runs launched, on the
    # arguments of its first launch there, against the plain version
    log(f"[scaling] launches by (kernel, shapes): {dict(counts)}")
    rows = recorded_rows(calls, counts)
    phase_mark("phase 16: kernel rows")
    return rows


def call_key(kernel: str, *args) -> tuple:
    """A launch's key: the kernel, and each tensor argument's shape, row
    stride and dtype (``scatter_rows``: also the rows it adds into)."""
    return (kernel,) + tuple(
        (tuple(a.shape), a.stride(0) if a.dim() else 0, str(a.dtype)[6:])
        if isinstance(a, torch.Tensor) else a for a in args)


@contextlib.contextmanager
def kernel_calls(tag: str, calls: dict, counts: collections.Counter):
    """Every launch of gather_rows, gather_mean (gather_max),
    gather_max_bwd, pair_scores and scatter_rows inside the block, at the
    kernel wrappers: the launches at each :func:`call_key` (``counts``)
    and the arguments of the first launch there, with ``tag``
    (``calls``)."""
    def recorded(kernel, fn):
        def launch(*args):
            key = call_key(kernel, *args)
            counts[key] += 1
            calls.setdefault(key, {"tag": tag, "args": tuple(
                a.detach() if isinstance(a, torch.Tensor) else a
                for a in args)})
            return fn(*args)
        return launch

    launch_agg = agg._launch
    with patched(gather, gather_rows_kernel=recorded(
                     "gather_rows", gather.gather_rows_kernel)), \
            patched(agg, _launch=lambda name, symbol, *args: recorded(
                name, lambda *a: launch_agg(name, symbol, *a))(*args),
                    gather_max_bwd_kernel=recorded(
                        "gather_max_bwd", agg.gather_max_bwd_kernel)), \
            patched(sddmm, pair_scores_kernel=recorded(
                "pair_scores", sddmm.pair_scores_kernel)), \
            patched(scatter, scatter_rows_kernel=recorded(
                "scatter_rows", scatter.scatter_rows_kernel)):
        yield


def recorded_rows(calls: dict, counts: collections.Counter) -> list:
    """The rows of every shape :func:`kernel_calls` recorded, each on the
    arguments of its first launch there (freed once its rows are made)."""
    rows = []
    for key in list(calls):
        rows.extend(shape_rows(key, calls.pop(key), counts[key]))
        torch.cuda.empty_cache()
    return rows


def shape_rows(key: tuple, rec: dict, launches: int) -> list:
    """The kernel rows of one recorded launch shape (:func:`kernel_calls`),
    timed on a cold L2: one row, or for gather_max_bwd two (the tie split
    alone and the whole backward, :func:`max_backward_rows`)."""
    kernel, tag, args = key[0], rec["tag"], rec["args"]
    if kernel == "gather_max_bwd":
        args = args[1:4]          # (g, embed, idx, mask, out) -> the table
    first, idx = args[0], args[1]
    dtype = "bf16" if first.dtype == torch.bfloat16 else "f32"
    stride = ("" if first.stride(0) == first.shape[1]
              else f" stride {first.stride(0)}")
    if kernel == "gather_rows":
        return [gather_row(f"{tag}, {idx.shape[0]} ids over "
                           f"{list(first.shape)}{stride}, {dtype}", *args,
                           launches, cold=True)]
    if kernel == "scatter_rows":
        return [scatter_row(f"{tag}, {first.shape[0]} rows into "
                            f"[{args[2]}, {first.shape[1]}], {dtype}", *args,
                            launches, cold=True)]
    if kernel == "pair_scores":
        return [scores_row(f"{tag}, {idx.shape[0]} x {first.shape[0]}, H "
                           f"{first.shape[1]}, {dtype}", first, idx,
                           launches, cold=True)]
    label = (f"{tag}, idx {list(idx.shape)} over {list(first.shape)}"
             f"{stride}, {dtype}")
    if kernel == "gather_max_bwd":
        return max_backward_rows(label, *args, launches, cold=True)
    return [kernel_row(kernel, label, *args, launches, cold=True)]


# ------------------------------------------------------------ studies

# phase 17: the ports of tools/validate_cached.py, staleness_quality.py,
# max_seed_study.py, prefetch_bench.py and profile_dense.py on stand-ins
# of Cora's and Pubmed's shapes: (nodes, edges drawn, features, classes)
CORA_STANDIN = (2708, 5429, 1433, 7)
PUBMED_STANDIN = (19717, 44338, 500, 3)
# the cuts, of epochs only (the tools' widths, batches, seeds and
# protocols stay): max_seed_study's 5 x 50 epochs take 0.57-0.78 s an
# epoch on the card, so 25 epochs keep the phase near 100-150 s
STUDY_EPOCHS = {"validate_cached": 50, "staleness_quality": 50,
                "max_seed_study": 25}
# synthetic_power_law's features are basis[label] plus noise, every class
# separable, so a stand-in's F1 would read 1.0 whatever the pipeline did:
# LABEL_NOISE of its labels are redrawn (RandomState(LABEL_SEED)), after
# the features, so that the best a model can reach is the share of val
# labels left as their features say (standin)
LABEL_NOISE, LABEL_SEED = 0.4, 5
# validate_cached's float32 and bfloat16 best val F1s stay within this of
# each other (23 of the Cora stand-in's 451 val nodes)
DTYPE_F1_GAP = 0.05


def standin(shape: tuple) -> tuple:
    """The stand-in of ``shape`` with LABEL_NOISE of its labels redrawn,
    and the (floor, ceiling) of its val F1: the ceiling the share of val
    nodes whose label is still their features' class (a model that
    recovers the class from the features reaches it), the floor halfway
    between the share of the most common val label (no use of the
    features) and the ceiling."""
    n, e, d, c = shape
    ds = synthetic_power_law(n, e, num_feats=d, num_classes=c, seed=824)
    rng = np.random.RandomState(LABEL_SEED)
    labels = ds.labels.copy()
    noisy = rng.rand(n) < LABEL_NOISE
    labels[noisy] = rng.randint(0, c, int(noisy.sum()))
    val = labels[ds.val_nodes]
    ceiling = float(np.mean(val == ds.labels[ds.val_nodes]))
    chance = float(np.bincount(val).max() / len(val))
    return dataclasses.replace(ds, labels=labels), ((chance + ceiling) / 2,
                                                    ceiling)


def check_f1(tag: str, f1: float, bars: tuple) -> None:
    """A stand-in's best val F1 is above the floor and below 1."""
    assert bars[0] < f1 < 1, (tag, f1, bars)


@contextlib.contextmanager
def built_batches(into: list):
    """Every compact batch the block's Trainers build (on their prefetch
    threads too), appended to ``into``."""
    build_batch = Trainer._build_train_batch

    def record(self, nodes):
        into.append(build_batch(self, nodes))
        return into[-1]

    with patched(Trainer, _build_train_batch=record):
        yield


def validate_launches(ds, rec: dict, b_sz: int, bf16: bool) -> dict:
    """validate_cached's launches, from the code: an epoch's refresh and T
    = len(train) // b_sz bfloat16-rule steps (:func:`big_launches`; in
    float32 the backward is index_add_, no scatter_rows), then its
    evaluations at the nodes themselves (:func:`evaluation_launches`)."""
    epochs = len(rec["epochs"])
    t = max(1, len(ds.train_nodes) // b_sz)
    want = big_launches(ds.num_nodes, ds.feature_dim, b_sz, t, epochs,
                        epochs, backward=bf16)
    return added(want, evaluation_launches(ds, rec["epochs"], len))


def evaluations(trainers: list) -> int:
    """The embeddings the trainers' evaluations made: val each time, test
    where val improved."""
    return sum(len(tr.history) + sum("test_f1" in h for h in tr.history)
               for tr in trainers)


def counted(tag: str, calls: dict, counts: collections.Counter, fn):
    """fn() with the counts set to 0 before and read after, its launches
    recorded by shape (:func:`kernel_calls`): (result, launches, s)."""
    agg.reset_launches()
    t0 = time.perf_counter()
    with kernel_calls(tag, calls, counts):
        out = fn()
    torch.cuda.synchronize()
    return out, dict(agg.LAUNCHES), time.perf_counter() - t0


def studies_phase(dev: torch.device, phase_mark) -> list:
    """Phase 17: the five quality and ablation tools on the stand-ins,
    exact negatives at their default budget (the tools' own runs); returns
    the kernel rows at every shape they launched."""
    calls, counts = {}, collections.Counter()
    t0 = time.perf_counter()
    (cora, cora_bars), (pubmed, pubmed_bars) = (standin(CORA_STANDIN),
                                                standin(PUBMED_STANDIN))
    log(f"[studies] stand-ins: cora {CORA_STANDIN}, pubmed "
        f"{PUBMED_STANDIN} (nodes, edges drawn, features, classes), "
        f"{LABEL_NOISE} of the labels redrawn, made in "
        f"{time.perf_counter() - t0:.3f} s; every F1 below is a stand-in's; "
        f"val F1 (floor, ceiling): cora {cora_bars}, pubmed {pubmed_bars}")
    cfg = GraphSageConfig(num_layers=2, input_size=cora.feature_dim,
                          out_size=HIDDEN)
    with exact_negatives_budget():
        # -------- validate_cached, float32 and bfloat16, b_sz 512
        epochs = STUDY_EPOCHS["validate_cached"]
        best = {}
        for dtype in ("float32", "bfloat16"):
            rec, launches, secs = counted(
                f"validate_cached {dtype}", calls, counts,
                lambda: validate_cached.run(
                    cora, epochs=epochs, compute_dtype=dtype, device=dev,
                    log=lambda line: log(f"[studies] validate_cached "
                                         f"{dtype} {line}")))
            losses = [e["loss"] for e in rec["epochs"]]
            assert len(losses) == epochs and np.all(np.isfinite(losses))
            check_f1(f"validate_cached {dtype}", rec["best_val_f1"],
                     cora_bars)
            best[dtype] = rec["best_val_f1"]
            want = validate_launches(cora, rec, 512, dtype == "bfloat16")
            assert launches == want, (dtype, launches, want)
            log(f"[studies] validate_cached {dtype}: {epochs} epochs in "
                f"{secs:.3f} s, loss {losses[0]:.6f} -> {losses[-1]:.6f}, "
                f"stand-in best val F1 {rec['best_val_f1']:.4f} test "
                f"{rec['test_f1_at_best_val']:.4f}; launches {launches} as "
                f"predicted")
        assert abs(best["float32"] - best["bfloat16"]) <= DTYPE_F1_GAP, best
        log(f"[studies] validate_cached best val F1 float32 - bfloat16: "
            f"{best['float32'] - best['bfloat16']:.4f} (bar {DTYPE_F1_GAP})")
        phase_mark("phase 17: validate_cached")

        # -------- staleness_quality, k in KS, both stand-ins
        epochs = STUDY_EPOCHS["staleness_quality"]
        trainers = []
        out, launches, secs = counted(
            "staleness_quality", calls, counts,
            lambda: staleness_quality.study(
                [("cora", cora, 512), ("pubmed", pubmed, 1024)],
                epochs=epochs, device=dev, trainers=trainers,
                log=lambda line: log(f"[studies] staleness_quality {line}")))
        want = launch_counts()
        for tr in trainers:
            want = added(want, trainer_launches(tr, epochs))
        assert launches == want, (launches, want)
        for name, bars in (("cora", cora_bars), ("pubmed", pubmed_bars)):
            assert [r["refresh_every"] for r in out[name]] == list(
                staleness_quality.KS), out
            for r in out[name]:
                check_f1(f"staleness_quality {name} k {r['refresh_every']}",
                         r["best_val_f1"], bars)
        log(f"[studies] staleness_quality ({epochs} epochs, stand-in F1s) "
            f"{json.dumps(out)} in {secs:.3f} s; launches {launches} as "
            f"predicted")
        phase_mark("phase 17: staleness_quality")

        # -------- max_seed_study, compact MAX b_sz 20
        epochs = STUDY_EPOCHS["max_seed_study"]
        trainers, built = [], []
        with built_batches(built):
            out, launches, secs = counted(
                "max_seed_study", calls, counts,
                lambda: max_seed_study.run(
                    cora, epochs=epochs, device=dev, trainers=trainers,
                    log=lambda line: log(f"[studies] max_seed_study "
                                         f"{line}")))
        want = compact_launches(trainers[0].mcfg, "sup", built,
                                evaluations(trainers))
        assert launches == want, (launches, want)
        assert len(out["seeds"]) == len(max_seed_study.SEEDS), out
        for seed, rec in out["seeds"].items():
            check_f1(f"max_seed_study seed {seed}", rec["best_val_f1"],
                     cora_bars)
        log(f"[studies] max_seed_study ({len(max_seed_study.SEEDS)} seeds, "
            f"{epochs} epochs, stand-in F1s) {json.dumps(out)} in "
            f"{secs:.3f} s, {len(built)} steps; launches {launches} as "
            f"predicted")
        phase_mark("phase 17: max_seed_study")

        # -------- prefetch_bench, sup and unsup, b_sz 128, 3 timed epochs;
        # then once more under deterministic algorithms (float32
        # index_add_ in a fixed order), where both depths must end equal
        def bit_equal(keep: dict) -> bool:
            a, b = keep["params"][0], keep["params"][2]
            return len(a) == len(b) > 0 and all(map(torch.equal, a, b))

        for method in ("sup", "unsup"):
            built, keep = [], {}
            with built_batches(built):
                res, launches, secs = counted(
                    f"prefetch_bench {method}", calls, counts,
                    lambda: prefetch_bench.run(cora, "cora",
                                               learn_method=method,
                                               device=dev, keep=keep))
            want = compact_launches(cfg, method, built, 0)
            assert launches == want, (method, launches, want)
            check = {}
            with deterministic():
                prefetch_bench.run(cora, "cora", epochs=1,
                                   learn_method=method, device=dev,
                                   keep=check)
            assert bit_equal(check), method
            log(f"[studies] prefetch_bench {method} {json.dumps(res)} in "
                f"{secs:.3f} s; seconds an epoch serial "
                f"{keep['epoch_s'][0]:.6f} prefetch2 "
                f"{keep['epoch_s'][2]:.6f}; {len(built)} batches, launches "
                f"{launches} as predicted; under deterministic algorithms "
                f"the depths end bit-equal (without: {bit_equal(keep)})")
        phase_mark("phase 17: prefetch_bench")

        # -------- profile_dense at its defaults
        keep = {}
        res, launches, secs = counted(
            "profile_dense", calls, counts,
            lambda: profile_dense.run(
                cora, device=dev, keep=keep,
                log=lambda line: log(f"[studies] profile_dense {line}")))
        # each program twice (warm, timed) over its T steps (one loss a
        # step): full_step and forward_only one gather_mean a layer a
        # step, sampling_only none
        want = launch_counts(gather_mean=2 * 2 * 2 * len(keep["full_step"]))
        assert launches == want, (launches, want)
        for name in profile_dense.PROGRAMS:
            assert np.isfinite(res[name]) and res[name] > 0, res
            assert torch.isfinite(keep[name]).all(), name
        log(f"[studies] profile_dense {json.dumps(res)} ms a step in "
            f"{secs:.3f} s; full_step losses {keep['full_step'][0]:.6f} -> "
            f"{keep['full_step'][-1]:.6f}; launches {launches} as "
            f"predicted")
        phase_mark("phase 17: profile_dense")

    # -------- a kernel row at each launch shape, against the plain version
    log(f"[studies] launches by (kernel, shapes): {dict(counts)}")
    rows = recorded_rows(calls, counts)
    phase_mark("phase 17: kernel rows")
    return rows


# ------------------------------------------------------------ config 5

# phase 14: BASELINE.json's config 5 (graphsage_torch.bigscale_bench's
# graph); the refresh's plain version runs in blocks of BIG_BLOCK rows
BIG_BLOCK = 50_000
BIG_SERVE_ROW = "powerlaw1M_cap16_bf16"
BIG_EPOCHS = 2


@contextlib.contextmanager
def first_calls(module, name: str, keep: dict, key_of, grad: bool = False):
    """``module.<name>`` keeping, for each key ``key_of(*args)`` that is
    not None, the arguments and output of its first call (with ``grad``,
    also the gradient that reaches that output)."""
    fn = getattr(module, name)

    def first(*args):
        out = fn(*args)
        key = key_of(*args)
        if key is not None and key not in keep:
            rec = keep[key] = {
                "args": tuple(a.detach() if isinstance(a, torch.Tensor)
                              else a for a in args),
                "out": out.detach()}
            if grad and out.requires_grad:
                out.register_hook(
                    lambda g: rec.setdefault("g", g.detach()))
        return out

    with patched(module, **{name: first}):
        yield


def big_launches(n: int, d: int, batch: int, steps: int, refreshes: int = 1,
                 epochs: int = 1, unsup: bool = False,
                 backward: bool = True) -> dict:
    """The launches of ``refreshes`` refreshes and ``epochs`` epochs of
    ``steps`` bfloat16 steps at ``batch`` over [n, d] tables, from the
    code's rules: a refresh's gather_mean; a step's gather_rows, one on the
    full-table branch (cached.layer1_full_table) and two per occurrence;
    with ``backward``, one scatter_rows a step on the full-table branch;
    for unsup one pair_scores a step where sddmm.dense_block_pays takes
    the score block of the bench's 4,096 targets x (6 + 20) pairs."""
    full = cached.layer1_full_table(n, d, batch * (FANOUT + 1), HIDDEN)
    block = unsup and sddmm.dense_block_pays(4096, batch, 4096 * (6 + 20),
                                             HIDDEN)
    t = epochs * steps
    return launch_counts(gather_mean=refreshes,
                         gather_rows=t * (1 if full else 2),
                         scatter_rows=t * int(full and backward),
                         pair_scores=t * int(block))


def added(want: dict, more: dict) -> dict:
    """``want`` with ``more``'s counts added, kernel by kernel."""
    return {name: count + more.get(name, 0) for name, count in want.items()}


def evaluation_launches(ds, history: list, rows) -> dict:
    """The launches of the evaluations in ``history``: for each embedding
    (val, and test where val F1 improved) a refresh and the layer-1
    gathers of ``rows(nodes)`` targets (:func:`big_launches`)."""
    want = launch_counts()
    for entry in history:
        for nodes, key in ((ds.val_nodes, "val_f1"),
                           (ds.test_nodes, "test_f1")):
            if key in entry:
                want = added(want, big_launches(
                    ds.num_nodes, ds.feature_dim, rows(nodes), 1,
                    backward=False))
    return want


def trainer_launches(tr: CachedTrainer, epochs: int) -> dict:
    """What the counted CachedTrainer run launches: a refresh on epochs
    0, k, 2k, ..., and the evaluations at m1 = bucket(nodes) x (K + 1)
    (:func:`evaluation_launches`); T steps an epoch; in bfloat16
    scatter_rows a step on the full-table branch (float32's backward is
    index_add_)."""
    steps = -(-len(tr.ds.train_nodes) // tr.tcfg.b_sz)
    refreshes = sum(1 for ep in range(epochs)
                    if ep % tr.tcfg.refresh_every == 0)
    want = big_launches(tr.ds.num_nodes, tr.ds.feature_dim, tr.tcfg.b_sz,
                        steps, refreshes, epochs,
                        backward=tr.mcfg.compute_dtype == "bfloat16")
    return added(want, evaluation_launches(
        tr.ds, tr.history, lambda nodes: _bucket(len(nodes))))


def big_gather_rows(recs: dict, rows_from: dict) -> list:
    """gather_rows and scatter_rows kernel rows at each 1M-row shape that a
    counted run recorded (``rows_from``: key -> (label, launches))."""
    rows = []
    for key, (label, launches) in rows_from.items():
        rec = recs[key]
        table, idx = rec["args"]
        rows.append(gather_row(label, table, idx, launches))
        if "g" in rec:
            rows.append(scatter_row(label + " backward", rec["g"], idx,
                                    table.shape[0], launches))
    return rows


# ------------------------------------------- phase 18: the pretransform

PRETRANSFORM_SOURCE = "graphsage_torch/csrc/pretransform.cu"
# serving's two MEAN layers on config 5: [1M, K] -> 2H = 256
BIG_NODES, BIG_FEATS, BIG_CAP = 1_000_000, 602, 16


def three_piece_check(name: str, got: torch.Tensor, want: torch.Tensor,
                      h: torch.Tensor, w: torch.Tensor) -> tuple:
    """The bfloat16 pretransform against its plain version: every element
    within one bfloat16 ulp of the plain version's plus 2^-20 of
    |h| @ |w|.T there (both sum the same exact float32 products, in other
    orders).  Returns (max abs error, share of identical elements)."""
    absprod = torch.matmul(h.float().abs(), w.float().abs().T)
    diff = (got.float() - want.float()).abs()
    excess = float((diff - bf16_ulp(want) - 2.0**-20 * absprod).max())
    if excess > 0:
        raise AssertionError(f"{name}: {excess} outside the three-piece "
                             f"bound")
    del absprod
    return float(diff.max()), float((got == want).float().mean())


def pretransform_row(label: str, h: torch.Tensor, w: torch.Tensor,
                     launches: int, bias: torch.Tensor | None = None
                     ) -> dict:
    """The pretransform kernel against its plain version at one shape, and
    its row.  Yardsticks: the path the kernel replaced (upcast, float32
    SGEMM, cast: ``library_ms``) and a one-piece bfloat16 ``torch.mm``
    (``bf16_mm_ms``, a product of bf16(w) alone, not the same function).
    With ``bias`` the row is the bias-and-relu epilogue's: the library
    path adds the bias and takes the relu before the cast, and the bound
    counts the algorithm's products and bytes (one float32 weight and
    bias), as the benchmark's pool_roofline.embed does."""
    n, k = h.shape
    p = w.shape[0]
    pieces = pt.split_weight(w)
    got = pt.pretransform(h, w, bias=bias)
    torch.cuda.synchronize()
    err, same = three_piece_check(f"pretransform {label}", got,
                                  pt.pretransform_plain(h, pieces, bias),
                                  h, w)
    del got
    if bias is None:
        ops = 3 * 2 * n * k * p           # the kernel's: three pieces
        nbytes = (n * k + n * p + 3 * p * k) * 2
    else:
        ops = 2 * n * k * p
        nbytes = (n * k + n * p) * 2 + (p * k + p) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    upcast = lambda: float32_pretransform(h, w, bias)
    w16 = w.bfloat16()
    bf16_mm = lambda: torch.mm(h, w16.T)
    kernel = ("pretransform_kernel" if bias is None
              else "pretransform_bias_relu_kernel")
    row = {
        "name": f"{kernel.removesuffix('_kernel')} ({label})",
        "route": "cuda",
        "source": PRETRANSFORM_SOURCE,
        "replaces": ("no TPU kernel: cuBLAS's float32 SGEMM and two casts"
                     if bias is None else "no TPU kernel: the JAX package "
                     "has no pool aggregator"),
        "launches": launches,
        "max_abs_err": err,
        "identical": same,
        **times(lambda: pt.pretransform(h, w, bias=bias), kernel,
                library=upcast, reps=20),
        "plain_ms": cuda_ms(lambda: pt.pretransform_plain(
            h, pt.split_weight(w), bias), reps=3, warmup=1),
        "bf16_mm_ms": cuda_ms(bf16_mm, reps=20),
        "bf16_mm_device_ms": device_ms(bf16_mm),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    library = ("upcast + float32 SGEMM + cast" if bias is None else
               "upcast + float32 SGEMM + bias + relu + cast")
    log(f"kernel {row['name']}: h {tuple(h.shape)} stride {h.stride(0)} "
        f"bf16, w {tuple(w.shape)} f32, {ops} operations, {nbytes} bytes; "
        f"{timing_note(row)} [library: {library}] "
        f"bf16_mm_ms {row['bf16_mm_ms']:.6f} bf16_mm_device_ms "
        f"{row['bf16_mm_device_ms']:.6f} max_abs_err {err} identical "
        f"{same:.6f}")
    return row


def float32_pretransform(h: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """The path a bfloat16 table took before the kernel: upcast, float32
    product (plus ``bias``, then relu, where given), cast
    (``layers.pretransform``'s stand-in for the A/B)."""
    z = torch.matmul(h.float(), w.float().T)
    if bias is not None:
        z = torch.relu(z + bias.float())
    return z.to(h.dtype)


def pretransform_phase(dev: torch.device, phase_mark=None) -> list:
    """Phase 18: the bfloat16 pretransform kernel at serving's two MEAN
    layers on config 5, [1M, 602] and [1M, 128] -> 256, against its plain
    version with its row; then a 1M-node MEAN bfloat16 serving pass over a
    width-16 table, launches counted (one pretransform and one gather_mean
    a layer), its table against the same pass through the float32 path,
    and the two passes timed in turns."""
    gen = torch.Generator(device=dev).manual_seed(18)
    rows = []
    feats = torch.randn(BIG_NODES, BIG_FEATS, generator=gen,
                        device=dev).bfloat16()
    cfg = GraphSageConfig(num_layers=2, input_size=BIG_FEATS,
                          out_size=HIDDEN, compute_dtype="bfloat16")
    params = init_graphsage(torch.Generator().manual_seed(824), cfg)
    params = {"layers": [{"weight": lay["weight"].to(dev)}
                         for lay in params["layers"]]}
    with torch.no_grad():
        for layer, h in enumerate((feats, torch.randn(
                BIG_NODES, HIDDEN, generator=gen, device=dev).bfloat16())):
            w = params["layers"][layer]["weight"]
            d = h.shape[1]
            w_part = torch.cat([w[:, :d], w[:, d:]])
            rows.append(pretransform_row(f"serving layer {layer + 1}, "
                                         f"[{BIG_NODES}, {d}] -> "
                                         f"{w_part.shape[0]}", h, w_part, 1))
            del h
    if phase_mark is not None:
        phase_mark("phase 18: pretransform rows")

    degrees = torch.randint(0, BIG_CAP + 1, (BIG_NODES,), generator=gen,
                            device=dev, dtype=torch.int32)
    neighbors = torch.randint(0, BIG_NODES, (BIG_NODES, BIG_CAP),
                              generator=gen, device=dev, dtype=torch.int32)
    pad = PaddedAdjacency(neighbors=neighbors, degrees=degrees,
                          true_degrees=None, truncated=True)

    def embed_all():
        return infer.full_graph_embeddings(params, cfg, feats, pad,
                                           fetch=False, device=dev)

    agg.reset_launches()
    table = embed_all()
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    want = launch_counts(pretransform=2, gather_mean=2)
    log(f"[pretransform] 1M MEAN bf16 pass: launches {launches}, predicted "
        f"{want}")
    assert launches == want, (launches, want)
    with patched(layers, pretransform=float32_pretransform):
        ref = embed_all()
    diff = (table.float() - ref.float()).norm(dim=1)
    norms = ref.float().norm(dim=1)
    gap = float((diff / torch.maximum(norms, norms.median())).max())
    log(f"[pretransform] 1M MEAN bf16 pass against the float32 path: max "
        f"abs diff {float((table.float() - ref.float()).abs().max())}, "
        f"identical {float((table == ref).float().mean()):.6f}, worst row "
        f"gap {gap:.3e}")
    assert gap < 0.01, gap
    del table, ref, diff, norms

    def with_float32():
        with patched(layers, pretransform=float32_pretransform):
            return embed_all()

    kernel_ms, float32_ms = in_turns(embed_all, with_float32, 5)
    log(f"[pretransform] 1M MEAN bf16 pass, in turns: kernel "
        f"{statistics.median(kernel_ms):.6f} ms (all {kernel_ms}), float32 "
        f"path {statistics.median(float32_ms):.6f} ms (all {float32_ms})")
    profile_device(embed_all, statistics.median(kernel_ms))
    del feats, pad, neighbors, degrees
    torch.cuda.empty_cache()
    return rows


# ----------------------------- phase 19: the pool transform's epilogue

# serving's two POOL layers on sage_pool_reddit: [232965, K] -> P = 512
POOL_NODES, POOL_HIDDEN, POOL_SIZE, POOL_CAP = 232_965, 256, 512, 25


def pool_phase(dev: torch.device, phase_mark=None) -> list:
    """Phase 19: the pretransform's bias-and-relu epilogue at serving's two
    POOL layers on sage_pool_reddit, [232965, 602] and [232965, 256] ->
    512, against its plain version with its row; then a 232,965-node POOL
    bfloat16 serving pass over a width-25 table, launches counted (one
    pretransform and one gather_max a layer), its table against the same
    pass through the float32 pool transform, and the two passes timed in
    turns.  The biases are drawn (``init_pool``'s are zero), so that the
    epilogue's sum is tested."""
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    feats = torch.randn(POOL_NODES, BIG_FEATS, generator=gen,
                        device=dev).bfloat16()
    cfg = GraphSageConfig(num_layers=2, input_size=BIG_FEATS,
                          out_size=POOL_HIDDEN, agg_func="POOL",
                          pool_size=POOL_SIZE, compute_dtype="bfloat16")
    params = init_graphsage(torch.Generator().manual_seed(824), cfg)
    params = {"layers": [{"weight": lay["weight"].to(dev)}
                         for lay in params["layers"]],
              "pool": [{"weight": mlp["weight"].to(dev),
                        "bias": 0.1 * torch.randn(POOL_SIZE, generator=gen,
                                                  device=dev)}
                       for mlp in params["pool"]]}
    with torch.no_grad():
        for layer, h in enumerate((feats, torch.randn(
                POOL_NODES, POOL_HIDDEN, generator=gen,
                device=dev).bfloat16())):
            mlp = params["pool"][layer]
            rows.append(pretransform_row(
                f"serving POOL layer {layer + 1}, [{POOL_NODES}, "
                f"{h.shape[1]}] -> {POOL_SIZE}", h, mlp["weight"], 1,
                bias=mlp["bias"]))
            del h
    if phase_mark is not None:
        phase_mark("phase 19: pretransform_bias_relu rows")

    degrees = torch.randint(0, POOL_CAP + 1, (POOL_NODES,), generator=gen,
                            device=dev, dtype=torch.int32)
    neighbors = torch.randint(0, POOL_NODES, (POOL_NODES, POOL_CAP),
                              generator=gen, device=dev, dtype=torch.int32)
    pad = PaddedAdjacency(neighbors=neighbors, degrees=degrees,
                          true_degrees=None, truncated=True)

    def embed_all():
        return infer.full_graph_embeddings(params, cfg, feats, pad,
                                           fetch=False, device=dev)

    embed_all()                                  # warm
    torch.cuda.synchronize()
    agg.reset_launches()
    table = embed_all()
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    want = launch_counts(pretransform=2, gather_max=2)
    log(f"[pool] {POOL_NODES}-node POOL bf16 pass: launches {launches}, "
        f"predicted {want}")
    assert launches == want, (launches, want)
    with patched(layers, pretransform=float32_pretransform):
        ref = embed_all()
    diff = (table.float() - ref.float()).norm(dim=1)
    norms = ref.float().norm(dim=1)
    gap = float((diff / torch.maximum(norms, norms.median())).max())
    log(f"[pool] POOL bf16 pass against the float32 pool transform: max "
        f"abs diff {float((table.float() - ref.float()).abs().max())}, "
        f"identical {float((table == ref).float().mean()):.6f}, worst row "
        f"gap {gap:.3e}")
    assert gap < 0.01, gap
    del table, ref, diff, norms

    def with_float32():
        with patched(layers, pretransform=float32_pretransform):
            return embed_all()

    kernel_ms, float32_ms = in_turns(embed_all, with_float32, 5)
    log(f"[pool] POOL bf16 pass, in turns: epilogue kernel "
        f"{statistics.median(kernel_ms):.6f} ms (all {kernel_ms}), float32 "
        f"pool transform {statistics.median(float32_ms):.6f} ms (all "
        f"{float32_ms})")
    profile_device(embed_all, statistics.median(kernel_ms))
    del feats, pad, neighbors, degrees
    torch.cuda.empty_cache()
    return rows


def config5_phase(dev: torch.device, phase_mark) -> list:
    """Phase 14: config 5 through the four modules, in this process."""
    torch.cuda.empty_cache()
    n, e, d = bigscale_bench.NODES, bigscale_bench.EDGES, bigscale_bench.FEATS
    for b in (*bigscale_bench.SUP_BATCHES, bigscale_bench.UNSUP_BATCH):
        full = cached.layer1_full_table(n, d, b * (FANOUT + 1), HIDDEN)
        log(f"[config5] layer-1 branch at D {d}, B {b}, m1 "
            f"{b * (FANOUT + 1)}: "
            f"{'full table' if full else 'per occurrence'}")
        assert full
    ds, pad, gen_s = bigscale_bench.load_1m(n, e)
    log(f"[config5] graph: {n} nodes, {int(pad.true_degrees.sum())} edge "
        f"slots, table [{pad.num_nodes}, {pad.width}], generated in "
        f"{gen_s:.3f} s (host)")
    feats = bigscale_bench.device_feats(n, d, dev)
    train_split = n // 2
    refreshes, gathers, serving = {}, {}, {}

    def big_key(*args):
        return (tuple(args[0].shape), args[1].shape[0]) if (
            args[0].shape[0] == n) else None

    # -------- bigscale_bench: 65536, 131072, direct at k 4, unsup
    t0 = time.perf_counter()
    with first_calls(cached, "mean_aggregate", refreshes, big_key), \
            first_calls(cached, "gather_rows", gathers, big_key, grad=True), \
            patched(bigscale_bench, DIRECT_KS=(4,)):
        record = bigscale_bench.run(
            ds, pad, feats, {*map(str, bigscale_bench.SUP_BATCHES), "direct",
                             "unsup"}, dev, gen_s, log=log)
    log(f"[config5] bigscale_bench rows in {time.perf_counter() - t0:.3f} s")
    rows_by = {r["name"]: r for r in record["rows"]}
    for b in bigscale_bench.SUP_BATCHES:
        row = rows_by[f"powerlaw1M_b{b}_cached_bfloat16"]
        t = row["honest_T"]
        assert t == -(-train_split // b), (b, t)
        assert np.isfinite(row["step_ms"]) and row["step_ms"] > 0, row
        assert row["launches"] == big_launches(n, d, b, t), row
        assert row["steponly_launches"] == big_launches(n, d, b, t, 0), row
    b = bigscale_bench.DIRECT_BATCH
    row = rows_by[f"powerlaw1M_b{b}_cached_bfloat16_direct_k4"]
    assert row["launches"] == big_launches(n, d, b, row["honest_T"], 1,
                                           4), row
    b = bigscale_bench.UNSUP_BATCH
    unsup = rows_by[f"powerlaw1M_b{b}_cached_bfloat16_unsup"]
    assert unsup["launches"] == big_launches(
        n, d, b, -(-train_split // b), unsup=True), unsup
    log(f"[config5] launches of every row equal the code's prediction")
    phase_mark("phase 14: bigscale_bench rows")

    # -------- profile_bigscale
    t0 = time.perf_counter()
    b, steps = profile_bigscale.BATCH, profile_bigscale.STEPS
    prof = profile_bigscale.run(ds, pad, feats, dev, b, steps, log=log)
    log(f"[config5] profile_bigscale {json.dumps(prof)} "
        f"({time.perf_counter() - t0:.3f} s)")
    want = {"refresh_ms": launch_counts(gather_mean=3),
            "steponly_ms_per_step": big_launches(n, d, b, steps, 0),
            "forward_only_ms_per_step": big_launches(n, d, b, steps, 0,
                                                     backward=False),
            "stopgrad_w1_ms_per_step": big_launches(n, d, b, steps, 0,
                                                    backward=False)}
    assert prof["launches"] == want, (prof["launches"], want)

    # -------- step_anatomy's 1m workload (phase 15's checks)
    t0 = time.perf_counter()
    keep = {}
    check_anatomy("1m", step_anatomy.anatomy(ds, pad, ANATOMY_BATCH, dev,
                                             feats=feats, log=log,
                                             keep=keep), n, d, keep["ids"])
    log(f"[config5] step_anatomy 1m in {time.perf_counter() - t0:.3f} s")

    # -------- refresh_locality
    t0 = time.perf_counter()
    loc = refresh_locality.run(ds, pad, feats, dev, log=log)
    log(f"[config5] refresh_locality {json.dumps(loc)} "
        f"({time.perf_counter() - t0:.3f} s)")
    phase_mark("phase 14: profile_bigscale, refresh_locality")

    # -------- the 1M serving row (infer_bench --bigscale's)
    spec = next(s for s in infer_bench._row_specs(bigscale=True)
                if s["name"] == BIG_SERVE_ROW)
    with first_calls(infer, "mean_aggregate", serving, big_key):
        srow, emb = infer_bench.serve_row(
            BIG_SERVE_ROW, ds, infer_bench.padded(ds, spec["width"]),
            spec["dtype"], spec["agg"], spec["note"], dev)
    assert srow["launches"] == launch_counts(gather_mean=2,
                                             pretransform=2), srow
    assert emb.shape == (n, HIDDEN) and np.isfinite(emb).all()
    log(f"[config5] {json.dumps(srow)}")
    del emb
    torch.cuda.empty_cache()

    # -------- kernel rows of the 602-wide path, against the plain versions
    kernels = []
    (refresh,) = refreshes.values()
    embed, idx, mask = refresh["args"]
    kernels.append(kernel_row(
        "gather_mean", f"config 5 refresh, bf16, idx {list(idx.shape)} over "
        f"{list(embed.shape)}", embed, idx, mask,
        rows_by[f"powerlaw1M_b{bigscale_bench.SUP_BATCHES[0]}_cached_"
                f"bfloat16"]["launches"]["gather_mean"], block=BIG_BLOCK))
    err = max(check_close(f"[config5] the first refresh rows {lo}:"
                          f"{lo + BIG_BLOCK}",
                          refresh["out"][lo:lo + BIG_BLOCK],
                          agg.mean_aggregate_plain(
                              embed, idx[lo:lo + BIG_BLOCK],
                              mask[lo:lo + BIG_BLOCK]))
              for lo in range(0, n, BIG_BLOCK))
    log(f"[config5] the main path's first refresh against the plain "
        f"version, {-(-n // BIG_BLOCK)} blocks of {BIG_BLOCK} rows: max abs "
        f"error {err}")
    del refreshes, refresh, embed, idx, mask
    (serve,) = serving.values()
    kernels.append(kernel_row(
        "gather_mean", f"serving {BIG_SERVE_ROW} layers 1-2, bf16, idx "
        f"{list(serve['args'][1].shape)} over {list(serve['args'][0].shape)}"
        f", stride {serve['args'][0].stride(0)}", *serve["args"],
        srow["launches"]["gather_mean"], block=BIG_BLOCK))
    del serving, serve
    steps_of = {b: -(-train_split // b) for b in
                (*bigscale_bench.SUP_BATCHES, bigscale_bench.UNSUP_BATCH)}
    kernels.extend(big_gather_rows(gathers, {
        ((n, HIDDEN), b * (FANOUT + 1)): (
            f"config 5 b{b} full table, {b * (FANOUT + 1)} ids over "
            f"[{n}, {HIDDEN}]", steps_of[b])
        for b in steps_of}))
    del gathers
    torch.cuda.empty_cache()
    phase_mark("phase 14: kernel rows of the 602-wide path")

    # -------- train_1m_e2e, two epochs (a cut of scale only)
    del feats, ds, pad, record
    torch.cuda.empty_cache()
    ds64, gen64_s = train_1m_e2e.load(n, e)
    log(f"[config5] the {train_1m_e2e.FEATS}-wide dataset generated in "
        f"{gen64_s:.3f} s (host)")
    refreshes, gathers = {}, {}
    out_dir = os.path.join(BUILD_DIR, "chip_smoke_config5")
    agg.reset_launches()
    t0 = time.perf_counter()
    with first_calls(cached, "mean_aggregate", refreshes, big_key), \
            first_calls(cached, "gather_rows", gathers, big_key):
        rec, tr = train_1m_e2e.run(ds64, dev, out_dir, BIG_EPOCHS,
                                   train_1m_e2e.B_SZ, gen64_s, e, log=log)
    torch.cuda.synchronize()
    launches = dict(agg.LAUNCHES)
    # the timed epochs and the idle probe's epoch
    want = trainer_launches(tr, BIG_EPOCHS + 1)
    tr.pair_sampler.close()
    log(f"[config5] train_1m_e2e {json.dumps(rec)} "
        f"({time.perf_counter() - t0:.3f} s); launches {launches}; "
        f"predicted from the code {want}")
    assert launches == want, (launches, want)
    assert len(rec["epochs"]) == BIG_EPOCHS
    losses = [ep["mean_loss"] for ep in rec["epochs"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    log(f"[config5] train_1m_e2e mean losses {losses}, val F1 "
        f"{[ep['val_f1'] for ep in rec['epochs']]}, best val F1 "
        f"{rec['best_val_f1']}")
    m1 = train_1m_e2e.B_SZ * (FANOUT + 1)
    key = ((n, train_1m_e2e.FEATS), m1)
    assert not cached.layer1_full_table(n, train_1m_e2e.FEATS, m1, HIDDEN)
    embed, idx, mask = refreshes[((n, train_1m_e2e.FEATS), n)]["args"]
    kernels.append(kernel_row(
        "gather_mean", f"train_1m_e2e refresh, bf16, idx {list(idx.shape)} "
        f"over {list(embed.shape)}", embed, idx, mask,
        launches["gather_mean"], block=BIG_BLOCK))
    table, idx = gathers[key]["args"]
    kernels.append(gather_row(
        f"train_1m_e2e per occurrence, {m1} ids over {list(table.shape)}",
        table, idx, launches["gather_rows"]))
    del refreshes, gathers, tr, ds64
    torch.cuda.empty_cache()
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # uniform negatives: "auto" would choose by the host's core count
    os.environ["GS_EXACT_NEG_BUDGET_S"] = "0"
    return run(torch.device("cuda"))


def run(dev: torch.device) -> int:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    start = time.perf_counter()

    def phase_done(what: str) -> None:
        log(f"-- {what} done at {time.perf_counter() - start:.1f} s")

    t0 = time.perf_counter()
    reused = all(build.library_path(name).exists() for name in build.SOURCES)
    # the host engine (g++) builds beside the kernels (one nvcc each)
    engine = concurrent.futures.ThreadPoolExecutor(1).submit(
        native_build.build)
    paths = build.build()
    for name in build.SOURCES:
        build.load_library(name)
    log(f"build: {', '.join(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.3f} s"
        f"{' (existing builds, reused)' if reused else ''}")
    for path in paths.values():
        log(path.with_suffix(".log").read_text().strip())
    log(f"build: host engine {engine.result().name} ready after "
        f"{time.perf_counter() - t0:.3f} s")
    smi = nvidia_smi()
    log(f"card: {smi}")
    global ADD_NS
    ADD_NS = add_latency(dev)

    small_graph_check(dev)
    phase_done("phases 1-2 (build, small graph)")

    t0 = time.perf_counter()
    ds = synthetic_power_law(NODES, EDGES, num_feats=FEATS,
                             num_classes=CLASSES, seed=0)
    pad = ds.graph.to_padded_sampled(WIDTH, np.random.RandomState(99))
    n_valid = int(pad.degrees.sum())
    log(f"graph: {NODES} nodes, {ds.graph.num_edges} directed edges, "
        f"table [{pad.num_nodes}, {pad.width}], {n_valid} valid slots, "
        f"made in {time.perf_counter() - t0:.3f} s")
    feats = torch.from_numpy(ds.features).to(dev)
    pad = PaddedAdjacency(neighbors=torch.from_numpy(pad.neighbors).to(dev),
                          degrees=torch.from_numpy(pad.degrees).to(dev),
                          true_degrees=pad.true_degrees,
                          truncated=pad.truncated)

    summaries, rows = [], []
    for agg_func, dtype in CONFIGS:
        cfg = GraphSageConfig(num_layers=2, input_size=FEATS,
                              out_size=HIDDEN, agg_func=agg_func,
                              compute_dtype=dtype)
        gen = torch.Generator().manual_seed(824)
        params = {"sage": init_graphsage(gen, cfg),
                  "clf": init_classifier(gen, HIDDEN, CLASSES)}
        summary, kernel_rows = serve_config(f"{agg_func} {dtype}", cfg,
                                            params, feats, pad, n_valid, dev)
        summaries.append(summary)
        rows.extend(kernel_rows)
    log(json.dumps({"serving": summaries}))
    phase_done("phase 3 (serving)")

    rows.extend(pretransform_phase(dev, phase_done))
    phase_done("phase 18 (the bfloat16 pretransform)")

    rows.extend(pool_phase(dev, phase_done))
    phase_done("phase 19 (the pool transform's epilogue)")

    train_ds = dataclasses.replace(ds,
                                   train_nodes=ds.train_nodes[:TRAIN_NODES])
    training = {method: train_method(method, train_ds, dev)
                for method in ("plus_unsup", "sup")}
    unsup = training["plus_unsup"]
    step_inputs = capture_step_inputs(unsup["trainer"])
    rows.extend(mean_step_rows(step_inputs,
                               unsup["launches"]["gather_mean"]))
    rows.extend(score_rows(step_inputs, unsup["launches"]["pair_scores"],
                           dev))
    # MAX (sup, gcn) and LSTM (plus_unsup) on the compact pipeline
    for key, method, agg_func, gcn in (("sup MAX gcn", "sup", "MAX", True),
                                       ("plus_unsup LSTM", "plus_unsup",
                                        "LSTM", False)):
        res = training[key] = train_method(method, train_ds, dev, agg_func,
                                           gcn, free_running=False)
        step_inputs = capture_step_inputs(res["trainer"])
        step_rows = max_step_rows if agg_func == "MAX" else lstm_step_rows
        rows.extend(step_rows(step_inputs, res["launches"]))
    log(json.dumps({"training": {
        method: {"ms_per_step": v["ms_per_step"]}
        for method, v in training.items()}}))
    del training, unsup, step_inputs, res
    phase_done("phases 4-5 (compact training, kernel rows)")

    cli_round_trip(dev)
    cli_cached(dev)
    phase_done("phase 6 (CLI)")

    results = {}
    for config in CACHED_CONFIGS:
        results[config[0]] = cached_config(*config, ds=ds, dev=dev)
    rows.extend(cached_rows(results))
    log(json.dumps({"cached": {label: res["summary"]
                               for label, res in results.items()}}))
    total = sum(res["launches"]["gather_rows"] for res in results.values())
    phase_done("phase 7 (cached training)")

    # phase 3 for the cached-LSTM hybrid that (d) trained and exported
    params, cfg, _, meta = infer.load_bundle(results["d"]["bundle"])
    assert meta["lstm_hybrid"] is True
    summary, _ = serve_config("LSTM hybrid float32", cfg, params, feats, pad,
                              n_valid, dev, lstm_hybrid=True)
    log(json.dumps({"serving": [summary]}))
    del results, feats, pad
    phase_done("phase 3 for the hybrid")
    rows.extend(microbench_rows(dev, total))
    phase_done("phase 8 (microbench)")

    bf16_rows, bf16_runs = bf16_phase(ds, train_ds, dev, phase_done)
    rows.extend(bf16_rows)
    phase_done("phase 9 (bf16 training)")

    del train_ds
    resume_phase(dev)
    phase_done("phase 10 (checkpoints and resume)")

    dist_rows, dist_summaries = dist_phase(ds, bf16_runs, dev, phase_done)
    rows.extend(dist_rows)
    phase_done("phase 11 (distribution)")

    rows.extend(tp_phase(ds, dev, phase_done))
    phase_done("phase 12 (tensor parallel)")

    rows.extend(bench_phase(ds, bf16_runs["e"]["summary"], dev))
    phase_done("phase 13 (bench rows)")

    rows.extend(anatomy_phase(ds, dev, phase_done))
    phase_done("phase 15 (anatomy tools)")

    rows.extend(scaling_phase(ds, dist_summaries["o"], dev, phase_done))
    phase_done("phase 16 (scaling tools)")

    rows.extend(studies_phase(dev, phase_done))
    phase_done("phase 17 (quality and ablation tools)")

    del ds
    rows.extend(config5_phase(dev, phase_done))
    phase_done("phase 14 (config 5)")

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
