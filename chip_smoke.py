#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of memgraph_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (any failed check exits nonzero):

1. Card: print ``nvidia-smi``'s name and power limit; build the CUDA
   kernels (``memgraph_tpu_torch/ops/csrc/*.cu``, nvcc, in parallel), the
   host Benes router and the native CSR builder (g++), timed.
2. Benes kernels against their plain PyTorch versions on the card:
   random permutations routed by the port's router at n = 7, 10, 12, 14,
   16, 17, 20, 24 slots (log2), in f32 and bf16, plus two small-K
   networks (n = 20, K = 8: 4096 rows; n = 16, K = 1: 2^15 rows) and the
   identity permutation (every stage dead).  Each network is placed on
   the card from the router's packed mask rows (``build_masks`` selects
   the live rows; nothing is unpacked): its middle stages composed
   (``compose_mid``: one ``benes_mid`` launch on the iota) into the index
   that ``benes_mid_gather`` applies, each outer side (``compose_outer``:
   one ``benes_outer`` launch per live side) into the row index that
   ``benes_outer_gather`` applies; both indices must equal the CPU
   composition, and the kernels' ``benes_apply`` the stage-by-stage
   plain network.  Bit-exact; the launch counters must move.  Every
   network's four kernels are also held alone against their plain
   versions on values; at n = 20 and 24 they are timed too (kernel,
   plain-version, bound and gather ``x[perm]`` times; the stage kernels
   also on the 16-bit iota that placement feeds them).
3. Microbenchmark kernels (``memgraph_tpu_torch/benchmarks/micro*.py``,
   ``ops/csrc/micro.cu``): the three entry points run at the JAX module's
   sizes with the launch counters reset just before and read just after
   (each counter must move by what its entry point's timing implies).
   Then each of the ten kernels is held against its plain version on the
   card (bit-exact, or within its stated tolerance), transpose_loop and
   sandwich also on random values at an odd iteration count,
   lane_gather_loop also at R = 100 (a ragged last block) x 501 on random
   values, gather_loop also at R = 256 x 51 and at its largest R = 16384
   x 3, big_matmul also at (64, 32, 32) x 3 and (256, 512, 96) x 7 (its
   smaller tiles).  The five looping kernels fail if their time is under
   0.95 x their on-chip bound, which would mean work was skipped (a
   hoisted product, passes merged, gathers composed); their lines print
   the launch design (blocks, cluster size, threads, shared memory, SMs
   occupied) and the share of the bound reached; gather_loop's and
   lane_gather_loop's also their ``split``: the time at several iteration
   counts, t(0) (entry, exit, launch) and the time an iteration.  Each
   kernel is timed: warm device time (``ms``: launches queued behind a
   device spin, so the Python wrapper's cost hides), cold (a 128 MB
   scratch write between launches, where the inputs fit in the 50 MB L2),
   back to back from Python (``host_ms``), plain, one PyTorch call (or the
   loop of calls a looping kernel stands for), the bound, and for kernels
   that loop on chip the on-chip bound (shared-memory or shuffle bytes
   over 128 B/clock/SM on every SM of the card, at ``clocks.max.sm``:
   lane_gather_loop 4 B a value an iteration, one shuffle's or one
   read's, gather_loop 8 B, a read and a write; sandwich 24 B, the
   fewest its five passes need with each gather folded into the round
   trip of the transpose after it; for big_matmul its FMAs over 256
   flop/clock on every SM).  One ``micro`` line per kernel and size.
4. Main path at the north-star size: a skewed digraph of 1,000,000 nodes
   and 10,000,000 edges from seed 7 (``dst = rand**2 * n``) held by a
   versioned ``northstar.CooSource``, snapshot v0 from
   ``ops.csr.GraphCache.get`` (one full export, whose ``from_coo`` must
   go through the native CSR builder, placed on the card) ->
   ``ops.pagerank.pagerank`` with 50
   iterations at damping 0.85 and tol 0, in f32 and in bf16 (one MXU
   plan serves both).  Launch counts are reset just before and read just
   after, and must equal what the plan's networks imply.  f32 ranks
   against a float64 scipy power iteration; bf16 against f32 inside
   ``PRECISION_BOUNDS["bf16"]``.  Placement must not call
   ``np.unpackbits``; the line gives each route's placement split (host
   mask selection, upload, CUDA-event compose time).  Each kernel is then
   held against its plain version on the main path's own networks and
   timed there (the stage kernels ``benes_mid`` and ``benes_outer``,
   which run only at placement, fed the same packed rows that were
   composed).
5. Snapshot refresh: a commit to the source of the main path's mutation
   from seed 11 (5,000 edges removed, 5,000 added on the graph's skew, 8
   nodes emptied of out-edges, 8 dangling nodes given one), and its
   snapshot v1 from ``GraphCache.get``: it must come by
   ``export_csr_delta`` from v0 (native builder), equal a full export of
   v1 array for array, and carry ``_delta_ctx = (v0, the commit's changed
   gids)``.  PageRank at f32 and bf16, cold and warm, with launch counts
   reset just before and read just after.  It fails if ``build_plan`` ran,
   if the runs did not
   share the base plan's placed routes, if the launches are not base +
   delta per iteration plus the delta's placement, if f32 leaves the
   main path's bounds against float64 on the mutated graph, if bf16
   leaves ``PRECISION_BOUNDS["bf16"]`` against the f32 delta run, or if
   the bf16 run did not move with the mutation (it sits nearer the base
   snapshot's ranks, or its change from the base's bf16 ranks misses the
   f32 change by half of it).  One ``refresh`` line;
   each kernel held and timed on the delta nets.
6. Katz on the main path's placed graph (after the main path, before
   the refresh): ``ops.katz.katz_centrality`` at α = 0.05 (about 0.5 / λ
   for the north star's Aᵀ), β = 1, 50 iterations, tol -1, f32 and
   bf16, cold and warm, launch counts reset just before and read just
   after.  The line prints λ of Aᵀ (a float64 power iteration) and α λ.
   It rides PageRank's plan and placed routes: it fails if
   ``build_plan`` ran, if any route was placed, if a stage kernel ran, or
   if a run made other than 2 x 50 ``benes_mid_gather`` and 4 x 50
   ``benes_outer_gather`` launches.  f32 against a float64 scipy run of
   the recurrence (max relative 1e-4, top-100 100/100), bf16 against f32
   inside ``PRECISION_BOUNDS["bf16"]["katz_rel"]``.  One ``katz`` line:
   the unnormalized plan's derivation and the multipliers' placement
   (seconds), iteration ms beside PageRank's in the same minute.
7. (after the refresh) The segment backend on the card: a graph of
   100,000 nodes and 450,000 edges from the north star's generator (under
   ``MXU_MIN_EDGES``); PageRank (damping 0.85) and katz (α = 0.05) at f32
   against float64 with the main path's bounds, HITS against a float64
   run of the same steps (``HITS_TOL`` of the largest entry), 50
   iterations each, cold and warm.  Degree centrality, in, out and total,
   on this graph and on the north star, bit-equal to numpy's float32
   counts over n - 1.  ``segment`` and ``degree`` lines.
   Both runs of each are bit-equal (the segment sums are the
   deterministic ``csr_spmm_sum``); its launches are counted: one an
   iteration (two for HITS) and one for PageRank's setup.
8. (after the refresh, before the segment backend) The deterministic
   segment sums (``ops/csrc/segment.cu``) on the north star:
   ``csr_spmm_sum`` over the CSC runs (the pull matvec) and the CSR runs
   (the reversed one), f32 and bf16, 1, 3 and 32 lanes, and
   ``lane_sum`` in its three forms at 1, 3 and 32 lanes; then K1 where
   its design can break: run lengths around its short/long bound T
   (T - 1, T, T + 1, 2T, 32T + 1, and empty runs), a star of 2^20 + 5
   in-edges, the no-gather form (``g=None``, first, as
   ``semiring._float_sum`` launches it) and int64 offsets and indices.
   K1 is given the longest run as the main path gives it (a graph's
   ``longest_csc_run`` / ``longest_csr_run``); where no run is long (the
   CSR runs) the two-role launch is held to the same bits and timed
   beside it (``two_role_ms``).  Each bit-equal to the plain version on
   CPU copies, a column alone bit-equal to itself inside B lanes, two
   launches bit-equal.  Timed with the plain version on the card, the
   byte bound (K1: each distinct gathered row of x read once) and
   library calls (a ``torch.sparse_csr_tensor`` product and
   ``index_add_`` for K1, ``torch.sum`` for K2), the previous design's
   time beside this run's where it was measured (``previous_ms``, on the
   ``segment_kernels`` lines only).  ``segment_kernels`` lines.
9. PPR on the north star (``ppr`` line), counts reset just before and
   read just after: one PPR (3 seeded sources, 50 iterations) against a
   float64 scipy power iteration (max error 1e-4 of the largest entry,
   top-100 100/100); a 32-lane batch (1-5 seeded sources a lane, tol
   1e-6) whose lanes 0, 7, 19 and 31 are bit-equal to sequential runs
   with equal iterations; a 3-lane batch (bucket 4, padding dropped)
   bit-equal to the big batch's first lanes; bf16 within
   ``PRECISION_BOUNDS["bf16"]``; a warm start from the converged batch
   in at most 2 iterations; ``ppr_topk`` equal to the sorted vectors,
   ties to the lower index; iteration ms single and batched; launches
   equal to one K1 and one K2 a setup, one K1 and two K2 an iteration.
10. Components and traversal on the north star (``traversal`` line):
   WCC and SCC against ``scipy.sparse.csgraph.connected_components``
   (weak, strong; labels the minimum index), SCC's rounds; SSSP with
   weights uniform in [0.5, 1.5) from seed 17 against Dijkstra (same
   unreachable set, max relative error 1e-5); BFS levels exact against
   unweighted shortest paths with push and pull levels both run;
   ``multi_source_sssp`` (8 sources) and ``khop_neighborhood`` (k = 2)
   exact; seconds a call.  No hand-written kernel is on this path (min
   is exact: ``scatter_reduce_``).
11. (after the refresh, before the segment sums) The snapshot lineage
   (``snapshot`` line): v2, a second commit (1,000 edges removed and
   1,000 added, seed 13), must come by the delta export from v1, equal a
   full export, and anchor on v0 with the gids changed since v0; its
   PageRank (f32 and bf16, cold and warm, counts reset just before and
   read just after) must refresh from v0's base plan with no
   ``build_plan``, f32 within the main path's bounds of float64, bf16
   within ``PRECISION_BOUNDS``.  Then every procedure counterpart
   (``memgraph_tpu_torch/procedures/graph_algorithms.py``) once on v2
   through the source, each returning host numpy (``procedures`` line,
   seconds a call); ``pagerank.get`` held by gid to a converged float64
   run (L1 within its stopping rule's bound), the WCC partition and the
   BFS levels to scipy on v2's edges.  Then a wrapped change log (1,025 one-edge commits)
   must give one full export, counted once in
   ``delta.fallback_rebuild_total``, with no ``_delta_ctx``, and a
   repeated ``get`` at one version the same object (``get_hit_us``).
12. Label propagation (``labelprop`` line; undirected, 30 rounds at most,
   counts reset just before and read just after): two north-star runs
   bit-equal with equal rounds; the labels after round 3 and after the
   last round equal to one numpy election (float64 run weights, the
   reference's rules) of the card's labels a round earlier; on the
   segment graph equal to a numpy run of every round, with equal rounds;
   the directed mode once.  One K1 launch a round (its no-gather form);
   the launches of the first and the last round are kept and held
   bit-equal to the plain version on CPU copies of the same inputs.
13. Betweenness (``betweenness`` line) on the north star: 8 sources from
   seed 0, directed and undirected, and 64 directed sources, against a
   float64 Brandes over the same sources (plain torch on the card; max
   error 1e-4 of the largest
   score; top 100: the card's top 100 all within that error of the
   reference's 100th score or above, the set overlap printed beside it;
   each node scored above 1e-12 of the largest within 1e-3 relative);
   the 64 sources twice, bit-equal.  K1 launches: two a level walked a
   chunk.  The second 64-source run keeps its first chunk's widest
   forward and backward launches (B = 46 real lanes, gathered, ⊗ =
   first), held bit-equal to the plain version on CPU copies of the
   same inputs and timed (``segment_kernels`` lines).
14. (after the procedures, on v2) The dense paths' procedures
   (``dense_procedures`` line; counts reset just before, read just
   after): ``link_prediction.predict`` (1 pair) and ``recommend`` (1,000
   candidates) on degree features, ``node_classification.predict`` on
   the nodes' 128-wide embedding property (``northstar.vector_corpus``,
   held by the CooSource), parameters from seed 0 carried in by
   ``load_parameters``; ``vector_search.search``, ``knn.get``,
   ``ppr_search`` and ``kmeans.get_clusters`` over that property's
   index; seconds a call.  Held to the slot's embeddings (a fresh
   forward, bit-equal); ``node_similarity.jaccard`` on v2 is refused.
   Then the training paths' procedures (``training_procedures`` line) on
   v2: ``link_prediction.train`` (degree features), its
   ``get_training_results`` and ``predict``; ``node_classification.train``
   on the embedding property and ``get_training_data``;
   ``node2vec.random_walks`` from 100 nodes; ``node2vec.get_embeddings``
   (1 epoch, ``N2V_FIT_WALKS`` walks a node) on the segment graph's
   source; then a commit of 10 edges,
   after which ``predict`` must retrain; seconds a call.
15. GraphSAGE inference (``gnn`` line) on the north star (v0) at the
   procedures' defaults (hidden 64, out 32, 2 layers) on degree
   features (16 wide) and on the embedding property (128 wide): K1's
   launches, 16 / 128 and 64 lanes over the CSC and the CSR runs, kept
   and held bit-equal to the plain version on CPU copies and timed
   (``segment_kernels`` lines ``gnn_*``); the aggregation bit-equal to
   its plain version on CPU copies; two forwards bit-equal; h against a
   float64 forward (on the card) within ``GNN_REL_TOL`` of the largest
   |h|, the bf16 rounding of the float64 result beside it.
16. kNN (``knn`` line) on the 1M x 128 corpus (64 blobs, seed 19, 1% of
   the rows freed in ``valid_mask``): l2sq and cosine, f32 and bf16, 1
   and 100 queries, k = 10 and 100, ms a batch; f32 against a float64
   top-k on 8 queries (a swap only between float64 near-ties, counted),
   bf16 against the CPU copies; ties of a duplicated row to the lower
   index; k above the live rows.
17. k-means (``kmeans`` line): 64 clusters, 10 iterations from the first
   row of each blob, equal to a float64 Lloyd run, twice bit-equal; K1
   an iteration (the centroid sums), the first held to its plain version;
   ``kmeans_fit`` from a generator, timed; the centroid means by K1 and
   by the one-hot product, each route timed whole.  IVF (``ivf`` line): 1,024
   cells, 100 queries at n_probe 8 against exact search, recall@10, and
   the two routes of the centroid means at 1,024 cells.
18. Node similarity (``similarity`` line) at 8,192 nodes and 81,920 edges
   (the north star's generator): each mode's matrix bit-equal to numpy
   float32 from exact counts, the all-pairs procedures' records its
   positive pairs, ``pairwise`` on 1,000 pairs equal to it (cosine within
   2 ulps).
19. node2vec (``node2vec`` line): walks on the north star (v0), 4 from
   each node (4,000,000), length 20, at p = q = 1 and at p = 0.5, q = 2,
   ms a step; all 80M steps checked on the card to be edges or stalls at
   a sink; at p = q = 1 one chi-square over the next nodes of the 20
   nodes of the most out-edges against a uniform choice over their rows;
   in the biased run the share of returns (next == prev) within 5
   standard errors of the reference's single-retry rule (float64 from
   the graph) on a seeded 10^6 of the steps where cur has an edge back
   to prev, a sample that must tell the rule from the uniform walk.
   ``Node2Vec.fit`` at the defaults (dim 128, length 20, window 5, 5
   negatives, batch 8192) but one walk a node (``N2V_FIT_WALKS``: the
   defaults' 4 made the two fits 76 s of the run) for one epoch on the
   segment graph (cut from the north star, whose 840M pairs an epoch do
   not fit the run), twice bit-equal, three
   K1 launches a batch (counts set to 0 just before, read just after),
   one batch's kept and held to the plain version; the loss, ms a batch,
   the mean cosine of an edge's ends above random pairs'.
20. GraphSAGE training (``gnn_train`` line) on the north star (v0) at the
   procedures' defaults (hidden 64, out 32, 2 layers, lr 0.01, 30
   epochs): link prediction on degree features and node classification
   on the embedding property (8 in-degree octile classes on a seeded 10%
   of the nodes; the majority class's share printed beside the
   accuracy), each twice bit-equal (histories and parameters), the loss
   falling; K1 launches (counts set to 0 just before, read just after)
   equal to two a layer a forward, two an aggregation whose input needs
   a gradient and one a gathered index set a step, plus the evaluation's
   forward; the aggregation's backward, its layer-2 forward and the
   gathers' backward kept, held bit-equal to the plain version and timed
   (``segment_kernels`` lines ``gnn_train_*``); one epoch's gradients
   against a float64 autograd (on the card) of the same loss within
   ``GNN_GRAD_TOL`` of each tensor's largest entry, the bf16 rounding
   beside it; ms an epoch, and a link epoch's split.
21. (on v2, after the dense procedures) The RAG procedures
   (``rag_procedures`` line): ``graphrag.retrieve`` (10 seeds, 2 hops,
   10 records) over the 1M x 128 index against a float64 PPR from the
   same seeds masked by a scipy 2-hop set (the top 10 equal up to
   near-ties, scores within 1e-4 of the largest); ``igraphalg.pagerank``
   directed on v2 (v2's plan) and undirected on the segment graph, each
   within ``pagerank.get``'s L1 bound of float64;
   ``igraphalg.shortest_path_length`` on 8 pairs of the segment graph
   with seeded weights against Dijkstra (1e-5 relative, inf where it
   has inf); ``union_find.connected`` on 1,000 pairs of v2 and of the
   segment graph against scipy's components, and with ``update=False``
   from its stored labels.
22. (after the training procedures' commit) Commit-then-CALL through a
   warm pool (``warm_pool`` line): ``pagerank.get``, ``wcc.get`` and
   ``community_detection.get`` cold, a hit (the cold call's bytes,
   read-only, us), an
   adds-only commit of 1,000 edges (seed 17) and the three warm
   (PageRank's iterations fewer than cold's and within the L1 bound of
   a converged float64 run, WCC equal to scipy, the labels a fixpoint of
   one more round), a commit removing 1,000 edges (seed 19): WCC and
   labelprop cold (``cold_start_total`` + 2), PageRank warm; no plan
   built.  ``katz_centrality.get`` cold, a hit and warm on the segment
   graph within the katz line's bounds.
23. The index's delta refresh (``vector_delta`` line) on the first
   100,000 rows of the 1M x 128 corpus (``VD_ROWS``): a full build, a commit clearing 50 vectors, then one setting
   900 vectors, 50 on the cleared vertices, 50 of length 64, and
   clearing 100: a delta (the counters); commits rewriting values the
   vertices hold wrap the log, which gives a full build of the same
   state; each live row of the delta bit-equal to it, ``valid`` exactly
   the live rows, 100 queries' top 10 equal to the full build's (one
   list read of the corpus serves both).
24. Communities (``communities`` line):
   ``community_detection.louvain`` on the segment graph and
   ``leiden_community_detection.get`` on a 20,000-node, 90,000-edge graph
   of the generator, twice each (equal), Louvain's modularity equal to a
   float64 numpy one of its partition within 1e-9 and its ids compact
   from 1, Leiden's float64 modularity at least its Louvain's; no K1 or
   Benes launch.
25. (after katz, before the refresh) The resident kernel server
   (``kernel_server`` line, ``memgraph_tpu_torch/server/
   kernel_server.py``): each resident algorithm's device peak
   (``max_memory_allocated`` over one cold run on a freshly placed
   graph, the MXU route's placed routes included) at the segment graph
   and the north star against its admission estimate, within [1x, 2x];
   the allocator's cached blocks handed back and ``mem_get_info``
   printed; the daemon spawned on the card (this process built the
   kernels first) and timed; ``pagerank.get`` with ``kernel=`` on v0
   bit-equal to this process's partition-centric loop on a mesh of 1
   (the daemon's route) and within ``pagerank.get``'s L1 bound of its
   in-process call, ``pagerank.personalized`` equal to the in-process
   answer, routed with no fallback; the ``pagerank`` op at the main
   path's 50 iterations within its bounds of float64 and bit-equal to
   this process's mesh-of-1 run, and a key-only repeat a hit with the
   same bytes; 256 single-source PPR requests
   (top 10) from 16 threads, 32 of them repeated for their full vectors
   (hits) and bit-equal to in-process runs; an out-of-range member
   ``invalid`` beside completed batchmates, an oversized request
   ``shed``; a commit of 1,000 added edges (the warm pool's seed 17)
   shipped as the delta payload: an O(delta) apply (``delta.applied_total``
   +1, no re-shard, no compaction: the generation's sharded variant moved
   by ``apply_edge_delta``) and no plan build in the daemon, the warm
   PageRank in fewer iterations than cold and
   within ``pagerank.get``'s L1 bound of float64, every cached source
   whose neighbourhood the commit touched warm (two held to float64
   within ``PPR_REL_TOL``) and any whose mass on the changed nodes could
   move it past that bound, the rest hits (16 held to float64 on the new
   graph within ``PPR_REL_TOL``; a 1,000-edge commit leaves few or none);
   the delta rides a hit where the drift rule predicts one, else a warm
   request; a one-edge commit in one source's neighbourhood, shipped on
   a predicted hit, warms that source and leaves hits (16 held to
   float64 on the new graph within ``PPR_REL_TOL``); the daemon's K1 and
   K2 launches (its health reply) moved.  Its launches join the kernels'
   ``launches_by_path`` as ``kernel_server``.
25a. (after traversal) The mesh (``mesh`` line, ``parallel/mesh.py``,
   ``distributed.py``, ``analytics.py``, ``ops/spmv_mxu_sharded.py``) on
   v0, over a mesh of 1 and of 4 shards on the one card (which share its
   HBM and SMs: no multi-card scaling is measured): see ``phase_mesh``.
   Its K1, K2 and Benes launches join ``launches_by_path`` as ``mesh``,
   its recorded K1 calls the ``segment_kernels`` lines (``mesh_*``).
26. The read lane (``lane`` line, ``ops/columnar.py``,
   ``ops/pipeline.py``) on v0's edges, 1,000 self-loops planted, and a
   CooSource of them with seeded vertex properties (an int ``age``, an
   int32-range ``score`` about 10% absent, a 50-value string, a bool),
   exported by ``columnar.export_columns``: masked aggregates (count,
   sum, min, max under two predicates) equal to numpy int64, a sum past
   the 2^30 mass refused ``precision_overflow``; hop counts at 1 and 2
   hops (``include_lower``, ``edge_unique``, ``need_distinct``),
   unstaged and staged, equal to a scipy int64 count, a staged repeat
   three K1 launches and no torch sort; top-k ASC / DESC with null keys
   equal to a numpy stable sort; the ``lane`` op of an in-process kernel
   server over its socket equal to the in-process totals, a refusal
   typed.  ms a query per program after a warm call.
27. (last) The out-of-core tier (``tier`` line, ``ops/tier.py``,
   ``parallel/streamed.py``) on v0: the paging plan (16 blocks, the
   generation's row slack), f32 / bf16 / int8; streamed PageRank at 50
   iterations with exactly 16 + 50 x 16 K1 and 100 K2 launches,
   bit-equal to its ``resident=True`` comparator at each precision and
   within the main path's bounds of float64 (bf16, int8 within
   ``PRECISION_BOUNDS`` of f32); katz bit-equal to its comparator and
   within 1e-4 of float64; WCC equal to its comparator and to scipy.  An
   in-process kernel server with a 256 MiB budget answers a pagerank
   request ``streamed`` with the in-process bytes, a key-only repeat as
   a hit; after a 1,000-edge commit (seed 17) as the delta payload the
   generation's plan re-packs exactly the blocks the adds' sources own,
   each block's edges equal a fresh ``plan_tier``'s, and the run warm
   starts (fewer iterations than cold, within 1e-4 of float64); a
   10-edge commit out of block 0 re-packs that block alone; under 32 MiB
   the request is shed.  Each algorithm's streamed device peak against
   ``streamed_request_bytes`` within [1x, 2x].  Wire and raw bytes a
   sweep, H2D GB/s, the transfer's hidden share, ms an iteration.
28. (after the tier) The temporal graph network (``tgn`` line,
   ``procedures/tgn_module.py``) on a synthetic bipartite stream at the
   scale of JODIE's Wikipedia dataset (8,227 users, 1,000 pages, 157,474
   timestamped edges, seed ``TGN_SEED``): one ``train_and_eval`` epoch at
   the module's defaults, twice, the losses finite and the two runs'
   losses and memories bit-equal; the stream's first batch on the card
   against the port's CPU path in float64 from the same weights
   (``TGN_LOSS_TOL``; ``TGN_WEIGHT_TOL``; the memory within
   ``TGN_MEMORY_TOL`` plus the time encoding's f32 angle rounding, 2 x
   2^-24 x the batch's largest timestamp).  ms a batch
   and batches a second.  No kernel launch (dense products, torch's).
29. Node text embeddings (``embeddings`` line,
   ``procedures/embeddings_module.py``): 100,000 vertices, each with a
   label and three properties, some sentences planted twice, at D = 256
   and batch 2048: every norm 1 within 1e-6, equal sentences equal
   vectors, one chunk against a float64 numpy product of the same counts
   and projection (``EMB_TOL``).  The host hashing seconds and the device
   ms a chunk.  No kernel launch.
30. Spans and stage extents (``trace`` line, ``observability/``): a
   daemon on the card with tracing armed answers an armed, traced
   ``pagerank`` op and a PPR request on the segment graph: the spans
   come home through the carrier, every name in ``SPAN_NAMES``, every
   parent in the trace, the daemon's ``kernel.dispatch`` under the
   client's ``kernel.request``, each stage's seconds at most the
   request's wall time.  The segment route's ms an iteration, disarmed
   and armed, in turns; disarmed within ``TRACE_DISARMED_SLACK`` of
   armed.  Its launches join ``launches_by_path`` as ``trace``: this
   process's (the segment runs, counted from 0, K1 checked to move) and
   the daemon's (its health reply's counts before and after, K1 checked
   to move), added kernel by kernel.
31. node2vec's 2-D sharded step (``node2vec_sharded`` line,
   ``models/node2vec.py`` ``build_sharded_train_step``,
   ``parallel/mesh.py`` ``make_mesh_2d``) on the north star's nodes at
   the module's width (dim 128, batch 8192, 5 negatives) on a 2 x 2 mesh
   on the one card: 10 steps against the single-card ``train_step`` from
   the same tables (loss within ``N2V2D_LOSS_REL``; tables within
   ``N2V2D_TABLE_REL`` of their largest entry, and all but a share
   ``N2V2D_BULK_SHARE`` of the entries within ``N2V2D_BULK_REL``), two
   runs bit-equal, K1
   launches exactly 3 x 4 shards x 10 steps.  ms a step at 1 x 1 and 2 x
   2 (four shards share one card: no scaling is claimed).
32. The Cypher engine (``cypher`` line, ``storage/``, ``query/``): the
   port's own MVCC storage and interpreter on the card, built by the
   port's composition root (``main.build_database``), a user's path
   from Cypher text to the kernels.  See ``phase_cypher``.
33. The Bolt entry point (``bolt`` line, ``server/``, ``auth/``,
   ``dbms/``): a ``BoltServer`` serves the ``cypher`` phase's database
   before it is freed, driven only through the port's ``BoltClient``:
   auth, the lane, a commit, ``CALL pagerank.get()`` on the Benes
   kernels, a tenant on K1, the info queries.  See ``bolt_step``.
34. A JSON line of kernels ({"kernels": [...]}: the Benes four, the ten
   micro kernels, ``csr_spmm_sum`` and ``lane_sum``, each with its
   launches by path, ``lane``, ``tier``, ``tgn``, ``embeddings``,
   ``trace``, ``node2vec_sharded``, ``cypher`` and ``bolt`` among
   them), the card's name and power limit, and last ``{"ok": true,
   "device": {...}}``.

Times are CUDA-event times (kernels: launches queued behind a device
spin, ``device_ms``, so a short kernel's time is not its Python
wrapper's) or host wall time around work that ends in
``torch.cuda.synchronize()`` (PageRank runs).  ``bound_ms`` is the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s (H100 SXM
data-sheet peaks), counting each input read once and each output written
once.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores

ITERATIONS = 50
DAMPING = 0.85
BENES_SIZES = (7, 10, 12, 14, 16, 17, 20, 24)
TIMED_SIZES = (20, 24)
# networks of n slots (log2) placed at a small K besides their dtype's K:
# many more rows (2^(n-K)) than the main path's for the outer gather
SMALL_K = {16: 1, 20: 8}

# f32 against float64 after 50 iterations: each rank is a sum of up to
# ~thousands of f32 products per iteration, whose rounding (2^-24
# relative) compounds over the iterations to ~1e-6 relative (measured
# 8.8e-7 on a 1M-edge graph of the same family); budgeted 100x.
F32_REL_TOL = 1e-4
F32_L1_TOL = 1e-5


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def sm_clock_hz() -> float:
    """The SM clock ceiling ``nvidia-smi`` reports (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def reference_pagerank(src, dst, n_nodes, iterations=ITERATIONS,
                       damping=DAMPING):
    """float64 scipy CSR power iteration (bench.py:88-109)."""
    import scipy.sparse as sp
    deg = np.bincount(src, minlength=n_nodes).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    mat = sp.csr_matrix((inv_deg[src], (dst, src)),
                        shape=(n_nodes, n_nodes))
    dangling = deg == 0
    rank = np.full(n_nodes, 1.0 / n_nodes)
    for _ in range(iterations):
        dm = rank[dangling].sum()
        rank = (1 - damping) / n_nodes + damping * (mat @ rank
                                                    + dm / n_nodes)
    return rank


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn over reps launches, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t):
    """A bit view for exact comparison of f32 / bf16 tensors."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits(a, b) -> bool:
    import torch
    return torch.equal(bits(a), bits(b))


def place(masks_packed, n, dtype, K=None):
    """(mid rows, outer rows, spec) on the card, at the dtype's K or K:
    the live stages' packed mask rows, as placement uploads them."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    spec, mid, out = BC.build_masks(masks_packed, n,
                                    K or BC.K_BY_DTYPE[dtype])
    return (torch.from_numpy(mid).cuda(),
            None if out is None else torch.from_numpy(out).cuda(), spec)


def composed(mid_rows, spec):
    """compose_mid on the card (the stage kernel on the iota, once), held
    against the CPU composition (the plain ``_apply_stages``)."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    before = BC.benes_mid.launches
    mid_idx = BC.compose_mid(mid_rows, spec)
    want = BC.compose_mid(mid_rows.cpu(), spec)
    check(torch.equal(mid_idx.cpu(), want)
          and BC.benes_mid.launches - before == int(bool(spec.mid_stages)),
          f"compose_mid on the card != CPU composition at "
          f"n={spec.net_log2} K={spec.K}")
    return mid_idx


def composed_outer(outer_rows, spec):
    """compose_outer on the card (the stage kernel on the row iota, once
    per live side), held against the CPU composition; None where the net
    fits one tile."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    if outer_rows is None:
        return None
    before = BC.benes_outer.launches
    outer_idx = BC.compose_outer(outer_rows, spec)
    want = BC.compose_outer(outer_rows.cpu(), spec)
    check(torch.equal(outer_idx.cpu(), want)
          and BC.benes_outer.launches - before
          == BC.launches_per_placement(spec)["benes_outer"],
          f"compose_outer on the card != CPU composition at "
          f"n={spec.net_log2} K={spec.K}")
    return outer_idx


def random_values(N, dtype, seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, device="cuda", generator=gen).to(dtype)
    return x.view(-1, 128) if N >= 128 else x


def measure_kernels(x, masks, route, reps: int = 20,
                    timed: bool = True) -> dict:
    """Each kernel of one network against its plain version on x: exact
    check, then (timed) kernel / plain / bound / gather times per launch.
    route: (mid_idx, outer_idx, spec); masks: (mid rows, outer rows), the
    packed rows the indices were composed from, which feed the stage
    kernels benes_mid and benes_outer (placement).  The stage kernels are
    also held, and timed, on the 16-bit iota placement feeds them
    (``iota_*``)."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    mid_idx, outer_idx, spec = route
    mid_rows, outer_rows = masks
    N, e = x.numel(), x.element_size()
    row_bytes = -(-N // 8)
    iota = torch.arange(N, device="cuda", dtype=torch.int64)
    iota16 = iota.to(torch.int16).view(torch.bfloat16).view(x.shape)
    res = {}
    live = bool(spec.mid_stages)
    # bytes: values in and out, plus each live stage's packed row once
    cases = [("benes_mid_gather",
              lambda v: BC.benes_mid_gather(v, mid_idx, spec),
              lambda v: BC.benes_mid_gather_reference(v, mid_idx, spec),
              2 * N, N, live),
             ("benes_mid", lambda v: BC.benes_mid(v, mid_rows, spec),
              lambda v: BC.benes_mid_reference(v, mid_rows, spec),
              len(spec.mid_stages) * row_bytes,
              len(spec.mid_stages) * N, live)]
    if spec.outer_down:
        down = outer_idx[0]
        cases += [("benes_outer_gather",
                   lambda v: BC.benes_outer_gather(v, down, spec),
                   lambda v: BC.benes_outer_gather_reference(v, down, spec),
                   2 * N, N, True),
                  ("benes_outer",
                   lambda v: BC.benes_outer(v, outer_rows, spec.outer_down,
                                            spec),
                   lambda v: BC.benes_outer_reference(
                       v, outer_rows, spec.outer_down),
                   len(spec.outer_down) * row_bytes,
                   len(spec.outer_down) * N, True)]
    for name, kern, plain, extra_bytes, n_ops, live in cases:
        if not live:
            continue
        stage = name in ("benes_mid", "benes_outer")
        for v in (iota16, x) if stage else (x,):
            got, want = kern(v), plain(v)
            torch.cuda.synchronize()
            check(same_bits(got, want),
                  f"{name} disagrees with its plain version at N={N} "
                  f"{'16-bit iota' if v is iota16 else v.dtype}")
        err = float((got.float() - want.float()).abs().max())   # on x
        res[name] = {"net_log2": spec.net_log2, "K": spec.K,
                     "dtype": str(x.dtype), "max_abs_err": err,
                     "held_on": ["values", "iota"] if stage else ["values"]}
        if not timed:
            continue
        perm = plain(iota)          # the same function as one gather
        flat = x.view(-1)
        n_bytes = 2 * N * e + extra_bytes
        b, by = bound_ms(n_bytes, n_ops)
        res[name].update({
            "ops_per_slot": n_ops // N,
            "ms": device_ms(lambda: kern(x), reps),
            "host_ms": cuda_ms(lambda: kern(x), reps),
            "plain_ms": device_ms(lambda: plain(x), max(1, reps // 4)),
            "bound_ms": b, "bound_by": by, "n_bytes": n_bytes,
            "library_ms": device_ms(lambda: flat[perm], reps)})
        if stage:
            iota_bytes = 2 * N * 2 + extra_bytes
            ib, iby = bound_ms(iota_bytes, n_ops)
            res[name].update({
                "iota_ms": device_ms(lambda: kern(iota16), reps),
                "iota_bound_ms": ib, "iota_bound_by": iby,
                "iota_n_bytes": iota_bytes})
    return res


def counts() -> dict:
    from memgraph_tpu_torch.ops import benes_cuda as BC
    return {"benes_mid": BC.benes_mid.launches,
            "benes_mid_gather": BC.benes_mid_gather.launches,
            "benes_outer": BC.benes_outer.launches,
            "benes_outer_gather": BC.benes_outer_gather.launches}


def hold_network(packed, n, dtype, K=None, timed=False, route_s=0.0):
    """Place one routed network on the card (both indices held against
    the CPU composition), apply it with the kernels against the
    stage-by-stage plain network, check the counters, optionally time."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    N = 1 << n
    mid, out, spec = place(packed, n, dtype, K)
    mid_idx = composed(mid, spec)
    outer_idx = composed_outer(out, spec)
    x = random_values(N, dtype, seed=n)
    before = counts()
    got = BC.benes_apply(x, mid_idx, outer_idx, spec)
    want = BC.benes_apply_reference(x, mid, out, spec)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in counts().items()}
    per = BC.launches_per_apply(spec)
    check(same_bits(got, want),
          f"benes_apply != plain at n={n} K={spec.K} {dtype}")
    check(moved == dict(per, benes_mid=0, benes_outer=0)
          and moved["benes_mid_gather"] == 1
          and moved["benes_outer_gather"] == (2 if n > spec.K else 0),
          f"launch counters moved {moved} at n={n} K={spec.K} {dtype}")
    line = {"n": n, "dtype": str(dtype), "K": spec.K,
            "route_s": route_s, "exact": True, "launches": moved}
    if not timed:
        held = measure_kernels(x, (mid, out), (mid_idx, outer_idx, spec),
                               timed=False)
        line["kernels_exact"] = sorted(held)
    else:
        # values in and out, plus each pass's 2-byte index
        apply_bytes = 2 * N * x.element_size() + 2 * N * sum(per.values())
        line["apply_ms"] = device_ms(
            lambda: BC.benes_apply(x, mid_idx, outer_idx, spec), 20)
        line["apply_plain_ms"] = device_ms(
            lambda: BC.benes_apply_reference(x, mid, out, spec), 3)
        line["apply_bound_ms"] = apply_bytes / PEAK_BYTES_PER_S * 1e3
        perm = BC.benes_apply_reference(
            torch.arange(N, device="cuda"), mid, out, spec)
        flat = x.view(-1)
        line["apply_library_ms"] = device_ms(lambda: flat[perm], 20)
        line["kernels"] = measure_kernels(x, (mid, out),
                                          (mid_idx, outer_idx, spec))
    print("benes", json.dumps(line), flush=True)


def routed_permutation(n: int):
    """(packed masks, host seconds) of the random permutation of 2^n
    slots that ``phase_benes`` holds the kernels on."""
    from memgraph_tpu_torch.ops.benes import route_packed
    t0 = time.perf_counter()
    packed = route_packed(np.random.default_rng(100 + n).permutation(1 << n))
    return packed, time.perf_counter() - t0


def phase_benes(routed: dict):
    """Random and identity permutations through the kernels; ``routed``
    maps each of ``BENES_SIZES`` to its ``routed_permutation`` (a future:
    routed on the host while the kernels build)."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.benes import route_packed
    for n in BENES_SIZES:
        packed, route_s = routed[n].result()
        for dtype in (torch.float32, torch.bfloat16):
            hold_network(packed, n, dtype, timed=n in TIMED_SIZES,
                         route_s=route_s)
            if n in SMALL_K:
                hold_network(packed, n, dtype, K=SMALL_K[n])
    # identity: every stage dead, nothing launched, x comes back as is
    n = 16
    packed = route_packed(np.arange(1 << n))
    for dtype in (torch.float32, torch.bfloat16):
        mid, out, spec = place(packed, n, dtype)
        check(not (spec.mid_stages or spec.outer_down or spec.outer_up),
              "identity permutation left live stages")
        x = random_values(1 << n, dtype, seed=1)
        before = counts()
        mid_idx = composed(mid, spec)
        outer_idx = composed_outer(out, spec)
        rows = torch.arange(1 << n, device="cuda") >> spec.K
        check(outer_idx is None or bool((outer_idx == rows).all()),
              f"identity route's outer index is not the iota at {dtype}")
        got = BC.benes_apply(x, mid_idx, outer_idx, spec)
        check(same_bits(got, x) and before == counts(),
              f"identity route changed x or launched at {dtype}")
    print("benes identity exact, no launches", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the microbenchmark kernels
# ---------------------------------------------------------------------------

L2_BYTES = 50 * 2**20                 # H100 L2
SMEM_BYTES_PER_CLOCK = 128            # shared memory per SM per clock
FP32_FLOP_PER_CLOCK = 256             # 128 FMA lanes per SM per clock
SKIPPED_BELOW = 0.95                  # under 0.95 x the on-chip bound
# kernels whose time under SKIPPED_BELOW x their on-chip bound means work
# was skipped
WORK_CHECKED = ("gather_loop", "lane_gather_loop", "transpose_loop",
                "sandwich", "big_matmul")
MICRO_REPLACES = {
    "col_gather": "benchmarks/pallas_micro.py:46",
    "lane_gather": "benchmarks/pallas_micro.py:78",
    "stream": "benchmarks/pallas_micro.py:111",
    "gather_loop": "benchmarks/pallas_micro.py:138",
    "dynslice_gather": "benchmarks/pallas_micro2.py:83",
    "onehot_scatter": "benchmarks/pallas_micro2.py:149",
    "lane_gather_loop": "benchmarks/pallas_micro3.py:49",
    "transpose_loop": "benchmarks/pallas_micro3.py:84",
    "sandwich": "benchmarks/pallas_micro3.py:124",
    "big_matmul": "benchmarks/pallas_micro3.py:156",
}


# ~10 ms of device spin at 1.98 GHz: the host queues the timed launches
# meanwhile, so a small kernel's time is not its Python wrapper's
QUEUE_AHEAD_CYCLES = 20_000_000


def device_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn over reps launches queued behind a spin
    of the device (``torch.cuda._sleep``), after a warm-up: device time
    wherever the host queues all reps within the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int) -> float:
    """Mean CUDA-event time of fn with the L2 flushed before each launch
    (a 128 MB scratch write, outside the event pair), each launch queued
    behind a short device spin as in ``device_ms``."""
    import torch
    scratch = torch.empty(32 * 2**20, device="cuda")
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        scratch.fill_(1.0)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES // 20)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def expected_micro_launches() -> dict:
    """Launches one run of each entry point makes at its default sizes:
    each bench times n calls after one warm-up call."""
    from memgraph_tpu_torch.benchmarks import micro, micro2, micro3
    n1, n2, n3 = (micro.TIMED_CALLS + 1, micro2.TIMED_CALLS + 1,
                  micro3.TIMED_CALLS + 1)
    return {"col_gather": 5 * n1, "lane_gather": 3 * n1, "stream": 2 * n1,
            "gather_loop": micro.LOOP_TIMED_CALLS + 1,
            "dynslice_gather": n2, "onehot_scatter": n2,
            "lane_gather_loop": n3, "transpose_loop": n3, "sandwich": n3,
            "big_matmul": n3}


def _library_loops():
    """One PyTorch call per iteration (or the few a step needs), looped as
    the kernel loops: the yardsticks of the looping kernels."""
    import torch

    def gather_loop(tab, idx, iters):
        for _ in range(iters):
            tab = torch.gather(tab, 0, idx)
        return tab

    def lane_gather_loop(x, idx, iters):
        for _ in range(iters):
            x = torch.gather(x, 1, idx).add_(1.0)
        return x

    def tiles(a):
        return a.view(-1, 128, 128)

    def transpose_loop(x, iters):
        bufs = (torch.empty_like(x), torch.empty_like(x))
        for it in range(iters):
            torch.add(tiles(x).transpose(1, 2), 1.0, out=tiles(bufs[it % 2]))
            x = bufs[it % 2]
        return x

    def sandwich(x, s1, s2, s3, iters):
        for _ in range(iters):
            a = torch.gather(x, 1, s1)
            a = tiles(a).transpose(1, 2).reshape(x.shape)
            a = torch.gather(a, 1, s2)
            a = tiles(a).transpose(1, 2).reshape(x.shape)
            x = torch.gather(a, 1, s3)
        return x

    def big_matmul(a, b, iters):
        acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device)
        for _ in range(iters):
            acc.addmm_(a, b)
        return acc

    return (gather_loop, lane_gather_loop, transpose_loop, sandwich,
            big_matmul)


def micro_cases(sm_hz: float, n_sms: int):
    """One case per kernel and size, built as it is used (the largest
    inputs are 256 MB)."""
    from functools import partial

    import torch
    from memgraph_tpu_torch.benchmarks import micro as M1
    from memgraph_tpu_torch.benchmarks import micro2 as M2
    from memgraph_tpu_torch.benchmarks import micro3 as M3
    from memgraph_tpu_torch.benchmarks.loop_split import SPLITS
    lib_gl, lib_lgl, lib_tl, lib_sw, lib_mm = _library_loops()

    def put(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    def onchip(n_bytes, tiling=None):
        # on every SM of the card, whatever share of them a kernel's
        # design occupies; with the design's launch, also on the SMs it
        # occupies
        out = {"onchip_bound_ms": n_bytes / (SMEM_BYTES_PER_CLOCK * n_sms
                                             * sm_hz) * 1e3,
               "onchip_by": f"{n_bytes} B of shared memory or shuffle "
                            f"traffic at {SMEM_BYTES_PER_CLOCK} B/clock on "
                            f"{n_sms} SMs at {sm_hz / 1e6:.0f} MHz"}
        if tiling is not None:
            out["design"] = {k: tiling[k] for k in (
                "blocks", "cluster", "threads", "smem_bytes", "sms")}
            out["onchip_bound_occupied_ms"] = (
                out["onchip_bound_ms"] * n_sms / tiling["sms"])
        return out

    def case(name, size, kern, plain, library, library_call, n_bytes,
             n_ops, rtol=0.0, timed=True, split=None, **extra):
        # split: (iteration counts, the kernel at a count) of a loop
        return dict(name=name, size=size, kern=kern, plain=plain,
                    library=library, library_call=library_call,
                    n_bytes=n_bytes, n_ops=n_ops, rtol=rtol, timed=timed,
                    split=split, extra=extra)

    for R in (8, 64, 512, 2048, 8192):
        tab, idx = put(*M1.gather_inputs(R, R))
        yield case("col_gather", f"R={R}", partial(M1.col_gather, tab, idx),
                   partial(M1.col_gather_reference, tab, idx),
                   partial(torch.gather, tab, 0, idx.long()),
                   "torch.gather(tab, 0, idx)", 12 * R * 128, 0)
    for R in (8, 512, 8192):
        tab, idx = put(*M1.gather_inputs(R, 128))
        yield case("lane_gather", f"R={R}",
                   partial(M1.lane_gather, tab, idx),
                   partial(M1.lane_gather_reference, tab, idx),
                   partial(torch.gather, tab, 1, idx.long()),
                   "torch.gather(tab, 1, idx)", 12 * R * 128, 0)
    for MB in (64, 256):
        R = MB * 2**20 // 512
        gen = torch.Generator(device="cuda").manual_seed(MB)
        x = torch.randn((R, 128), device="cuda", generator=gen)
        one, two = (torch.full((1,), v, device="cuda") for v in (1.0, 2.0))
        yield case("stream", f"{MB} MB", partial(M1.stream, x),
                   partial(M1.stream_reference, x),
                   partial(torch.addcmul, one, x, two),
                   "torch.addcmul(one, x, two)", 8 * R * 128, 2 * R * 128)
        del x
    # the largest R the wrapper takes and a small one, then the main shape
    for R, it, timed in ((M1.MAX_LOOP_ROWS, 3, False), (256, 51, False),
                         (8192, 50, True)):
        tab, idx = put(*M1.gather_inputs(R, R))
        yield case("gather_loop", f"R={R} x{it}",
                   partial(M1.gather_loop, tab, idx, it),
                   partial(M1.gather_loop_reference, tab, idx, it),
                   partial(lib_gl, tab, idx.long(), it),
                   f"loop of {it} x torch.gather(acc, 0, idx)", 12 * R * 128,
                   0, timed=timed,
                   split=(SPLITS["gather_loop"],
                          partial(M1.gather_loop, tab, idx)),
                   **onchip(8 * R * 128 * it,
                            M1.gather_loop_tiling(R, n_sms)))

    grp, row3, rank = put(*M2.dynslice_inputs())
    R = row3.shape[0]
    full = (8 * grp.long().repeat_interleave(8, 0) + row3.long())
    yield case("dynslice_gather", f"E={R * 128}",
               partial(M2.dynslice_gather, grp, row3, rank),
               partial(M2.dynslice_gather_reference, grp, row3, rank),
               partial(torch.gather, rank, 0, full),
               "torch.gather(rank, 0, full_idx)",
               4 * (R // 8) + 8 * R * 128 + rank.numel() * 4, 0)
    del grp, row3, rank, full
    dblk, lanes, vals = put(*M2.onehot_inputs())
    bins = (dblk.long().repeat_interleave(8, 0) * 128 + lanes.long()).view(-1)

    def index_add():
        acc = torch.zeros((M2.RANK_R, 128), device="cuda")
        return acc.view(-1).index_add_(0, bins, vals.view(-1))

    yield case("onehot_scatter", f"E={R * 128}",
               partial(M2.onehot_scatter, dblk, lanes, vals),
               partial(M2.onehot_scatter_reference, dblk, lanes, vals),
               index_add, "torch.zeros + acc.view(-1).index_add_(0, bins, "
               "vals.view(-1))",
               4 * (R // 8) + 8 * R * 128 + M2.RANK_R * 128 * 4, R * 128,
               rtol=M2.ONEHOT_RTOL)
    del dblk, lanes, vals, bins

    gen = torch.Generator(device="cuda").manual_seed(9)
    for R, it, timed in ((100, 501, False), (4096, 500, True)):
        x, idx = put(*M3.lane_loop_inputs(R))
        label = ""
        if not timed:       # a ragged last block, on random values
            x, label = torch.randn((R, 128), device="cuda",
                                   generator=gen), " random x"
        yield case("lane_gather_loop", f"R={R} x{it}{label}",
                   partial(M3.lane_gather_loop, x, idx, it),
                   partial(M3.lane_gather_loop_reference, x, idx, it),
                   partial(lib_lgl, x, idx.long(), it),
                   f"loop of {it} x torch.gather(acc, 1, idx).add_(1)",
                   12 * R * 128, it * R * 128, timed=timed,
                   split=(SPLITS["lane_gather_loop"],
                          partial(M3.lane_gather_loop, x, idx)),
                   # 4 B a value an iteration, a shuffle's or a read's
                   **onchip(4 * R * 128 * it,
                            M3.lane_gather_loop_tiling(R, n_sms)))
    R = 8192
    gen = torch.Generator(device="cuda").manual_seed(10)
    for label, x, it, timed in (
            ("ones", torch.ones((R, 128), device="cuda"), 500, True),
            ("random x", torch.randn((R, 128), device="cuda",
                                     generator=gen), 501, False)):
        yield case("transpose_loop", f"R={R} x{it} {label}",
                   partial(M3.transpose_loop, x, it),
                   partial(M3.transpose_loop_reference, x, it),
                   partial(lib_tl, x, it),
                   f"loop of {it} x torch.add(tiles(acc).transpose(1, 2), "
                   "1, out=...)", 8 * R * 128, it * R * 128, timed=timed,
                   **onchip(8 * R * 128 * it,
                            M3.transpose_loop_tiling(R, n_sms)))
    R = 4096
    x, s1, s2, s3 = put(*M3.lane_loop_inputs(R, 3))
    longs = [s.long() for s in (s1, s2, s3)]
    for it, timed in ((200, True), (201, False)):
        yield case("sandwich", f"R={R} x{it}",
                   partial(M3.sandwich, x, s1, s2, s3, it),
                   partial(M3.sandwich_reference, x, s1, s2, s3, it),
                   partial(lib_sw, x, *longs, it),
                   f"loop of {it} x (3 torch.gather + 2 tile transposes)",
                   20 * R * 128, 0, timed=timed,
                   **onchip(24 * R * 128 * it, M3.sandwich_tiling(R, n_sms)))
    # shapes the 128 x 128 tile does not fit take the kernel's smaller
    # tiles; then the main shape, timed
    rng = np.random.default_rng(6)
    for (M, K, N), it, timed in (((64, 32, 32), 3, False),
                                 ((256, 512, 96), 7, False),
                                 (M3.MATMUL_SHAPE, 500, True)):
        a, b = (put(*M3.matmul_inputs()) if timed else
                put(rng.random((M, K), dtype=np.float32),
                    rng.random((K, N), dtype=np.float32)))
        flops = 2 * M * N * K * it
        # the work on every SM of the card, whatever kernel does it
        yield case("big_matmul", f"{M}x{K}x{N} x{it}",
                   partial(M3.big_matmul, a, b, it),
                   partial(M3.big_matmul_reference, a, b, it),
                   partial(lib_mm, a, b, it),
                   f"loop of {it} x acc.addmm_(a, b)",
                   4 * (M * K + K * N + M * N), flops + M * N * it,
                   rtol=M3.MATMUL_RTOL, timed=timed,
                   tiling=M3.big_matmul_tiling(M, K, N, n_sms),
                   onchip_bound_ms=flops / (FP32_FLOP_PER_CLOCK * n_sms
                                            * sm_hz) * 1e3,
                   onchip_by=f"f32 FMA pipes ({FP32_FLOP_PER_CLOCK} "
                             f"flop/clock) on {n_sms} SMs at "
                             f"{sm_hz / 1e6:.0f} MHz")


def phase_micro(sm_hz: float):
    """The three microbenchmark entry points, then each kernel against its
    plain version, timed."""
    from functools import partial

    import torch
    from memgraph_tpu_torch.benchmarks import micro, micro2, micro3
    from memgraph_tpu_torch.benchmarks._common import compare
    from memgraph_tpu_torch.benchmarks.loop_split import split_of
    mods = (micro, micro2, micro3)
    t0 = time.perf_counter()
    # the entry points: counts set to 0 just before, read just after
    for mod in mods:
        mod.reset_launch_counts()
    results = [r for mod in mods for r in mod.main(["--device", "cuda"])]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for mod in mods
                for fn in mod.KERNELS}
    expected = expected_micro_launches()
    check(launches == expected,
          f"micro launch counts {launches} != expected {expected}")
    bad = [r["bench"] for r in results if not r["ok"]]
    check(not bad, f"micro entry points disagree with plain versions: {bad}")
    entry_s = time.perf_counter() - t0

    lines = {}
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in micro_cases(sm_hz, n_sms):
        got, want = c["kern"](), c["plain"]()
        torch.cuda.synchronize()
        ok, err = compare(got, want, c["rtol"])
        check(ok, f"{c['name']} {c['size']} disagrees with its plain "
                  f"version (max abs err {err}, rtol {c['rtol']})")
        del got, want
        line = {"kernel": c["name"], "size": c["size"], "max_abs_err": err,
                "rtol": c["rtol"], "exact": c["rtol"] == 0.0}
        if c["timed"]:
            loops = "onchip_bound_ms" in c["extra"]
            reps = 5 if loops else 20
            b, by = bound_ms(c["n_bytes"], c["n_ops"])
            line.update(
                ms=device_ms(c["kern"], reps),
                cold_ms=(cuda_ms_cold(c["kern"], reps)
                         if c["n_bytes"] < L2_BYTES else None),
                host_ms=cuda_ms(c["kern"], reps),
                plain_ms=device_ms(c["plain"], 3),
                library_ms=device_ms(c["library"], 3 if loops else reps),
                library_call=c["library_call"], bound_ms=b, bound_by=by,
                **c["extra"])
            if loops:
                line["onchip_share"] = line["onchip_bound_ms"] / line["ms"]
            if c["split"] is not None:
                counts, at = c["split"]
                line["split"] = split_of(
                    {k: device_ms(partial(at, k), reps) for k in counts},
                    counts)
            if c["name"] in WORK_CHECKED:
                # quicker than shared memory or the FMA pipes allow: a
                # loop-invariant product hoisted, or passes merged
                check(line["ms"] >= SKIPPED_BELOW * line["onchip_bound_ms"],
                      f"{c['name']} {c['size']} took {line['ms']} ms, under "
                      f"{SKIPPED_BELOW} x its on-chip bound "
                      f"{line['onchip_bound_ms']} ms: work was skipped")
        lines.setdefault(c["name"], []).append(line)
        print("micro", json.dumps(line), flush=True)
    print(f"micro_phase entry_points_s {entry_s:.3f} total_s "
          f"{time.perf_counter() - t0:.3f}", flush=True)
    return launches, lines


def micro_counts() -> dict:
    """The micro kernels' launch counters, by kernel."""
    from memgraph_tpu_torch.benchmarks import micro, micro2, micro3
    return {fn.__name__: fn.launches for mod in (micro, micro2, micro3)
            for fn in mod.KERNELS}


def micro_kernel_entries(launches: dict, lines: dict, paths) -> list:
    """The micro kernels' entries of the {"kernels": [...]} line: numbers
    at the largest size the entry point runs, every size under shapes;
    by path, the entry points' launches and 0 on each of ``paths`` (the
    caller checked that no counter moved after the micro phase)."""
    out = []
    for name, replaces in MICRO_REPLACES.items():
        timed = [ln for ln in lines[name] if "ms" in ln]
        main = timed[-1]
        out.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/micro.cu",
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {"micro": launches[name],
                                 **dict.fromkeys(paths, 0)},
            "max_abs_err": max(ln["max_abs_err"] for ln in lines[name]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at": main["size"],
            "shapes": lines[name]})
    return out


def route_kernels(label, route, packed, dtype) -> dict:
    """Each kernel of one placed network of a PageRank run against its
    plain version, timed (these launches are not the run's).  The placed
    indices are held against the composition of the network's masks (the
    placement kept only the indices)."""
    import torch
    spec = route[2]
    mid, out, spec2 = place(packed, spec.net_log2, dtype)
    check(spec2 == spec and torch.equal(route[0], composed(mid, spec))
          and (route[1] is None if out is None
               else torch.equal(route[1], composed_outer(out, spec))),
          f"placed indices of the {label} net != its masks' composition")
    x = random_values(1 << spec.net_log2, dtype, seed=3)
    res = measure_kernels(x, (mid, out), route)
    print("route_kernels", label, json.dumps(res), flush=True)
    return res


def expected_run_launches(run, calls: int, placed_base: bool) -> dict:
    """The launches `calls` runs of ITERATIONS iterations of one placed
    PageRank run make, its placement included: per iteration one
    benes_apply of every route (edge, node and, on a delta run, delta),
    per placement the stage kernels of the delta route (placed by the
    run) and, where `placed_base`, of the base plan's edge and node
    routes (placed once per device and route dtype on the base state)."""
    from memgraph_tpu_torch.ops import benes_cuda as BC
    out = dict.fromkeys(("benes_mid", "benes_mid_gather", "benes_outer",
                         "benes_outer_gather"), 0)
    for name, route in run.routes.items():
        for k, v in BC.launches_per_apply(route[2]).items():
            out[k] += calls * ITERATIONS * v
        if name == "delta" or placed_base:
            for k, v in BC.launches_per_placement(route[2]).items():
                out[k] += v
    return out


@contextlib.contextmanager
def placement_guard():
    """Count the routes placed (``spmv_mxu._put_route`` calls) and fail if
    any of them calls ``np.unpackbits``: placement hands the router's
    packed rows to the card as they are.  Yields the list of calls."""
    from memgraph_tpu_torch.ops import spmv_mxu
    real_put, real_unpack, calls = spmv_mxu._put_route, np.unpackbits, []

    def refuse(*args, **kw):
        fail("np.unpackbits ran during placement on the card")

    def guarded(*args, **kw):
        calls.append(args[1])           # the net's log2 size
        np.unpackbits = refuse
        try:
            return real_put(*args, **kw)
        finally:
            np.unpackbits = real_unpack

    spmv_mxu._put_route = guarded
    try:
        yield calls
    finally:
        spmv_mxu._put_route = real_put


@contextlib.contextmanager
def snapshot_probe():
    """Watch the snapshot layer (ops/csr.py) while a ``GraphCache.get``
    runs: the seconds of each ``from_coo`` it calls, and the previous
    snapshot of each delta export that succeeded.  Yields {"from_coo_s":
    [...], "delta_from": [...]}."""
    from memgraph_tpu_torch.ops import csr as CSR
    real_from_coo, real_delta = CSR.from_coo, CSR.export_csr_delta
    probe = {"from_coo_s": [], "delta_from": []}

    def timed_from_coo(*args, **kw):
        t0 = time.perf_counter()
        out = real_from_coo(*args, **kw)
        probe["from_coo_s"].append(time.perf_counter() - t0)
        return out

    def seen_delta(prev, *args, **kw):
        out = real_delta(prev, *args, **kw)
        if out is not None:
            probe["delta_from"].append(prev)
        return out

    CSR.from_coo, CSR.export_csr_delta = timed_from_coo, seen_delta
    try:
        yield probe
    finally:
        CSR.from_coo, CSR.export_csr_delta = real_from_coo, real_delta


def timed_get(cache, source, **kw):
    """(the snapshot GraphCache.get gives on the card, seconds to it on
    the device, the snapshot probe)."""
    import torch
    with snapshot_probe() as probe:
        t0 = time.perf_counter()
        g = cache.get(source, device="cuda", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return g, secs, probe


def check_same_arrays(got, want, what: str):
    """A snapshot on the card equal, array for array, to a host one."""
    from memgraph_tpu_torch.ops.csr import _ARRAYS
    check(np.array_equal(got.node_gids, want.node_gids)
          and (got.n_nodes, got.n_edges, got.n_pad, got.e_pad)
          == (want.n_nodes, want.n_edges, want.n_pad, want.e_pad),
          f"{what}: node gids or sizes differ from a full export")
    for name in _ARRAYS:
        check(np.array_equal(getattr(got, name).cpu().numpy(),
                             getattr(want, name)),
              f"{what}: {name} differs from a full export")


@contextlib.contextmanager
def counted_plan_builds():
    """Count the ``spmv_mxu.build_plan`` calls made while the block runs;
    yields the list of calls."""
    from memgraph_tpu_torch.ops import spmv_mxu
    real, calls = spmv_mxu.build_plan, []

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    spmv_mxu.build_plan = counted
    try:
        yield calls
    finally:
        spmv_mxu.build_plan = real


def phase_main_path():
    import torch
    from memgraph_tpu_torch.northstar import (N_EDGES, N_NODES, CooSource,
                                              generate_graph, node_labels,
                                              vector_corpus)
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.ops.native import build_csr_csc_native
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    src, dst = generate_graph()
    # the nodes' embedding property (the dense paths' corpus) and classes
    corpus = vector_corpus()
    t0 = time.perf_counter()
    source = CooSource(src, dst, N_NODES, properties={
        EMBEDDING: corpus[0], "label": node_labels()})
    source_s = time.perf_counter() - t0
    cache = GraphCache()
    served = build_csr_csc_native.served
    # v0: the snapshot the main path runs on, a full export
    graph, export_s, probe = timed_get(cache, source)
    check(build_csr_csc_native.served == served + 1,
          "the native CSR builder did not serve the north-star graph")
    check(cache.counters["export.full"] == 1 and not probe["delta_from"]
          and getattr(graph, "_delta_ctx", None) is None
          and graph.n_nodes == N_NODES and graph.n_edges == N_EDGES,
          f"v0 was not one full export of the north star: "
          f"{cache.counters}")

    def drive(precision):
        t0 = time.perf_counter()
        ranks, err, iters = pagerank(graph, damping=DAMPING,
                                     max_iterations=ITERATIONS, tol=0.0,
                                     precision=precision)
        torch.cuda.synchronize()
        return ranks, iters, time.perf_counter() - t0

    # the main path: counts set to 0 just before, read just after
    with placement_guard() as placed_nets:
        BC.reset_launch_counts()
        r32, it32, cold32 = drive("f32")
        r16, it16, cold16 = drive("bf16")
        _, it32w, warm32 = drive("f32")
        _, it16w, warm16 = drive("bf16")
        launches = counts()

    state = graph._mxu_state
    plan = state["plan"]
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    runs = {precisions[dt]: run for (_, dt), run in state["runs"].items()}
    expected = dict.fromkeys(launches, 0)
    for p, run in runs.items():
        # per plan: 2 mid / 4 outer gathers an iteration (edge + node
        # nets), 2 benes_mid / 4 benes_outer at its placement (cold run)
        one = expected_run_launches(run, 1, placed_base=True)
        check(one == {"benes_mid": 2, "benes_mid_gather": 2 * ITERATIONS,
                      "benes_outer": 4, "benes_outer_gather": 4 * ITERATIONS},
              f"{p} plan launches {one} over one run and its placement")
        for k, v in expected_run_launches(run, 2, placed_base=True).items():
            expected[k] += v
    check(set(state["placed"]) == set(state["runs"]),
          "the base routes were not placed once per run's device and dtype")
    check(len(placed_nets) == 2 * len(state["placed"]),
          f"{len(placed_nets)} routes placed, not edge + node per dtype")
    check(it32 == it16 == it32w == it16w == ITERATIONS,
          f"iterations {it32}/{it16}/{it32w}/{it16w} != {ITERATIONS}")
    check(launches == expected,
          f"launch counts {launches} != expected {expected}")

    ref = reference_pagerank(src, dst, N_NODES)
    a32 = r32.double().cpu().numpy()
    a16 = r16.double().cpu().numpy()
    check(bool(np.isfinite(a32).all() and np.isfinite(a16).all())
          and a32.shape == a16.shape == (N_NODES,), "non-finite or misshaped")
    rel = float((np.abs(a32 - ref) / ref).max())
    l1 = float(np.abs(a32 - ref).sum())
    top = len(set(np.argsort(-a32)[:100]) & set(np.argsort(-ref)[:100]))
    check(rel <= F32_REL_TOL and l1 <= F32_L1_TOL,
          f"f32 ranks off the float64 reference: rel {rel} l1 {l1}")
    check(top == 100, f"f32 top-100 overlap {top}/100")
    bounds = PRECISION_BOUNDS["bf16"]
    linf16 = float(np.abs(a16 - a32).max())
    l1_16 = float(np.abs(a16 - a32).sum())
    k = bounds["topk_order"]
    top_order = bool((np.argsort(-a16)[:k] == np.argsort(-a32)[:k]).all())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"]
          and top_order, f"bf16 outside PRECISION_BOUNDS: linf {linf16} "
          f"l1 {l1_16} top-{k} order {top_order}")

    summary = {
        "n_nodes": N_NODES, "n_edges": N_EDGES, "iterations": ITERATIONS,
        "source_s": source_s, "export_s": export_s,
        "from_coo_s": probe["from_coo_s"][0], "from_coo_builder": "native",
        "plan_build_s": state["plan_build_s"],
        "placement_s": {precisions[key[1]]: placed["placement_s"]
                        + state["runs"][key].placement_s
                        for key, placed in state["placed"].items()},
        "placement_split": {precisions[key[1]]: placed["route_split"]
                            for key, placed in state["placed"].items()},
        "cold_run_s": {"f32": cold32, "bf16": cold16},
        "warm_run_s": {"f32": warm32, "bf16": warm16},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "edges_per_s": {"f32": N_EDGES * ITERATIONS / warm32,
                        "bf16": N_EDGES * ITERATIONS / warm16},
        "plan": {"G": plan.G, "R_G": plan.R_G, "C": plan.C, "W": plan.W,
                 "net_log2": plan.net_log2,
                 "node_net_log2": plan.node_net_log2},
        "launches": launches, "expected_launches": expected,
        "f32_vs_f64": {"max_rel": rel, "l1": l1, "top100": top},
        "bf16_vs_f32": {"linf": linf16, "l1": l1_16,
                        f"top{k}_order": top_order}}
    print("main_path", json.dumps(summary), flush=True)

    # each kernel on the main path's own networks, against its plain
    # version (these launches are not the main path's)
    shapes = {}
    for label, route, packed in (
            ("edge_f32", runs["f32"].routes["edge"], plan.masks_packed),
            ("edge_bf16", runs["bf16"].routes["edge"], plan.masks_packed),
            ("node_f32", runs["f32"].routes["node"],
             plan.node_masks_packed)):
        dtype = torch.bfloat16 if label == "edge_bf16" else torch.float32
        shapes[label] = route_kernels(label, route, packed, dtype)
    base = {"src": src, "dst": dst, "source": source, "cache": cache,
            "graph": graph, "v0_version": source.version,
            "ranks": {"f32": a32, "bf16": a16}, "ref": ref,
            "summary": summary,
            "placed_keys": list(state["placed"]), "corpus": corpus}
    return launches, shapes, base


def phase_refresh(base: dict):
    """A commit to the main path's source and its snapshot v1, which
    GraphCache.get exports by the delta path and anchors on v0: equal to
    a full export, no second plan build, the base routes shared, only
    the delta net placed; f32 against float64 on the mutated graph, bf16
    against the f32 delta run."""
    import torch
    from memgraph_tpu_torch.northstar import N_NODES, mutation
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.csr import export_csr
    from memgraph_tpu_torch.ops.native import build_csr_csc_native
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph, source, cache = base["graph"], base["source"], base["cache"]
    t0 = time.perf_counter()
    drop, add_src, add_dst = mutation(base["src"], base["dst"], N_NODES)
    mutate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    changed = source.commit(add_src, add_dst, remove=np.flatnonzero(drop))
    commit_s = time.perf_counter() - t0
    served = build_csr_csc_native.served
    succ, export_delta_s, probe = timed_get(cache, source)
    check(build_csr_csc_native.served == served + 1,
          "the native CSR builder did not serve the v1 snapshot")
    check(cache.counters["export.delta"] == 1
          and [g is graph for g in probe["delta_from"]] == [True],
          f"v1 did not come by the delta export from v0: {cache.counters}")
    ctx = getattr(succ, "_delta_ctx", None)
    check(ctx is not None and ctx[0] is graph and ctx[1] == changed
          == source.changes_between(base["v0_version"], source.version),
          "v1's _delta_ctx is not (v0, the commit's changed gids)")
    t0 = time.perf_counter()
    full = export_csr(source, to_device=False)
    export_full_s = time.perf_counter() - t0
    check_same_arrays(succ, full, "v1 (delta export)")
    src2, dst2, _ = full.host_coo
    del full

    # the refresh path: counts set to 0 just before, read just after
    with counted_plan_builds() as plan_builds, \
            placement_guard() as placed_nets:
        BC.reset_launch_counts()
        r32, cold32 = drive_pagerank(succ, "f32")
        r16, cold16 = drive_pagerank(succ, "bf16")
        _, warm32 = drive_pagerank(succ, "f32")
        _, warm16 = drive_pagerank(succ, "bf16")
        launches = counts()
    check(not plan_builds, f"build_plan ran {len(plan_builds)} time(s) "
                           "for the successor snapshot")

    state = succ._mxu_state
    delta = state.get("delta")
    check(delta is not None and state["plan"] is graph._mxu_state["plan"],
          "the successor did not take the delta path on the base plan")
    check(placed_nets == [delta.net_log2] * 2,
          f"the refresh placed nets {placed_nets}, not the delta net once "
          "per dtype")
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    runs = {precisions[dt]: run for (_, dt), run in state["runs"].items()}
    base_placed = graph._mxu_state["placed"]
    check(list(base_placed) == base["placed_keys"],
          f"the refresh placed base routes: {list(base_placed)} against "
          f"{base['placed_keys']} after the main path")
    expected = dict.fromkeys(launches, 0)
    for key, run in state["runs"].items():
        check(all(run.routes[r] is base_placed[key][r]
                  for r in ("edge", "node")),
              f"the {precisions[key[1]]} delta run does not share the base "
              "routes")
        for k, v in expected_run_launches(run, 2, placed_base=False).items():
            expected[k] += v
    check(launches == expected,
          f"refresh launch counts {launches} != expected {expected}")

    # base iterations again, in the same minute as the delta's
    # (not counted: the refresh counts were read above)
    base_warm = {}
    for p in ("f32", "bf16"):
        t0 = time.perf_counter()
        pagerank(graph, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0,
                 precision=p)
        torch.cuda.synchronize()
        base_warm[p] = time.perf_counter() - t0

    ref = reference_pagerank(src2, dst2, N_NODES)
    a32 = r32.double().cpu().numpy()
    a16 = r16.double().cpu().numpy()
    check(bool(np.isfinite(a32).all() and np.isfinite(a16).all())
          and a32.shape == a16.shape == (N_NODES,),
          "refresh ranks non-finite or misshaped")
    rel = float((np.abs(a32 - ref) / ref).max())
    l1 = float(np.abs(a32 - ref).sum())
    top = len(set(np.argsort(-a32)[:100]) & set(np.argsort(-ref)[:100]))
    check(rel <= F32_REL_TOL and l1 <= F32_L1_TOL and top == 100,
          f"refresh f32 off the float64 reference of the mutated graph: "
          f"rel {rel} l1 {l1} top-100 {top}")
    bounds = PRECISION_BOUNDS["bf16"]
    linf16 = float(np.abs(a16 - a32).max())
    l1_16 = float(np.abs(a16 - a32).sum())
    k = bounds["topk_order"]
    top_order = bool((np.argsort(-a16)[:k] == np.argsort(-a32)[:k]).all())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"]
          and top_order, f"refresh bf16 outside PRECISION_BOUNDS: linf "
          f"{linf16} l1 {l1_16} top-{k} order {top_order}")
    # the bf16 run must have moved with the mutation: its change from the
    # base's bf16 ranks tracks the f32 change (the common rounding of the
    # base contributions cancels); a bf16 run served by the bare base plan
    # (the JAX package's defect) has no change at all
    moved32 = a32 - base["ranks"]["f32"]
    moved16 = a16 - base["ranks"]["bf16"]
    moved_l1 = float(np.abs(moved32).sum())
    miss_l1 = float(np.abs(moved16 - moved32).sum())
    check(moved_l1 > 0 and miss_l1 < 0.5 * moved_l1,
          f"refresh bf16 did not move with the mutation: |bf16 change - "
          f"f32 change| {miss_l1} against |f32 change| {moved_l1}")
    to_base_l1 = float(np.abs(a16 - base["ranks"]["f32"]).sum())
    check(l1_16 < to_base_l1,
          f"refresh bf16 sits closer to the base snapshot's ranks (L1 "
          f"{to_base_l1}) than to the f32 delta run's (L1 {l1_16})")

    placement = {p: r.placement_s for p, r in runs.items()}
    first = state["diff_s"] + state["delta_build_s"]
    summary = {
        "n_delta": delta.n_delta, "changed_nodes": int(len(changed)),
        "delta": {"net_log2": delta.net_log2, "R_G": delta.R_G,
                  "C": delta.C},
        "mutate_s": mutate_s, "commit_s": commit_s,
        "export_delta_s": export_delta_s,
        "from_coo_s": probe["from_coo_s"][0], "from_coo_builder": "native",
        "export_full_s": export_full_s,
        "diff_s": state["diff_s"], "delta_build_s": state["delta_build_s"],
        "placement_s": placement,
        "placement_split": {p: r.route_split for p, r in runs.items()},
        "refresh_cold_s": {"f32": first + placement["f32"],
                           "bf16": placement["bf16"]},
        "base_plan_build_s": base["summary"]["plan_build_s"],
        "base_placement_s": base["summary"]["placement_s"],
        "cold_run_s": {"f32": cold32, "bf16": cold16},
        "warm_run_s": {"f32": warm32, "bf16": warm16},
        "cold_iteration_ms": {
            "f32": (cold32 - first - placement["f32"]) / ITERATIONS * 1e3,
            "bf16": (cold16 - placement["bf16"]) / ITERATIONS * 1e3},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "base_iteration_ms": {p: t / ITERATIONS * 1e3
                              for p, t in base_warm.items()},
        "base_iteration_ms_main_path": base["summary"]["iteration_ms"],
        "launches": launches, "expected_launches": expected,
        "f32_vs_f64": {"max_rel": rel, "l1": l1, "top100": top},
        "bf16_vs_f32": {"linf": linf16, "l1": l1_16,
                        f"top{k}_order": top_order},
        "bf16_moved": {"f32_change_l1": moved_l1,
                       "bf16_change_miss_l1": miss_l1,
                       "bf16_vs_base_f32_l1": to_base_l1}}
    print("refresh", json.dumps(summary), flush=True)
    base["v1"] = succ
    base["snapshot"] = {
        "v1": {"changed": len(changed), "export_delta_s": export_delta_s,
               "export_full_s": export_full_s,
               "cold_iteration_ms": summary["cold_iteration_ms"],
               "iteration_ms": summary["iteration_ms"],
               "base_iteration_ms": summary["base_iteration_ms"]}}

    shapes = {}
    for p, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        shapes[f"delta_{p}"] = route_kernels(
            f"delta_{p}", runs[p].routes["delta"], delta.masks_packed, dtype)
    return launches, shapes


# ---------------------------------------------------------------------------
# phases 6-8: katz on PageRank's routes, the segment backend, degree
# ---------------------------------------------------------------------------

KATZ_ALPHA = 0.05       # about 0.5 / λ, λ of the north star's Aᵀ (katz line)
KATZ_BETA = 1.0
SEGMENT_NODES, SEGMENT_EDGES = 100_000, 450_000
# HITS against a float64 run of the same steps, relative to the largest
# entry: the CPU rehearsal at this size reads 1.2e-7 (hubs) and 1.1e-8
# (authorities); the card sums in the same order (csr_spmm_sum);
# budgeted ~100x
HITS_TOL = 1e-5


def transposed_adjacency(src, dst, n_nodes):
    """Aᵀ as a float64 scipy matrix (row v: the edges into v)."""
    import scipy.sparse as sp
    return sp.csr_matrix((np.ones(len(src)), (dst, src)),
                         shape=(n_nodes, n_nodes))


def reference_katz(a_t, alpha, beta=KATZ_BETA, iterations=ITERATIONS):
    """float64 scipy run of x <- alpha Aᵀx + beta from zeros."""
    x = np.zeros(a_t.shape[0])
    for _ in range(iterations):
        x = alpha * (a_t @ x) + beta
    return x


def spectral_radius(a_t, iterations=100) -> float:
    """λ of Aᵀ by a float64 power iteration (||Aᵀx|| / ||x||): katz
    contracts for α λ < 1, and ``katz_rel`` holds for α λ <= 1/2."""
    n_nodes = a_t.shape[0]
    x = np.ones(n_nodes) / np.sqrt(n_nodes)
    lam = 0.0
    for _ in range(iterations):
        y = a_t @ x
        lam = float(np.linalg.norm(y))
        x = y / max(lam, 1e-300)
    return lam


def reference_hits(a_t, iterations=ITERATIONS):
    """float64 scipy run of HITS's steps (ops/katz.py:_hits_step): the
    authorities from the hubs, then the hubs from the new authorities,
    each L2-normalized, from ones."""
    a = a_t.T.tocsr()
    hub = np.ones(a_t.shape[0])
    auth = hub
    for _ in range(iterations):
        auth = a_t @ hub
        auth = auth / max(np.linalg.norm(auth), 1e-30)
        hub = a @ auth
        hub = hub / max(np.linalg.norm(hub), 1e-30)
    return hub, auth


def vs_float64(got, ref) -> dict:
    """max relative error, and the overlap of the top 100."""
    a = got.double().cpu().numpy()
    check(bool(np.isfinite(a).all()) and a.shape == ref.shape,
          "non-finite or misshaped centralities")
    return {"max_rel": float((np.abs(a - ref) / ref).max()),
            "top100": len(set(np.argsort(-a)[:100])
                          & set(np.argsort(-ref)[:100]))}


def timed_run(fn):
    """(fn's result, host seconds to the end of its device work)."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_katz(base: dict):
    """Katz on the main path's placed graph, riding PageRank's plan and
    routes: no build_plan, no route placed, no stage kernel, the gathers
    of two nets an iteration; f32 against float64, bf16 against f32."""
    import torch
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops.katz import katz_centrality
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph = base["graph"]
    state = graph._mxu_state
    def katz(precision):
        return timed_run(lambda: katz_centrality(
            graph, alpha=KATZ_ALPHA, beta=KATZ_BETA,
            max_iterations=ITERATIONS, tol=-1.0, precision=precision))

    # the katz path: counts set to 0 just before, read just after
    with counted_plan_builds() as plan_builds, \
            placement_guard() as placed_nets:
        BC.reset_launch_counts()
        (k32, _, it32), cold32 = katz("f32")
        (k16, _, it16), cold16 = katz("bf16")
        (_, _, it32w), warm32 = katz("f32")
        (_, _, it16w), warm16 = katz("bf16")
        launches = counts()
    # PageRank in the same minute (not counted)
    pr_warm = {p: timed_run(lambda p=p: pagerank(
        graph, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0,
        precision=p))[1] for p in ("f32", "bf16")}

    check(not plan_builds, f"build_plan ran {len(plan_builds)} time(s) for "
                           "katz on a planned graph")
    check(not placed_nets, f"katz placed routes {placed_nets}")
    check(it32 == it16 == it32w == it16w == ITERATIONS,
          f"katz iterations {it32}/{it16}/{it32w}/{it16w} != {ITERATIONS}")
    per_run = {"benes_mid": 0, "benes_mid_gather": 2 * ITERATIONS,
               "benes_outer": 0, "benes_outer_gather": 4 * ITERATIONS}
    expected = {k: 4 * v for k, v in per_run.items()}
    check(launches == expected,
          f"katz launch counts {launches} != expected {expected} (4 runs)")
    cache = state["semiring"]
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    for (_, dev, dt), placed in cache["placed"].items():
        shared = state["placed"][(dev, dt)]
        check(placed["shares"] is shared
              and all(placed[r] is shared[r] for r in ("edge", "node")),
              f"katz {precisions[dt]} does not ride PageRank's routes")

    a_t = transposed_adjacency(base["src"], base["dst"], graph.n_nodes)
    katz64 = reference_katz(a_t, KATZ_ALPHA)
    base.setdefault("refs", {})["katz64"] = katz64       # the mesh's too
    f32 = vs_float64(k32, katz64)
    check(f32["max_rel"] <= F32_REL_TOL and f32["top100"] == 100,
          f"katz f32 off the float64 reference: {f32}")
    # katz_rel is derived for α λ <= 1/2 (ops/semiring.py)
    lam = spectral_radius(a_t)
    check(KATZ_ALPHA * lam <= 0.5,
          f"α λ = {KATZ_ALPHA * lam} > 1/2: katz_rel does not hold there")
    bound = PRECISION_BOUNDS["bf16"]["katz_rel"]
    rel16 = float(((k16 - k32).abs() / k32).max())
    check(rel16 <= bound, f"katz bf16 off f32 by {rel16} > {bound}")
    summary = {
        "alpha": KATZ_ALPHA, "beta": KATZ_BETA, "iterations": ITERATIONS,
        "lambda": lam, "alpha_lambda": KATZ_ALPHA * lam,
        "plan_builds": len(plan_builds), "routes_placed": len(placed_nets),
        "derive_s": cache["plan_s"][False],
        "placement_s": {precisions[dt]: p["placement_s"]
                        for (_, _, dt), p in cache["placed"].items()},
        "cold_run_s": {"f32": cold32, "bf16": cold16},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "pagerank_iteration_ms": {p: t / ITERATIONS * 1e3
                                  for p, t in pr_warm.items()},
        "launches": launches, "expected_launches": expected,
        "f32_vs_f64": f32, "bf16_vs_f32": {"max_rel": rel16,
                                           "bound": bound}}
    print("katz", json.dumps(summary), flush=True)
    return launches


def degree_line(label, graph, src, dst) -> dict:
    """Degree centrality in each direction, bit-equal to numpy's float32
    counts over n - 1; with its device time."""
    import torch
    from memgraph_tpu_torch.ops.katz import degree_centrality
    n = graph.n_nodes
    plain = {"in": np.bincount(dst, minlength=n),
             "out": np.bincount(src, minlength=n)}
    plain["total"] = plain["in"] + plain["out"]
    out = {}
    for direction, count in plain.items():
        got = degree_centrality(graph, direction)
        want = torch.from_numpy(count.astype(np.float32)
                                / np.float32(max(n - 1, 1)))
        check(got.dtype == torch.float32
              and torch.equal(got.cpu().view(torch.int32),
                              want.view(torch.int32)),
              f"degree_centrality {direction} on the {label} graph is not "
              "numpy's")
        out[direction] = cuda_ms(lambda d=direction: degree_centrality(
            graph, d), 10)
    return {"graph": label, "ms": out, "bit_equal": True}


def phase_segment(base: dict):
    """The segment backend on the card: PageRank, katz and HITS on a graph
    under MXU_MIN_EDGES, against float64; degree centrality on it and on
    the north star."""
    import torch
    from memgraph_tpu_torch.northstar import generate_graph
    from memgraph_tpu_torch.ops import semiring as S
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.katz import hits, katz_centrality
    from memgraph_tpu_torch.ops.pagerank import pagerank

    n = SEGMENT_NODES
    src, dst = generate_graph(n_nodes=n, n_edges=SEGMENT_EDGES)
    check(SEGMENT_EDGES < S.MXU_MIN_EDGES,
          "the segment graph is not under MXU_MIN_EDGES")
    graph = from_coo(src, dst, n_nodes=n).to_device("cuda")
    runs = {}
    # the segment path: counts set to 0 just before, read just after
    reset_all_counts()
    for name, fn in (
            ("pagerank", lambda: pagerank(graph, damping=DAMPING,
                                          max_iterations=ITERATIONS,
                                          tol=0.0)),
            ("katz", lambda: katz_centrality(graph, alpha=KATZ_ALPHA,
                                             max_iterations=ITERATIONS,
                                             tol=-1.0)),
            ("hits", lambda: hits(graph, max_iterations=ITERATIONS,
                                  tol=-1.0))):
        first, cold = timed_run(fn)
        out, warm = timed_run(fn)
        check(out[-1] == ITERATIONS, f"segment {name} ran {out[-1]} "
                                     f"iterations, not {ITERATIONS}")
        vectors = [v for v in out if isinstance(v, torch.Tensor)]
        check(all(same_bits(a, b) for a, b in zip(
            [v for v in first if isinstance(v, torch.Tensor)], vectors)),
              f"two segment {name} runs are not bit-equal")
        runs[name] = (out, cold, warm)
    launches = all_counts()
    check(getattr(graph, "_mxu_state", None) is None,
          "the segment graph took the MXU plan")
    # an iteration: one run sum (two for HITS); PageRank's setup one more
    expected = {"csr_spmm_sum": 2 * ((ITERATIONS + 1) + ITERATIONS
                                     + 2 * ITERATIONS),
                "lane_sum": 0}
    check({k: launches[k] for k in expected} == expected,
          f"segment launch counts {launches} != expected {expected}")

    pr = vs_float64(runs["pagerank"][0][0],
                    reference_pagerank(src, dst, n))
    a_t = transposed_adjacency(src, dst, n)
    kz = vs_float64(runs["katz"][0][0], reference_katz(a_t, KATZ_ALPHA))
    for name, got in (("pagerank", pr), ("katz", kz)):
        check(got["max_rel"] <= F32_REL_TOL and got["top100"] == 100,
              f"segment {name} off the float64 reference: {got}")
    hub64, auth64 = reference_hits(a_t)
    hub, auth = (v.double().cpu().numpy() for v in runs["hits"][0][:2])
    hits_err = {"hub": float(np.abs(hub - hub64).max() / hub64.max()),
                "auth": float(np.abs(auth - auth64).max() / auth64.max())}
    check(max(hits_err.values()) <= HITS_TOL,
          f"segment HITS off the float64 steps: {hits_err} > {HITS_TOL}")
    lam = spectral_radius(a_t)
    summary = {
        "n_nodes": n, "n_edges": SEGMENT_EDGES, "iterations": ITERATIONS,
        "katz_alpha_lambda": KATZ_ALPHA * lam,
        "cold_run_s": {k: v[1] for k, v in runs.items()},
        "iteration_ms": {k: v[2] / ITERATIONS * 1e3
                         for k, v in runs.items()},
        "pagerank_vs_f64": pr, "katz_vs_f64": kz,
        "hits_vs_f64": hits_err, "hits_tol": HITS_TOL,
        "reruns_bit_equal": True, "launches": launches,
        "expected_launches": expected}
    print("segment", json.dumps(summary), flush=True)
    for label, g, s, d in (("segment", graph, src, dst),
                           ("north_star", base["graph"], base["src"],
                            base["dst"])):
        print("degree", json.dumps(degree_line(label, g, s, d)), flush=True)
    del graph
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phases 9-11: the deterministic segment sums, PPR, components and traversal
# ---------------------------------------------------------------------------

SEG_LANES = (1, 3, 32)
SEGMENT_REPLACES = ("no pallas_call: port's own; the JAX package's sorted "
                    "jax.ops.segment_sum, memgraph_tpu/ops/semiring.py:182")
PPR_TOL = 1e-6
PPR_MAX_ITERATIONS = 100
PPR_LANES = 32
PPR_SEED = 13
# single PPR against float64 after ITERATIONS fixed iterations, relative
# to the largest entry: f32 rounding as for PageRank's 1e-4 (F32_REL_TOL)
PPR_REL_TOL = 1e-4
PPR_TOPK = 100
SSSP_SEED = 17
# Bellman-Ford in f32 against float64 Dijkstra: a path of h hops carries
# h f32 roundings (2^-24 relative each, h ~ 10-20 here); budgeted ~10x
SSSP_REL_TOL = 1e-5
MSSP_SOURCES = 8
KHOP_K = 2


def seg_counts() -> dict:
    from memgraph_tpu_torch.ops import segment_cuda as SC
    return {"csr_spmm_sum": SC.csr_spmm_sum.launches,
            "lane_sum": SC.lane_sum.launches}


def reset_all_counts():
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops import segment_cuda as SC
    BC.reset_launch_counts()
    SC.reset_launch_counts()


def all_counts() -> dict:
    return {**counts(), **seg_counts()}


class K1Recorder:
    """Stands in for ops/segment_cuda in one module's namespace while a
    path runs: its ``csr_spmm_sum`` is the real one (which counts the
    launch as the path's), and it keeps copies of the inputs, the keyword
    arguments and the result of the calls that ``keep(x, ptr, g, w, kw)``
    names (a key, or None); a call kept under a key replaces the one kept
    there before."""

    def __init__(self, sc, keep):
        self._sc, self._keep, self.calls = sc, keep, {}

    def __getattr__(self, name):
        return getattr(self._sc, name)

    def csr_spmm_sum(self, x, ptr, g=None, w=None, **kw):
        y = self._sc.csr_spmm_sum(x, ptr, g, w, **kw)
        key = self._keep(x, ptr, g, w, kw)
        if key is not None:
            self.calls[key] = {
                "x": x.clone(), "ptr": ptr.clone(),
                "g": None if g is None else g.clone(),
                "w": None if w is None else w.clone(), "kw": dict(kw),
                "y": y.clone()}
        return y


@contextlib.contextmanager
def k1_recorded(module, keep):
    """``module``'s K1 calls recorded (``K1Recorder``) while inside;
    yields the calls kept, by key."""
    rec = K1Recorder(module.SC, keep)
    module.SC = rec
    try:
        yield rec.calls
    finally:
        module.SC = rec._sc


def path_k1_lines(calls: dict, prefix: str, n_in=None) -> list:
    """A ``segment_kernels`` line for each K1 call a path made (kept by
    ``k1_recorded``): the path's launch held to its plain version on CPU
    copies, and timed as ``segment_kernel_line`` times it."""
    lines = []
    for key, c in calls.items():
        kw = c["kw"]
        line = segment_kernel_line(
            f"{prefix}_{key}", c["x"], c["ptr"], c["g"], c["w"],
            kw.get("precision", "f32"),
            c["x"].shape[0] if n_in is None else n_in, kw.get("longest"),
            mul=kw.get("mul", "times"), launched=c["y"])
        print("segment_kernels", json.dumps(line), flush=True)
        lines.append(line)
    return lines


# The previous designs' kernel times (a thread a run for K1, a launch a
# level for K2; PERF.md §6, NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's at the shapes they were measured at: (runs, precision,
# lanes) for K1, lanes for K2 (dot form)
PREVIOUS_K1_MS = {("csc", "f32", 1): 0.817, ("csc", "bf16", 1): 0.941,
              ("csc", "f32", 3): 0.740, ("csc", "f32", 32): 1.091,
              ("csc", "bf16", 32): 1.255, ("csr", "f32", 1): 0.106,
              ("csr", "bf16", 1): 0.106, ("csr", "f32", 3): 0.122,
              ("csr", "f32", 32): 0.819}
PREVIOUS_K2_MS = {1: 0.0254, 3: 0.0326, 32: 0.1257}


def spmm_bytes(n_edges: int, n_seg: int, lanes: int, x_rows: int,
               index_bytes: int = 4, weight_bytes: int = 4,
               ptr_bytes: int = 4) -> int:
    """K1's bytes: each edge's index and weight, the B values of each row
    of x that a run reads, each read once (``x_rows``: the distinct
    gathered rows, or the edges with no gather), the run offsets, and the
    output written once."""
    return n_edges * (index_bytes + weight_bytes) + x_rows * lanes * 4 \
        + (n_seg + 1) * ptr_bytes + n_seg * lanes * 4


def segment_kernel_line(label, x, ptr, g, w, precision, n_in, longest,
                        mul="times", launched=None) -> dict:
    """K1 on the card against its plain version on CPU copies, column by
    column against its 1-lane call, and against a second launch, given
    the longest run as the main path gives it (``longest``: a graph's
    ``longest_csc_run`` / ``longest_csr_run``, or None where the path
    does not give it); timed, with the plain version on the card and the
    library calls: a ``torch.sparse_csr_tensor`` product (gathered, f32;
    unit weights for ⊗ = first) and ``index_add_`` of the precomputed
    contributions.  Where no run is
    long, the launch with the longest run unknown (the two-role kernel)
    is held to the same bits and timed beside it (``two_role_ms``).
    ``launched``: the result of the path's own launch on these inputs,
    held to the same bits.  A 1-D x is taken as one lane."""
    import torch
    from memgraph_tpu_torch.ops import segment_cuda as SC
    if x.dim() == 1:
        x = x.unsqueeze(1)
    lanes = x.shape[1]

    def k1(xx=x, longest=longest):
        return SC.csr_spmm_sum(xx, ptr, g, w, mul=mul, precision=precision,
                               longest=longest)

    def cpu(t):
        return None if t is None else t.cpu()

    got = k1()
    again = k1()
    want = SC.csr_spmm_sum_reference(x.cpu(), ptr.cpu(), cpu(g), cpu(w),
                                     mul=mul, precision=precision)
    what = f"csr_spmm_sum {label} {mul} {precision} B={lanes}"
    check(same_bits(got.cpu(), want),
          f"{what} is not its plain version's bits")
    check(same_bits(got, again), f"{what}: two launches differ")
    check(launched is None or same_bits(launched.reshape(got.shape), got),
          f"{what}: the path's own launch is not these bits")
    col = k1(x[:, lanes - 1].contiguous())
    check(same_bits(col, got[:, lanes - 1].contiguous()),
          f"{what}: a column alone is not its bits inside {lanes} lanes")
    n_seg = ptr.numel() - 1
    longest_run = int((ptr[1:] - ptr[:-1]).max()) if n_seg else 0
    check(longest is None or longest == longest_run,
          f"{what}: given longest run {longest}, has {longest_run}")
    lo, hi = int(ptr[0]), int(ptr[-1])
    n_edges = hi - lo
    x_rows = n_edges if g is None else int(torch.unique(g[lo:hi]).numel())
    t, by = bound_ms(spmm_bytes(
        n_edges, n_seg, lanes, x_rows,
        index_bytes=0 if g is None else g.element_size(),
        weight_bytes=0 if w is None else 4, ptr_bytes=ptr.element_size()),
        (2.0 if mul == "times" else 1.0) * n_edges * lanes)
    ids = torch.repeat_interleave(
        torch.arange(n_seg, device=x.device), (ptr[1:] - ptr[:-1]).long())
    vals = x[lo:hi] if g is None else x[g[lo:hi]]
    if w is not None:
        vals = vals * w[lo:hi].unsqueeze(1)
    index_add_ms = cuda_ms(lambda: torch.zeros(
        n_seg, lanes, device=x.device).index_add_(0, ids, vals), 5)
    line = {
        "runs": label, "mul": mul, "precision": precision, "lanes": lanes,
        "longest_given": longest,
        "ptr": str(ptr.dtype).replace("torch.", ""),
        "g": None if g is None else str(g.dtype).replace("torch.", ""),
        "n_seg": n_seg, "n_edges": n_edges, "x_rows": x_rows,
        "longest_run": longest_run,
        "bit_equal": True, "lanes_independent": True, "rerun_equal": True,
        "max_abs_err": 0.0,
        "ms": device_ms(k1, 10),
        "previous_ms": PREVIOUS_K1_MS.get((label, precision, lanes)),
        "plain_ms": cuda_ms(lambda: SC.csr_spmm_sum_reference(
            x, ptr, g, w, mul=mul, precision=precision), 3),
        "bound_ms": t, "bound_by": by,
        "index_add_ms": index_add_ms}
    if longest is not None and longest <= SC.long_run():
        check(same_bits(k1(longest=None), got),
              f"{what}: the two-role launch is not the short one's bits")
        line["two_role_ms"] = device_ms(lambda: k1(longest=None), 10)
    if g is not None:
        # ⊗ = first is the product with unit weights
        ww = torch.ones(n_edges, device=x.device) if w is None else w[lo:hi]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # torch's beta-state notices
            mat = torch.sparse_csr_tensor(
                (ptr - lo).to(g.dtype).contiguous(), g[lo:hi].contiguous(),
                ww.contiguous(), size=(n_seg, n_in))
        line["library_ms"] = cuda_ms(lambda: mat @ x, 5)
        line["library"] = ("torch.sparse_csr_tensor(ptr, g, w) @ x (f32)"
                           if w is not None else
                           "torch.sparse_csr_tensor(ptr, g, 1) @ x (f32)")
    else:
        line["library_ms"] = index_add_ms
        line["library"] = "index_add_ of the contributions"
    return line


def lane_sum_line(a, m) -> dict:
    """K2 in each form against its plain version, and B-independence."""
    import torch
    from memgraph_tpu_torch.ops import segment_cuda as SC
    lanes = a.shape[1]
    b = a.flip(0).contiguous()
    forms = {"sum": {}, "dot": {"m": m}, "l1": {"b": b}}
    for form, kw in forms.items():
        got = SC.lane_sum(a, **kw)
        want = SC.lane_sum_reference(a.cpu(), **{k: v.cpu()
                                                 for k, v in kw.items()})
        check(same_bits(got.cpu(), want),
              f"lane_sum {form} B={lanes} is not its plain version's bits")
        check(same_bits(got, SC.lane_sum(a, **kw)),
              f"lane_sum {form} B={lanes}: two launches differ")
        one = SC.lane_sum(a[:, -1].contiguous(),
                          **{k: (v[:, -1].contiguous() if k == "b" else v)
                             for k, v in kw.items()})
        check(same_bits(one.view(1), got[-1:]),
              f"lane_sum {form}: a column alone is not its bits inside "
              f"{lanes} lanes")
    n = a.shape[0]
    t, by = bound_ms(n * lanes * 4 + n * 4 + lanes * 4, 2.0 * n * lanes)
    return {"lanes": lanes, "rows": n, "bit_equal": True,
            "lanes_independent": True, "max_abs_err": 0.0,
            "ms": device_ms(lambda: SC.lane_sum(a, m=m), 20),
            "previous_ms": PREVIOUS_K2_MS.get(lanes),
            "plain_ms": cuda_ms(lambda: SC.lane_sum_reference(a, m=m), 5),
            "bound_ms": t, "bound_by": by,
            "library_ms": cuda_ms(lambda: torch.sum(a * m.unsqueeze(1),
                                                    dim=0), 20),
            "library": "torch.sum(a * m[:, None], dim=0)",
            "at": "dot form (the dangling mass)"}


def straddle_lengths(n_runs: int, seed: int) -> np.ndarray:
    """Run lengths around K1's short/long bound T (T - 1, T, T + 1, 2T,
    32T + 1), mixed with empty runs."""
    from memgraph_tpu_torch.ops.segment_cuda import long_run
    T = long_run()
    rng = np.random.default_rng(seed)
    return rng.choice([0, 0, T - 1, T, T + 1, 2 * T, 32 * T + 1], n_runs)


def star_lengths() -> np.ndarray:
    """A star into one node, 2^20 + 5 in-edges, between short runs."""
    return np.array([0, 3, 2**20 + 5, 0, 7, 1])


def phase_segment_kernels(base: dict):
    """K1 and K2 on the north star against their plain versions: CSC runs
    (the pull matvec) and CSR runs (the reversed one), f32 and bf16, 1, 3
    and 32 lanes; then K1 where its design can break: run lengths
    straddling the short/long bound, one run of 2^20 + 5, the no-gather
    form (``g=None``, ⊗ = first, as ``semiring._float_sum`` launches it)
    and int64 offsets and indices.  Bit-equal, lane-independent,
    rerun-equal; timed."""
    import torch
    graph = base["graph"]
    rng = np.random.default_rng(PPR_SEED)
    k1 = []
    for lanes in SEG_LANES:
        x = torch.from_numpy(rng.random((graph.n_pad, lanes),
                                        dtype=np.float32)).cuda()
        for label, ptr, g, w, longest in (
                ("csc", graph.csc_runs(), graph.csc_src, graph.csc_weights,
                 graph.longest_csc_run),
                ("csr", graph.row_ptr, graph.col_idx, graph.weights,
                 graph.longest_csr_run)):
            for precision in ("f32", "bf16"):
                line = segment_kernel_line(label, x, ptr, g, w, precision,
                                           graph.n_pad, longest)
                print("segment_kernels", json.dumps(line), flush=True)
                k1.append(line)
    k2 = []
    m = torch.from_numpy((rng.random(graph.n_pad) < 0.1).astype(
        np.float32)).cuda()
    for lanes in SEG_LANES:
        a = torch.from_numpy(rng.random((graph.n_pad, lanes),
                                        dtype=np.float32)).cuda()
        line = lane_sum_line(a, m)
        print("segment_kernels", json.dumps({"lane_sum": line}), flush=True)
        k2.append(line)

    def shape(label, x, ptr, g, w, lanes_list, longest, precisions=("f32",),
              mul="times", n_in=graph.n_pad):
        for lanes in lanes_list:
            xl = x[:, :lanes].contiguous()
            for precision in precisions:
                line = segment_kernel_line(label, xl, ptr, g, w, precision,
                                           n_in, longest, mul=mul)
                print("segment_kernels", json.dumps(line), flush=True)
                k1.append(line)

    rng = np.random.default_rng(PPR_SEED + 1)
    x = torch.from_numpy(rng.random((graph.n_pad, max(SEG_LANES)),
                                    dtype=np.float32)).cuda()
    csc = graph.csc_runs()
    shape("csc_int64", x, csc.long(), graph.csc_src.long(),
          graph.csc_weights, (1, 3), graph.longest_csc_run)
    edges = int(csc[-1])
    per_edge = torch.from_numpy(rng.random((edges, 3),
                                           dtype=np.float32)).cuda()
    shape("csc_no_gather", per_edge, csc, None, None, (1, 3),
          graph.longest_csc_run, mul="first", n_in=edges)
    del per_edge
    for label, lengths in (("straddle", straddle_lengths(2**13, 5)),
                           ("star", star_lengths())):
        ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                               .astype(np.int32)).cuda()
        n = int(ptr[-1])
        g = torch.from_numpy(rng.integers(0, graph.n_pad, n)
                             .astype(np.int32)).cuda()
        w = torch.from_numpy(rng.random(n, dtype=np.float32)).cuda()
        shape(label, x, ptr, g, w, SEG_LANES, int(lengths.max()),
              precisions=("f32", "bf16"))
    return {"csr_spmm_sum": k1, "lane_sum": k2}


def segment_kernel_entries(lines: dict, mxu: dict, by_path: dict) -> list:
    """K1's and K2's entries of the {"kernels": [...]} line: numbers at
    the single PPR's shape (CSC runs, f32, one lane), every shape under
    shapes; launches those of the PPR path, by path beside them."""
    out = []
    for name, at in (("csr_spmm_sum", {"runs": "csc", "precision": "f32",
                                       "lanes": 1}),
                     ("lane_sum", {"lanes": 1})):
        shapes = lines[name]
        main = next(ln for ln in shapes
                    if all(ln[k] == v for k, v in at.items()))
        out.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/segment.cu",
            "replaces": SEGMENT_REPLACES,
            "launches": by_path["ppr"][name],
            "launches_by_path": {**{p: c[name] for p, c in mxu.items()},
                                 **{p: c[name] for p, c in by_path.items()}},
            "max_abs_err": max(ln["max_abs_err"] for ln in shapes),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "at": at,
            # measured in this run only: the previous design's times stay
            # on the segment_kernels lines
            "shapes": [{k: v for k, v in ln.items() if k != "previous_ms"}
                       for ln in shapes]})
    return out


def reference_ppr(src, dst, n_nodes, sources, iterations=ITERATIONS,
                  damping=DAMPING):
    """float64 scipy power iteration of PPR (ops/pagerank.py's update)
    from the normalized restart vector."""
    import scipy.sparse as sp
    deg = np.bincount(src, minlength=n_nodes).astype(np.float64)
    inv_deg = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    mat = sp.csr_matrix((inv_deg[src], (dst, src)),
                        shape=(n_nodes, n_nodes))
    dangling = deg == 0
    p = np.zeros(n_nodes)
    p[np.asarray(sources)] = 1.0
    p /= p.sum()
    x = p.copy()
    for _ in range(iterations):
        x = (1 - damping) * p + damping * (mat @ x + x[dangling].sum() * p)
    return x


def phase_ppr(base: dict):
    """PPR on the north star: single against float64, a 32-lane batch
    with lanes bit-equal to sequential runs, a 3-lane batch, bf16 within
    bounds, a warm start, top-k; K1/K2 launches against their counts."""
    import torch
    from memgraph_tpu_torch.ops import pagerank as PR
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes
    rng = np.random.default_rng(PPR_SEED)
    single_sources = rng.choice(n, 3, replace=False)
    sets = [rng.choice(n, int(rng.integers(1, 6)), replace=False)
            for _ in range(PPR_LANES)]
    seq_lanes = (0, 7, 19, PPR_LANES - 1)
    expected = {"csr_spmm_sum": 0, "lane_sum": 0}

    def ran(iterations: int):
        # setup: the CSR weight sums (K1) and the restart norms (K2);
        # an iteration: the matvec (K1), dangling mass and L1 error (K2)
        expected["csr_spmm_sum"] += 1 + iterations
        expected["lane_sum"] += 1 + 2 * iterations

    def single(sources, **kw):
        out, s = timed_run(lambda: PR.personalized_pagerank(
            graph, sources, damping=DAMPING, **kw))
        ran(out[2])
        return out, s

    def batch(lane_sets, raw=True, **kw):
        # the loop runs until its slowest lane stops: max(iters)
        out, s = timed_run(lambda: PR.personalized_pagerank_batch(
            graph, lane_sets, damping=DAMPING, raw=raw, **kw))
        ran(int(out[2].max()))
        return out, s

    # the PPR path: counts set to 0 just before, read just after
    reset_all_counts()
    (r1, _, it1), s1 = single(single_sources, max_iterations=ITERATIONS,
                              tol=-1.0)
    (_, _, it1w), s1w = single(single_sources, max_iterations=ITERATIONS,
                               tol=-1.0)
    (xb, eb, ib), sb = batch(sets, tol=PPR_TOL,
                             max_iterations=PPR_MAX_ITERATIONS)
    seq = {lane: single(sets[lane], tol=PPR_TOL,
                        max_iterations=PPR_MAX_ITERATIONS)[0]
           for lane in seq_lanes}
    (x3, e3, i3), _ = batch(sets[:3], tol=PPR_TOL,
                            max_iterations=PPR_MAX_ITERATIONS)
    (r3, _, _), _ = batch(sets[:3], raw=False, tol=PPR_TOL,
                          max_iterations=PPR_MAX_ITERATIONS)
    (x16, _, i16), _ = batch(sets[:3], tol=PPR_TOL,
                             max_iterations=PPR_MAX_ITERATIONS,
                             precision="bf16")
    (xw, _, iw), _ = batch(sets, tol=PPR_TOL,
                           max_iterations=PPR_MAX_ITERATIONS,
                           x0=xb.cpu().numpy())
    (xt, _, it_t), st = batch(sets, tol=-1.0, max_iterations=ITERATIONS)
    # a dangling source keeps its mass: every other entry ties at 0
    dangling = int(rng.choice(np.flatnonzero(
        np.bincount(src, minlength=n) == 0)))
    (rd, _, _), _ = single([dangling], tol=PPR_TOL,
                           max_iterations=PPR_MAX_ITERATIONS)
    lanes_k = torch.cat([xb[:n].T, rd.unsqueeze(0)])
    (vals, idx) = PR.ppr_topk(lanes_k, n, PPR_TOPK, raw=True)
    torch.cuda.synchronize()
    launches = all_counts()

    check(launches["csr_spmm_sum"] > 0 and launches["lane_sum"] > 0,
          f"the PPR path launched no segment kernel: {launches}")
    check({k: launches[k] for k in expected} == expected,
          f"PPR launch counts {launches} != expected {expected}")
    check(it1 == it1w == ITERATIONS and int(it_t.max()) == ITERATIONS,
          f"fixed-length PPR ran {it1}/{it1w}/{it_t.max()} iterations")

    a = r1.double().cpu().numpy()
    ref = reference_ppr(src, dst, n, single_sources)
    check(bool(np.isfinite(a).all()) and a.shape == (n,),
          "non-finite or misshaped PPR ranks")
    rel = float(np.abs(a - ref).max() / ref.max())
    top = len(set(np.argsort(-a)[:PPR_TOPK])
              & set(np.argsort(-ref)[:PPR_TOPK]))
    check(rel <= PPR_REL_TOL and top == PPR_TOPK,
          f"PPR off float64: max err {rel} of the largest entry, top-"
          f"{PPR_TOPK} {top}")

    ranks = xb[:n].T.cpu()
    iters = ib.cpu().numpy()
    check(bool(torch.isfinite(ranks).all()) and bool((iters >= 1).all()),
          "non-finite batch ranks or a lane that never ran")
    for lane, (r, _, it) in seq.items():
        check(same_bits(r.cpu().contiguous(), ranks[lane].contiguous())
              and it == int(iters[lane]),
              f"batch lane {lane} is not the sequential run: iters "
              f"{iters[lane]} against {it}")
    check(x3.shape[1] == 4 and tuple(i3.shape) == (4,),
          f"3 lanes ran as {x3.shape[1]}, not the bucket of 4")
    check(r3.shape == (3, n) and same_bits(
        torch.from_numpy(r3), ranks[:3].contiguous()),
          "the 3-lane batch is not the 32-lane batch's first lanes")
    bounds = PRECISION_BOUNDS["bf16"]
    d16 = (x16[:n, :3] - x3[:n, :3]).abs()
    linf16 = float(d16.max())
    l1_16 = float(d16.sum(dim=0).max())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"],
          f"bf16 PPR outside PRECISION_BOUNDS: linf {linf16} l1 {l1_16}")
    warm_iters = int(iw.max())
    check(warm_iters <= 2, f"warm start took {warm_iters} iterations")
    want_vals, _ = torch.sort(lanes_k, dim=1, descending=True)
    vals_h, idx_h = vals.cpu(), idx.cpu().long()
    check(same_bits(vals_h, want_vals[:, :PPR_TOPK].cpu().contiguous())
          and same_bits(torch.gather(lanes_k.cpu(), 1, idx_h), vals_h),
          "ppr_topk is not the sorted full vector")
    ties = (vals_h[:, 1:] == vals_h[:, :-1])
    check(bool((idx_h[:, 1:] > idx_h[:, :-1])[ties].all()),
          "ppr_topk broke a tie toward the higher index")
    summary = {
        "n_nodes": n, "n_edges": graph.n_edges, "damping": DAMPING,
        "single": {"sources": single_sources.tolist(),
                   "iterations": ITERATIONS, "cold_s": s1,
                   "iteration_ms": s1w / ITERATIONS * 1e3,
                   "max_err_of_largest": rel, "top100": top},
        "batch": {"lanes": PPR_LANES, "tol": PPR_TOL,
                  "iters_min_max": [int(iters.min()), int(iters.max())],
                  "run_s": sb, "sequential_bit_equal": list(seq_lanes),
                  "fixed_iteration_ms": st / ITERATIONS * 1e3,
                  "warm_iters_max": warm_iters,
                  "bf16_vs_f32": {"linf": linf16, "l1": l1_16},
                  "topk": PPR_TOPK, "topk_ties": int(ties.sum()),
                  "topk_dangling_source": dangling},
        "launches": launches, "expected_launches": expected}
    print("ppr", json.dumps(summary), flush=True)
    return launches


def min_index_labels(labels) -> np.ndarray:
    """Each node's label replaced by the minimum node index of its class."""
    n = len(labels)
    mins = np.full(int(labels.max()) + 1, n, dtype=np.int64)
    np.minimum.at(mins, labels, np.arange(n))
    return mins[labels].astype(np.int32)


def dedup_min(src, dst, w):
    """(src, dst, w) with one edge a (src, dst) pair, its least weight:
    a scipy matrix would sum parallel edges."""
    order = np.lexsort((w, dst, src))
    s, d, ww = src[order], dst[order], w[order]
    first = np.ones(len(s), dtype=bool)
    first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
    return s[first], d[first], ww[first]


def phase_traversal(base: dict):
    """WCC, SCC, SSSP, direction-optimizing BFS, multi-source SSSP and
    k-hop on the north star against scipy.sparse.csgraph."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    import torch
    from memgraph_tpu_torch.ops import components as C
    from memgraph_tpu_torch.ops import traversal as T
    from memgraph_tpu_torch.ops.csr import from_coo

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes
    rng = np.random.default_rng(SSSP_SEED)
    weights = rng.uniform(0.5, 1.5, len(src)).astype(np.float32)
    wgraph = from_coo(src, dst, weights, n_nodes=n).to_device("cuda")
    out_deg = np.bincount(src, minlength=n)
    source = int(rng.choice(np.flatnonzero(out_deg > 0)))
    sources = rng.choice(n, MSSP_SOURCES, replace=False)
    scc_stats = {}
    secs = {}

    def call(name, fn):
        out, secs[name] = timed_run(fn)
        return out

    # the traversal path: counts set to 0 just before, read just after
    reset_all_counts()
    T.do_bfs.levels.update(push=0, pull=0)
    comp, wcc_iters = call("wcc", lambda: C.weakly_connected_components(
        graph))
    scc = call("scc", lambda: C.strongly_connected_components(
        graph, stats=scc_stats))
    dist, sssp_iters = call("sssp", lambda: T.sssp(wgraph, source))
    levels, bfs_iters = call("bfs_levels", lambda: T.bfs_levels(
        graph, source))
    mssp = call("multi_source_sssp", lambda: T.multi_source_sssp(
        graph, sources, weighted=False))
    khop = call("khop_neighborhood", lambda: T.khop_neighborhood(
        graph, sources[:4], KHOP_K))
    launches = all_counts()
    bfs_split = dict(T.do_bfs.levels)

    adj = sp.csr_matrix((np.ones(len(src), dtype=np.int8), (src, dst)),
                        shape=(n, n))
    _, weak = csgraph.connected_components(adj, directed=True,
                                           connection="weak")
    check(np.array_equal(comp, min_index_labels(weak)),
          "WCC labels are not scipy's components by their minimum index")
    _, strong = csgraph.connected_components(adj, directed=True,
                                             connection="strong")
    check(np.array_equal(scc, min_index_labels(strong)),
          "SCC labels are not scipy's components by their minimum index")

    s_, d_, w_ = dedup_min(src, dst, weights)
    wadj = sp.csr_matrix((w_.astype(np.float64), (s_, d_)), shape=(n, n))
    ref = csgraph.dijkstra(wadj, indices=source)
    got = dist.double().cpu().numpy()
    reach = np.isfinite(ref)
    check(np.array_equal(np.isfinite(got), reach),
          "SSSP's unreachable set is not Dijkstra's")
    pos = reach & (ref > 0)
    sssp_rel = float((np.abs(got[pos] - ref[pos]) / ref[pos]).max())
    check(sssp_rel <= SSSP_REL_TOL and got[source] == 0.0,
          f"SSSP off Dijkstra by {sssp_rel} > {SSSP_REL_TOL}")

    hops = csgraph.shortest_path(adj, unweighted=True,
                                 indices=np.concatenate([[source], sources]))
    base.setdefault("refs", {}).update(      # the mesh's references too
        weak=weak, source=source, hops=hops[0])
    want_levels = np.where(np.isinf(hops[0]), -1, hops[0]).astype(np.int32)
    check(np.array_equal(levels.cpu().numpy(), want_levels),
          "BFS levels are not the unweighted shortest paths")
    check(bfs_split["push"] > 0 and bfs_split["pull"] > 0,
          f"BFS did not run both push and pull levels: {bfs_split}")
    got_m = mssp.double().cpu().numpy()
    check(got_m.shape == (MSSP_SOURCES, n)
          and np.array_equal(got_m, hops[1:]),
          "multi_source_sssp is not the unweighted shortest paths")
    sym = (adj + adj.T).tocsr()
    near = csgraph.dijkstra(sym, unweighted=True, indices=sources[:4],
                            limit=KHOP_K + 0.5)
    check(np.array_equal(khop.cpu().numpy(), (near <= KHOP_K).any(axis=0)),
          "khop_neighborhood is not the k-hop set")
    summary = {
        "n_nodes": n, "n_edges": graph.n_edges,
        "wcc": {"components": int(weak.max()) + 1, "iterations": wcc_iters},
        "scc": {"components": int(strong.max()) + 1,
                "rounds": scc_stats["rounds"]},
        "sssp": {"source": source, "iterations": sssp_iters,
                 "reached": int(reach.sum()), "max_rel": sssp_rel},
        "bfs": {"iterations": bfs_iters, "levels": bfs_split},
        "multi_source_sssp": {"sources": MSSP_SOURCES},
        "khop": {"k": KHOP_K, "sources": 4, "reached": int(khop.sum())},
        "seconds": secs, "launches": launches}
    print("traversal", json.dumps(summary), flush=True)
    del wgraph
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------------------
# phases 12-14: the snapshot lineage, the procedures on it, label
# propagation and betweenness
# ---------------------------------------------------------------------------

# pagerank.get on v2 (stop_epsilon 1e-5: it stops once an iteration
# moves the ranks by at most that in L1) against a converged float64 run:
# the map contracts by the damping in L1, so the stopping iterate lies
# within tol d / (1 - d) of the fixed point; f32 adds the main path's L1
# bound, and 200 float64 iterations leave 2 d^200
PR_PROC_TOL = 1e-5
PR_PROC_REF_ITERATIONS = 200
PR_PROC_L1 = (PR_PROC_TOL * DAMPING / (1 - DAMPING) + F32_L1_TOL
              + 2 * DAMPING ** PR_PROC_REF_ITERATIONS)
LP_ROUNDS = 30          # the community_detection.get default
LP_CHECKED_ROUND = 3
BC_SAMPLES = 8
BC_SEED = 0
# 64 sampled sources: two chunks of the autotuned B = 46 on the north
# star, the first with every lane a real source.  The procedures phase
# passes the same samples = 64: the registration's default, samples = 0,
# is exact Brandes over all 1,000,000 sources
BC_WIDE_SAMPLES = 64
# f32 Brandes against float64: each score is a sum of per-source quotients
# (1 + delta) / sigma over up to ~20 levels, each carrying a few f32
# roundings (2^-24 relative); 1e-4 of the largest score is ~100x that
BC_REL_TOL = 1e-4
BC_TOPK = 100
# each node's own score: every term of Brandes's sums is positive, so f32
# errs by a relative amount at every node, with no cancellation.  A run
# sum of m positive terms errs by at most (m - 1) 2^-24 relative and in
# practice by ~sqrt(m) 2^-24; runs here reach ~10^4 (node 0's in-run)
# over ~12 levels: ~1e-4 at worst in practice, and 1e-3 leaves 10x.  The
# floor only keeps the quotient away from zero scores
BC_NODE_REL_TOL = 1e-3
BC_NODE_FLOOR = 1e-12
HIT_GETS = 20


def drive_pagerank(graph, precision):
    """(ranks, seconds to the end of the device work) of 50 fixed
    iterations."""
    from memgraph_tpu_torch.ops.pagerank import pagerank
    (ranks, _, iters), secs = timed_run(lambda: pagerank(
        graph, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0,
        precision=precision))
    check(iters == ITERATIONS, f"PageRank ran {iters} iterations, not "
                               f"{ITERATIONS}")
    return ranks, secs


def phase_snapshot(base: dict):
    """v2: a second commit (1,000 edges added, 1,000 removed, seed 13),
    exported by the delta path from v1 and anchored on v0; its PageRank
    plans from v0's base (no build_plan), f32 against float64 with the
    main path's bounds, bf16 within PRECISION_BOUNDS of f32."""
    import torch
    from memgraph_tpu_torch.northstar import N_NODES, second_commit
    from memgraph_tpu_torch.ops.csr import export_csr
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS

    graph, v1 = base["graph"], base["v1"]
    source, cache = base["source"], base["cache"]
    removed, add_src, add_dst = second_commit(source.alive_ids(), N_NODES)
    changed = source.commit(add_src, add_dst, remove=removed)
    v2, export_delta_s, probe = timed_get(cache, source)
    check(cache.counters["export.delta"] == 2
          and [g is v1 for g in probe["delta_from"]] == [True],
          f"v2 did not come by the delta export from v1: {cache.counters}")
    ctx = getattr(v2, "_delta_ctx", None)
    since_v0 = source.changes_between(base["v0_version"], source.version)
    check(ctx is not None and ctx[0] is graph and ctx[1] == since_v0
          and changed <= since_v0,
          "v2's _delta_ctx is not (v0, the gids changed since v0)")
    t0 = time.perf_counter()
    full = export_csr(source, to_device=False)
    export_full_s = time.perf_counter() - t0
    check_same_arrays(v2, full, "v2 (delta export)")
    src2, dst2, _ = full.host_coo
    del full

    # v2's refresh: counts set to 0 just before, read just after
    with counted_plan_builds() as plan_builds:
        reset_all_counts()
        r32, cold32 = drive_pagerank(v2, "f32")
        r16, cold16 = drive_pagerank(v2, "bf16")
        _, warm32 = drive_pagerank(v2, "f32")
        _, warm16 = drive_pagerank(v2, "bf16")
        launches = all_counts()
    check(not plan_builds, f"build_plan ran {len(plan_builds)} time(s) for "
                           "v2")
    state = v2._mxu_state
    check(state.get("delta") is not None and state["base"] is
          graph._mxu_state and state["plan"] is graph._mxu_state["plan"],
          "v2 did not refresh from v0's base plan")
    expected = dict.fromkeys(counts(), 0)
    for run in state["runs"].values():
        for k, v in expected_run_launches(run, 2, placed_base=False).items():
            expected[k] += v
    check({k: launches[k] for k in expected} == expected,
          f"v2 launch counts {launches} != expected {expected}")
    base_warm = {p: drive_pagerank(graph, p)[1] for p in ("f32", "bf16")}

    ref = reference_pagerank(src2, dst2, N_NODES)
    a32 = r32.double().cpu().numpy()
    a16 = r16.double().cpu().numpy()
    check(bool(np.isfinite(a32).all() and np.isfinite(a16).all())
          and a32.shape == a16.shape == (N_NODES,),
          "v2 ranks non-finite or misshaped")
    rel = float((np.abs(a32 - ref) / ref).max())
    l1 = float(np.abs(a32 - ref).sum())
    top = len(set(np.argsort(-a32)[:100]) & set(np.argsort(-ref)[:100]))
    check(rel <= F32_REL_TOL and l1 <= F32_L1_TOL and top == 100,
          f"v2 f32 off the float64 reference: rel {rel} l1 {l1} top {top}")
    bounds = PRECISION_BOUNDS["bf16"]
    linf16 = float(np.abs(a16 - a32).max())
    l1_16 = float(np.abs(a16 - a32).sum())
    check(linf16 <= bounds["pagerank_linf"] and l1_16 <= bounds["pagerank_l1"],
          f"v2 bf16 outside PRECISION_BOUNDS: linf {linf16} l1 {l1_16}")
    first = state["diff_s"] + state["delta_build_s"]
    precisions = {torch.float32: "f32", torch.bfloat16: "bf16"}
    placement = {precisions[dt]: r.placement_s
                 for (_, dt), r in state["runs"].items()}
    base["v2"], base["v2_coo"] = v2, (src2, dst2)
    base["snapshot"]["v2"] = {
        "changed": len(changed), "changed_since_v0": len(since_v0),
        "n_delta": state["delta"].n_delta,
        "export_delta_s": export_delta_s,
        "from_coo_s": probe["from_coo_s"][0],
        "export_full_s": export_full_s,
        "diff_s": state["diff_s"], "delta_build_s": state["delta_build_s"],
        "placement_s": placement,
        "cold_iteration_ms": {
            "f32": (cold32 - first - placement["f32"]) / ITERATIONS * 1e3,
            "bf16": (cold16 - placement["bf16"]) / ITERATIONS * 1e3},
        "iteration_ms": {"f32": warm32 / ITERATIONS * 1e3,
                         "bf16": warm16 / ITERATIONS * 1e3},
        "base_iteration_ms": {p: t / ITERATIONS * 1e3
                              for p, t in base_warm.items()},
        "f32_vs_f64": {"max_rel": rel, "l1": l1, "top100": top},
        "bf16_vs_f32": {"linf": linf16, "l1": l1_16},
        "launches": launches, "build_plan_calls": len(plan_builds)}
    return launches


def procedure_answers(outs: dict, v2, src2, dst2, start_idx: int,
                      kept: dict) -> dict:
    """``pagerank.get``, ``weakly_connected_components.get`` and
    ``bfs.get`` (from ``start_idx``) on snapshot v2, by gid, against a
    converged float64 PageRank and scipy's components and unweighted
    shortest paths on v2's edges (dense ids, as v2 numbers them).  The
    float64 PageRank is kept in ``kept["v2_pagerank64"]`` for a later
    phase."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    n = v2.n_nodes
    gids = np.asarray(v2.node_gids)
    by_gid = np.argsort(gids, kind="stable")

    def dense(out):
        return by_gid[np.searchsorted(gids[by_gid], out["node_gids"])]

    t0 = time.perf_counter()
    pr = outs["pagerank.get"]
    ref = reference_pagerank(src2, dst2, n, iterations=PR_PROC_REF_ITERATIONS)
    kept["v2_pagerank64"] = ref
    pr_l1 = float(np.abs(pr["rank"].astype(np.float64)
                         - ref[dense(pr)]).sum())
    check(pr_l1 <= PR_PROC_L1,
          f"pagerank.get on v2 off float64 by L1 {pr_l1} > {PR_PROC_L1}")
    adj = sp.csr_matrix((np.ones(len(src2), dtype=np.int8), (src2, dst2)),
                        shape=(n, n))
    _, weak = csgraph.connected_components(adj, directed=True,
                                           connection="weak")
    wcc = outs["weakly_connected_components.get"]
    comp = np.empty(n, dtype=np.int64)
    comp[dense(wcc)] = wcc["component_id"]
    check(np.array_equal(min_index_labels(comp), min_index_labels(weak)),
          "weakly_connected_components.get on v2 is not scipy's partition")
    hops = csgraph.shortest_path(adj, unweighted=True, indices=start_idx)
    bfs = outs["bfs.get"]
    at = dense(bfs)
    check(np.array_equal(np.sort(at), np.flatnonzero(np.isfinite(hops)))
          and np.array_equal(bfs["level"].astype(np.float64), hops[at]),
          "bfs.get on v2 is not the unweighted shortest paths")
    checked = {"pagerank.get": {"l1": pr_l1, "limit": PR_PROC_L1},
               "weakly_connected_components.get": {
                   "components": int(weak.max()) + 1, "equal": True},
               "bfs.get": {"reached": len(at), "equal": True},
               "reference_s": time.perf_counter() - t0}
    return checked


def phase_procedures(base: dict):
    """Each procedure counterpart (memgraph_tpu_torch/procedures/
    graph_algorithms.py) called once on v2 through the CooSource on the
    card: each returns host numpy arrays, a row a node it yields.
    ``pagerank.get``, ``weakly_connected_components.get`` and ``bfs.get``
    are held by gid against float64 / scipy on v2's edges."""
    import torch
    from memgraph_tpu_torch.procedures import graph_algorithms as P

    source, cache, v2 = base["source"], base["cache"], base["v2"]
    check(cache.get(source, device="cuda") is v2,
          "the procedures would not run on v2")
    n = v2.n_nodes
    rng = np.random.default_rng(PPR_SEED)
    seeds = [int(g) for g in v2.node_gids[rng.choice(n, 3, replace=False)]]
    start_idx = int(np.argmax(np.diff(v2.row_ptr.cpu().numpy()[:n + 1])))
    start = int(v2.node_gids[start_idx])
    calls = [
        ("pagerank.get", (), {}),
        ("pagerank.personalized", (seeds,), {}),
        # α of the katz phase: the procedure's default 0.2 is past 1/λ
        # on this graph (the series diverges)
        ("katz_centrality.get", (KATZ_ALPHA,), {}),
        ("community_detection.get", (), {}),
        ("weakly_connected_components.get", (), {}),
        ("strongly_connected_components.get", (), {}),
        ("degree_centrality.get", (), {}),
        ("hits.get", (), {}),
        ("betweenness_centrality.get", (),
         {"samples": BC_WIDE_SAMPLES}),
        ("bfs.get", (start,), {}),
        ("sssp.get", (start,), {}),
        ("graph_util.khop", (seeds, KHOP_K), {}),
    ]
    secs, rows, outs = {}, {}, {}
    # the procedures' path: counts set to 0 just before, read just after
    reset_all_counts()
    for name, args, kw in calls:
        out, secs[name] = timed_run(
            lambda: P.PROCEDURES[name](source, *args, cache=cache,
                                       device="cuda", **kw))
        outs[name] = out
        check(isinstance(out, dict) and out
              and all(isinstance(v, np.ndarray) for v in out.values()),
              f"{name} did not return host numpy columns")
        gids = out["node_gids"]
        check(gids.dtype == np.int64
              and all(len(v) == len(gids) for v in out.values()),
              f"{name}'s columns are not a row a node")
        check(all(np.isfinite(v).all() for k, v in out.items()
                  if k != "node_gids" and v.dtype.kind == "f"),
              f"{name} returned values that are not finite")
        rows[name] = len(gids)
    launches = all_counts()
    check(rows["pagerank.get"] == rows["hits.get"] == n
          and 0 < rows["bfs.get"] <= n and 0 < rows["graph_util.khop"] <= n,
          f"procedure rows {rows}")

    checked = procedure_answers(outs, v2, *base.pop("v2_coo"), start_idx,
                                base)
    summary = {"version": base["source"].version, "n_nodes": n,
               "n_edges": v2.n_edges, "seconds": secs, "rows": rows,
               "vs_reference": checked,
               "launches": launches, "cache": dict(cache.counters)}
    print("procedures", json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return launches


def phase_snapshot_log(base: dict):
    """A wrapped change log (one commit more than the log holds, an edge
    each) gives a full export, counted once, with no _delta_ctx; a
    repeated get at one version returns the same object.  Prints the
    ``snapshot`` line."""
    from memgraph_tpu_torch.utils.metrics import global_metrics

    source, cache = base["source"], base["cache"]
    before = dict(cache.counters)
    fallbacks = global_metrics.value("delta.fallback_rebuild_total")
    v_before = source.version
    n = base["graph"].n_nodes
    for i in range(source.log_size + 1):
        source.commit([i], [(7 * i + 1) % n])
    check(not source.changes_between(v_before, source.version),
          "the change log did not wrap")
    wrapped, export_s, probe = timed_get(cache, source)
    fallbacks = global_metrics.value("delta.fallback_rebuild_total") \
        - fallbacks
    check(fallbacks == 1
          and cache.counters["export.full"] == before["export.full"] + 1
          and not probe["delta_from"]
          and getattr(wrapped, "_delta_ctx", None) is None,
          f"a wrapped log did not give one counted full export without a "
          f"_delta_ctx: {before} -> {cache.counters}, {fallbacks} "
          f"fallback rebuilds")
    hits_us = []
    for _ in range(HIT_GETS):
        t0 = time.perf_counter()
        again = cache.get(source, device="cuda")
        hits_us.append((time.perf_counter() - t0) * 1e6)
        check(again is wrapped, "a repeated get returned another snapshot")
    snap = base["snapshot"]
    summary = {
        "v0": {"export_s": base["summary"]["export_s"],
               "from_coo_s": base["summary"]["from_coo_s"],
               "iteration_ms": base["summary"]["iteration_ms"]},
        **snap,
        "wrapped": {"commits": source.log_size + 1, "export_s": export_s,
                    "from_coo_s": probe["from_coo_s"][0],
                    "n_edges": wrapped.n_edges},
        "get_hit_us": {"median": float(np.median(hits_us)),
                       "min": float(min(hits_us))},
        "counters": {**cache.counters,
                     "delta.fallback_rebuild_total": fallbacks}}
    print("snapshot", json.dumps(summary), flush=True)
    del base["v1"], base["v2"]


def election64(src, dst, n, labels, self_weight=0.0):
    """One label-propagation election in numpy (ops/labelprop.py's rules)
    over the undirected view of the true edges, unit weights summed in
    float64: the run weight of each (node, neighbor label), each node's
    best weight, the least label of that weight, and the own label where
    it weighs as much or there is no neighbor."""
    s2 = np.concatenate([src, dst]).astype(np.int64)
    d2 = np.concatenate([dst, src]).astype(np.int64)
    lab = labels[s2].astype(np.int64)
    order = np.argsort(d2 * n + lab, kind="stable")
    d_s, l_s = d2[order], lab[order]
    first = np.ones(len(d_s), dtype=bool)
    first[1:] = (d_s[1:] != d_s[:-1]) | (l_s[1:] != l_s[:-1])
    starts = np.flatnonzero(first)
    run_w = np.add.reduceat(np.ones(len(d_s)), starts)
    run_d, run_l = d_s[starts], l_s[starts]
    nfirst = np.ones(len(run_d), dtype=bool)
    nfirst[1:] = run_d[1:] != run_d[:-1]
    nstarts = np.flatnonzero(nfirst)
    best_w = np.full(n, -np.inf)
    best_w[run_d[nstarts]] = np.maximum.reduceat(run_w, nstarts)
    cand = np.where(run_w >= best_w[run_d] - 1e-12, run_l, n)
    best_l = np.full(n, n, dtype=np.int64)
    best_l[run_d[nstarts]] = np.minimum.reduceat(cand, nstarts)
    own = ((best_l >= n) | (self_weight >= best_w)
           | (np.isclose(self_weight, best_w) & (labels <= best_l)))
    return np.where(own, labels, best_l).astype(np.int32)


def labelprop64(src, dst, n, rounds):
    """(labels, rounds run) of label propagation in numpy, round by
    round: ``election64`` from every node its own label, until no label
    changes or ``rounds``."""
    labels = np.arange(n, dtype=np.int32)
    for it in range(1, rounds + 1):
        new = election64(src, dst, n, labels)
        if np.array_equal(new, labels):
            return new, it
        labels = new
    return labels, rounds


def phase_labelprop(base: dict):
    """Label propagation (undirected, 30 rounds at most) on the north
    star: two runs bit-equal with equal rounds, the card's labels after
    round k equal to one numpy election of its labels after round k - 1
    (k = 3 and the last round); on the segment graph equal to a numpy
    run of every round; the directed mode once.  One K1 launch a
    round; the launches of the first and the last round held bit-equal to
    the plain version on the same inputs (``segment_kernels`` lines
    ``labelprop_round1`` / ``labelprop_last_round``)."""
    import torch
    from memgraph_tpu_torch.northstar import generate_graph
    from memgraph_tpu_torch.ops import semiring
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.ops.labelprop import label_propagation

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes

    def lp(g, rounds=LP_ROUNDS, directed=False):
        return timed_run(lambda: label_propagation(
            g, max_iterations=rounds, directed=directed))

    def first_and_last(x, ptr, g, w, kw):
        first_and_last.calls += 1
        return "round1" if first_and_last.calls == 1 else "last_round"

    first_and_last.calls = 0
    # the labelprop path: counts set to 0 just before, read just after;
    # the run-weight sums of its first and last rounds kept
    reset_all_counts()
    with k1_recorded(semiring, first_and_last) as k1_calls:
        (labels, rounds), secs = lp(graph)
    launches = all_counts()
    check(launches["csr_spmm_sum"] == rounds
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"labelprop launches {launches} over {rounds} rounds")
    check(set(k1_calls) == ({"round1", "last_round"} if rounds > 1
                            else {"round1"}),
          f"labelprop's run sums were not recorded: {sorted(k1_calls)}")
    k1_lines = path_k1_lines(k1_calls, "labelprop")
    del k1_calls
    (again, rounds2), secs2 = lp(graph)
    check(rounds2 == rounds and np.array_equal(again, labels),
          "two labelprop runs are not bit-equal")
    check(labels.dtype == np.int32 and labels.shape == (n,)
          and 0 <= labels.min() and labels.max() < n,
          "labelprop labels misshaped or out of range")
    elections = {}
    for k in sorted({LP_CHECKED_ROUND, rounds}):
        before, _ = label_propagation(graph, max_iterations=k - 1)
        after = labels if k == rounds else label_propagation(
            graph, max_iterations=k)[0]
        t0 = time.perf_counter()
        want = election64(src, dst, n, before)
        elections[k] = time.perf_counter() - t0
        check(np.array_equal(after, want),
              f"labelprop round {k} is not the float64 election of round "
              f"{k - 1}: {int((after != want).sum())} labels differ")
    (dlabels, drounds), dsecs = lp(graph, directed=True)
    check(dlabels.shape == (n,) and 0 < drounds <= LP_ROUNDS,
          "directed labelprop misshaped")

    ssrc, sdst = generate_graph(n_nodes=SEGMENT_NODES,
                                n_edges=SEGMENT_EDGES)
    sg = from_coo(ssrc, sdst, n_nodes=SEGMENT_NODES).to_device("cuda")
    (slabels, srounds), ssecs = lp(sg)
    want, wrounds = labelprop64(ssrc, sdst, SEGMENT_NODES, LP_ROUNDS)
    check(srounds == wrounds and np.array_equal(slabels, want),
          f"segment-graph labelprop differs from numpy's every round: "
          f"{srounds} / {wrounds} rounds, "
          f"{int((slabels != want).sum())} labels")
    summary = {
        "north_star": {"rounds": rounds, "seconds": [secs, secs2],
                       "ms_a_round": secs2 / rounds * 1e3,
                       "communities": int(len(np.unique(labels))),
                       "checked_rounds": sorted(elections),
                       "election64_s": elections},
        "directed": {"rounds": drounds, "seconds": dsecs,
                     "ms_a_round": dsecs / drounds * 1e3,
                     "communities": int(len(np.unique(dlabels)))},
        "segment": {"n_nodes": SEGMENT_NODES, "n_edges": SEGMENT_EDGES,
                    "rounds": srounds, "seconds": ssecs,
                    "ms_a_round": ssecs / srounds * 1e3,
                    "communities": int(len(np.unique(slabels))),
                    "equal_to_numpy": True},
        "k1_at_the_path": {ln["runs"]: {k: ln[k] for k in (
            "n_seg", "n_edges", "longest_run", "ms", "bound_ms")}
            for ln in k1_lines},
        "launches": launches}
    print("labelprop", json.dumps(summary), flush=True)
    base["path_k1_lines"] += k1_lines
    del sg
    torch.cuda.empty_cache()
    return launches


def dedup_pairs(src, dst, n, directed):
    """The simple graph Brandes counts paths on: no self-loops, parallel
    edges once (a scipy boolean matrix sums them away), undirected pairs
    both ways."""
    import scipy.sparse as sp
    keep = src != dst
    s, d = src[keep], dst[keep]
    if not directed:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    adj = sp.coo_matrix((np.ones(len(s), dtype=bool), (s, d)),
                        shape=(n, n)).tocsr()
    return adj.nonzero()


def reference_brandes(src, dst, n, sources, directed):
    """float64 Brandes over ``sources``, on the card in plain torch
    (independent of ops/betweenness.py): a level-synchronous BFS from
    each source over the simple graph (``dedup_pairs``), its shortest-
    path DAG, the path counts sigma level by level up and the
    dependencies level by level down (float64 ``index_add_``: sigma is an
    integer count, exact below 2^53; a dependency's rounding is ~1e-16
    relative), a source's dependencies added in source order; scaled by
    n / k, halved when undirected and normalized as ops/betweenness.py
    does."""
    import torch
    s_np, d_np = dedup_pairs(src, dst, n, directed)
    s = torch.from_numpy(s_np.astype(np.int64)).cuda()
    d = torch.from_numpy(d_np.astype(np.int64)).cuda()

    def dependencies(root):
        dist = torch.full((n,), -1, dtype=torch.int64, device="cuda")
        dist[root] = 0
        frontier = torch.zeros(n, dtype=torch.bool, device="cuda")
        frontier[root] = True
        level = 0
        while True:
            nb = d[frontier[s]]
            nb = nb[dist[nb] < 0]
            if nb.numel() == 0:
                break
            level += 1
            dist[nb] = level
            frontier.zero_()
            frontier[nb] = True
        du = dist[s]
        dag = (du >= 0) & (dist[d] == du + 1)
        es, ed, lv = s[dag], d[dag], du[dag]
        sigma = torch.zeros(n, dtype=torch.float64, device="cuda")
        sigma[root] = 1.0
        by_level = [lv == L for L in range(level)]
        for sel in by_level:
            sigma.index_add_(0, ed[sel], sigma[es[sel]])
        delta = torch.zeros(n, dtype=torch.float64, device="cuda")
        for sel in reversed(by_level):
            a, b = es[sel], ed[sel]
            delta.index_add_(0, a, sigma[a] / sigma[b] * (1.0 + delta[b]))
        delta[root] = 0.0
        return delta

    bc = torch.zeros(n, dtype=torch.float64, device="cuda")
    for root in sources:
        bc += dependencies(int(root))
    bc = bc.cpu().numpy()
    del s, d
    torch.cuda.empty_cache()
    bc *= n / len(sources)
    if not directed:
        bc /= 2.0
    return bc / ((n - 1) * (n - 2) / (1.0 if directed else 2.0))


def top_overlap(got, ref, k, tol):
    """(the overlap of the top-k sets, the top k of ``got`` whose
    reference score is within ``tol`` of the reference's k-th or above:
    a tie at the k-th place within the tolerance orders either way)."""
    g_top = np.argsort(-got, kind="stable")[:k]
    r_top = np.argsort(-ref, kind="stable")[:k]
    kth = ref[r_top[-1]]
    return (len(set(g_top) & set(r_top)),
            int((ref[g_top] >= kth - tol).sum()))


def widest_first_chunk():
    """A ``k1_recorded`` choice for one betweenness call: of its first
    chunk, the forward call (the first ptr seen) and the backward call
    whose x holds the most nonzero values (the widest level)."""
    seen = {"forward_ptr": None, "backward": False, "nnz": {}}

    def keep(x, ptr, g, w, kw):
        if seen["forward_ptr"] is None:
            seen["forward_ptr"] = ptr
        forward = ptr is seen["forward_ptr"]
        if not forward:
            seen["backward"] = True
        elif seen["backward"]:
            return None             # the next chunk's forward sweep
        key = "forward" if forward else "backward"
        nnz = int(x.count_nonzero())
        if nnz <= seen["nnz"].get(key, -1):
            return None
        seen["nnz"][key] = nnz
        return key

    return keep


def vs_brandes(got, ref) -> dict:
    """The card's scores against float64 Brandes: the largest error
    against the largest score, the top 100, and the relative error of
    every node scored above ``BC_NODE_FLOOR`` of the largest."""
    top = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    overlap, within = top_overlap(got, ref, BC_TOPK, BC_REL_TOL * top)
    scored = ref > BC_NODE_FLOOR * top
    node_rel = float((np.abs(got[scored] - ref[scored])
                      / ref[scored]).max(initial=0.0))
    return {"max_abs_err": err, "largest": top, "rel_to_largest": err / top,
            f"top{BC_TOPK}_sets": overlap, f"top{BC_TOPK}_within_tol": within,
            "nodes_scored": int(scored.sum()), "node_max_rel": node_rel,
            "ok": bool(np.isfinite(got).all() and err <= BC_REL_TOL * top
                       and within == BC_TOPK
                       and node_rel <= BC_NODE_REL_TOL)}


def phase_betweenness(base: dict):
    """Betweenness on the north star: 8 sampled sources (seed 0),
    directed and undirected, and 64 directed (two chunks of B = 46, the
    first all real sources) against float64 Brandes over the same
    sources: max error 1e-4 of the largest score, the top 100, and each
    node's relative error; the 64-source run twice, bit-equal.  K1
    launches: two a level a chunk.  In the second 64-source run the
    first chunk's widest forward and backward launches are kept and held
    bit-equal to the plain version on the same inputs
    (``segment_kernels`` lines ``betweenness_forward`` /
    ``betweenness_backward``: B = 46, a last lane tile of 6)."""
    import torch
    from memgraph_tpu_torch.ops import betweenness as BT

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes
    stats, lines = [], {}

    def bc(directed, samples):
        st = {}
        out, secs = timed_run(lambda: BT.betweenness_centrality(
            graph, directed=directed, samples=samples, seed=BC_SEED,
            stats=st))
        stats.append(st)
        return out, secs, st

    # the betweenness path: counts set to 0 just before, read just after
    reset_all_counts()
    runs = {"directed_8": bc(True, BC_SAMPLES),
            "undirected_8": bc(False, BC_SAMPLES),
            "directed_64": bc(True, BC_WIDE_SAMPLES)}
    with k1_recorded(BT, widest_first_chunk()) as k1_calls:
        runs["directed_64_again"] = bc(True, BC_WIDE_SAMPLES)
    launches = all_counts()
    levels = sum(sum(st["levels"]) for st in stats)
    check(launches["csr_spmm_sum"] == 2 * levels
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"betweenness launches {launches} against {levels} levels")
    check(same_bits(runs["directed_64"][0], runs["directed_64_again"][0]),
          "two betweenness runs of 64 sources are not bit-equal")
    chunk = runs["directed_64"][2]["chunk"]
    check(set(k1_calls) == {"forward", "backward"}
          and all(c["x"].shape == (graph.n_pad, chunk)
                  for c in k1_calls.values()),
          f"betweenness's K1 launches were not recorded: {sorted(k1_calls)}")
    k1_lines = path_k1_lines(k1_calls, "betweenness")
    del k1_calls
    for name, directed, samples in (
            ("directed_8", True, BC_SAMPLES),
            ("undirected_8", False, BC_SAMPLES),
            ("directed_64", True, BC_WIDE_SAMPLES)):
        sources = np.random.default_rng(BC_SEED).choice(n, samples,
                                                         replace=False)
        got = runs[name][0].double().cpu().numpy()
        t0 = time.perf_counter()
        line = vs_brandes(got, reference_brandes(src, dst, n, sources,
                                                 directed))
        line["reference_s"] = time.perf_counter() - t0
        check(got.shape == (n,) and line.pop("ok"),
              f"{name} betweenness off float64: {line}")
        lines[name] = line
    summary = {
        "samples": {"checked": BC_SAMPLES, "wide": BC_WIDE_SAMPLES},
        "chunk": {k: st["chunk"] for k, (_, _, st) in runs.items()},
        "levels": {k: st["levels"] for k, (_, _, st) in runs.items()},
        "seconds": {k: secs for k, (_, secs, _) in runs.items()},
        "recorded": "directed_64_again",
        "vs_float64": lines, "reruns_bit_equal": True,
        "k1_at_the_path": {ln["runs"]: {k: ln[k] for k in (
            "lanes", "n_seg", "n_edges", "longest_run", "ms", "bound_ms")}
            for ln in k1_lines},
        "launches": launches, "levels_walked": levels}
    print("betweenness", json.dumps(summary), flush=True)
    base["path_k1_lines"] += k1_lines
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the dense paths: GraphSAGE inference, kNN, k-means, IVF, node similarity
# and their procedures
# ---------------------------------------------------------------------------

EMBEDDING = "embedding"     # the CooSource's vector property (northstar)
GNN_SEED = 0
GNN_HIDDEN, GNN_OUT, GNN_LAYERS = 64, 32, 2   # the procedures' defaults
GNN_WIDTHS = (16, 128)      # degree features; the embedding property
# h against a float64 forward with the same parameters, as a share of the
# largest |h|: each layer rounds h, the aggregate and the weights to
# bfloat16 (2^-9 relative) before its products and their sum after them;
# a CPU run on a 1M-edge graph of the same family measured 0.0059-0.0075
# (3-4 such roundings); budgeted 8
GNN_REL_TOL = 8 * 2.0 ** -9
KNN_SEED = 29
KNN_FREED = 0.01            # the share of corpus rows freed in valid_mask
KNN_BATCHES = (1, 100)
KNN_KS = (10, 100)
KNN_CHECKED = 8             # queries held to float64 / the CPU copies
# bf16 scores on the card against the same function on CPU copies: the
# same bf16-rounded operands, f32 sums in another order (128 products)
KNN_BF16_TOL = 1e-5
KMEANS_CLUSTERS = 64
KMEANS_ITERS = 10
IVF_CELLS = 1024
IVF_PROBES = 8
IVF_K = 10
SIM_NODES, SIM_EDGES = 8192, 81920
SIM_PAIRS = 1000
RECOMMEND_CANDIDATES = 1000


def gnn_reference(src, dst, n, feats, model):
    """The float64 forward of ``model`` on the n true nodes (plain torch
    on the card): the undirected mean over parallel edges counted each,
    no rounding."""
    import torch
    s, d = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
    ones = torch.ones(len(src), dtype=torch.float64, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # torch's sparse notices
        into = torch.sparse_coo_tensor(torch.stack([d, s]), ones,
                                       (n, n)).coalesce()
        out = torch.sparse_coo_tensor(torch.stack([s, d]), ones,
                                      (n, n)).coalesce()
    deg = torch.clamp(torch.bincount(s, minlength=n)
                      + torch.bincount(d, minlength=n), min=1).double()
    h = torch.from_numpy(np.asarray(feats, dtype=np.float64)).cuda()
    layers = len(model.w_self)
    for k in range(layers):
        agg = (torch.sparse.mm(into, h) + torch.sparse.mm(out, h)) \
            / deg[:, None]
        h = (h @ model.w_self[k].double() + agg @ model.w_neigh[k].double()
             + model.b[k].double())
        if k < layers - 1:
            h = torch.relu(h)
    return h.cpu().numpy()


def phase_gnn(base: dict):
    """GraphSAGE inference on the north star (v0) at the procedures'
    defaults (hidden 64, out 32, 2 layers, Glorot parameters from seed 0)
    on degree features (16 wide) and on the 128-wide embedding property.
    Counts set to 0 just before the two forwards, read just after: K1
    gathered, ⊗ = first, over the CSC and the CSR runs, at 16 / 128 and
    64 lanes; each kept launch held bit-equal to its plain version on CPU
    copies and timed (``segment_kernels`` lines ``gnn_*``); the whole
    aggregation bit-equal to its plain version on CPU copies at each
    width; the forward twice bit-equal; h against a float64 forward
    within ``GNN_REL_TOL`` of the largest |h|."""
    import torch
    from memgraph_tpu_torch.ops import gnn as G

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n = graph.n_nodes
    points = base["corpus"][0]
    feats = {16: G.degree_features(graph)}
    wide = torch.zeros(graph.n_pad, points.shape[1], device="cuda")
    wide[:n] = torch.from_numpy(points).cuda()
    feats[128] = wide
    models = {w: G.init_sage_params(
        w, GNN_HIDDEN, GNN_OUT, GNN_LAYERS,
        generator=torch.Generator().manual_seed(GNN_SEED), device="cuda")
        for w in feats}

    def keep(x, ptr, g, w, kw):
        runs = "csc" if g is graph.csc_src else "csr"
        return f"{runs}_B{x.shape[1]}"

    # the GNN path: counts set to 0 just before, read just after
    h, cold = {}, {}
    reset_all_counts()
    with k1_recorded(G, keep) as calls:
        for w in GNN_WIDTHS:
            h[w], cold[w] = timed_run(
                lambda: G.sage_forward(models[w], feats[w], graph))
    launches = all_counts()
    want = len(GNN_WIDTHS) * GNN_LAYERS * 2
    check(launches["csr_spmm_sum"] == want
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"GNN launches {launches}, not {want} K1 launches")
    check(set(calls) == {f"{r}_B{b}" for r in ("csc", "csr")
                         for b in (16, 64, 128)},
          f"the GNN path's K1 calls were not recorded: {sorted(calls)}")
    warm, out = {}, {}
    for w in GNN_WIDTHS:
        again, warm[w] = timed_run(
            lambda: G.sage_forward(models[w], feats[w], graph))
        check(same_bits(again, h[w]), f"two {w}-wide forwards differ")
    cpu_graph = graph.to_device("cpu")
    for lanes in (16, 64, 128):
        x = calls[f"csc_B{lanes}"]["x"]
        check(same_bits(G._mean_aggregate(x, graph).cpu(),
                        G._mean_aggregate(x.cpu(), cpu_graph)),
              f"the {lanes}-wide aggregation is not its plain version's "
              f"bits")
    del cpu_graph
    k1_lines = path_k1_lines(calls, "gnn", n_in=graph.n_pad)
    del calls
    for w in GNN_WIDTHS:
        t0 = time.perf_counter()
        ref = gnn_reference(src, dst, n, feats[w][:n].cpu().numpy(),
                            models[w])
        got = h[w][:n].double().cpu().numpy()
        check(bool(np.isfinite(got).all())
              and got.shape == (n, GNN_OUT), f"{w}-wide h non-finite")
        top = float(np.abs(ref).max())
        err = float(np.abs(got - ref).max()) / top
        rounding = float(np.abs(torch.from_numpy(ref).to(
            torch.bfloat16).double().numpy() - ref).max()) / top
        check(err <= GNN_REL_TOL,
              f"{w}-wide h off float64 by {err} of the largest |h|")
        out[w] = {"cold_s": cold[w], "forward_ms": warm[w] * 1e3,
                  "err_over_largest": err,
                  "bf16_rounding_over_largest": rounding,
                  "limit": GNN_REL_TOL, "largest": top,
                  "reference_s": time.perf_counter() - t0}
    summary = {"n_nodes": n, "n_edges": graph.n_edges,
               "layers": GNN_LAYERS, "hidden": GNN_HIDDEN, "out": GNN_OUT,
               "by_width": out,
               "k1_at_the_path": {ln["runs"]: {k: ln[k] for k in (
                   "lanes", "n_seg", "longest_run", "ms", "bound_ms",
                   "plain_ms", "library_ms")} for ln in k1_lines},
               "launches": launches}
    print("gnn", json.dumps(summary), flush=True)
    base["path_k1_lines"] += k1_lines
    torch.cuda.empty_cache()
    return launches


def phase_dense_procedures(base: dict):
    """The dense paths' procedure counterparts once each on v2 through the
    CooSource, counts set to 0 just before and read just after:
    ``link_prediction.predict`` (1 pair) and ``recommend`` (1,000
    candidates) on degree features, ``node_classification.predict`` on
    the embedding property, parameters from seed 0 bound by
    ``load_parameters``; ``vector_search.search``, ``knn.get``,
    ``ppr_search`` and ``kmeans.get_clusters`` (64 clusters) over the
    embedding index; seconds a call.  The answers are held to the slot's
    embeddings (a fresh forward, bit-equal), the search's own row first,
    ``knn.get`` equal to the search's next ten, and
    ``node_similarity.jaccard`` on v2 (1M nodes) refused."""
    import torch
    from memgraph_tpu_torch.ops import gnn as G
    from memgraph_tpu_torch.procedures import ProcedureError
    from memgraph_tpu_torch.procedures import ml_modules as ML
    from memgraph_tpu_torch.procedures import structure_modules as SM
    from memgraph_tpu_torch.procedures import utility_modules as UM
    from memgraph_tpu_torch.procedures import vector_search as VS

    source, cache, v2 = base["source"], base["cache"], base["v2"]
    check(cache.get(source, device="cuda") is v2,
          "the dense procedures would not run on v2")
    n = v2.n_nodes
    gids = np.asarray(v2.node_gids)
    points = base["corpus"][0]
    rng = np.random.default_rng(KNN_SEED)
    a, b = (int(i) for i in rng.choice(n, 2, replace=False))
    cands = gids[rng.choice(n, RECOMMEND_CANDIDATES, replace=False)]
    n_classes = int(np.max(source.vertex_property("label", gids))) + 1
    models, index_cache = ML.ModelRegistry(), VS.IndexCache()

    def params(width, out):
        return G.init_sage_params(
            width, GNN_HIDDEN, out, GNN_LAYERS,
            generator=torch.Generator().manual_seed(GNN_SEED), device="cuda")

    query = points[a].tolist()
    kw = {"device": "cuda"}
    calls = [
        ("link_prediction.load_parameters", lambda: ML.load_parameters(
            source, "link_prediction", params(16, GNN_OUT), models=models,
            cache=cache, **kw)),
        ("link_prediction.predict", lambda: ML.link_prediction_predict(
            source, int(gids[a]), int(gids[b]), models=models, cache=cache,
            **kw)),
        ("link_prediction.recommend", lambda: ML.link_prediction_recommend(
            source, int(gids[a]), cands.tolist(), 10, models=models,
            cache=cache, **kw)),
        ("node_classification.set_model_parameters",
         lambda: ML.set_model_parameters(
             source, "node_classification",
             {"node_features_property": EMBEDDING}, models=models)),
        ("node_classification.load_parameters", lambda: ML.load_parameters(
            source, "node_classification", params(points.shape[1],
                                                  n_classes),
            models=models, cache=cache, **kw)),
        ("node_classification.predict",
         lambda: ML.node_classification_predict(
             source, int(gids[a]), models=models, cache=cache, **kw)),
        ("vector_search.search", lambda: VS.search(
            source, EMBEDDING, query, 11, index_cache=index_cache, **kw)),
        ("knn.get", lambda: VS.knn_get(
            source, int(gids[a]), EMBEDDING, 10, index_cache=index_cache,
            **kw)),
        ("vector_search.ppr_search", lambda: VS.ppr_search(
            source, EMBEDDING, query, 5, 10, cache=cache,
            index_cache=index_cache, **kw)),
        ("kmeans.get_clusters", lambda: UM.kmeans_get_clusters(
            source, EMBEDDING, KMEANS_CLUSTERS, index_cache=index_cache,
            **kw)),
    ]
    secs, outs = {}, {}
    # the dense procedures' path: counts set to 0 just before, read just
    # after
    reset_all_counts()
    for name, fn in calls:
        outs[name], secs[name] = timed_run(fn)
    launches = all_counts()

    lp = models.slot(source, "link_prediction")
    nc = models.slot(source, "node_classification")
    for slot, what in ((lp, "link_prediction"), (nc, "node_classification")):
        check(slot.graph is v2 and same_bits(
            slot.emb, G.sage_forward(slot.params, slot.feats, v2)),
            f"{what}'s embeddings are not a fresh forward's bits on v2")
    emb = lp.emb.double().cpu().numpy()

    def sigmoid_dot(i, j):
        return 1.0 / (1.0 + np.exp(-float(emb[i] @ emb[j])))

    score = outs["link_prediction.predict"]["score"]
    check(score.shape == (1,) and 0.0 <= score[0] <= 1.0
          and abs(score[0] - sigmoid_dot(a, b)) <= 1e-5,
          f"link_prediction.predict {score} is not its embeddings' score")
    rec = outs["link_prediction.recommend"]
    idx = [v2.gid_to_idx[int(g)] for g in rec["node_gids"]]
    best = np.sort([sigmoid_dot(a, v2.gid_to_idx[int(g)])
                    for g in cands])[::-1][:10]
    check(len(idx) == 10 and set(rec["node_gids"]) <= set(cands.tolist())
          and bool((np.diff(rec["score"]) <= 0).all())
          and np.abs(rec["score"] - best).max() <= 1e-5,
          "link_prediction.recommend is not the best ten of its "
          "candidates")
    cls = outs["node_classification.predict"]["predicted_class"]
    check(cls.tolist() == [int(torch.argmax(nc.emb[a]))]
          and 0 <= cls[0] < n_classes,
          f"node_classification.predict {cls} is not its logits' argmax")
    found = outs["vector_search.search"]
    near = outs["knn.get"]
    check(len(found["node_gids"]) == 11 and found["node_gids"][0] == gids[a]
          and near["node_gids"].tolist() == found["node_gids"][1:].tolist()
          and np.array_equal(near["similarity"], found["similarity"][1:]),
          "vector_search.search / knn.get: not the query's row, then "
          "the same ten")
    ppr = outs["vector_search.ppr_search"]
    check(0 < len(ppr["node_gids"]) <= 10
          and bool((ppr["score"] > 0).all())
          and bool((np.diff(ppr["score"]) <= 0).all()),
          "vector_search.ppr_search's ranks are not positive, descending")
    clusters = outs["kmeans.get_clusters"]
    check(len(clusters["node_gids"]) == n
          and 0 <= clusters["cluster_id"].min()
          and clusters["cluster_id"].max() < KMEANS_CLUSTERS,
          "kmeans.get_clusters misshaped")
    try:
        SM.node_similarity_all(source, "jaccard", cache=cache, **kw)
        refused = False
    except ProcedureError:
        refused = True
    check(refused, "node_similarity.jaccard on v2 was not refused")
    summary = {"version": source.version, "n_nodes": n,
               "seconds": secs,
               "rows": {k: len(v["node_gids"]) for k, v in outs.items()
                        if isinstance(v, dict) and "node_gids" in v},
               "index_builds": index_cache.counters["full_builds"],
               "launches": launches}
    print("dense_procedures", json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return launches


def knn64(points64, valid, queries, k, metric):
    """The float64 top k of each query (ties to the lower index) over the
    valid rows: (indices (q, k), float64 scores of every row)."""
    x, q = points64, queries.astype(np.float64)
    if metric == "cosine":
        x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    s = q @ x.T
    if metric == "l2sq":
        s = 2.0 * s - np.sum(points64 ** 2, axis=1)[None, :]
    s[:, valid <= 0] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k], s


def vs_knn64(idx, ref, s64, tol) -> int:
    """The positions where the card's top k is not float64's: each must
    hold a near tie (float64 scores within ``tol``); their count."""
    swaps = 0
    for row in range(len(idx)):
        for got, want in zip(idx[row], ref[row]):
            if got != want:
                swaps += 1
                check(abs(s64[row, got] - s64[row, want]) <= tol,
                      f"kNN row {row}: {got} in place of {want}, float64 "
                      f"{s64[row, got]} vs {s64[row, want]}")
    return swaps


def phase_knn(base: dict):
    """Brute-force kNN on the 1M x 128 corpus with 1% of its rows freed in
    ``valid_mask``: l2sq and cosine, f32 and bf16, 1 and 100 queries, k =
    10 and 100, ms a query batch.  f32: 8 queries against a float64
    top-k, indices and order (a swap only between float64 near-ties);
    bf16: 8 queries against the same function on CPU copies (scores
    within ``KNN_BF16_TOL`` of the largest, recall stated); a query of a
    duplicated row ties to the lower indices, and k above the live rows
    fills with the lowest masked rows."""
    import torch
    from memgraph_tpu_torch.ops import knn as K

    points = base["corpus"][0]
    n, d = points.shape
    corpus = torch.from_numpy(points).cuda()
    rng = np.random.default_rng(KNN_SEED)
    valid = (rng.random(n) >= KNN_FREED).astype(np.float32)
    mask = torch.from_numpy(valid).cuda()
    queries_np = (points[rng.choice(n, max(KNN_BATCHES), replace=False)]
                  + rng.standard_normal((max(KNN_BATCHES), d),
                                        dtype=np.float32) * 0.5)
    queries = torch.from_numpy(queries_np).cuda()
    reset_all_counts()
    lines, results = [], {}
    for metric in ("l2sq", "cosine"):
        for use_bf16 in (False, True):
            for q in KNN_BATCHES:
                for k in KNN_KS:
                    def fn():
                        return K.knn(corpus, queries[:q], k, metric,
                                     use_bf16, valid_mask=mask)
                    out, cold = timed_run(fn)
                    results[(metric, use_bf16, q, k)] = out
                    ms = min(timed_run(fn)[1] for _ in range(3)) * 1e3
                    lines.append({"metric": metric,
                                  "precision": "bf16" if use_bf16 else "f32",
                                  "queries": q, "k": k, "ms": ms,
                                  "cold_ms": cold * 1e3})
    launches = all_counts()
    points64 = points.astype(np.float64)
    checked = {}
    k = max(KNN_KS)
    for metric in ("l2sq", "cosine"):
        s32, i32 = results[(metric, False, max(KNN_BATCHES), k)]
        ref, s64 = knn64(points64, valid, queries_np[:KNN_CHECKED], k,
                         metric)
        idx = i32[:KNN_CHECKED].cpu().numpy()
        check(bool(valid[idx].all()), f"{metric} kNN returned a freed row")
        # f32's error in a score: a 128-term dot and |x|^2 at these
        # magnitudes, 2^-24 relative a term; budgeted 64 ulps of the
        # largest term
        mag = (2 * np.linalg.norm(queries_np[:KNN_CHECKED], axis=1).max()
               * np.linalg.norm(points, axis=1).max()
               + (points ** 2).sum(1).max()) if metric == "l2sq" else 1.0
        tol = 64 * 2.0 ** -24 * float(mag)
        swaps = vs_knn64(idx, ref, s64, tol)
        sb, ib = results[(metric, True, max(KNN_BATCHES), k)]
        cs, ci = K.knn(corpus.cpu(), queries[:KNN_CHECKED].cpu(), k, metric,
                       True, valid_mask=mask.cpu())
        top = float(cs.abs().max())
        berr = float((sb[:KNN_CHECKED].cpu() - cs).abs().max())
        check(berr <= KNN_BF16_TOL * top,
              f"{metric} bf16 scores off the CPU copies' by {berr}")
        recall = float(np.mean([
            len(set(a) & set(b)) / k for a, b in zip(
                ib[:KNN_CHECKED].cpu().numpy(), ci.numpy())]))
        recall64 = float(np.mean([
            len(set(a) & set(b)) / k for a, b in zip(
                ib[:KNN_CHECKED].cpu().numpy(), ref)]))
        checked[metric] = {"f32_vs_f64_swaps": swaps, "f32_tol": tol,
                           "bf16_vs_cpu_err": berr, "bf16_vs_cpu_limit":
                           KNN_BF16_TOL * top, "bf16_recall_vs_cpu": recall,
                           "bf16_recall_vs_f64": recall64}
    # ties: a row copied to three later rows, queried; k above the live
    # rows
    rows = np.sort(rng.choice(n, 4, replace=False))
    dup = corpus.clone()
    dup[torch.from_numpy(rows[1:]).cuda()] = dup[int(rows[0])].clone()
    for metric in ("l2sq", "cosine"):
        for use_bf16 in (False, True):
            s, i = K.knn(dup, dup[int(rows[2]):int(rows[2]) + 1], 8, metric,
                         use_bf16)
            check(i[0, :4].tolist() == rows.tolist()
                  and len(set(s[0, :4].tolist())) == 1,
                  f"a duplicated row's ties ({metric}, bf16={use_bf16}) are "
                  f"not in index order: {i[0, :4].tolist()} vs "
                  f"{rows.tolist()}")
    del dup
    few = torch.zeros(n, device="cuda")
    few[torch.from_numpy(rows[:3]).cuda()] = 1.0
    _, i = K.knn(corpus, queries[:2], 10, "l2sq", False, valid_mask=few)
    masked = [j for j in range(10) if j not in rows[:3]][:7]
    check(all(sorted(r[:3]) == rows[:3].tolist() and r[3:] == masked
              for r in i.tolist()),
          f"k above the live rows: {i.tolist()}")
    summary = {"n": n, "dim": d, "freed": int((valid == 0).sum()),
               "batches": lines, "checked": checked, "launches": launches}
    print("knn", json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return launches


def lloyd64(points64, init_rows, iters):
    """float64 Lloyd steps from the given rows: (centroids, the nearest
    centroid of each point, the first on a tie)."""
    import scipy.sparse as sp
    n = len(points64)
    psq = np.sum(points64 ** 2, axis=1)
    cent = points64[init_rows]
    for it in range(iters + 1):
        dist = psq[:, None] - 2.0 * points64 @ cent.T \
            + np.sum(cent ** 2, axis=1)[None, :]
        assign = np.argmin(dist, axis=1)
        if it == iters:
            return cent, assign
        counts = np.bincount(assign, minlength=len(cent))
        sums = sp.csr_matrix((np.ones(n), (assign, np.arange(n))),
                             shape=(len(cent), n)) @ points64
        cent = np.where(counts[:, None] > 0,
                        sums / np.maximum(counts, 1)[:, None], cent)


def centroid_routes(points, cent0) -> dict:
    """The two deterministic routes of a Lloyd step's centroid means, on
    the first iteration's assignment, each timed whole on the card: the
    port's (``knn._centroids``: the stable sort by cluster, the counts,
    K1's run sums, the means) and the reference's one-hot product
    (``one_hot.T @ points`` at full f32, then the means).  Their largest
    difference, and whether two one-hot products are bit-equal."""
    import torch
    from memgraph_tpu_torch.ops import knn as K

    psq = torch.sum(points ** 2, dim=1, keepdim=True)
    assign = K._assign(points, psq, cent0)

    def onehot():
        hot = torch.nn.functional.one_hot(assign, cent0.shape[0]).to(
            torch.float32)
        counts = hot.sum(dim=0)[:, None]
        return torch.where(counts > 0, (hot.T @ points)
                           / torch.clamp(counts, min=1.0), cent0)

    k1_means = K._centroids(points, assign, cent0)
    first, second = onehot(), onehot()
    out = {"k1_route_ms": cuda_ms(
               lambda: K._centroids(points, assign, cent0), 20),
           "onehot_route_ms": cuda_ms(onehot, 20),
           "onehot_bit_equal_twice": same_bits(first, second),
           "max_abs_diff": float((first - k1_means).abs().max())}
    del first, second, k1_means
    torch.cuda.empty_cache()
    return out


def phase_kmeans(base: dict):
    """k-means of the 1M x 128 corpus at 64 clusters, 10 iterations, from
    the first row of each blob: the assignment equal to a float64 numpy
    Lloyd run from the same rows, two runs bit-equal, ms an iteration;
    counts set to 0 just before, read just after (K1 an iteration, the
    centroid sums), the first iteration's launch kept and held to its
    plain version on CPU copies.  Then ``kmeans_fit`` (rows from a
    generator, seed 0), timed, and the centroid means' two routes side by
    side (``centroid_routes``)."""
    import torch
    from memgraph_tpu_torch.ops import knn as K

    points, blob = base["corpus"]
    corpus = torch.from_numpy(points).cuda()
    rows = np.unique(blob, return_index=True)[1]
    check(len(rows) == KMEANS_CLUSTERS, "the corpus lacks a blob")
    cent0 = corpus[torch.from_numpy(rows).cuda()]

    def first(x, ptr, g, w, kw):
        first.calls += 1
        return "iteration1" if first.calls == 1 else None

    first.calls = 0
    reset_all_counts()
    with k1_recorded(K, first) as calls:
        (cent, assign), secs = timed_run(
            lambda: K.kmeans_steps(corpus, cent0, KMEANS_ITERS))
    launches = all_counts()
    check(launches["csr_spmm_sum"] == KMEANS_ITERS
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"k-means launches {launches} over {KMEANS_ITERS} iterations")
    (cent2, assign2), secs2 = timed_run(
        lambda: K.kmeans_steps(corpus, cent0, KMEANS_ITERS))
    check(torch.equal(assign, assign2) and same_bits(cent, cent2),
          "two k-means runs differ")
    k1_lines = path_k1_lines(calls, "kmeans", n_in=len(points))
    del calls
    t0 = time.perf_counter()
    _, want = lloyd64(points.astype(np.float64), rows, KMEANS_ITERS)
    ref_s = time.perf_counter() - t0
    got = assign.cpu().numpy()
    check(np.array_equal(got, want),
          f"k-means differs from float64 Lloyd at "
          f"{int((got != want).sum())} points")
    (fcent, fassign), fit_s = timed_run(lambda: K.kmeans_fit(
        corpus, KMEANS_CLUSTERS, KMEANS_ITERS,
        generator=torch.Generator().manual_seed(0)))
    sizes = np.bincount(fassign.cpu().numpy(), minlength=KMEANS_CLUSTERS)
    routes = centroid_routes(corpus, cent0)
    summary = {"n": len(points), "clusters": KMEANS_CLUSTERS,
               "iterations": KMEANS_ITERS, "seconds": [secs, secs2],
               "ms_an_iteration": secs2 / KMEANS_ITERS * 1e3,
               "equal_to_float64": True, "float64_s": ref_s,
               "fit_s": fit_s, "fit_cluster_sizes": [int(sizes.min()),
                                                     int(sizes.max())],
               "k1_at_the_path": {ln["runs"]: {k: ln[k] for k in (
                   "n_seg", "longest_run", "ms", "bound_ms", "plain_ms",
                   "library_ms")} for ln in k1_lines},
               "centroid_routes": routes,
               "launches": launches}
    print("kmeans", json.dumps(summary), flush=True)
    base["path_k1_lines"] += k1_lines
    torch.cuda.empty_cache()
    return launches


def phase_ivf(base: dict):
    """An IVF index of the corpus at 1,024 cells (its k-means from a
    generator, seed 0), 100 queries at n_probe 8, k = 10, l2sq, against
    exact f32 search: recall@10 stated; each IVF score at most the exact
    one at its rank (the probed cells are a subset); the centroid means'
    two routes at the trained cells (``centroid_routes``)."""
    import torch
    from memgraph_tpu_torch.ops import knn as K

    points = base["corpus"][0]
    n, d = points.shape
    corpus = torch.from_numpy(points).cuda()
    rng = np.random.default_rng(KNN_SEED + 1)
    queries = (points[rng.choice(n, max(KNN_BATCHES), replace=False)]
               + rng.standard_normal((max(KNN_BATCHES), d),
                                     dtype=np.float32) * 0.5)
    reset_all_counts()
    index, build_s = timed_run(lambda: K.IvfIndex(corpus,
                                                  n_clusters=IVF_CELLS))
    (scores, ids), search_s = timed_run(
        lambda: index.search(queries, IVF_K, IVF_PROBES, "l2sq"))
    launches = all_counts()
    check(launches["csr_spmm_sum"] == KMEANS_ITERS,
          f"IVF launches {launches}")
    es, ei = K.knn(corpus, torch.from_numpy(queries).cuda(), IVF_K, "l2sq",
                   use_bf16=False)
    es, ei = es.cpu().numpy(), ei.cpu().numpy()
    check(ids.shape == (len(queries), IVF_K) and (ids >= 0).all()
          and bool((scores <= es + 1e-3 * np.abs(es)).all()),
          "IVF scores above the exact search's")
    recall = float(np.mean([len(set(a) & set(b)) / IVF_K
                            for a, b in zip(ids, ei)]))
    cells = np.diff(index.cell_start)
    routes = centroid_routes(corpus, index.centroids)
    summary = {"n": n, "cells": IVF_CELLS, "n_probe": IVF_PROBES,
               "k": IVF_K, "queries": len(queries), "build_s": build_s,
               "search_ms_a_query": search_s / len(queries) * 1e3,
               "recall_at_10": recall,
               "cell_sizes": [int(cells.min()), int(cells.max())],
               "centroid_routes": routes,
               "launches": launches}
    print("ivf", json.dumps(summary), flush=True)
    del index
    torch.cuda.empty_cache()
    return launches


def phase_similarity(base: dict):
    """Node similarity at ``DENSE_LIMIT``: a graph of 8,192 nodes and
    81,920 edges from the north star's generator, through a CooSource.
    The dense matrix in each mode bit-equal to numpy float32 from exact
    integer counts; each all-pairs procedure's records the positive
    pairs i < j of that matrix; ``pairwise`` on 1,000 pairs equal to the
    matrix (jaccard, overlap) or within 2 f32 ulps (cosine: the host
    divides in float64)."""
    import scipy.sparse as sp
    import torch
    from memgraph_tpu_torch.northstar import CooSource, generate_graph
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.ops.similarity import similarity_matrix
    from memgraph_tpu_torch.procedures import structure_modules as SM

    src, dst = generate_graph(SIM_NODES, SIM_EDGES)
    source, cache = CooSource(src, dst, SIM_NODES), GraphCache()
    graph = cache.get(source, device="cuda")
    n = SIM_NODES
    adj = sp.csr_matrix((np.ones(len(src), dtype=np.int32), (src, dst)),
                        shape=(n, n))
    adj.data[:] = 1
    common = (adj @ adj.T).toarray().astype(np.float32)
    deg = np.asarray(adj.sum(1)).ravel().astype(np.float32)
    eps = np.float32(1e-9)
    union = deg[:, None] + deg[None, :] - common
    low = np.minimum(deg[:, None], deg[None, :])
    root = np.sqrt(deg[:, None] * deg[None, :])
    want = {"jaccard": np.where(union > 0, common / np.maximum(union, eps),
                                np.float32(0)),
            "overlap": np.where(low > 0, common / np.maximum(low, eps),
                                np.float32(0)),
            "cosine": np.where(root > 0, common / np.maximum(root, eps),
                               np.float32(0))}
    del common, union, low, root
    rng = np.random.default_rng(KNN_SEED + 2)
    pairs = rng.integers(0, n, (SIM_PAIRS, 2))
    reset_all_counts()
    out = {}
    for mode in ("jaccard", "overlap", "cosine"):
        mat, ms = timed_run(lambda: similarity_matrix(graph, mode))
        got = mat.cpu().numpy()
        check(got.dtype == np.float32
              and np.array_equal(got.view(np.int32),
                                 want[mode].view(np.int32)),
              f"{mode} is not numpy float32's bits")
        rec, proc_s = timed_run(lambda: SM.node_similarity_all(
            source, mode, cache=cache, device="cuda"))
        i, j = np.nonzero(np.triu(want[mode], k=1) > 0)
        check(np.array_equal(rec["node1_gids"], i)
              and np.array_equal(rec["node2_gids"], j)
              and np.array_equal(rec["similarity"],
                                 want[mode][i, j].astype(np.float64)),
              f"node_similarity.{mode}'s records are not the matrix's")
        pw, pw_s = timed_run(lambda: SM.node_similarity_pairwise(
            source, pairs.tolist(), mode, cache=cache, device="cuda"))
        at = want[mode][pw["node1_gids"], pw["node2_gids"]]
        ulps = np.abs(pw["similarity"].astype(np.float32).view(np.int32)
                      - at.view(np.int32))
        check(len(pw["similarity"]) == SIM_PAIRS
              and int(ulps.max()) <= (2 if mode == "cosine" else 0),
              f"node_similarity.pairwise {mode} off the matrix by "
              f"{int(ulps.max())} ulps")
        out[mode] = {"matrix_ms": ms * 1e3, "procedure_s": proc_s,
                     "records": len(i), "pairwise_s": pw_s,
                     "pairwise_max_ulps": int(ulps.max())}
    launches = all_counts()
    summary = {"n_nodes": n, "n_edges": graph.n_edges, "modes": out,
               "launches": launches}
    print("similarity", json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the training paths: GraphSAGE training and node2vec, and their procedures
# ---------------------------------------------------------------------------

GNN_EPOCHS, GNN_LR = 30, 0.01       # the procedures' defaults
GNN_CLASSES = 8                     # in-degree octiles
GNN_LABELED = 0.1                   # the share of the nodes labeled
GNN_LABEL_SEED = 37
# one epoch's gradients against a float64 autograd of the same loss with
# no rounding, as a share of each tensor's largest entry: the forward
# rounds h, the aggregate and the weights to bfloat16 and the backward
# rounds the gradients where JAX's autodiff does (2^-9 relative each, a
# few chained); a CPU run on a 1M-edge graph of the same family measured
# 0.0022-0.0035 (the bf16 rounding of the float64 gradients alone
# 0.0016-0.0026); budgeted 8
GNN_GRAD_TOL = 8 * 2.0 ** -9
WALKS_PER_NODE, WALK_LENGTH = 4, 20
WALK_BIAS = (0.5, 2.0)              # (p, q) of the biased run
WALK_SEED = 31
WALK_HUBS = 20                      # nodes of the most out-edges
WALK_PVALUE = 1e-4                  # the uniform choice's chi-square floor
WALK_SAMPLE = 1_000_000             # biased steps held to the rule
RETURN_SIGMAS = 5.0
N2V_TIMED_STEPS = 50
# the node2vec fits' walks a node (the node2vec phase's two and
# training_procedures' get_embeddings): the defaults' 4 cut to 1 to keep
# the script inside its time limit (at 4 they took ~115 s of it)
N2V_FIT_WALKS = 1
PROC_WALK_STARTS = 100


@contextlib.contextmanager
def backward_tagged(gnn):
    """While inside, ``tag["on"]`` is True during the backward of the
    aggregation (``gnn._Aggregate``), so that a K1 recorder can tell its
    launches from the forward's."""
    tag = {"on": False}
    held = gnn._Aggregate.__dict__["backward"]

    def backward(ctx, grad):
        tag["on"] = True
        try:
            return held.__func__(ctx, grad)
        finally:
            tag["on"] = False

    gnn._Aggregate.backward = staticmethod(backward)
    try:
        yield tag
    finally:
        gnn._Aggregate.backward = held


def train_k1_launches(layers: int, epochs: int, gathers: int) -> int:
    """K1 launches of a trainer's run: two a layer a forward, two an
    aggregation whose input needs a gradient (all but layer 1's), one a
    gathered index set a step; then the evaluation's forward."""
    return epochs * (2 * layers + 2 * (layers - 1) + gathers) + 2 * layers


def link_loss64(model, feats, src, dst, neg_src, neg_dst, n):
    """The link loss of ``model`` in float64 (on the card, plain torch),
    no rounding: the undirected mean over parallel edges counted each
    (torch.sparse), the true edges then the negatives scored, sigmoid
    cross-entropy averaged.  Returns (loss, the parameters' float64
    leaves by layer)."""
    import torch
    from torch.nn import functional as F
    s, d = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
    ones = torch.ones(len(src), dtype=torch.float64, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # torch's sparse notices
        into = torch.sparse_coo_tensor(torch.stack([d, s]), ones,
                                       (n, n)).coalesce()
        out = torch.sparse_coo_tensor(torch.stack([s, d]), ones,
                                      (n, n)).coalesce()
    deg = torch.clamp(torch.bincount(s, minlength=n)
                      + torch.bincount(d, minlength=n), min=1).double()
    leaves = [[p.detach().double().requires_grad_(True)
               for p in (model.w_self[k], model.w_neigh[k], model.b[k])]
              for k in range(len(model.w_self))]
    h = feats[:n].double()
    for k, (w_self, w_neigh, b) in enumerate(leaves):
        agg = (torch.sparse.mm(into, h) + torch.sparse.mm(out, h)) \
            / deg[:, None]
        h = h @ w_self + agg @ w_neigh + b
        if k < len(leaves) - 1:
            h = torch.relu(h)
    ns, nd = neg_src.long(), neg_dst.long()
    scores = torch.cat([(h[s] * h[d]).sum(-1), (h[ns] * h[nd]).sum(-1)])
    labels = torch.cat([
        torch.ones(len(src), dtype=torch.float64, device="cuda"),
        torch.zeros(len(ns), dtype=torch.float64, device="cuda")])
    loss = (-labels * F.logsigmoid(scores)
            - (1.0 - labels) * F.logsigmoid(-scores)).mean()
    return loss, leaves


def octile_labels(dst, n):
    """(dense indices, classes): a seeded 10% of the nodes, each labeled
    by the octile of its in-degree (ties in one class)."""
    indeg = np.bincount(dst, minlength=n)
    cuts = np.quantile(indeg, np.arange(1, GNN_CLASSES) / GNN_CLASSES)
    classes = np.searchsorted(cuts, indeg, side="right")
    rng = np.random.default_rng(GNN_LABEL_SEED)
    idx = np.sort(rng.choice(n, int(n * GNN_LABELED), replace=False))
    return idx, classes[idx]


def phase_training_procedures(base: dict):
    """The training paths' procedure counterparts on v2 through the
    CooSource (after the dense procedures), counts set to 0 just before
    and read just after: ``link_prediction.train`` (degree features) and
    ``get_training_results``, ``predict``; ``node_classification.train``
    on the embedding property and ``get_training_data``;
    ``node2vec.random_walks`` from 100 nodes; ``node2vec.get_embeddings``
    (1 epoch, ``N2V_FIT_WALKS`` walks a node) on the segment graph's own
    source; then a commit of 10
    edges and ``link_prediction.predict``, which must retrain on the new
    snapshot.  Seconds a call; the records held to the slots."""
    import torch
    from memgraph_tpu_torch.northstar import CooSource, generate_graph
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.procedures import ml_modules as ML
    from memgraph_tpu_torch.procedures import node2vec_module as N2VP

    source, cache, v2 = base["source"], base["cache"], base["v2"]
    check(cache.get(source, device="cuda") is v2,
          "the training procedures would not run on v2")
    n = v2.n_nodes
    models, kw = ML.ModelRegistry(), {"cache": cache, "device": "cuda"}
    gids = np.asarray(v2.node_gids)
    a, b = int(gids[0]), int(gids[1])
    picked = gids[np.random.default_rng(WALK_SEED).choice(
        n, PROC_WALK_STARTS, replace=False)]
    src, dst = generate_graph(n_nodes=SEGMENT_NODES, n_edges=SEGMENT_EDGES)
    seg_source, seg_cache = CooSource(src, dst, SEGMENT_NODES), GraphCache()
    secs, outs = {}, {}
    # the training procedures' path: counts set to 0 just before, read
    # just after
    reset_all_counts()
    for name, fn in (
            ("link_prediction.train", lambda: ML.link_prediction_train(
                source, models=models, **kw)),
            ("link_prediction.get_training_results",
             lambda: ML.link_prediction_get_training_results(
                 source, models=models)),
            ("link_prediction.predict", lambda: ML.link_prediction_predict(
                source, a, b, models=models, **kw)),
            ("node_classification.set_model_parameters",
             lambda: ML.set_model_parameters(
                 source, "node_classification",
                 {"node_features_property": EMBEDDING}, models=models)),
            ("node_classification.train",
             lambda: ML.node_classification_train(source, models=models,
                                                  **kw)),
            ("node_classification.get_training_data",
             lambda: ML.node_classification_get_training_data(
                 source, models=models)),
            ("node2vec.random_walks", lambda: N2VP.random_walks(
                source, picked.tolist() + [-1], 10, **kw)),
            ("node2vec.get_embeddings", lambda: N2VP.get_embeddings(
                seg_source, walks_per_node=N2V_FIT_WALKS, epochs=1,
                cache=seg_cache, device="cuda"))):
        outs[name], secs[name] = timed_run(fn)
    lp = models.slot(source, "link_prediction")
    trained = lp.params
    check(lp.graph is v2
          and len(outs["link_prediction.train"]["training_results"][0])
          == GNN_EPOCHS
          and outs["link_prediction.get_training_results"][
              "training_results"][0] == lp.history
          and outs["node_classification.train"]["epoch"].tolist()
          == list(range(1, GNN_EPOCHS + 1))
          and 0.0 <= outs["link_prediction.predict"]["score"][0] <= 1.0,
          "the training procedures' records are not the slots'")
    walk = outs["node2vec.random_walks"]["walk"]
    rows = outs["node2vec.get_embeddings"]
    check(walk.shape == (PROC_WALK_STARTS, 11)
          and walk[:, 0].tolist() == picked.tolist()
          and rows["embedding"].shape == (SEGMENT_NODES, 128)
          and rows["node_gids"].tolist() == list(range(SEGMENT_NODES)),
          "the node2vec procedures' records are misshaped")
    rng = np.random.default_rng(GNN_LABEL_SEED)
    source.commit(add_src=rng.integers(0, n, 10),
                  add_dst=rng.integers(0, n, 10))
    name = "link_prediction.predict (after a commit: retrains)"
    outs[name], secs[name] = timed_run(lambda: ML.link_prediction_predict(
        source, a, b, models=models, **kw))
    launches = all_counts()
    link, forward = train_k1_launches(GNN_LAYERS, GNN_EPOCHS, 4), \
        2 * GNN_LAYERS
    # get_embeddings' defaults but N2V_FIT_WALKS walks a node
    pairs = 2 * 5 * SEGMENT_NODES * N2V_FIT_WALKS * 21
    want = 2 * (link + forward) + train_k1_launches(
        GNN_LAYERS, GNN_EPOCHS, 1) + 3 * max(pairs // 8192, 1)
    check(launches["csr_spmm_sum"] == want
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"training procedures' launches {launches}, not {want} K1: two "
          f"trainings of each model, two link forwards, a node2vec epoch")
    check(lp.params is not trained and lp.graph is not v2
          and lp.version == source.version and len(lp.history) == GNN_EPOCHS
          and lp.graph.n_edges == v2.n_edges + 10,
          "predict after a commit did not retrain on the new snapshot")
    summary = {"version": source.version, "n_nodes": n, "seconds": secs,
               "link_auc": lp.history[-1]["auc"],
               "class_acc": outs["node_classification.train"][
                   "val_log"][-1]["acc"],
               "launches": launches}
    print("training_procedures", json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return launches


def phase_gnn_train(base: dict):
    """GraphSAGE training on the north star (v0) at the procedures'
    defaults (hidden 64, out 32, 2 layers, lr 0.01, 30 epochs, seed 0):
    link prediction on degree features (16 wide), node classification on
    the 128-wide embedding property with 8 in-degree octile classes on a
    seeded 10% of the nodes.  Counts set to 0 just before the four runs
    (each trainer twice), read just after; the K1 launches equal what the
    epochs imply (``train_k1_launches``).  Two runs bit-equal (histories
    and parameters); the loss falls.  The first link run's K1 launches
    are recorded: the aggregation's backward (CSC and CSR runs, 64 lanes)
    and forward at layer 2, and the gathers' backward (the edges by dst,
    no gather; by src, the CSR order; the negatives, sorted), each held
    bit-equal to its plain version on CPU copies and timed
    (``segment_kernels`` lines ``gnn_train_*``).  One epoch's gradients
    against a float64 autograd (on the card) of the same loss,
    negatives and parameters within ``GNN_GRAD_TOL`` of each tensor's
    largest entry.
    ms an epoch from a 30- and a 1-epoch run, and a link epoch's split
    (CUDA events)."""
    import torch
    from memgraph_tpu_torch.ops import gnn as G

    graph, src, dst = base["graph"], base["src"], base["dst"]
    n, m = graph.n_nodes, graph.n_edges
    points = base["corpus"][0]
    degree = G.degree_features(graph)
    wide = torch.zeros(graph.n_pad, points.shape[1], device="cuda")
    wide[:n] = torch.from_numpy(points).cuda()
    label_idx, labels = octile_labels(dst, n)
    majority = float(np.bincount(labels).max() / len(labels))
    by_src, _ = G.edge_runs(graph)
    shape = {"hidden_dim": GNN_HIDDEN, "n_layers": GNN_LAYERS,
             "epochs": GNN_EPOCHS, "lr": GNN_LR, "seed": GNN_SEED}

    def link(epochs=GNN_EPOCHS):
        return G.train_link_prediction(graph, feats=degree, out_dim=GNN_OUT,
                                       **{**shape, "epochs": epochs})

    def classify(epochs=GNN_EPOCHS):
        return G.train_node_classification(graph, label_idx, labels,
                                           feats=wide,
                                           **{**shape, "epochs": epochs})

    recording = {"on": False}

    def keep(x, ptr, g, w, kw):
        if not recording["on"]:
            return None
        if g is graph.csc_src or g is graph.col_idx:
            runs = "csc" if g is graph.csc_src else "csr"
            way = "backward" if tag["on"] else "forward"
            return f"{way}_{runs}_B{x.shape[1]}" if x.shape[1] == 64 \
                else None
        if g is None:
            return "gather_by_dst"
        return "gather_by_src" if g is by_src.order else "gather_negatives"

    runs = {}
    # the training path: counts set to 0 just before, read just after
    reset_all_counts()
    with backward_tagged(G) as tag, k1_recorded(G, keep) as calls:
        recording["on"] = True
        runs["link_a"], _ = timed_run(link)
        recording["on"] = False
        runs["link_b"], link_s = timed_run(link)
        runs["classify_a"], _ = timed_run(classify)
        runs["classify_b"], classify_s = timed_run(classify)
    launches = all_counts()
    want = 2 * (train_k1_launches(GNN_LAYERS, GNN_EPOCHS, 4)
                + train_k1_launches(GNN_LAYERS, GNN_EPOCHS, 1))
    check(launches["csr_spmm_sum"] == want
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"GNN training launches {launches}, not {want} K1 launches")
    check(set(calls) == {"forward_csc_B64", "forward_csr_B64",
                         "backward_csc_B64", "backward_csr_B64",
                         "gather_by_dst", "gather_by_src",
                         "gather_negatives"},
          f"the training path's K1 calls were not recorded: {sorted(calls)}")
    for name in ("link", "classify"):
        a, b = runs[f"{name}_a"], runs[f"{name}_b"]
        check(a[-1] == b[-1] and all(same_bits(p, q) for p, q in zip(
            a[0].parameters(), b[0].parameters())),
              f"two {name} trainings are not the same bits")
        history = a[-1]
        check(len(history) == GNN_EPOCHS
              and np.isfinite([h["loss"] for h in history]).all()
              and history[-1]["loss"] < history[0]["loss"],
              f"the {name} loss did not fall: {history[0]['loss']} -> "
              f"{history[-1]['loss']}")
    model, _, lp_history = runs["link_a"]
    _, _, n_classes, nc_history = runs["classify_a"]
    check(n_classes == GNN_CLASSES and 0.5 < lp_history[-1]["auc"] <= 1.0,
          f"link AUC {lp_history[-1]['auc']}, classes {n_classes}")
    del runs
    one = {"link": timed_run(lambda: link(1))[1],
           "classify": timed_run(lambda: classify(1))[1]}
    k1_lines = path_k1_lines(calls, "gnn_train")
    del calls

    # one epoch's gradients against float64 (the first epoch's draws)
    t0 = time.perf_counter()
    init = G.init_sage_params(degree.shape[1], GNN_HIDDEN, GNN_OUT,
                              GNN_LAYERS, device="cuda",
                              generator=torch.Generator().manual_seed(
                                  GNN_SEED))
    gen = torch.Generator(device="cuda").manual_seed(GNN_SEED)
    neg = [torch.randint(0, n, (m,), generator=gen, device="cuda",
                         dtype=torch.int32) for _ in range(2)]
    init.requires_grad_(True)
    loss = G.link_loss(init, degree, graph, G.edge_runs(graph),
                       tuple(G.row_runs(i, graph.n_pad) for i in neg))
    loss.backward()
    loss64, leaves = link_loss64(init, degree, src, dst, neg[0], neg[1], n)
    loss64.backward()
    grads = {}
    for k in range(GNN_LAYERS):
        for name, p, q in zip(("w_self", "w_neigh", "b"),
                              (init.w_self[k], init.w_neigh[k], init.b[k]),
                              leaves[k]):
            want64 = q.grad.cpu()
            top = float(want64.abs().max())
            err = float((p.grad.double().cpu() - want64).abs().max()) / top
            rounding = float((want64.to(torch.bfloat16).double()
                              - want64).abs().max()) / top
            check(err <= GNN_GRAD_TOL,
                  f"layer {k} {name}'s gradient off float64 by {err} of "
                  f"its largest entry")
            grads[f"{k}.{name}"] = {"err_over_largest": err,
                                    "bf16_rounding_over_largest":
                                        rounding}
    loss64 = float(loss64.detach())
    loss_err = abs(float(loss.detach()) - loss64) / loss64
    grad_s = time.perf_counter() - t0
    del loss, loss64, leaves

    # where a link epoch's time goes (CUDA events, the same shapes)
    pos = G.edge_runs(graph)
    runs_neg = tuple(G.row_runs(i, graph.n_pad) for i in neg)
    opt = G.adam(init.parameters(), GNN_LR)
    split = {
        "draw_and_sort_ms": cuda_ms(lambda: [G.row_runs(torch.randint(
            0, n, (m,), generator=gen, device="cuda", dtype=torch.int32),
            graph.n_pad) for _ in range(2)], 3),
        "forward_ms": cuda_ms(lambda: G.link_loss(init, degree, graph, pos,
                                                  runs_neg), 3),
        "forward_backward_ms": cuda_ms(lambda: G.link_loss(
            init, degree, graph, pos, runs_neg).backward(), 3),
        "adam_ms": cuda_ms(opt.step, 3)}
    del init, neg, runs_neg, opt

    summary = {
        "n_nodes": n, "n_edges": m, "layers": GNN_LAYERS,
        "hidden": GNN_HIDDEN, "out": GNN_OUT, "epochs": GNN_EPOCHS,
        "link": {"train_s": link_s, "one_epoch_run_s": one["link"],
                 "ms_an_epoch": (link_s - one["link"]) * 1e3
                 / (GNN_EPOCHS - 1),
                 "loss_first": lp_history[0]["loss"],
                 "loss_last": lp_history[-1]["loss"],
                 "auc": lp_history[-1]["auc"]},
        "classify": {"train_s": classify_s,
                     "one_epoch_run_s": one["classify"],
                     "ms_an_epoch": (classify_s - one["classify"]) * 1e3
                     / (GNN_EPOCHS - 1),
                     "loss_first": nc_history[0]["loss"],
                     "loss_last": nc_history[-1]["loss"],
                     "acc": nc_history[-1]["acc"],
                     "majority_share": majority,
                     "labeled": len(label_idx)},
        "link_epoch_split": split,
        "gradients_vs_float64": {"limit": GNN_GRAD_TOL,
                                 "loss_rel": loss_err, "by_tensor": grads,
                                 "seconds": grad_s},
        "k1_at_the_path": {ln["runs"]: {k: ln[k] for k in (
            "lanes", "n_seg", "n_edges", "longest_run", "ms", "bound_ms",
            "plain_ms", "library_ms")} for ln in k1_lines},
        "launches": launches}
    print("gnn_train", json.dumps(summary), flush=True)
    base["path_k1_lines"] += k1_lines
    torch.cuda.empty_cache()
    return launches


def steps_are_edges(walks, graph) -> int:
    """Checks on the card that every step of ``walks`` is an edge of
    ``graph`` (a search of the sorted CSR keys src·n + dst) or a stall at
    a node with no out-edge; the steps checked."""
    import torch
    n = graph.n_nodes
    keys = graph.src_idx[:graph.n_edges].long() * n \
        + graph.col_idx[:graph.n_edges].long()
    a = walks[:, :-1].reshape(-1).long()
    b = walks[:, 1:].reshape(-1).long()
    step = a * n + b
    at = torch.clamp(torch.searchsorted(keys, step), max=keys.numel() - 1)
    sink = (graph.row_ptr[1:] - graph.row_ptr[:-1])[:n] == 0
    ok = (keys[at] == step) | ((a == b) & sink[a])
    check(bool(ok.all()), f"{int((~ok).sum())} walk steps are neither an "
                          f"edge nor a stall at a sink")
    return int(step.numel())


def hub_chi_square(walks, row_ptr, col_idx, out_deg) -> dict:
    """The next-node counts after the ``WALK_HUBS`` nodes of the most
    out-edges against a uniform choice over each one's CSR row (parallel
    edges counted each): one chi-square over the hubs together."""
    import scipy.stats
    import torch
    hubs = np.argsort(-out_deg, kind="stable")[:WALK_HUBS]
    a = walks[:, :-1].reshape(-1)
    b = walks[:, 1:].reshape(-1)
    at = torch.isin(a, torch.from_numpy(hubs).to(a.device, a.dtype))
    a, b = a[at].cpu().numpy(), b[at].cpu().numpy()
    stat, dof, visits = 0.0, 0, 0
    for h in hubs.tolist():
        row = col_idx[row_ptr[h]:row_ptr[h + 1]]
        values, mult = np.unique(row, return_counts=True)
        nxt = b[a == h]
        counts = np.array([(nxt == v).sum() for v in values])
        check(counts.sum() == len(nxt), f"a walk left hub {h} off its row")
        expected = len(nxt) * mult / len(row)
        stat += float(((counts - expected) ** 2 / expected).sum())
        dof += len(values) - 1
        visits += len(nxt)
    return {"hubs": WALK_HUBS, "visits": visits, "chi2": stat, "dof": dof,
            "pvalue": float(scipy.stats.chi2.sf(stat, dof))}


def return_share(walks, graph, row_ptr, col_idx, p, q) -> dict:
    """The share of returns (next == prev) among the biased run's steps
    where a return can happen (cur has an out-edge to prev; a seeded
    ``WALK_SAMPLE`` of them), against the share the reference's
    single-retry rule gives those steps (float64 from the graph: P = c /
    deg · (α_back / M + R), c the count of prev in cur's row, R the first
    candidate's rejection probability, M = max(1, 1/p, 1/q)) and its
    standard error; the uniform walk's share c / deg beside it, which the
    sample must tell apart from the rule's."""
    import torch
    n, m = graph.n_nodes, graph.n_edges
    keys = graph.src_idx[:m].long() * n + graph.col_idx[:m].long()
    prev = walks[:, :-2].reshape(-1).long()
    cur = walks[:, 1:-1].reshape(-1).long()
    back = cur * n + prev
    at = torch.clamp(torch.searchsorted(keys, back), max=m - 1)
    possible = (keys[at] == back).nonzero().squeeze(1)
    del back, at
    gen = torch.Generator(device=walks.device).manual_seed(WALK_SEED)
    pick = possible[torch.randperm(possible.numel(), generator=gen,
                                   device=walks.device)[:WALK_SAMPLE]]
    count = int(pick.numel())
    nxt = walks[:, 2:].reshape(-1)[pick].long().cpu().numpy()
    prev, cur = prev[pick].cpu().numpy(), cur[pick].cpu().numpy()
    host_keys = keys.cpu().numpy()
    limit = max(1.0, 1.0 / p, 1.0 / q)
    deg = (row_ptr[cur + 1] - row_ptr[cur]).astype(np.int64)
    owner = np.repeat(np.arange(count), deg)
    first = np.cumsum(deg) - deg
    x = col_idx[row_ptr[cur][owner] + np.arange(deg.sum()) - first[owner]]
    pv = prev[owner]
    query = pv * n + x
    found = host_keys[np.minimum(np.searchsorted(host_keys, query),
                                 m - 1)] == query
    alpha = np.where(x == pv, 1.0 / p, np.where(found, 1.0, 1.0 / q))
    accepted = np.bincount(owner, weights=alpha / limit,
                           minlength=count) / deg
    uniform = np.bincount(owner, weights=(x == pv).astype(np.float64),
                          minlength=count) / deg
    prob = uniform * (1.0 / p / limit + 1.0 - accepted)
    want = float(prob.mean())
    se = float(np.sqrt((prob * (1.0 - prob)).sum())) / count
    got = float((nxt == prev).mean())
    check(abs(got - want) <= RETURN_SIGMAS * se,
          f"returns {got} of {count} biased steps, the rule gives {want} "
          f"(standard error {se})")
    # the sample tells the biased rule from the uniform choice
    check(abs(want - float(uniform.mean())) > RETURN_SIGMAS * se,
          f"{count} steps cannot tell the rule's returns {want} from the "
          f"uniform walk's {float(uniform.mean())} (standard error {se})")
    return {"steps_where_possible": int(possible.numel()), "steps": count,
            "returns": got, "rule": want, "standard_error": se,
            "uniform_rule": float(uniform.mean())}


def phase_node2vec(base: dict):
    """node2vec.  Walks on the north star (v0): 4 from each node (4M
    walks), length 20, at p = q = 1 and at p = 0.5, q = 2, ms a step;
    every step an edge or a stall at a sink (all 80M checked on the
    card); at p = q = 1 the next nodes after the 20 nodes of the most
    out-edges uniform over their rows (chi-square); in the biased run the
    share of returns within 5 standard errors of the single-retry rule's
    (float64) on a seeded 10^6 of the steps that can return.
    Training: ``Node2Vec.fit`` at the defaults but ``N2V_FIT_WALKS``
    walks a node, for one epoch on the segment graph (100,000 nodes,
    450,000 edges; the north star's 840M pairs an epoch do not fit the
    run),
    counts set to 0 just before two fits, read just after: three K1
    launches a batch (the gathers' backward), one batch's kept and held
    bit-equal to the plain version (``segment_kernels`` lines
    ``node2vec_*``); the fits bit-equal; the loss; ms a batch
    (``train_step``, CUDA events); the mean cosine of an edge's ends
    above random pairs'."""
    import torch
    from memgraph_tpu_torch.models import node2vec as N2V
    from memgraph_tpu_torch.northstar import generate_graph
    from memgraph_tpu_torch.ops import gnn as G
    from memgraph_tpu_torch.ops import walks as W
    from memgraph_tpu_torch.ops.csr import from_coo

    graph = base["graph"]
    n = graph.n_nodes
    row_ptr = graph.row_ptr.cpu().numpy().astype(np.int64)
    col_idx = graph.col_idx.cpu().numpy().astype(np.int64)
    out_deg = np.diff(row_ptr)[:n]
    starts = torch.arange(n, device="cuda").repeat(WALKS_PER_NODE)
    walks = {}
    reset_all_counts()
    for label, (p, q) in (("uniform", (1.0, 1.0)), ("biased", WALK_BIAS)):
        W.random_walks(graph, starts[:1024], 2, p=p, q=q)     # warm-up
        gen = torch.Generator(device="cuda").manual_seed(WALK_SEED)
        w, secs = timed_run(lambda: W.random_walks(
            graph, starts, WALK_LENGTH, gen, p=p, q=q))
        check(w.shape == (n * WALKS_PER_NODE, WALK_LENGTH + 1)
              and bool((w[:, 0] == starts).all()),
              f"the {label} walks are misshaped")
        walks[label] = {"p": p, "q": q, "s": secs,
                        "ms_a_step": secs * 1e3 / WALK_LENGTH,
                        "steps_checked": steps_are_edges(w, graph)}
        if label == "uniform":
            walks[label]["chi_square"] = chi = hub_chi_square(
                w, row_ptr, col_idx, out_deg)
            check(chi["pvalue"] > WALK_PVALUE,
                  f"the hubs' next nodes are not uniform: {chi}")
        else:
            walks[label]["return_share"] = return_share(
                w, graph, row_ptr, col_idx, p, q)
        del w
    walk_launches = all_counts()
    check(all(v == 0 for v in walk_launches.values()),
          f"the walks launched a kernel: {walk_launches}")

    src, dst = generate_graph(n_nodes=SEGMENT_NODES, n_edges=SEGMENT_EDGES)
    seg = from_coo(src, dst, n_nodes=SEGMENT_NODES).to_device("cuda")
    cfg = N2V.Node2VecConfig(epochs=1, walks_per_node=N2V_FIT_WALKS)
    pairs = 2 * cfg.window * SEGMENT_NODES * cfg.walks_per_node \
        * (cfg.walk_length + 1)
    batches = max(pairs // cfg.batch_size, 1)
    recording = {"on": False}

    def keep(x, ptr, g, w, kw):
        return f"B{x.shape[0]}" if recording["on"] else None

    fits, fit_s, losses = [], [], []
    # the node2vec path: counts set to 0 just before, read just after
    reset_all_counts()
    with k1_recorded(G, keep) as calls:
        for k in range(2):
            recording["on"] = k == 0
            model = N2V.Node2Vec(cfg)
            emb, secs = timed_run(lambda: model.fit(seg))
            fits.append(emb)
            fit_s.append(secs)
            losses.append(model.epoch_losses)
    launches = all_counts()
    check(launches["csr_spmm_sum"] == 2 * 3 * batches
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"node2vec launches {launches}, not {2 * 3 * batches} K1")
    check(same_bits(fits[0], fits[1]) and losses[0] == losses[1],
          "two node2vec fits are not the same bits")
    emb = fits[0]
    check(emb.shape == (SEGMENT_NODES, cfg.embedding_dim)
          and bool(torch.isfinite(emb).all())
          and np.isfinite(losses[0]).all(), "node2vec's fit misshaped")
    unit = emb / torch.clamp(emb.norm(dim=1, keepdim=True), min=1e-12)
    s, d = torch.from_numpy(src).cuda(), torch.from_numpy(dst).cuda()
    rng = np.random.default_rng(WALK_SEED)
    r1, r2 = (torch.from_numpy(rng.integers(0, SEGMENT_NODES, len(src)))
              .cuda() for _ in range(2))
    edge_cos = float((unit[s] * unit[d]).sum(-1).double().mean())
    random_cos = float((unit[r1] * unit[r2]).sum(-1).double().mean())
    check(edge_cos > random_cos,
          f"an edge's ends (cosine {edge_cos}) are no nearer than random "
          f"pairs ({random_cos})")
    k1_lines = path_k1_lines(calls, "node2vec")
    del calls, fits

    # ms a batch: train_step alone on the fit's shapes
    gen = torch.Generator(device="cuda").manual_seed(WALK_SEED)
    tables = N2V.init_params(seg.n_pad, cfg.embedding_dim, gen)
    for t in tables.values():
        t.requires_grad_(True)
    opt = G.adam(list(tables.values()), cfg.learning_rate)
    batch = W.walks_to_skipgram_pairs(W.random_walks(
        seg, torch.arange(SEGMENT_NODES, device="cuda"), cfg.walk_length,
        gen), cfg.window)
    batch = batch[torch.randperm(batch.shape[0], generator=gen,
                                 device="cuda")[:cfg.batch_size]]
    negs = torch.randint(0, SEGMENT_NODES, (cfg.batch_size, cfg.negatives),
                         generator=gen, device="cuda", dtype=torch.int32)
    batch_ms = cuda_ms(lambda: N2V.train_step(
        tables, opt, batch[:, 0], batch[:, 1], negs), N2V_TIMED_STEPS)
    del tables, opt

    summary = {
        "walks": {"n_walks": n * WALKS_PER_NODE, "length": WALK_LENGTH,
                  **walks},
        "fit": {"n_nodes": SEGMENT_NODES, "n_edges": SEGMENT_EDGES,
                "cut": "segment graph, one epoch, one walk a node: the "
                       "north star's 840M pairs an epoch do not fit the "
                       "run",
                "pairs": pairs, "batches": batches, "fit_s": fit_s,
                "loss": losses[0], "ms_a_batch": batch_ms,
                "edge_cosine": edge_cos, "random_cosine": random_cos},
        "k1_at_the_path": {ln["runs"]: {k: ln[k] for k in (
            "lanes", "n_seg", "n_edges", "ms", "bound_ms", "plain_ms",
            "library_ms")} for ln in k1_lines},
        "launches": launches}
    print("node2vec", json.dumps(summary), flush=True)
    base["path_k1_lines"] += k1_lines
    torch.cuda.empty_cache()
    return launches


# --- commit-then-CALL: the warm pool, communities, the RAG procedures and
# the vector index's delta refresh ------------------------------------------

WARM_MOVES = 1_000          # edges added (seed 17), then removed (seed 19)
WARM_ADD_SEED, WARM_REMOVE_SEED = 17, 19
KATZ_PROC_EPS = 1e-5        # katz.get's L-inf stop: 1e-5 of x >= beta = 1
LEIDEN_NODES, LEIDEN_EDGES = 20_000, 90_000
MODULARITY_TOL = 1e-9
RAG_SEED = 41
RAG_K_SEEDS, RAG_HOPS, RAG_LIMIT = 10, 2, 10
RAG_TOL = 1e-4              # of the largest score: PPR_REL_TOL's bound
SPL_PAIRS = 8
SPL_REL_TOL = 1e-5          # SSSP_REL_TOL
UF_PAIRS = 1_000
VD_SEED = 43
# the index's rows: the corpus's first 100,000 (a depth cut, for the
# script's time limit: the full builds read the list form a row at a
# time, 73 s at 1M rows on the card)
VD_ROWS = 100_000
VD_SETS, VD_UNSET, VD_OFFDIM, VD_CLEARS = 900, 50, 50, 100
VD_OFF_DIM = 64
VD_QUERIES = 100
VD_SCORE_RTOL = 1e-6        # a row's score in another matrix's product


def modularity64(src, dst, w, comm) -> float:
    """float64 modularity of a partition of the graph taken undirected
    (each edge both ways), from numpy sums alone."""
    w = np.ones(len(src)) if w is None else np.asarray(w, np.float64)
    m2 = 2.0 * w.sum()
    if m2 <= 0:
        return 0.0
    internal = 2.0 * w[comm[src] == comm[dst]].sum()
    k = np.bincount(src, w, minlength=len(comm)) \
        + np.bincount(dst, w, minlength=len(comm))
    tot = np.bincount(comm, k)
    return float(internal / m2 - (tot ** 2).sum() / m2 ** 2)


def segment_source(weighted: bool = False):
    """A CooSource over the segment graph (cut from the north star's
    generator), with seeded weights in [0.5, 2) when asked."""
    from memgraph_tpu_torch.northstar import CooSource, generate_graph
    src, dst = generate_graph(n_nodes=SEGMENT_NODES, n_edges=SEGMENT_EDGES)
    w = (np.random.default_rng(SSSP_SEED).uniform(0.5, 2.0, len(src))
         .astype(np.float32) if weighted else None)
    return CooSource(src, dst, SEGMENT_NODES, weights=w), src, dst, w


def by_dense(graph, out) -> np.ndarray:
    """The dense index of each record's gid."""
    return np.asarray([graph.gid_to_idx[int(g)] for g in out["node_gids"]])


def phase_rag_procedures(base: dict):
    """On v2 (after the dense procedures): ``graphrag.retrieve`` over the
    1M x 128 embedding index against a float64 PPR from the same seeds
    masked by a scipy 2-hop set; ``igraphalg.pagerank`` directed on v2
    (its plan) and undirected on the segment graph, each within the
    ``pagerank.get`` bound of a converged float64 run;
    ``igraphalg.shortest_path_length`` on 8 pairs of the weighted segment
    graph against Dijkstra; ``union_find.connected`` on 1,000 pairs of v2
    against scipy's components, then again with ``update=False`` from its
    stored labels (WCC not run), and on 1,000 pairs of the segment graph,
    half of them to a node without an edge.  Counts set to 0 just before the calls
    and read just after; seconds a call."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse import csgraph
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.procedures import combinatorial_modules as CM
    from memgraph_tpu_torch.procedures import graphrag as GR
    from memgraph_tpu_torch.procedures import igraph_module as IG
    from memgraph_tpu_torch.procedures import vector_search as VS

    source, cache, v2 = base["source"], base["cache"], base["v2"]
    check(cache.get(source, device="cuda") is v2,
          "the RAG procedures would not run on v2")
    n = v2.n_nodes
    points = base["corpus"][0]
    rng = np.random.default_rng(RAG_SEED)
    query = points[int(rng.integers(0, n))].tolist()
    seg, ssrc, sdst, sw = segment_source(weighted=True)
    seg_cache = GraphCache()
    seg_pairs = rng.integers(0, SEGMENT_NODES, (SPL_PAIRS, 2))
    uf_pairs = rng.integers(0, n, (2, UF_PAIRS))
    # the north star is one weak component: on the segment graph half the
    # right-hand ends are nodes without an edge
    alone = np.setdiff1d(np.arange(SEGMENT_NODES),
                         np.concatenate([ssrc, sdst]))
    seg_uf = np.stack([rng.integers(0, SEGMENT_NODES, UF_PAIRS),
                       np.concatenate([
                           rng.integers(0, SEGMENT_NODES, UF_PAIRS // 2),
                           rng.choice(alone, UF_PAIRS - UF_PAIRS // 2)])])
    index_cache = VS.IndexCache()
    kw = {"device": "cuda"}
    index, index_s = timed_run(lambda: index_cache.get(source, EMBEDDING,
                                                       "cuda"))
    wcc_runs = []
    real_wcc = CM.weakly_connected_components

    def counted_wcc(*args, **kwargs):
        wcc_runs.append(1)
        return real_wcc(*args, **kwargs)

    calls = [
        ("graphrag.retrieve", lambda: GR.retrieve(
            source, EMBEDDING, query, RAG_K_SEEDS, RAG_HOPS, RAG_LIMIT,
            cache=cache, index_cache=index_cache, **kw)),
        ("igraphalg.pagerank", lambda: IG.pagerank_get(
            source, cache=cache, **kw)),
        ("igraphalg.pagerank undirected (segment)", lambda: IG.pagerank_get(
            seg, directed=False, cache=seg_cache, **kw)),
        *((f"igraphalg.shortest_path_length {i}",
           lambda a=int(a), b=int(b): IG.shortest_path_length(
               seg, a, b, "weight", cache=seg_cache, **kw))
          for i, (a, b) in enumerate(seg_pairs)),
        ("union_find.connected", lambda: CM.union_find_connected(
            source, uf_pairs[0].tolist(), uf_pairs[1].tolist(),
            cache=cache, **kw)),
        ("union_find.connected update=False",
         lambda: CM.union_find_connected(
             source, uf_pairs[0].tolist(), uf_pairs[1].tolist(),
             update=False, cache=cache, **kw)),
        ("union_find.connected (segment)", lambda: CM.union_find_connected(
            seg, seg_uf[0].tolist(), seg_uf[1].tolist(), cache=seg_cache,
            **kw))]
    secs, outs = {}, {}
    # the RAG procedures' path: counts set to 0 just before, read just
    # after
    CM.weakly_connected_components = counted_wcc
    try:
        reset_all_counts()
        for name, fn in calls:
            if name.endswith("update=False"):
                wcc_before = len(wcc_runs)
            outs[name], secs[name] = timed_run(fn)
        launches = all_counts()
    finally:
        CM.weakly_connected_components = real_wcc
    check(launches["csr_spmm_sum"] > 0 and launches["lane_sum"] > 0
          and launches["benes_mid_gather"] > 0
          and launches["benes_outer_gather"] > 0,
          f"the RAG procedures did not launch K1, K2 and the Benes "
          f"gathers: {launches}")

    # graphrag.retrieve: the same seeds (the index's own top 10), a
    # float64 PPR masked by the scipy 2-hop set
    t0 = time.perf_counter()
    sims, idx = VS._search_entry(index, VS._query(index, query),
                                 RAG_K_SEEDS, "cosine")
    seeds = [v2.gid_to_idx[index.row_gids[int(i)]] for i in idx[0]]
    src2, dst2 = (a.astype(np.int64) for a in v2.host_coo[:2])
    ppr = reference_ppr(src2, dst2, n, seeds, iterations=PPR_MAX_ITERATIONS)
    sym = sp.csr_matrix((np.ones(2 * len(src2), dtype=np.float32),
                         (np.concatenate([src2, dst2]),
                          np.concatenate([dst2, src2]))), shape=(n, n))
    reach = np.zeros(n, dtype=np.float32)
    reach[seeds] = 1.0
    for _ in range(RAG_HOPS):
        reach = np.maximum(reach, (sym @ reach > 0).astype(np.float32))
    want = np.where(reach > 0, ppr, 0.0)
    order = np.argsort(-want)[:RAG_LIMIT]
    rag = outs["graphrag.retrieve"]
    got_idx = by_dense(v2, rag)
    top = float(want[order[0]])
    floor = float(want[order[-1]]) - RAG_TOL * top
    check(len(got_idx) == RAG_LIMIT
          and np.abs(rag["score"] - want[order]).max() <= RAG_TOL * top
          and bool((want[got_idx] >= floor).all())
          and np.abs(rag["score"] - want[got_idx]).max() <= RAG_TOL * top,
          "graphrag.retrieve's top 10 is not the float64 masked PPR's up "
          "to near-ties")
    seed_sim = {s: float(v) for s, v in zip(seeds, sims[0])}
    check(np.allclose(rag["seed_similarity"],
                      [seed_sim.get(int(i), 0.0) for i in got_idx]),
          "graphrag.retrieve's seed similarities are not the seeds'")
    rag_check = {"top_score": top, "max_abs_vs_f64": float(
        np.abs(rag["score"] - want[order]).max()),
        "same_order": got_idx.tolist() == order.tolist(),
        "seeds_in_top": int(sum(int(i) in seed_sim for i in got_idx)),
        "reach": int((reach > 0).sum())}

    # igraphalg.pagerank: directed on v2, undirected on the segment graph
    pr = outs["igraphalg.pagerank"]
    ref = base.pop("v2_pagerank64", None)
    if ref is None:
        ref = reference_pagerank(src2, dst2, n,
                                 iterations=PR_PROC_REF_ITERATIONS)
    pr_l1 = float(np.abs(pr["rank"].astype(np.float64)
                         - ref[by_dense(v2, pr)]).sum())
    check(pr_l1 <= PR_PROC_L1,
          f"igraphalg.pagerank on v2 off float64 by L1 {pr_l1}")
    upr = outs["igraphalg.pagerank undirected (segment)"]
    sg = seg_cache.get(seg, device="cuda")
    uref = reference_pagerank(np.concatenate([ssrc, sdst]),
                              np.concatenate([sdst, ssrc]), SEGMENT_NODES,
                              iterations=PR_PROC_REF_ITERATIONS)
    upr_l1 = float(np.abs(upr["rank"].astype(np.float64)
                          - uref[by_dense(sg, upr)]).sum())
    check(upr_l1 <= PR_PROC_L1,
          f"igraphalg.pagerank undirected off float64 by L1 {upr_l1}")

    # shortest_path_length against Dijkstra on the weighted segment graph
    s_, d_, w_ = dedup_min(ssrc, sdst, sw.astype(np.float64))
    adj = sp.csr_matrix((w_, (s_, d_)), shape=(SEGMENT_NODES,) * 2)
    dist = csgraph.dijkstra(adj, directed=True, indices=seg_pairs[:, 0])
    lengths, worst = [], 0.0
    for i, (a, b) in enumerate(seg_pairs):
        got = outs[f"igraphalg.shortest_path_length {i}"]["length"][0]
        want_l = dist[i, b]
        if np.isinf(want_l):
            check(np.isinf(got), f"shortest_path_length {a}->{b} is {got}, "
                                 f"Dijkstra's inf")
        else:
            rel = abs(got - want_l) / max(want_l, 1e-30)
            worst = max(worst, rel)
            check(rel <= SPL_REL_TOL, f"shortest_path_length {a}->{b} "
                                      f"{got} vs Dijkstra {want_l}")
        lengths.append(float(got))

    # union_find.connected against scipy's weak components of v2
    adj2 = sp.csr_matrix((np.ones(len(src2), dtype=np.int8), (src2, dst2)),
                         shape=(n, n))
    _, weak = csgraph.connected_components(adj2, directed=True,
                                           connection="weak")
    uf = outs["union_find.connected"]
    want_uf = weak[uf_pairs[0]] == weak[uf_pairs[1]]
    check(np.array_equal(uf["connected"], want_uf)
          and uf["node1_gids"].tolist() == uf_pairs[0].tolist(),
          "union_find.connected is not scipy's components")
    again = outs["union_find.connected update=False"]
    check(wcc_before == 1 and len(wcc_runs) == 2
          and np.array_equal(again["connected"], want_uf),
          "union_find.connected update=False did not serve the stored "
          "labels")
    s_adj = sp.csr_matrix((np.ones(len(ssrc), dtype=np.int8), (ssrc, sdst)),
                          shape=(SEGMENT_NODES,) * 2)
    _, s_weak = csgraph.connected_components(s_adj, directed=True,
                                             connection="weak")
    s_want = s_weak[seg_uf[0]] == s_weak[seg_uf[1]]
    check(np.array_equal(outs["union_find.connected (segment)"][
        "connected"], s_want) and 0 < s_want.sum() < UF_PAIRS,
          "union_find.connected on the segment graph is not scipy's "
          "components, or not both answers")
    summary = {"version": source.version, "n_nodes": n,
               "index_full_build_s": index_s, "seconds": secs,
               "graphrag.retrieve": rag_check,
               "igraphalg.pagerank": {"l1": pr_l1, "limit": PR_PROC_L1},
               "igraphalg.pagerank undirected": {
                   "n_nodes": SEGMENT_NODES, "l1": upr_l1},
               "shortest_path_length": {
                   "lengths": lengths, "max_rel": worst,
                   "unreached": int(np.isinf(lengths).sum())},
               "union_find.connected": {
                   "pairs": UF_PAIRS, "connected": int(want_uf.sum()),
                   "components": int(weak.max()) + 1,
                   "segment_connected": int(s_want.sum()),
                   "segment_components": int(s_weak.max()) + 1},
               "reference_s": time.perf_counter() - t0,
               "launches": launches}
    print("rag_procedures", json.dumps(summary), flush=True)
    del index, index_cache, sym, adj2
    torch.cuda.empty_cache()
    return launches


def phase_warm_pool(base: dict):
    """Commit-then-CALL through a warm pool of its own (the procedures
    phase filled the global one), on the north star's CooSource and
    GraphCache after the training procedures' commit: ``pagerank.get``,
    ``wcc.get`` and ``community_detection.get`` cold; ``pagerank.get``
    again (a hit: the cold call's bytes, read-only, µs); an adds-only
    commit of 1,000 edges
    (seed 17), then the three warm (PageRank's iterations fewer than
    cold's, within the ``pagerank.get`` bound of a converged float64
    run; WCC equal to scipy; the labels a fixpoint: one more round seeded
    with them changes none); a commit removing 1,000 edges (seed 19), then
    WCC and labelprop cold (``cold_start_total`` + 2, WCC equal to scipy)
    and PageRank warm.  No plan is built: every snapshot refreshes from
    v0's.  Then ``katz_centrality.get`` cold, as a hit and warm after
    an adds-only commit on the segment graph's own source (katz would
    build a plan of its own on a new north-star version), against float64
    with the katz line's bounds.  Counts set to 0 just before and read
    just after."""
    import scipy.sparse as sp
    import torch
    from scipy.sparse import csgraph
    from memgraph_tpu_torch.northstar import N_NODES
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.ops.delta import LocalWarmPool
    from memgraph_tpu_torch.ops.labelprop import label_propagation
    from memgraph_tpu_torch.procedures import graph_algorithms as P
    from memgraph_tpu_torch.utils.metrics import global_metrics

    source, cache = base["source"], base["cache"]
    pool = LocalWarmPool()
    kw = {"cache": cache, "pool": pool, "device": "cuda"}
    seg, ssrc, sdst, _ = segment_source()
    seg_kw = {"cache": GraphCache(), "pool": pool, "device": "cuda"}
    calls = {"pagerank": P.pagerank_get, "wcc": P.weakly_connected_components_get,
             "labelprop": P.community_detection_get}
    secs, outs, iters, kept = {}, {}, {}, {}

    def run(tag, algo):
        outs[tag], secs[tag] = timed_run(lambda: calls[algo](source, **kw))
        sol = pool.solution(source.storage, algo)
        iters[tag], kept[tag] = sol.iters, sol.x

    def katz(tag):
        outs[tag], secs[tag] = timed_run(lambda: P.katz_centrality_get(
            seg, KATZ_ALPHA, KATZ_PROC_EPS, **seg_kw))
        iters[tag] = pool.solution(seg.storage, "katz").iters

    def graph_now():
        return cache.get(source, device="cuda")

    def starts():
        """The warm and cold starts counted since the phase began."""
        return {k: global_metrics.value(f"delta.{k}_start_total") - v
                for k, v in starts0.items()}

    starts0 = {k: global_metrics.value(f"delta.{k}_start_total")
               for k in ("warm", "cold")}
    # the warm pool's path: counts set to 0 just before, read just after
    with counted_plan_builds() as plan_builds:
        reset_all_counts()
        for algo in calls:
            run(f"{algo} cold", algo)
        cold_copy = {k: v.copy() for k, v in outs["pagerank cold"].items()}
        t0 = time.perf_counter()
        hit = P.pagerank_get(source, **kw)
        hit_us = (time.perf_counter() - t0) * 1e6
        g_cold = graph_now()
        rng = np.random.default_rng(WARM_ADD_SEED)
        source.commit(rng.integers(0, N_NODES, WARM_MOVES),
                      (rng.random(WARM_MOVES) ** 2 * N_NODES).astype(np.int64))
        for algo in calls:
            run(f"{algo} warm", algo)
        g_add = graph_now()
        after_adds = starts()
        rng = np.random.default_rng(WARM_REMOVE_SEED)
        source.commit(remove=rng.choice(source.alive_ids(), WARM_MOVES,
                                        replace=False))
        for algo in ("wcc", "labelprop", "pagerank"):
            run(f"{algo} after removal", algo)
        g_rem = graph_now()
        katz("katz cold")
        katz_copy = {k: v.copy() for k, v in outs["katz cold"].items()}
        t0 = time.perf_counter()
        katz_hit = P.katz_centrality_get(seg, KATZ_ALPHA, KATZ_PROC_EPS,
                                         **seg_kw)
        katz_hit_us = (time.perf_counter() - t0) * 1e6
        rng = np.random.default_rng(WARM_ADD_SEED)
        seg.commit(rng.integers(0, SEGMENT_NODES, WARM_MOVES),
                   (rng.random(WARM_MOVES) ** 2
                    * SEGMENT_NODES).astype(np.int64))
        katz("katz warm")
        launches = all_counts()
    check(not plan_builds, f"build_plan ran {len(plan_builds)} time(s) on "
                           "the warm pool's snapshots")
    check(launches["benes_mid_gather"] > 0
          and launches["benes_outer_gather"] > 0
          and launches["csr_spmm_sum"] > 0,
          f"the warm pool's path launched no Benes gather or K1: {launches}")
    check(all(hit[k].tobytes() == v.tobytes() for k, v in cold_copy.items())
          and all(katz_hit[k].tobytes() == v.tobytes()
                  for k, v in katz_copy.items()),
          "a repeated call on an unchanged graph did not return the cold "
          "call's bytes")
    check(not hit["rank"].flags.writeable
          and not katz_hit["rank"].flags.writeable,
          "a hit returned a stored solution that its caller can change")
    check(after_adds == {"warm": 3, "cold": 0}
          and starts() == {"warm": 5, "cold": 2},
          f"warm/cold starts {after_adds}, {starts()}: expected 3 warm "
          f"after the adds, then 2 cold (wcc, labelprop) and 1 warm "
          f"(pagerank) after the removal, then katz warm")
    check(iters["pagerank warm"] < iters["pagerank cold"]
          and iters["katz warm"] < iters["katz cold"],
          f"warm runs not shorter than cold: {iters}")

    def coo(g):
        return tuple(a.astype(np.int64) for a in g.host_coo[:2])

    def wcc_equal(g, out):
        s, d = coo(g)
        adj = sp.csr_matrix((np.ones(len(s), dtype=np.int8), (s, d)),
                            shape=(g.n_nodes, g.n_nodes))
        _, weak = csgraph.connected_components(adj, directed=True,
                                               connection="weak")
        comp = np.empty(g.n_nodes, dtype=np.int64)
        comp[by_dense(g, out)] = out["component_id"]
        return np.array_equal(min_index_labels(comp),
                              min_index_labels(weak))

    t0 = time.perf_counter()
    s3, d3 = coo(g_add)
    ref = reference_pagerank(s3, d3, g_add.n_nodes,
                             iterations=PR_PROC_REF_ITERATIONS)
    warm = outs["pagerank warm"]
    pr_l1 = float(np.abs(warm["rank"].astype(np.float64)
                         - ref[by_dense(g_add, warm)]).sum())
    check(pr_l1 <= PR_PROC_L1,
          f"warm pagerank.get off float64 by L1 {pr_l1} > {PR_PROC_L1}")
    check(wcc_equal(g_add, outs["wcc warm"]),
          "warm wcc.get is not scipy's partition")
    check(wcc_equal(g_rem, outs["wcc after removal"]),
          "wcc.get after the removal is not scipy's partition")
    warm_labels = kept["labelprop warm"]
    again, _ = label_propagation(g_add, max_iterations=1,
                                 labels0=warm_labels)
    check(np.array_equal(again, warm_labels),
          "the warm labels are not a fixpoint: one more round moves "
          f"{int((again != warm_labels).sum())}")
    seg_graph = seg_kw["cache"].get(seg, device="cuda")
    a_t = transposed_adjacency(*coo(seg_graph), SEGMENT_NODES)
    lam = spectral_radius(a_t)
    check(KATZ_ALPHA * lam <= 0.5, f"α λ = {KATZ_ALPHA * lam} > 1/2 on the "
                                   f"segment graph")
    kx = outs["katz warm"]["rank"].astype(np.float64)
    kref = reference_katz(a_t, KATZ_ALPHA)[by_dense(seg_graph,
                                                    outs["katz warm"])]
    k_rel = float((np.abs(kx - kref) / kref).max())
    k_top = len(set(np.argsort(-kx)[:100]) & set(np.argsort(-kref)[:100]))
    check(k_rel <= F32_REL_TOL and k_top == 100,
          f"warm katz_centrality.get off float64: rel {k_rel} top {k_top}")
    summary = {"n_edges": [g_cold.n_edges, g_add.n_edges, g_rem.n_edges],
               "seconds": secs, "iterations": iters, "hit_us": hit_us,
               "katz_hit_us": katz_hit_us, "starts": starts(),
               "pagerank_warm_l1": {"l1": pr_l1, "limit": PR_PROC_L1},
               "katz_warm": {"max_rel": k_rel, "top100": k_top,
                             "alpha_lambda": KATZ_ALPHA * lam},
               "reference_s": time.perf_counter() - t0,
               "launches": launches}
    print("warm_pool", json.dumps(summary), flush=True)
    torch.cuda.empty_cache()
    return launches


def phase_communities(base: dict):
    """``community_detection.louvain`` on the segment graph and
    ``leiden_community_detection.get`` on a 20,000-node, 90,000-edge graph
    of the north star's generator (Louvain's move loop is a host loop
    over the edges: cut from the north star), twice each through a
    CooSource and a GraphCache on the card.  The two runs equal; the
    Louvain ids compact from 1 and its modularity equal to an independent
    float64 numpy one of the returned partition within 1e-9; Leiden's
    refined ids within [0, n) and its partition's float64 modularity at
    least the Louvain partition's on the same graph.  No K1 or Benes
    launch: counts set to 0 just before, read just after."""
    from memgraph_tpu_torch.northstar import CooSource, generate_graph
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.ops.louvain import louvain
    from memgraph_tpu_torch.procedures import combinatorial_modules as CM
    from memgraph_tpu_torch.procedures import structure_modules as SM

    seg, ssrc, sdst, _ = segment_source()
    lsrc, ldst = generate_graph(n_nodes=LEIDEN_NODES, n_edges=LEIDEN_EDGES)
    small = CooSource(lsrc, ldst, LEIDEN_NODES)
    kw = {"cache": GraphCache(), "device": "cuda"}
    secs, outs = {}, {}
    # the communities' path: counts set to 0 just before, read just after
    reset_all_counts()
    for tag, fn in (
            ("louvain", lambda: SM.community_detection_louvain(seg, **kw)),
            ("louvain again",
             lambda: SM.community_detection_louvain(seg, **kw)),
            ("leiden", lambda: CM.leiden_get(small, **kw)),
            ("leiden again", lambda: CM.leiden_get(small, **kw))):
        outs[tag], secs[tag] = timed_run(fn)
    launches = all_counts()
    check(all(v == 0 for v in launches.values()),
          f"the communities' path launched a kernel: {launches}")
    for tag in ("louvain", "leiden"):
        a, b = outs[tag], outs[f"{tag} again"]
        check(a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                           for k in a),
              f"two {tag} runs differ")
    lv = outs["louvain"]
    check(lv["node_gids"].tolist() == list(range(SEGMENT_NODES)),
          "community_detection.louvain's records are not the nodes'")
    ids = np.unique(lv["community_id"])
    check(ids.tolist() == list(range(1, len(ids) + 1)),
          "Louvain's community ids are not compact from 1")
    q = float(lv["modularity"][0])
    q64 = modularity64(ssrc, sdst, None, lv["community_id"])
    check(bool((lv["modularity"] == q).all()) and abs(q - q64)
          <= MODULARITY_TOL,
          f"Louvain's modularity {q} is not the partition's float64 {q64}")
    ld = outs["leiden"]
    comm = ld["community_id"]
    check(ld["node_gids"].tolist() == list(range(LEIDEN_NODES))
          and 0 <= comm.min() and comm.max() < LEIDEN_NODES
          and np.array_equal(ld["communities"][:, 0], comm),
          "leiden_community_detection.get's records are misshaped")
    q_leiden = modularity64(lsrc, ldst, None, comm)
    g_small = kw["cache"].get(small, device="cuda")
    t0 = time.perf_counter()
    lv_small, q_small = louvain(g_small)
    louvain_small_s = time.perf_counter() - t0
    check(abs(modularity64(lsrc, ldst, None, lv_small) - q_small)
          <= MODULARITY_TOL, "Louvain's modularity on the 20k graph is not "
                             "its partition's")
    # every move of the refinement has a positive modularity gain
    check(q_leiden >= q_small - MODULARITY_TOL,
          f"Leiden's refined partition has modularity {q_leiden}, below "
          f"its Louvain partition's {q_small}")
    summary = {
        "louvain": {"n_nodes": SEGMENT_NODES, "n_edges": SEGMENT_EDGES,
                    "communities": len(ids), "modularity": q,
                    "modularity64": q64},
        "leiden": {"n_nodes": LEIDEN_NODES, "n_edges": LEIDEN_EDGES,
                   "communities": int(len(np.unique(comm))),
                   "modularity64": q_leiden,
                   "louvain_modularity": q_small,
                   "louvain_s": louvain_small_s},
        "seconds": secs, "launches": launches}
    print("communities", json.dumps(summary), flush=True)
    return launches


def phase_vector_delta(base: dict):
    """The embedding index's delta refresh on the first ``VD_ROWS`` rows
    of the north star's 1M x 128 corpus, a source of their own: one full
    build; a commit that clears 50 vectors (refreshed);
    then the measured commit: 900 new values, 50 on the vertices that
    had none, 50 of another length (64) and 100 clears.  The refresh must
    be a delta (the counters); then commits that rewrite values the
    vertices already hold wrap the change log, which must give a full
    build of the same state (the counters); each live gid's row of the
    delta entry is bit-equal to it and ``valid`` exactly the live rows,
    100 queries' top 10 the full build's as (gid, score) pairs.  Seconds
    of the full builds, ms of the measured refresh.  Counts set to 0
    just before, read just after (the index launches none of the listed
    kernels)."""
    import torch
    from memgraph_tpu_torch.northstar import CooSource
    from memgraph_tpu_torch.procedures import vector_search as VS

    points = base["corpus"][0][:VD_ROWS]
    no_edges = np.zeros(0, np.int64)
    source = CooSource(no_edges, no_edges, VD_ROWS,
                       properties={EMBEDDING: points})
    dim = points.shape[1]
    rng = np.random.default_rng(VD_SEED)
    picked = rng.choice(VD_ROWS, VD_SETS + VD_UNSET + VD_OFFDIM + VD_CLEARS,
                        replace=False)
    sets, unset, off, clears = np.split(picked, np.cumsum(
        [VD_SETS, VD_UNSET, VD_OFFDIM]))
    index_cache = VS.IndexCache()
    secs = {}
    reset_all_counts()
    full0, secs["full_build"] = timed_run(
        lambda: index_cache.get(source, EMBEDDING, "cuda"))
    source.commit(set_properties={EMBEDDING: (unset, [None] * len(unset))})
    _, secs["clear_refresh"] = timed_run(
        lambda: index_cache.get(source, EMBEDDING, "cuda"))
    values = (list(rng.standard_normal((VD_SETS, dim), dtype=np.float32))
              + list(rng.standard_normal((VD_UNSET, dim), dtype=np.float32))
              + list(rng.standard_normal((VD_OFFDIM, VD_OFF_DIM),
                                         dtype=np.float32))
              + [None] * VD_CLEARS)
    source.commit(set_properties={EMBEDDING: (
        np.concatenate([sets, unset, off, clears]), values)})
    before = dict(index_cache.counters)
    entry, secs["delta_refresh"] = timed_run(
        lambda: index_cache.get(source, EMBEDDING, "cuda"))
    check(index_cache.counters == {
        "full_builds": before["full_builds"],
        "delta_refreshes": before["delta_refreshes"] + 1},
        f"the commit's refresh was not a delta: {before} -> "
        f"{index_cache.counters}")
    # the full build of the same state: the log wrapped by commits that
    # rewrite values the vertices already hold, so the cache must build
    # in full (one list read of the corpus serves both checks)
    n_sets = len(sets)
    for i in range(source.log_size + 1):
        source.commit(set_properties={EMBEDDING: (
            [int(sets[i % n_sets])], [values[i % n_sets]])})
    before = dict(index_cache.counters)
    full, secs["wrapped_full_build"] = timed_run(
        lambda: index_cache.get(source, EMBEDDING, "cuda"))
    check(index_cache.counters["full_builds"] == before["full_builds"] + 1,
          f"a wrapped log did not give a full build: {index_cache.counters}")
    launches = all_counts()
    live = VD_ROWS - VD_UNSET - VD_OFFDIM - VD_CLEARS + VD_UNSET
    check(entry.size == full.size == live
          and set(entry.gid_to_row) == set(full.gid_to_row)
          and entry.dim_counts == full.dim_counts
          and entry.offdim == full.offdim,
          "the delta entry's rows, counts or off-dimension set differ from "
          "a full build's")
    gids = np.fromiter(full.gid_to_row, dtype=np.int64, count=full.size)
    rows_d = torch.as_tensor([entry.gid_to_row[int(g)] for g in gids],
                             device=entry.matrix.device)
    rows_f = torch.as_tensor([full.gid_to_row[int(g)] for g in gids],
                             device=full.matrix.device)
    check(same_bits(entry.matrix[rows_d], full.matrix[rows_f]),
          "a live row of the delta entry is not the full build's bits")
    valid = torch.zeros_like(entry.valid)
    valid[rows_d] = 1.0
    check(torch.equal(entry.valid, valid),
          "the delta entry's valid is not exactly its live rows")
    queries = torch.from_numpy(points[rng.choice(VD_ROWS, VD_QUERIES,
                                                 replace=False)]).cuda()
    (s_d, i_d), (s_f, i_f) = (VS._search_entry(e, queries, 10, "cosine")
                              for e in (entry, full))
    g_d = np.asarray(entry.row_gids, dtype=object)[i_d]
    g_f = np.asarray(full.row_gids, dtype=object)[i_f]
    check(np.array_equal(g_d, g_f)
          and np.allclose(s_d, s_f, rtol=VD_SCORE_RTOL, atol=0.0),
          f"the delta entry's top 10 differ from the full build's: "
          f"{int((g_d != g_f).sum())} gids, max score diff "
          f"{float(np.abs(s_d - s_f).max())}")
    summary = {"n_rows": live, "dim": dim, "seconds": secs,
               "delta_refresh_ms": secs["delta_refresh"] * 1e3,
               "capacity": int(entry.matrix.shape[0]),
               "free_rows": len(entry.free_rows),
               "score_max_abs_diff": float(np.abs(s_d - s_f).max()),
               "counters": index_cache.counters, "launches": launches}
    print("vector_delta", json.dumps(summary), flush=True)
    del entry, full, full0, index_cache
    torch.cuda.empty_cache()
    return launches


KS_REQUESTS = 256           # single-source PPR requests of the burst
KS_THREADS = 16             # client threads sending them
KS_SAMPLED = 32             # cold replies held bit-equal to in-process
KS_SEED = 47                # the burst's sources and the sample
KS_TOPK = 10                # the burst's replies: the top 10
KS_PR_TOL = 1e-6            # the pagerank op's L1 stop, cold and warm
KS_HELD_WARM = 2            # warm PPR replies held to float64
KS_HELD_HITS = 16           # post-commit PPR hits measured against float64
KS_TIMEOUT = 300.0          # a client's socket timeout, seconds
KS_FOOTPRINT_RANGE = (1.0, 2.0)   # admission estimate over measured peak
KS_PPR_LANES = (1, 32)      # PPR batches whose peak is measured
# the warm op's float64 reference: a truncation error of 2 x 0.85^100 =
# 1.7e-7 in L1, far inside PR_PROC_L1
KS_REF_ITERATIONS = 100


def device_peak(run) -> int:
    """Bytes the caching allocator held at most while ``run()`` ran,
    above what it held before (``torch.cuda.max_memory_allocated``)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a0 = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - a0


def mesh_route_peak(host, op: str, header: dict) -> int:
    """The device peak of one request of ``op`` on a fresh generation of
    the host graph ``host``, imported as the daemon imports it (the
    snapshot unplaced), through the server's own dispatch: the mesh
    routes' sharded variant, placed by ``ensure_sharded``, and the
    loop's temporaries."""
    from memgraph_tpu_torch.ops.delta import ResidentGraph
    from memgraph_tpu_torch.server import kernel_server as ks
    srv = ks.KernelServer(os.devnull, device="cuda",
                          hbm_budget_bytes=1 << 50)
    srv._graphs.put(ResidentGraph("footprint", 1, host, device=srv.device))
    box = {}

    def run():
        box["reply"], _ = srv._dispatch_op(op, {
            "graph_key": "footprint", "graph_version": 1,
            "n_nodes": host.n_nodes, **header}, {})

    peak = device_peak(run)
    check(box["reply"].get("ok") and srv._graphs.peek(
        "footprint")._graph.device is None,
          f"the {op} request's footprint run failed or placed the "
          f"snapshot: {box['reply']}")
    return peak


def footprint_lines(base: dict) -> list:
    """Each resident algorithm's device peak, one cold run on a freshly
    placed graph (its arrays, the MXU route's placed routes, the run's
    temporaries), and each mesh route's (``pagerank_op``: the daemon's
    ``pagerank`` op; ``bfs``: ``semiring``'s) on a fresh unplaced
    generation (``mesh_route_peak``), at the segment graph and the north
    star, beside the kernel server's admission estimate.  The north
    star's fresh graph gets v0's host plan with nothing placed: no second
    plan build, the same bytes on the card."""
    import torch
    from memgraph_tpu_torch.northstar import N_NODES, generate_graph
    from memgraph_tpu_torch.ops import pagerank as PR
    from memgraph_tpu_torch.ops.csr import from_coo
    from memgraph_tpu_torch.server import kernel_server as ks

    sizes = {"segment": (from_coo(*generate_graph(SEGMENT_NODES,
                                                  SEGMENT_EDGES),
                                  n_nodes=SEGMENT_NODES), None),
             "north_star": (from_coo(base["src"], base["dst"],
                                     n_nodes=N_NODES),
                            base["graph"]._mxu_state)}
    lines = []
    for label, (host, state) in sizes.items():
        n, e = host.n_nodes, host.n_edges
        runs = {a: {"algorithm": a} for a in ("pagerank", "katz", "wcc",
                                              "labelprop")}
        runs["katz"]["alpha"] = KATZ_ALPHA
        runs.update({f"ppr_{b}": {"lanes": b} for b in KS_PPR_LANES})
        mesh = {"pagerank_op": ("pagerank", {}),
                "bfs": ("semiring", {"algorithm": "bfs", "source": 0})}
        n_pad, e_pad = ks._padded_graph_dims(n, e)

        def line(name, peak, est):
            return {"graph": label, "algorithm": name, "n_pad": n_pad,
                    "e_pad": e_pad, "peak_bytes": peak,
                    "estimate_bytes": est,
                    "estimate_over_peak": est / max(peak, 1)}

        for name, header in runs.items():

            def run():
                g = host.to_device("cuda")
                if state is not None:
                    object.__setattr__(g, "_mxu_state", {
                        "plan": state["plan"], "plan_build_s": 0.0,
                        "runs": {}, "placed": {},
                        "semiring": PR._semiring_cache(),
                        "lock": PR._build_lock(g)})
                if "lanes" in header:
                    PR.personalized_pagerank_batch(
                        g, [[i] for i in range(header["lanes"])], raw=True)
                else:
                    ks.run_algorithm(g, header["algorithm"], header,
                                     device="cuda")

            peak = device_peak(run)
            if "lanes" in header:
                est = (ks._graph_footprint_bytes("ppr", n, e)
                       + ks._lane_state_bytes(n, e, header["lanes"]))
            else:
                est = ks._graph_footprint_bytes(name, n, e,
                                                torch.device("cuda"))
            lines.append(line(name, peak, est))
        for name, (op, header) in mesh.items():
            lines.append(line(name, mesh_route_peak(host, op, header),
                              ks._graph_footprint_bytes(
                                  header.get("algorithm", "pagerank"), n, e,
                                  torch.device("cuda"), op)))
    torch.cuda.empty_cache()
    return lines


def ppr_reference64(src, dst, n_nodes, sources_list, iterations=ITERATIONS,
                    damping=DAMPING, device="cuda") -> np.ndarray:
    """``reference_ppr`` of each source set at once, in float64 on
    ``device`` (a sparse CSR product a step: scipy's arithmetic in
    seconds for 18 sets on the north star): (n, sets) float64 on the
    host."""
    import torch
    dev = torch.device(device)
    src_t = torch.as_tensor(np.asarray(src, dtype=np.int64), device=dev)
    dst_t = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=dev)
    deg = torch.bincount(src_t, minlength=n_nodes).to(torch.float64)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                          torch.zeros_like(deg))
    mat = torch.sparse_coo_tensor(torch.stack([dst_t, src_t]),
                                  inv_deg[src_t], (n_nodes, n_nodes))
    mat = mat.coalesce().to_sparse_csr()
    dangling = deg == 0
    p = torch.zeros(n_nodes, len(sources_list), dtype=torch.float64,
                    device=dev)
    for j, sources in enumerate(sources_list):
        p[torch.as_tensor(np.asarray(sources, dtype=np.int64),
                          device=dev), j] = 1.0
    p /= p.sum(dim=0)
    x = p.clone()
    for _ in range(iterations):
        x = (1 - damping) * p + damping * (mat @ x + x[dangling].sum(dim=0)
                                           * p)
    return x.cpu().numpy()


def phase_kernel_server(base: dict):
    """The resident kernel server on the card (``kernel_server`` line):
    each algorithm's device peak against its admission estimate (in this
    process, before the spawn); then the daemon, spawned on the card
    once this process has built the kernels, serves the north star v0 by
    the procedures' key: ``pagerank.get`` and ``pagerank.personalized``
    through ``kernel=`` equal to the in-process answers; the ``pagerank``
    op at 50 iterations, tol 0, within the main path's bounds of float64
    (bit-equality to this process's run printed) and a key-only repeat a
    hit with the same bytes; 256 single-source PPR requests from 16
    threads (top 10), 32 of them, cold, repeated for their full vectors:
    hits, bit-equal to in-process runs; an out-of-range member answered
    invalid beside completed batchmates, an oversized request shed; a
    commit of 1,000 added edges (seed 17) shipped as the delta payload:
    the generation moves O(delta), its snapshot through a DeltaPlan (no
    full plan build in the daemon), the warm PageRank in fewer
    iterations than cold and within ``pagerank.get``'s bound of float64,
    every cached source whose neighbourhood the commit touched warm (two
    held to float64), and so is any whose mass on the changed nodes could
    move it past the PPR bound (``kernel_server.PPR_HIT_BOUND``); the
    others hits, up to 16 of them held to float64 on the new graph
    within ``PPR_REL_TOL`` (the delta rides a predicted hit, else a warm
    request); a one-edge commit inside one source's neighbourhood,
    shipped on a request the cache answers (a hit the drift rule
    predicts), moves the generation and warms that source, the others
    hits or warm by the mass rule, 16 of the hits held to float64 on the
    new graph.  The daemon's launches come home on its health reply."""
    import tempfile
    import torch
    from memgraph_tpu_torch.server import kernel_server as ks

    check(base["source"].version == base["v0_version"],
          "the source moved before the phase")
    t0 = time.perf_counter()
    footprints = footprint_lines(base)
    footprint_s = time.perf_counter() - t0
    # the daemon shares the card: hand back the allocator's cached blocks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"kernel_server_memory free_bytes {free} total_bytes {total} "
          f"allocated_bytes {torch.cuda.memory_allocated()}", flush=True)

    sock = os.path.join(tempfile.mkdtemp(prefix="mgks"), "ks.sock")
    t0 = time.perf_counter()
    try:
        client = ks.ensure_server(sock, spawn_timeout_s=KS_TIMEOUT,
                                  idle_timeout_s=KS_TIMEOUT, device="cuda")
    except RuntimeError as e:
        fail(f"the kernel server did not start: {e}")
    if client is None:
        print(ks.log_tail(sock), file=sys.stderr, flush=True)
        fail("the kernel server did not answer within its spawn timeout")
    spawn_s = time.perf_counter() - t0
    check(client.process is not None, "a daemon of another process "
                                      "answered on the phase's socket")
    client.settimeout(KS_TIMEOUT)
    try:
        summary = drive_kernel_server(base, client, sock)
    finally:
        client.shutdown()
        client.close()
        try:
            client.process.wait(timeout=60)
        except subprocess.TimeoutExpired:
            client.process.kill()
            client.process.wait()
    summary.update(spawn_s=spawn_s, footprint_s=footprint_s,
                   footprints=footprints)
    print("kernel_server", json.dumps(summary), flush=True)
    for ln in footprints:
        lo, hi = KS_FOOTPRINT_RANGE
        check(lo <= ln["estimate_over_peak"] <= hi,
              f"admission estimate of {ln['algorithm']} on the "
              f"{ln['graph']} graph is {ln['estimate_over_peak']:.3f} x "
              f"its measured peak, outside [{lo}, {hi}]")
    torch.cuda.empty_cache()
    return summary["launches"]


def drive_kernel_server(base, client, sock) -> dict:
    """The daemon's checks of ``phase_kernel_server``; its summary."""
    import threading
    from memgraph_tpu_torch.ops.csr import shard_edges
    from memgraph_tpu_torch.ops.delta import LocalWarmPool, incident_edges
    from memgraph_tpu_torch.ops.pagerank import personalized_pagerank
    from memgraph_tpu_torch.parallel.distributed import \
        pagerank_partition_centric
    from memgraph_tpu_torch.parallel.mesh import get_mesh_context
    from memgraph_tpu_torch.procedures import graph_algorithms as P
    from memgraph_tpu_torch.server import kernel_server as ks
    from memgraph_tpu_torch.utils.metrics import global_metrics

    source, cache, graph = base["source"], base["cache"], base["graph"]
    n = graph.n_nodes
    v0 = source.version
    src0, dst0, w0 = (np.asarray(a) for a in graph.host_coo)
    key = P._graph_key(source, "analytics")
    h0 = client.health()
    kw = {"cache": cache, "device": "cuda"}
    routed = global_metrics.value("analytics.kernel_routed_total")
    fallbacks = global_metrics.value("analytics.kernel_route_fallback_total")

    # the procedures' route at v0: the first call ships the edges
    def timed_call(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    got_pr, first_s = timed_call(
        lambda: P.pagerank_get(source, kernel=sock, **kw))
    # the daemon's pagerank is the mesh's partition-centric loop over a
    # mesh of 1: held bit for bit to that loop run here on the same
    # snapshot, and within pagerank.get's L1 bound of its in-process call
    ctx1 = get_mesh_context(1)
    scsr1 = shard_edges(src0, dst0, w0, n, 1).to_device(ctx1)
    mesh_pr, _, _ = pagerank_partition_centric(
        scsr1, ctx1, damping=DAMPING, max_iterations=100, tol=PR_PROC_TOL)
    want_pr = P._rows(graph, rank=mesh_pr.cpu().numpy())
    inproc_pr = P.pagerank_get(source, pool=LocalWarmPool(), **kw)
    proc_l1 = float(np.abs(got_pr["rank"].astype(np.float64)
                           - inproc_pr["rank"]).sum())
    check(proc_l1 <= 10 * PR_PROC_TOL,
          f"routed pagerank.get off the in-process call by L1 {proc_l1}")
    ppr_gids = [int(g) for g in graph.node_gids[[3, n // 3, n - 7]]]
    got_ppr, ppr_first_s = timed_call(
        lambda: P.pagerank_personalized(source, ppr_gids, kernel=sock, **kw))
    want_ppr = P.pagerank_personalized(source, ppr_gids, **kw)
    check(global_metrics.value("analytics.kernel_routed_total")
          == routed + 2 and global_metrics.value(
              "analytics.kernel_route_fallback_total") == fallbacks,
          "the procedures' calls did not both take the kernel route")
    proc_equal = {"pagerank.get": got_pr["rank"].tobytes()
                  == want_pr["rank"].tobytes(),
                  "pagerank.personalized": got_ppr["rank"].tobytes()
                  == want_ppr["rank"].tobytes()}
    check(all(proc_equal.values()),
          f"routed procedures differ from in-process: {proc_equal}")

    # the pagerank op on v0: the main path's run, then a key-only repeat
    op = {"graph_key": key, "graph_version": v0, "n_nodes": n}
    (h, out), cold_s = timed_call(lambda: client.call_pagerank(
        **op, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0))
    ranks = out["ranks"]
    check(ranks.shape == (n,) and bool(np.isfinite(ranks).all())
          and h["iters"] == ITERATIONS and h["tier"] == "resident",
          f"pagerank op reply {h}")
    ref = base["ref"]
    a = ranks.astype(np.float64)
    vs64 = {"max_rel": float((np.abs(a - ref) / ref).max()),
            "l1": float(np.abs(a - ref).sum()),
            "top100": len(set(np.argsort(-a)[:100])
                          & set(np.argsort(-ref)[:100]))}
    check(vs64["max_rel"] <= F32_REL_TOL and vs64["l1"] <= F32_L1_TOL
          and vs64["top100"] == 100,
          f"the pagerank op's ranks off float64: {vs64}")
    mesh_ranks, _, _ = pagerank_partition_centric(
        scsr1, ctx1, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0)
    bit_equal = ranks.tobytes() == mesh_ranks.cpu().numpy().tobytes()
    check(bit_equal, "the pagerank op's ranks are not this process's "
                     "partition-centric run on a mesh of 1, bit for bit")
    del scsr1
    (h2, out2), hit_s = timed_call(lambda: client.call_pagerank(
        **op, damping=DAMPING, max_iterations=ITERATIONS, tol=0.0))
    check(h2.get("cache") == "hit"
          and out2["ranks"].tobytes() == ranks.tobytes(),
          "a key-only repeat was not a hit with the same bytes")
    (hc, _), cold_tol_s = timed_call(lambda: client.call_pagerank(
        **op, tol=KS_PR_TOL))

    # the PPR burst: 256 single-source requests from 16 threads, top 10
    rng = np.random.default_rng(KS_SEED)
    sources = rng.choice(n, KS_REQUESTS, replace=False)
    replies, latencies, errors = {}, {}, []
    ppr_kw = {"graph_key": key, "n_nodes": n, "tol": PPR_TOL,
              "max_iterations": PPR_MAX_ITERATIONS}

    def burst(version, top_k):
        out, lat = {}, {}
        barrier = threading.Barrier(KS_THREADS)

        def worker(t):
            c = ks.KernelClient(sock, timeout=KS_TIMEOUT)
            try:
                barrier.wait(timeout=KS_TIMEOUT)
                for s in sources[t::KS_THREADS]:
                    t0 = time.perf_counter()
                    out[int(s)] = c.ppr([int(s)], graph_version=version,
                                        top_k=top_k, **ppr_kw)
                    lat[int(s)] = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(KS_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=KS_TIMEOUT)
        wall = time.perf_counter() - t0
        check(not errors and len(out) == KS_REQUESTS,
              f"the PPR burst failed: {errors[:3]}")
        ms = np.asarray(list(lat.values())) * 1e3
        stats = {"requests_per_s": KS_REQUESTS / wall, "wall_s": wall,
                 "p50_ms": float(np.percentile(ms, 50)),
                 "p99_ms": float(np.percentile(ms, 99)),
                 "cache": {k: sum(1 for h, _ in out.values()
                                  if h["cache"] == k)
                           for k in ("miss", "warm", "hit")}}
        return out, stats

    health_before_burst = client.health()["counters"]
    replies, burst_stats = burst(v0, KS_TOPK)
    health_after_burst = client.health()["counters"]

    def counter_delta(name, after, before):
        return after.get(name, 0.0) - before.get(name, 0.0)

    batches = counter_delta("ppr.batch_size.count", health_after_burst,
                            health_before_burst)
    members = counter_delta("ppr.batch_size.sum", health_after_burst,
                            health_before_burst)
    drain_s = counter_delta("ppr.drain_s.sum", health_after_burst,
                            health_before_burst)
    neigh_s = counter_delta("ppr.neighborhood_s.sum", health_after_burst,
                            health_before_burst)
    burst_stats.update(mean_batch=members / max(batches, 1),
                       batches=batches, drain_s=drain_s,
                       neighborhood_s=neigh_s,
                       neighborhood_share=neigh_s / max(drain_s, 1e-12))
    check(burst_stats["cache"]["miss"] == KS_REQUESTS,
          f"first burst not all cold: {burst_stats['cache']}")
    sample = rng.choice(sources, KS_SAMPLED, replace=False)
    sampled_equal = 0
    full = {}                  # the sampled sources' cached v0 vectors
    for s in sample:
        h, out = client.ppr([int(s)], graph_version=v0, **ppr_kw)
        check(h["cache"] == "hit", f"the repeat of source {s} was no hit")
        full[int(s)] = out["ranks"]
        want, _, iters = personalized_pagerank(
            graph, [int(s)], tol=PPR_TOL, max_iterations=PPR_MAX_ITERATIONS)
        want = want.cpu().numpy()
        equal = out["ranks"].tobytes() == want.tobytes() \
            and h["iters"] == int(iters)
        top = replies[int(s)][1]
        equal = equal and np.array_equal(
            top["topk_idx"], np.argsort(-want, kind="stable")[:KS_TOPK])
        sampled_equal += int(equal)
    check(sampled_equal == KS_SAMPLED,
          f"{KS_SAMPLED - sampled_equal} of {KS_SAMPLED} sampled cold PPR "
          f"replies differ from in-process runs")

    # typed answers: one out-of-range member among batchmates; a shed
    good = [int(s) for s in sources[:3]]
    mixed, errs = {}, []
    barrier = threading.Barrier(4)

    def member(s):
        c = ks.KernelClient(sock, timeout=KS_TIMEOUT)
        try:
            barrier.wait(timeout=KS_TIMEOUT)
            mixed[s] = ("ok", c.ppr([s], graph_version=v0, **{
                **ppr_kw, "tol": PPR_TOL / 2}))
        except ks.KernelServerError as e:
            mixed[s] = ("typed", e)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e))
        finally:
            c.close()

    threads = [threading.Thread(target=member, args=(s,))
               for s in good + [n + 5]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=KS_TIMEOUT)
    check(not errs and mixed.get(n + 5, ("",))[0] == "typed"
          and mixed[n + 5][1].outcome == "invalid"
          and all(mixed.get(s, ("",))[0] == "ok"
                  and mixed[s][1][0]["outcome"] == "completed"
                  for s in good),
          f"an invalid member disturbed its batch: {mixed} {errs}")
    try:
        client.ppr([1], graph_key="oversized", n_nodes=1 << 40)
        shed = None
    except ks.KernelServerError as e:
        shed = e.outcome
    check(shed == "shed", f"an oversized request was answered {shed}")

    # a commit of 1,000 added edges (the warm_pool phase's seed 17),
    # shipped as the delta payload
    from memgraph_tpu_torch.northstar import N_NODES
    rng = np.random.default_rng(WARM_ADD_SEED)
    add_src = rng.integers(0, N_NODES, WARM_MOVES)
    add_dst = (rng.random(WARM_MOVES) ** 2 * N_NODES).astype(np.int64)
    src1 = np.concatenate([src0.astype(np.int64), add_src])
    dst1 = np.concatenate([dst0.astype(np.int64), add_dst])
    w1 = np.concatenate([w0, np.ones(WARM_MOVES, np.float32)])
    changed = np.unique(np.concatenate([add_src, add_dst]))
    bitmap = np.zeros(n, dtype=bool)
    bitmap[changed] = True
    inc = incident_edges(src1, dst1, w1, bitmap)
    payload = {"changed": changed, "inc_src": inc[0], "inc_dst": inc[1],
               "inc_w": inc[2]}
    v1 = v0 + 1
    before = client.health()
    plans = before["plans"]
    (hw, outw), warm_s = timed_call(lambda: client.call_pagerank(
        graph_key=key, graph_version=v1, base_version=v0, n_nodes=n,
        tol=KS_PR_TOL, **payload))
    after = client.health()

    def moved(name):
        return after["counters"].get(name, 0.0) \
            - before["counters"].get(name, 0.0)

    # the generation's sharded variant moved by apply_edge_delta (no
    # re-shard, no compaction) and the warm run built no plan
    check(after["plans"] == plans and moved("delta.applied_total") == 1
          and moved("delta.resharded_total") == 0
          and moved("delta.compacted_total") == 0,
          f"the commit was not an O(delta) apply: plans {plans} -> "
          f"{after['plans']}, delta counters {after['counters']}")
    check(hw["warm_started"] and hw["graph_version"] == v1
          and hw["iters"] < hc["iters"],
          f"warm pagerank op {hw} not shorter than cold {hc}")
    ref1 = reference_pagerank(src1, dst1, n, iterations=KS_REF_ITERATIONS)
    warm_l1 = float(np.abs(outw["ranks"].astype(np.float64) - ref1).sum())
    check(warm_l1 <= PR_PROC_L1,
          f"warm pagerank op off float64 by L1 {warm_l1} > {PR_PROC_L1}")
    counters = after["counters"]

    def neighbourhoods(s_arr, d_arr):
        """Each burst source and its out-neighbours."""
        sel = np.isin(s_arr, sources)
        out = {int(s): {int(s)} for s in sources}
        for a, b in zip(s_arr[sel].tolist(), d_arr[sel].tolist()):
            out[a].add(b)
        return out

    def carried(r, *changes) -> bool:
        """Whether a cached vector ``r`` (fresh: no drift yet) stays a hit
        across the change sets ``changes`` in turn: the daemon's drift
        rule (``_PprCacheEntry.carries_over``) replayed on the same
        vector."""
        drift = 0.0
        for ids in changes:
            ids = np.unique(np.asarray(ids, dtype=np.int64))
            mass = float(np.sum(r[ids[ids < len(r)]], dtype=np.float64))
            drift = drift + 2.0 * DAMPING / (1.0 - DAMPING) * (mass + drift)
            if drift > ks.PPR_HIT_BOUND * float(r.max()):
                return False
        return True

    def stays_hot(nb, r, *changes) -> bool:
        """The daemon's whole rule on an entry fresh before ``changes``
        (neighbourhood ``nb``, vector ``r``): no change meets a bounded
        neighbourhood, and the drift stays within the bound."""
        return len(nb) <= ks.PPR_NEIGH_CAP and not any(
            nb & set(np.asarray(c).tolist()) for c in changes) \
            and carried(r, *changes)

    def ship(hot, version, base_version, delta, cache="hit"):
        """The commit's delta payload, on one request of a burst source
        (a client ships it once; later requests are key-only): a hit
        where the commit leaves the source's vector within the bound,
        which moves the generation before it is answered, else a warm
        recomputation."""
        h, _ = client.ppr([hot], graph_version=version,
                          base_version=base_version, top_k=KS_TOPK,
                          **ppr_kw, **delta)
        check(h["outcome"] == "completed" and h["cache"] == cache,
              f"the delta's request for source {hot}: {h}, not {cache}")

    neigh0 = neighbourhoods(src0, dst0)
    expect_warm = {s for s, nb in neigh0.items() if nb & set(
        changed.tolist())}
    # 1,000 changed nodes hold more than the bound's mass of most sources'
    # vectors: the delta rides a hit only where one is predicted
    hot = [s for s in sorted(full) if stays_hot(neigh0[s], full[s], changed)]
    shipped = hot[0] if hot else int(sample[0])
    ship(shipped, v1, v0, payload, "hit" if hot else "warm")
    replies1, burst1 = burst(v1, KS_TOPK)
    got_warm = {s for s, (h, _) in replies1.items() if h["cache"] == "warm"}
    got_hit = {s for s, (h, _) in replies1.items() if h["cache"] == "hit"}
    # the shipped source was answered at v1 already: a hit in the burst
    check(expect_warm - {shipped} <= got_warm and shipped in got_hit
          and got_hit == set(neigh0) - got_warm,
          f"after the commit: {len(got_warm)} warm, at least "
          f"{len(expect_warm)} expected; {len(got_hit)} hits")
    # the sampled sources, whose cached v0 vectors this process holds:
    # warm exactly where the rule replayed on them says so
    others = sorted(set(full) - {shipped})
    want_warm1 = {s for s in others
                  if not stays_hot(neigh0[s], full[s], changed)}
    check(want_warm1 == got_warm & set(others),
          f"after the commit, sampled sources warm "
          f"{sorted(got_warm & set(others))}, the rule says "
          f"{sorted(want_warm1)}")
    # the warm replies held to float64 on v1; so are hits (v0's vectors,
    # kept because the commit missed their neighbourhoods and moved them
    # by at most the bound)
    held = sorted(expect_warm)[:KS_HELD_WARM]
    held_hits = sorted(int(s) for s in rng.choice(
        sorted(got_hit), min(KS_HELD_HITS, len(got_hit)), replace=False))
    refs = ppr_reference64(src1, dst1, n, [[s] for s in held + held_hits],
                           iterations=PPR_MAX_ITERATIONS)
    rel = {}
    for s, r64 in zip(held + held_hits, refs.T):
        h, out = client.ppr([s], graph_version=v1, **ppr_kw)
        check(h["cache"] == "hit", f"source {s} repeat at v1 no hit")
        rel[s] = float(np.abs(out["ranks"] - r64).max() / r64.max())
    warm_err = [rel[s] for s in held]
    check(all(e <= PPR_REL_TOL for e in warm_err),
          f"warm PPR replies off float64: {warm_err}")
    hit_err = [rel[s] for s in held_hits]
    check(all(e <= PPR_REL_TOL for e in hit_err),
          f"PPR hits after the commit off float64 on the new graph: "
          f"{hit_err}")

    # a one-edge commit inside one source's neighbourhood: that source
    # warm, every other hit
    neigh1 = neighbourhoods(src1, dst1)
    covered = set().union(*neigh1.values())
    s0 = next(s for s in (int(x) for x in sources)
              if all(s not in nb for t, nb in neigh1.items() if t != s))
    t_node = next(int(x) for x in rng.permutation(n) if int(x) not in covered)
    src2 = np.concatenate([src1, [s0]])
    dst2 = np.concatenate([dst1, [t_node]])
    w2 = np.concatenate([w1, np.ones(1, np.float32)])
    bitmap[:] = False
    bitmap[[s0, t_node]] = True
    inc2 = incident_edges(src2, dst2, w2, bitmap)
    # the sampled sources recomputed at v1 (no drift): their v1 vectors
    recomputed = (set(full) & got_warm) | (set() if hot else {shipped})
    full1 = {}
    for s in sorted(recomputed):
        h, out = client.ppr([s], graph_version=v1, **ppr_kw)
        check(h["cache"] == "hit", f"source {s} repeat at v1 no hit")
        full1[s] = out["ranks"]
    hot = [s for s in sorted(full1)
           if s != s0 and not neigh1[s] & {s0, t_node}
           and carried(full1[s], [s0, t_node])]
    check(bool(hot), "no sampled source stays a hit across the one-edge "
                     f"commit ({len(full1)} predicted)")
    ship(hot[0], v1 + 1, v1,
         {"changed": np.asarray([s0, t_node]), "inc_src": inc2[0],
          "inc_dst": inc2[1], "inc_w": inc2[2]})
    replies2, burst2 = burst(v1 + 1, KS_TOPK)
    got_warm2 = [s for s, (h, _) in replies2.items() if h["cache"] == "warm"]
    check(s0 in got_warm2 and 0 < burst2["cache"]["hit"]
          == KS_REQUESTS - len(got_warm2),
          f"a commit in source {s0}'s neighbourhood warmed {got_warm2}")
    # the sampled sources again, exactly: an entry recomputed at v1 is
    # fresh there; one carried across the first commit keeps its v0
    # vector, its v0 neighbourhood and that commit's drift
    edge2 = [s0, t_node]
    others2 = sorted(set(full) - {hot[0]})
    want_warm2 = {s for s in others2 if not (
        stays_hot(neigh1[s], full1[s], edge2) if s in full1
        else stays_hot(neigh0[s], full[s], changed, edge2))}
    check(want_warm2 == set(got_warm2) & set(others2),
          f"after the one-edge commit, sampled sources warm "
          f"{sorted(set(got_warm2) & set(others2))}, the rule says "
          f"{sorted(want_warm2)}")
    # the hits after it (vectors carried across the commit) held to
    # float64 on the new graph
    hits2 = sorted(s for s, (h, _) in replies2.items() if h["cache"] == "hit")
    held2 = sorted(int(s) for s in rng.choice(
        hits2, min(KS_HELD_HITS, len(hits2)), replace=False))
    refs2 = ppr_reference64(src2, dst2, n, [[s] for s in held2],
                            iterations=PPR_MAX_ITERATIONS)
    hit_err2 = []
    for s, r64 in zip(held2, refs2.T):
        h, out = client.ppr([s], graph_version=v1 + 1, **ppr_kw)
        check(h["cache"] == "hit", f"source {s} repeat at v2 no hit")
        hit_err2.append(float(np.abs(out["ranks"] - r64).max() / r64.max()))
    check(all(e <= PPR_REL_TOL for e in hit_err2),
          f"PPR hits after the one-edge commit off float64: {hit_err2}")

    health = client.health()
    launches = {k: v - h0["launches"][k]
                for k, v in health["launches"].items()}
    check(all(launches[k] > 0 for k in ("csr_spmm_sum", "lane_sum")),
          f"the daemon's launches did not move: {launches}")
    hc_ = health["counters"]

    def mean(name):
        return hc_.get(f"{name}.sum", 0.0) / max(hc_.get(f"{name}.count", 0.0),
                                                 1.0)

    return {
        "n_nodes": n, "n_edges": int(graph.n_edges),
        "procedures": {"pagerank_get_first_s": first_s,
                       "pagerank_personalized_first_s": ppr_first_s,
                       "equal": proc_equal,
                       "pagerank_get_l1_vs_in_process": proc_l1},
        "pagerank_op": {"cold_ms": cold_s * 1e3, "hit_ms": hit_s * 1e3,
                        "cold_tol_ms": cold_tol_s * 1e3,
                        "cold_tol_iters": hc["iters"],
                        "warm_ms": warm_s * 1e3, "warm_iters": hw["iters"],
                        "bit_equal_in_process": bit_equal,
                        "vs_float64": vs64, "warm_l1": warm_l1},
        "delta": {"apply_ms": mean("delta.apply_s") * 1e3,
                  "snapshot_ms": mean("delta.snapshot_s") * 1e3,
                  "changed": int(len(changed)),
                  "plans_before": plans, "plans_after": after["plans"]},
        "ppr": {"burst": burst_stats, "after_commit": burst1,
                "after_one_edge": burst2, "sampled_bit_equal": sampled_equal,
                "warm_vs_float64": warm_err, "warm_expected":
                len(expect_warm), "warm_by_mass": len(got_warm - expect_warm),
                "hits_vs_float64": hit_err,
                "one_edge_warm": len(got_warm2),
                "sampled_warm": [len(want_warm1), len(want_warm2)],
                "hits_after_one_edge_vs_float64": hit_err2,
                "hits_over_bound": sum(e > PPR_REL_TOL for e in hit_err),
                "one_edge_source": s0},
        "budget_bytes": health["hbm_budget_bytes"],
        "daemon_memory": health["memory"],
        "launches": launches, "counters": {
            k: v for k, v in hc_.items()
            if k.startswith(("kernel_server.dispatch.", "delta.", "ppr."))}}

MESH_SHARDS = 4             # shards of the multi-shard mesh, on one card
MESH_LP_ROUNDS = 5          # label propagation rounds held to one card's
MESH_SERVER_EVERY = 10      # the resumable server run's checkpoint interval
MESH_FAULT_HIT = 4          # device.lost at the third chunk of that run
MESH_MXU_PLAN_BUDGET_S = 45.0


def mesh_collective_ms(ctx, block: int) -> float:
    """CUDA-event ms of one PageRank collective of ``ctx``: the
    psum_scatter of every shard's (P, block + 2) payload (counted
    collectives, outside any run)."""
    import torch
    from memgraph_tpu_torch.parallel import mesh as M
    P = ctx.n_shards
    payloads = [torch.rand(P, block + 2, device=d) for d in ctx.devices]
    before = dict(M.collective_counts)
    ms = cuda_ms(lambda: M.psum_scatter(ctx, payloads), 50)
    M.collective_counts.update(before)
    return ms


def phase_mesh(base: dict):
    """The mesh (``mesh`` line, parallel/mesh.py, distributed.py,
    analytics.py, ops/spmv_mxu_sharded.py) on the north star v0: a mesh
    of 1 (``cuda:0``) and a mesh of ``MESH_SHARDS`` shards on the one card
    (``cuda:0`` four times; they share its HBM and SMs, so nothing here
    measures multi-card scaling).  On each: the placements timed;
    partition-centric PageRank at 50 iterations (tol -1), f32 (within the
    main path's bounds of float64) and bf16 (within PRECISION_BOUNDS of
    f32), katz (α = 0.05, 50 iterations) within 1e-4 of float64,
    WCC equal to scipy's components by minimum index, label propagation
    (5 rounds) equal to the single-card labels, SSSP within
    ``SSSP_REL_TOL`` of scipy's unweighted distances and BFS levels equal
    to them; exactly one collective an iteration or round; the K1 and K2
    launches of the path counted (set to 0 just before, read just after)
    and recorded K1 calls held to the plain version; ms an iteration (the
    slope between 5 and 50 iterations) beside the single-card segment
    route's on the same graph, and the collective's ms.  Two mesh-4 runs
    bit-equal.  The sharded MXU route on ``MESH_SHARDS`` shards: plan
    build seconds, placement, PageRank at 50 iterations (bf16 route, the
    reference's default, within PRECISION_BOUNDS of the f32 mesh ranks;
    f32 route within the main path's bounds of float64), its Benes
    gathers counted and held to their plain versions.  The resumable
    server run: an in-process kernel server with checkpoint_every=10
    serves the pagerank op at 50 iterations, then again with a
    device.lost at the third chunk: resumed once, 10 iterations redone,
    bit-equal to the unfaulted run."""
    import torch
    from memgraph_tpu_torch.ops import csr as C
    from memgraph_tpu_torch.ops import pagerank as PR
    from memgraph_tpu_torch.ops import segment_cuda as SC
    from memgraph_tpu_torch.ops import spmv_mxu_sharded as MS
    from memgraph_tpu_torch.ops.labelprop import label_propagation
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS
    from memgraph_tpu_torch.parallel import analytics as A
    from memgraph_tpu_torch.parallel import distributed as D
    from memgraph_tpu_torch.parallel import mesh as M
    from memgraph_tpu_torch.utils import faultinject as FI
    from memgraph_tpu_torch.utils.metrics import global_metrics

    graph, src, dst, ref = base["graph"], base["src"], base["dst"], \
        base["ref"]
    n = graph.n_nodes
    b16 = PRECISION_BOUNDS["bf16"]

    # the references: katz's and traversal's float64 / scipy answers on v0
    # (base["refs"]), the single card's labels
    refs = base["refs"]
    katz64, weak = refs["katz64"], refs["weak"]
    source, hops = refs["source"], refs["hops"]
    want_levels = np.where(np.isinf(hops), -1, hops).astype(np.int32)
    t0 = time.perf_counter()
    single_lp, _ = label_propagation(graph, max_iterations=MESH_LP_ROUNDS)
    refs_s = time.perf_counter() - t0

    def hold(name, ok, what):
        check(ok, f"mesh {name}: {what}")

    kinds = ("benes_mid", "benes_mid_gather", "benes_outer",
             "benes_outer_gather", "csr_spmm_sum", "lane_sum")
    path = dict.fromkeys(kinds, 0)
    out = {"n_nodes": n, "n_edges": int(graph.n_edges), "source": source,
           "references_s": refs_s, "meshes": {}}
    ranks4 = None
    for name, ctx in (("1", M.get_mesh_context(1)),
                      (str(MESH_SHARDS), M.get_mesh_context(
                          devices=("cuda:0",) * MESH_SHARDS))):
        line = {"devices": [str(d) for d in ctx.devices]}
        (scsr, line["place_src_s"]) = timed_run(
            lambda: C.shard_csr(graph, ctx, by="src"))
        (_, line["place_dst_doubled_s"]) = timed_run(
            lambda: C.shard_csr(graph, ctx, by="dst", doubled=True))
        line.update(block=scsr.block, per=scsr.per, n_pad2=scsr.n_pad2)
        secs, iters = {}, {}

        def run(tag, fn):
            res, secs[tag] = timed_run(fn)
            return res

        # the mesh path: counts set to 0 just before, read just after
        reset_all_counts()
        M.reset_collective_counts()
        r32, _, iters["pagerank_f32"] = run("pagerank_f32", lambda: (
            A.pagerank_mesh(graph, ctx, damping=DAMPING,
                            max_iterations=ITERATIONS, tol=-1.0)))
        r16, _, iters["pagerank_bf16"] = run("pagerank_bf16", lambda: (
            A.pagerank_mesh(graph, ctx, damping=DAMPING,
                            max_iterations=ITERATIONS, tol=-1.0,
                            precision="bf16")))
        kz, _, iters["katz"] = run("katz", lambda: A.katz_mesh(
            graph, ctx, alpha=KATZ_ALPHA, beta=KATZ_BETA,
            max_iterations=ITERATIONS, tol=-1.0))
        comp, iters["wcc"] = run("wcc", lambda: A.components_mesh(
            graph, ctx))
        lp, iters["labelprop"] = run("labelprop", lambda: (
            A.label_propagation_mesh(graph, ctx,
                                     max_iterations=MESH_LP_ROUNDS)))
        dist, iters["sssp"] = run("sssp", lambda: A.sssp_mesh(
            graph, ctx, source))
        levels, iters["bfs"] = run("bfs", lambda: A.bfs_mesh(
            graph, ctx, source))
        launches = all_counts()
        coll = dict(M.collective_counts)
        for k in kinds:
            path[k] += launches[k]
        hold(name, launches["csr_spmm_sum"] > 0 and launches["lane_sum"] > 0,
             f"K1 / K2 not launched: {launches}")
        hold(name, iters["pagerank_f32"] == iters["pagerank_bf16"]
             == iters["katz"] == ITERATIONS, f"iterations {iters}")
        hold(name, coll == {"psum_scatter": 2 * ITERATIONS,
                            "psum": ITERATIONS,
                            "pmin": iters["wcc"] + iters["sssp"]
                            + iters["bfs"],
                            "pmax": 0, "all_gather": iters["labelprop"]},
             f"not one collective an iteration: {coll} for {iters}")
        a = r32.double().cpu().numpy()
        vs64 = {"max_rel": float((np.abs(a - ref) / ref).max()),
                "l1": float(np.abs(a - ref).sum())}
        hold(name, vs64["max_rel"] <= F32_REL_TOL
             and vs64["l1"] <= F32_L1_TOL, f"f32 ranks off float64 {vs64}")
        d16 = np.abs(r16.double().cpu().numpy() - a)
        bf16 = {"linf": float(d16.max()), "l1": float(d16.sum())}
        hold(name, bf16["linf"] <= b16["pagerank_linf"]
             and bf16["l1"] <= b16["pagerank_l1"], f"bf16 off f32 {bf16}")
        katz_rel = float((np.abs(kz.double().cpu().numpy() - katz64)
                          / katz64).max())
        hold(name, katz_rel <= F32_REL_TOL, f"katz off float64 {katz_rel}")
        hold(name, np.array_equal(comp, min_index_labels(weak)),
             "WCC labels are not scipy's components by minimum index")
        hold(name, np.array_equal(lp, single_lp),
             "labels differ from the single-card label propagation")
        reach = np.isfinite(hops)
        hold(name, np.array_equal(np.isfinite(dist), reach),
             "SSSP's unreachable set is not scipy's")
        pos = reach & (hops > 0)
        sssp_rel = float((np.abs(dist[pos] - hops[pos]) / hops[pos]).max())
        hold(name, sssp_rel <= SSSP_REL_TOL and dist[source] == 0.0,
             f"SSSP off scipy by {sssp_rel}")
        hold(name, np.array_equal(levels, want_levels),
             "BFS levels are not the unweighted shortest paths")
        # ms an iteration: the slope between warm runs of 5 and 50
        (_, t50) = timed_run(lambda: A.pagerank_mesh(
            graph, ctx, damping=DAMPING, max_iterations=ITERATIONS,
            tol=-1.0))
        (_, t5) = timed_run(lambda: A.pagerank_mesh(
            graph, ctx, damping=DAMPING, max_iterations=5, tol=-1.0))
        line.update(
            seconds=secs, iterations=iters, launches=launches,
            collectives=coll, vs_float64=vs64, bf16_vs_f32=bf16,
            katz_vs_float64=katz_rel, sssp_vs_scipy=sssp_rel,
            pagerank_ms_per_iteration=(t50 - t5) / (ITERATIONS - 5) * 1e3,
            collective_ms=mesh_collective_ms(ctx, scsr.block))
        if ctx.n_shards > 1:
            ranks4 = r32
            again, _, _ = A.pagerank_mesh(graph, ctx, damping=DAMPING,
                                          max_iterations=ITERATIONS, tol=-1.0)
            hold(name, again.cpu().numpy().tobytes()
                 == r32.cpu().numpy().tobytes(), "two runs differ")
            line["bit_equal_runs"] = True
            # a shard's K1 calls held to the plain version (2 iterations)
            with k1_recorded(D, lambda x, ptr, g, w, kw: (
                    "contrib" if kw.get("mul", "times") == "times"
                    else "wsum")) as calls:
                A.pagerank_mesh(graph, ctx, max_iterations=2, tol=-1.0)
            base["path_k1_lines"] += path_k1_lines(calls, "mesh")
            x = r32[:scsr.block].contiguous()
            m = (x > x.median()).to(torch.float32)
            hold(name, same_bits(SC.lane_sum(x, m=m),
                                 SC.lane_sum_reference(x, m=m)),
                 "K2 disagrees with its plain version on a shard's block")
        out["meshes"][name] = line
        object.__setattr__(graph, "_sharded_csr", {})
        del scsr
        torch.cuda.empty_cache()

    # the single-card segment route on the same graph, for its ms
    keep = PR.MXU_MIN_EDGES
    PR.MXU_MIN_EDGES = 1 << 62
    try:
        (_, s50) = timed_run(lambda: PR.pagerank(
            graph, damping=DAMPING, max_iterations=ITERATIONS, tol=-1.0))
        (_, s5) = timed_run(lambda: PR.pagerank(
            graph, damping=DAMPING, max_iterations=5, tol=-1.0))
    finally:
        PR.MXU_MIN_EDGES = keep
    out["segment_ms_per_iteration"] = (s50 - s5) / (ITERATIONS - 5) * 1e3

    # the sharded MXU route on MESH_SHARDS shards of the one card
    ctx = M.get_mesh_context(devices=("cuda:0",) * MESH_SHARDS)
    plan, plan_s = timed_run(lambda: MS.build_sharded_plan(
        src, dst, None, n, MESH_SHARDS))
    mxu = {"plan_s": plan_s, "net_log2": plan.net_log2, "R_G": plan.R_G,
           "C": plan.C, "node_net_log2": plan.node_net_log2,
           "over_plan_budget": plan_s > MESH_MXU_PLAN_BUDGET_S}
    reset_all_counts()
    (m16, _, it16), mxu["bf16_s"] = timed_run(lambda: MS.pagerank_mxu_sharded(
        src, dst, None, n, ctx, damping=DAMPING, max_iterations=ITERATIONS,
        tol=-1.0, plan=plan))
    mxu_launches = all_counts()
    run16 = plan._kernel_cache[(ctx.cache_key, None)]
    (m32, _, it32), mxu["f32_s"] = timed_run(lambda: MS.pagerank_mxu_sharded(
        src, dst, None, n, ctx, damping=DAMPING, max_iterations=ITERATIONS,
        tol=-1.0, plan=plan, route_dtype=torch.float32))
    for k in kinds:
        path[k] += all_counts()[k]
    mxu["placement_s"] = run16.placement_s
    hold("mxu", it16 == it32 == ITERATIONS, f"iterations {it16} / {it32}")
    from memgraph_tpu_torch.ops import benes_cuda as BC
    want = dict.fromkeys(kinds[:4], 0)
    for route in run16.routes:
        for k, v in BC.launches_per_placement(route[2]).items():
            want[k] += v
        for k, v in BC.launches_per_apply(route[2]).items():
            want[k] += ITERATIONS * v
    for route in run16.node_routes:
        for k, v in BC.launches_per_placement(route[2]).items():
            want[k] += v
        for k, v in BC.launches_per_apply(route[2]).items():
            want[k] += ITERATIONS * v
    got = {k: mxu_launches[k] for k in kinds[:4]}
    hold("mxu", got == want and got["benes_mid_gather"] > 0
         and got["benes_outer_gather"] > 0,
         f"Benes launches {got}, expected {want}")
    a = m32.double().cpu().numpy()
    vs64 = {"max_rel": float((np.abs(a - ref) / ref).max()),
            "l1": float(np.abs(a - ref).sum())}
    hold("mxu", vs64["max_rel"] <= F32_REL_TOL and vs64["l1"] <= F32_L1_TOL,
         f"f32 route off float64 {vs64}")
    d16 = np.abs(m16.double().cpu().numpy() - ranks4.double().cpu().numpy())
    mxu.update(vs_float64=vs64, bf16_vs_mesh_f32={
        "linf": float(d16.max()), "l1": float(d16.sum())},
        launches=got)
    hold("mxu", d16.max() <= b16["pagerank_linf"]
         and d16.sum() <= b16["pagerank_l1"],
         f"bf16 route off the f32 mesh ranks {mxu['bf16_vs_mesh_f32']}")
    (_, t5) = timed_run(lambda: MS.pagerank_mxu_sharded(
        src, dst, None, n, ctx, damping=DAMPING, max_iterations=5, tol=-1.0,
        plan=plan))
    (_, t50) = timed_run(lambda: MS.pagerank_mxu_sharded(
        src, dst, None, n, ctx, damping=DAMPING, max_iterations=ITERATIONS,
        tol=-1.0, plan=plan))
    mxu["bf16_ms_per_iteration"] = (t50 - t5) / (ITERATIONS - 5) * 1e3
    mxu["route_kernels"] = route_kernels(
        "mesh_shard0_edge_bf16", run16.routes[0], plan.masks_packed[0],
        torch.bfloat16)
    out["mxu_sharded"] = mxu
    del plan, run16
    torch.cuda.empty_cache()

    # the resumable server run: unfaulted, then a device.lost mid-run
    server = {}
    with served(checkpoint_every=MESH_SERVER_EVERY) as (_, client):
        kw = {"graph_key": "mesh", "n_nodes": n, "damping": DAMPING,
              "max_iterations": ITERATIONS}
        (h0, o0), server["cold_s"] = timed_run(lambda: client.call_pagerank(
            src=src, dst=dst, tol=-1.0, **kw))
        resumes = global_metrics.value("analytics.resume_total")
        redone = global_metrics.value("analytics.redone_iterations_total")
        FI.reset()
        FI.arm("device.lost", "raise", at=MESH_FAULT_HIT)
        try:
            # another tol (-2: the same 50 iterations) so that the stored
            # solution does not answer
            (h1, o1), server["faulted_s"] = timed_run(
                lambda: client.call_pagerank(tol=-2.0, **kw))
        finally:
            FI.reset()
        server.update(
            cold_iters=h0["iters"], faulted_iters=h1["iters"],
            resumes=global_metrics.value("analytics.resume_total") - resumes,
            redone_iterations=global_metrics.value(
                "analytics.redone_iterations_total") - redone,
            bit_equal=o0["ranks"].tobytes() == o1["ranks"].tobytes())
    hold("server", server["resumes"] == 1
         and server["redone_iterations"] == MESH_SERVER_EVERY
         and h0["iters"] == h1["iters"] == ITERATIONS and server["bit_equal"],
         f"the resumed run {server}")
    out["server"] = server
    out["launches"] = path
    print("mesh", json.dumps(out, default=float), flush=True)
    # the runs' closures hold placed rows in cycles: free them here, not
    # inside a later phase's peak measurement
    gc.collect()
    torch.cuda.empty_cache()
    return path


LANE_SEED = 53              # the lane's vertex properties and masks
LANE_LOOPS = 1_000          # self-loops planted in the lane's edge table
LANE_REPS = 5               # staged hop queries timed
LANE_CITIES = 50            # values of the string column
TIER_BUDGET = 256 << 20     # the tier phase's admission budget
TIER_SHED_BUDGET = 32 << 20
TIER_FOOTPRINT_RANGE = (1.0, 2.0)   # streamed estimate over measured peak
TIER_LOCAL_SEED = 59        # a commit of edges out of block 0's sources
TIER_LOCAL_MOVES = 10


@contextlib.contextmanager
def served(**kw):
    """A port KernelServer on the card in this process, serving a socket
    of its own from a thread; yields (server, client).  The client shuts
    it down on the way out."""
    import tempfile
    import threading
    from memgraph_tpu_torch.server import kernel_server as ks
    sock = os.path.join(tempfile.mkdtemp(prefix="mgks"), "ks.sock")
    srv = ks.KernelServer(sock, device="cuda", **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    client, deadline = None, time.monotonic() + 60
    while client is None and time.monotonic() < deadline:
        try:
            client = ks.KernelClient(sock, timeout=KS_TIMEOUT)
        except OSError:
            time.sleep(0.05)
    check(client is not None and client.ping(),
          "the in-process kernel server did not answer")
    try:
        yield srv, client
    finally:
        client.shutdown()
        client.close()
        thread.join(timeout=60)
        check(not thread.is_alive(), "the kernel server did not stop")


def lane_hops64(src, dst, emask, smask, midmask, tmask, n, hops,
                include_lower, edge_unique) -> dict:
    """The lane's path counts in int64 by scipy."""
    import scipy.sparse as sp
    s, d = src[emask], dst[emask]
    a = sp.csr_matrix((np.ones(len(s), np.int64), (d, s)), shape=(n, n))
    x0 = smask.astype(np.int64)
    mid, tm = midmask.astype(np.int64), tmask.astype(np.int64)
    x1 = a @ x0
    p = np.zeros(n, np.int64)
    if hops == 2:
        p2 = (a @ (x1 * mid)) * tm
        if edge_unique:
            lp = s == d
            sl = np.zeros(n, np.int64)
            np.add.at(sl, d[lp], (x0 * mid)[s[lp]])
            p2 -= sl * tm
        p += p2
    if hops == 1 or include_lower:
        p += x1 * tm
    return {"rows": int(p.sum()), "distinct": int((p > 0).sum())}


@contextlib.contextmanager
def counted_sorts():
    """torch.sort and torch.argsort counted while inside."""
    import torch
    seen = {"sort": 0, "argsort": 0}
    real = {k: getattr(torch, k) for k in seen}

    def counting(name):
        def run(*a, **k):
            seen[name] += 1
            return real[name](*a, **k)
        return run

    for k in seen:
        setattr(torch, k, counting(k))
    try:
        yield seen
    finally:
        for k, fn in real.items():
            setattr(torch, k, fn)


def phase_lane(base: dict):
    """The read lane (``lane`` line, ops/columnar.py and ops/
    pipeline.py) on the north star v0's edges: a CooSource of them with
    seeded vertex properties (``age`` in [0, 100), ``score`` over the
    int32 range with about 10% absent, ``city`` of 50 strings, ``flag``
    a bool), exported by ``columnar.export_columns`` (timed).  With the
    counts set to 0 just before and read just after: two masked
    aggregates (count, sum, min, max under two predicates) equal to
    numpy int64, and a sum whose absolute mass passes 2^30 refused
    ``precision_overflow``; hop counts at 1 and 2 hops (``include_lower``
    and not, ``edge_unique`` with 1,000 planted self-loops,
    ``need_distinct``) equal to a scipy int64 count, unstaged and on
    staged edges (a repeat query on staged edges calls no torch sort);
    top-k ASC and DESC with null keys equal to a numpy stable sort of the
    same f32 keys; the ``lane`` op of an in-process port kernel server,
    over its socket, equal to the in-process totals, and a refusal
    answered typed.  K1 must have launched.  Prints ms a query per
    program, staged and unstaged."""
    import torch
    from memgraph_tpu_torch.northstar import N_NODES, CooSource
    from memgraph_tpu_torch.ops import columnar as C
    from memgraph_tpu_torch.ops import pipeline as PL
    from memgraph_tpu_torch.ops import segment_cuda as SC

    n = N_NODES
    rng = np.random.default_rng(LANE_SEED)
    age = rng.integers(0, 100, n)
    score = rng.integers(-(2**31) + 1, 2**31 - 1, n).astype(object)
    score[rng.random(n) < 0.1] = None
    cities = np.array([f"city{k}" for k in range(LANE_CITIES)],
                      dtype=object)
    city = cities[rng.integers(0, LANE_CITIES, n)]
    flag = rng.random(n) < 0.5
    props = {"age": age, "score": score, "city": city, "flag": flag}
    source = CooSource(base["src"], base["dst"], n, properties=props)
    names = ("age", "score", "city", "flag")
    t0 = time.perf_counter()
    snap = C.export_columns(source, None, names)
    export_s = time.perf_counter() - t0
    kinds = {p: snap.columns[p].kind for p in names}
    check(kinds == {"age": "int", "score": "int", "city": "str",
                    "flag": "bool"}, f"the lane's column kinds: {kinds}")
    cols = [snap.columns[p] for p in names]
    vals = np.stack([PL.i32_column(c) for c in cols])
    present = np.stack([c.present for c in cols])
    check(int((~present[1]).sum()) == sum(v is None for v in score),
          "the score column's absent rows are not the source's")
    base_mask = np.ones(n, bool)
    code7 = snap.columns["city"].vocab["city7"]

    loops = rng.choice(n, LANE_LOOPS, replace=False).astype(np.int32)
    src = np.concatenate([base["src"].astype(np.int32), loops])
    dst = np.concatenate([base["dst"].astype(np.int32), loops])
    emask = rng.random(len(src)) < 0.9
    smask = age >= 90
    midmask = flag.astype(np.float32)
    tmask = present[1].astype(np.float32)
    hop_cases = [(1, False, True), (2, False, True), (2, True, True),
                 (2, False, False)]
    agg_cases = [
        (((0, ">="), (3, "=")), [30, 1],
         (("count", None), ("sum", 0), ("min", 1), ("max", 1),
          ("count", 1))),
        (((2, "="), (0, "<")), [code7, 50],
         (("count", None), ("sum", 0), ("min", 0), ("max", 0)))]
    ms, got = {}, {}

    def timed_ms(tag, fn, reps=LANE_REPS):
        """fn's answer, and its ms a call over ``reps`` more calls."""
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        ms[tag] = (time.perf_counter() - t0) / reps * 1e3
        return out

    # the lane's path: counts set to 0 just before, read just after
    reset_all_counts()
    for i, (preds, rhs, aggs) in enumerate(agg_cases):
        got[f"agg{i}"] = timed_ms(f"aggregate_{i}", lambda: PL.masked_aggregate(
            preds, aggs, vals, present, base_mask, rhs, device="cuda"))
    try:
        PL.masked_aggregate(((0, ">="),), (("sum", 1),), vals, present,
                            base_mask, [0], device="cuda")
        refused = None
    except PL.LaneRefused as e:
        refused = e.reason
    check(refused == "precision_overflow",
          f"a sum of mass past 2^30 was answered ({refused})")
    masks = (smask, midmask, tmask)
    for hops, low, uniq in hop_cases:
        kw = dict(hops=hops, include_lower=low, edge_unique=uniq,
                  need_rows=True, need_distinct=True)
        got[("raw", hops, low, uniq)] = timed_ms(
            f"hops{hops}_lower{int(low)}_unique{int(uniq)}_unstaged",
            lambda: PL.hop_counts(src, dst, emask, *masks, n,
                                  device="cuda", **kw))
    staged = timed_ms("stage_edges", lambda: PL.stage_edges(
        src, dst, emask, device="cuda"), reps=1)
    for hops, low, uniq in hop_cases:
        kw = dict(hops=hops, include_lower=low, edge_unique=uniq,
                  need_rows=True, need_distinct=True)
        got[("staged", hops, low, uniq)] = PL.hop_counts(
            staged, None, None, *masks, n, **kw)
    rep_kw = dict(hops=2, include_lower=False, edge_unique=True,
                  need_rows=True, need_distinct=True)
    k1_before = SC.csr_spmm_sum.launches
    with counted_sorts() as sorts:
        repeat = timed_ms("hops2_staged", lambda: PL.hop_counts(
            staged, None, None, *masks, n, **rep_kw))
    k1_repeat = (SC.csr_spmm_sum.launches - k1_before) / (LANE_REPS + 1)
    keyv, keyp = vals[1], present[1]
    for asc in (True, False):
        got[("topk", asc)] = timed_ms(
            f"topk_{'asc' if asc else 'desc'}", lambda: PL.masked_topk(
                ((0, "<"),), asc, vals, present, keyv, keyp, [50],
                device="cuda"))
    with served() as (_srv, client):
        remote = timed_ms("lane_op", lambda: client.lane_hops(
            src, dst, emask, *masks, n_nodes=n, **rep_kw), reps=2)
        over = (np.repeat(np.array([0, 1], np.int32), 5000),
                np.repeat(np.array([1, 2], np.int32), 5000),
                np.ones(10_000, bool), np.array([True, False, False]),
                np.ones(3, np.float32), np.ones(3, np.float32))
        try:
            client.lane_hops(*over, n_nodes=3, hops=2)
            remote_refused = None
        except PL.LaneRefused as e:
            remote_refused = e.reason
    launches = all_counts()
    check(launches["csr_spmm_sum"] > 0,
          f"the lane's path launched no K1: {launches}")
    check(k1_repeat == 3 and sorts == {"sort": 0, "argsort": 0},
          f"a staged repeat query launched {k1_repeat} K1 a query (3 "
          f"expected) and sorted {sorts}")
    check(remote_refused == "precision_overflow",
          f"the lane op's refusal came back as {remote_refused}")

    # the answers
    for i, (preds, rhs, aggs) in enumerate(agg_cases):
        sel = base_mask.copy()
        for (ci, op), r in zip(preds, rhs):
            cmp = {">=": np.greater_equal, "=": np.equal,
                   "<": np.less}[op]
            sel &= cmp(vals[ci].astype(np.int64), r) & present[ci]
        want = []
        for kind, ci in aggs:
            if ci is None:
                want.append(int(sel.sum()))
                continue
            s = sel & present[ci]
            v = vals[ci][s].astype(np.int64)
            want.append({"count": int(s.sum()), "sum": int(v.sum()),
                         "min": int(v.min()) if len(v) else None,
                         "max": int(v.max()) if len(v) else None}[kind])
        check(got[f"agg{i}"] == want,
              f"aggregate {i}: {got[f'agg{i}']} != numpy {want}")
    hop64 = {}
    for hops, low, uniq in hop_cases:
        want = lane_hops64(src, dst, emask, *masks, n, hops, low, uniq)
        hop64[f"{hops}/{int(low)}/{int(uniq)}"] = want
        for how in ("raw", "staged"):
            check(got[(how, hops, low, uniq)] == want,
                  f"{how} hop counts {hops}/{low}/{uniq}: "
                  f"{got[(how, hops, low, uniq)]} != scipy {want}")
    check(repeat == got[("staged", 2, False, True)] and remote == repeat,
          f"the lane op's totals {remote} differ from in-process {repeat}")
    for asc in (True, False):
        order, count = got[("topk", asc)]
        mask = (vals[0] < 50) & present[0]
        kf = keyv.astype(np.float32) * np.float32(1 if asc else -1)
        kf = np.where(keyp, kf, np.float32(3.0e38 if asc else -3.0e38))
        kf = np.where(mask, kf, np.float32(np.inf))
        check(count == int(mask.sum()) and np.array_equal(
            order, np.argsort(kf, kind="stable")),
              f"top-k {'ASC' if asc else 'DESC'} differs from numpy's "
              f"stable sort")
    summary = {"n_nodes": n, "n_edges": len(src), "export_s": export_s,
               "ms": ms, "k1_per_staged_query": k1_repeat,
               "aggregates": [got["agg0"], got["agg1"]],
               "hops": hop64, "remote": remote, "launches": launches}
    print("lane", json.dumps(summary), flush=True)
    return launches


def streamed_peak(run) -> int:
    """``device_peak`` of a streamed run (its blocks' host copies pinned
    before the measurement)."""
    run()
    return device_peak(run)


def phase_tier(base: dict):
    """The out-of-core tier (``tier`` line, ops/tier.py, parallel/
    streamed.py) on the north star v0: its paging plan at f32 (16 blocks
    of the uint16 codec), bf16 and int8 (the f32 plan's layout
    re-packed).  With the counts set to 0 just before and read just
    after: streamed f32 PageRank, 50 iterations, tol 0 (exactly 16 + 50 x
    16 K1 launches and 100 K2), bit-equal to its ``resident=True``
    comparator and within the main path's bounds of float64; katz (α =
    0.05, 50 iterations) bit-equal to its comparator and within 1e-4 of
    the largest float64 entry; WCC equal to its comparator and to
    scipy's partition; bf16 and int8 PageRank bit-equal to their
    comparators and within ``PRECISION_BOUNDS`` of f32.  Then, under an
    in-process kernel server with a 256 MiB budget, over its socket: a
    pagerank request (50 iterations, tol 0) answered ``streamed`` with
    the in-process bytes, a key-only repeat a hit; a cold run at tol
    1e-6; a commit of 1,000 added edges (seed 17) shipped as the delta
    payload: the generation's plan re-packs exactly the blocks the adds'
    sources own and reuses the rest, each block's edges equal a fresh
    ``plan_tier`` of the spliced COO, and the warm run starts from the
    previous ranks (fewer iterations than cold, within 1e-4 of float64's
    largest entry); the same request under a 32 MiB budget is shed.
    Each algorithm's streamed device peak against
    ``streamed_request_bytes`` within [1x, 2x].  Prints wire and raw
    bytes a sweep, H2D GB/s, the transfer's hidden share and ms an
    iteration streamed against the comparator."""
    import torch
    from scipy.sparse import csgraph
    from memgraph_tpu_torch.northstar import N_NODES
    from memgraph_tpu_torch.ops import tier as T
    from memgraph_tpu_torch.ops.delta import TIER_ROW_SLACK, incident_edges
    from memgraph_tpu_torch.ops.semiring import PRECISION_BOUNDS
    from memgraph_tpu_torch.parallel import streamed as ST
    from memgraph_tpu_torch.server import kernel_server as ks
    from memgraph_tpu_torch.utils.metrics import global_metrics

    n = N_NODES
    src0, dst0 = base["src"], base["dst"]
    e = len(src0)
    t0 = time.perf_counter()
    # the plan a generation of the kernel server keeps (room for commits)
    tiers = {"f32": T.plan_tier(src0, dst0, None, n, slack=TIER_ROW_SLACK)}
    plan_s = time.perf_counter() - t0
    for p in ("bf16", "int8"):
        tiers[p] = T.tier_from_scsr(tiers["f32"].scsr, p)
    t32 = tiers["f32"]
    check(t32.u16 and t32.n_blocks == T.plan_blocks(n, e),
          f"the f32 plan has {t32.n_blocks} blocks")
    kw = dict(max_iterations=ITERATIONS, tol=0.0, device="cuda")
    stats, runs, secs = {}, {}, {}

    def timed(tag, fn):
        runs[tag], secs[tag] = timed_run(fn)
        return runs[tag]

    # the tier's path: counts set to 0 just before, read just after
    reset_all_counts()
    stats["f32"] = {}
    timed("pagerank f32", lambda: ST.pagerank_streamed(
        t32, stats=stats["f32"], **kw))
    first = all_counts()
    per_run = {"csr_spmm_sum": t32.n_blocks * (1 + ITERATIONS),
               "lane_sum": 2 * ITERATIONS}
    check(all(first[k] == v for k, v in per_run.items()),
          f"streamed PageRank launched {first}, expected {per_run}")
    timed("pagerank f32 resident", lambda: ST.pagerank_streamed(
        t32, resident=True, **kw))
    for p in ("bf16", "int8"):
        stats[p] = {}
        timed(f"pagerank {p}", lambda: ST.pagerank_streamed(
            tiers[p], stats=stats[p], **kw))
        timed(f"pagerank {p} resident", lambda: ST.pagerank_streamed(
            tiers[p], resident=True, **kw))
    stats["katz"] = {}
    timed("katz", lambda: ST.katz_streamed(
        t32, alpha=KATZ_ALPHA, beta=KATZ_BETA, stats=stats["katz"], **kw))
    timed("katz resident", lambda: ST.katz_streamed(
        t32, alpha=KATZ_ALPHA, beta=KATZ_BETA, resident=True, **kw))
    stats["wcc"] = {}
    timed("wcc", lambda: ST.wcc_streamed(t32, stats=stats["wcc"],
                                         device="cuda"))
    timed("wcc resident", lambda: ST.wcc_streamed(t32, resident=True,
                                                  device="cuda"))

    # over the server: streamed, a hit, a commit's warm start, shed
    arrays = {"src": np.asarray(src0, np.int64),
              "dst": np.asarray(dst0, np.int64)}
    key = "tier-north-star"
    op = {"graph_key": key, "n_nodes": n}
    repacked0 = global_metrics.value("tier.blocks_repacked_total")
    reused0 = global_metrics.value("tier.blocks_reused_total")
    streamed0 = global_metrics.value("tier.admission_streamed_total")
    with served(hbm_budget_bytes=TIER_BUDGET) as (srv, client):
        (h_s, out_s), secs["server pagerank"] = timed_run(
            lambda: client.call_pagerank(
                src=arrays["src"], dst=arrays["dst"], graph_version=1,
                damping=DAMPING, max_iterations=ITERATIONS, tol=0.0, **op))
        h_hit, out_hit = client.call_pagerank(
            graph_version=1, damping=DAMPING, max_iterations=ITERATIONS,
            tol=0.0, **op)
        (h_c, _), secs["server cold"] = timed_run(
            lambda: client.call_pagerank(graph_version=1, tol=KS_PR_TOL,
                                         **op))
        gen = srv._graphs.peek(key)
        plan0 = gen.tiers[("f32", None)]
        rng = np.random.default_rng(WARM_ADD_SEED)
        add_src = rng.integers(0, n, WARM_MOVES)
        add_dst = (rng.random(WARM_MOVES) ** 2 * n).astype(np.int64)
        src1 = np.concatenate([arrays["src"], add_src])
        dst1 = np.concatenate([arrays["dst"], add_dst])
        w1 = np.ones(len(src1), np.float32)
        changed = np.unique(np.concatenate([add_src, add_dst]))
        bitmap = np.zeros(n, dtype=bool)
        bitmap[changed] = True
        inc = incident_edges(src1, dst1, w1, bitmap)
        (h_w, out_w), secs["server warm"] = timed_run(
            lambda: client.call_pagerank(
                graph_version=2, base_version=1, tol=KS_PR_TOL,
                changed=changed, inc_src=inc[0], inc_dst=inc[1],
                inc_w=inc[2], **op))
        plan1 = gen.tiers[("f32", None)]
        moved1 = {k: global_metrics.value(f"tier.blocks_{k}_total")
                  for k in ("repacked", "reused")}
        # a commit of edges out of block 0's sources: one block re-packed
        rl = np.random.default_rng(TIER_LOCAL_SEED)
        loc_src = rl.integers(0, plan1.block, TIER_LOCAL_MOVES)
        loc_dst = rl.integers(0, n, TIER_LOCAL_MOVES)
        src2 = np.concatenate([src1, loc_src])
        dst2 = np.concatenate([dst1, loc_dst])
        changed2 = np.unique(np.concatenate([loc_src, loc_dst]))
        bitmap = np.zeros(n, dtype=bool)
        bitmap[changed2] = True
        inc2 = incident_edges(src2, dst2, np.ones(len(src2), np.float32),
                              bitmap)
        h_l, _ = client.call_pagerank(
            graph_version=3, base_version=2, tol=KS_PR_TOL,
            changed=changed2, inc_src=inc2[0], inc_dst=inc2[1],
            inc_w=inc2[2], **op)
        plan2 = gen.tiers[("f32", None)]
        local = {k: global_metrics.value(f"tier.blocks_{k}_total")
                 - moved1[k] for k in ("repacked", "reused")}
        local["kept"] = [p for p in range(plan1.n_blocks)
                         if plan2.blocks[p] is plan1.blocks[p]]
    launches = all_counts()
    streamed_replies = global_metrics.value(
        "tier.admission_streamed_total") - streamed0
    with served(hbm_budget_bytes=TIER_SHED_BUDGET) as (_srv, client):
        try:
            client.call_pagerank(src=arrays["src"], dst=arrays["dst"],
                                 graph_version=1, max_iterations=ITERATIONS,
                                 tol=0.0, **op)
            shed = None
        except ks.KernelServerError as exc:
            shed = exc.outcome
    check(launches["csr_spmm_sum"] > 0 and launches["lane_sum"] > 0,
          f"the tier's path launched {launches}")

    # the answers
    ranks, _, it32 = runs["pagerank f32"]
    check(it32 == ITERATIONS and ranks.shape == (n,)
          and bool(np.isfinite(ranks).all()),
          f"streamed PageRank ran {it32} iterations")
    ref = base["ref"]
    a = ranks.astype(np.float64)
    vs64 = {"max_rel": float((np.abs(a - ref) / ref).max()),
            "l1": float(np.abs(a - ref).sum())}
    check(vs64["max_rel"] <= F32_REL_TOL and vs64["l1"] <= F32_L1_TOL,
          f"streamed PageRank off float64: {vs64}")
    bit_equal = {}
    for tag in ("pagerank f32", "pagerank bf16", "pagerank int8", "katz",
                "wcc"):
        s, r = runs[tag], runs[f"{tag} resident"]
        bit_equal[tag] = s[0].tobytes() == r[0].tobytes() and s[2] == r[2]
    check(all(bit_equal.values()),
          f"streamed differs from its resident comparator: {bit_equal}")
    reduced = {}
    for p in ("bf16", "int8"):
        d = np.abs(runs[f"pagerank {p}"][0] - ranks)
        reduced[p] = {"linf": float(d.max()), "l1": float(d.sum())}
        b = PRECISION_BOUNDS[p]
        check(reduced[p]["linf"] <= b["pagerank_linf"]
              and reduced[p]["l1"] <= b["pagerank_l1"],
              f"{p} streamed PageRank outside its bounds: {reduced[p]}")
    a_t = transposed_adjacency(src0, dst0, n)
    kref = reference_katz(a_t, KATZ_ALPHA)
    kref = kref / np.linalg.norm(kref)
    katz_err = float(np.abs(runs["katz"][0] - kref).max()
                     / np.abs(kref).max())
    check(runs["katz"][2] <= ITERATIONS and katz_err <= F32_REL_TOL,
          f"streamed katz off float64: {katz_err}")
    _, labels = csgraph.connected_components(a_t, directed=True,
                                             connection="weak")
    check(np.array_equal(min_index_labels(runs["wcc"][0]),
                         min_index_labels(labels)),
          "streamed WCC's partition differs from scipy's")

    check(h_s.get("tier") == "streamed" and streamed_replies >= 1
          and out_s["ranks"].tobytes() == ranks.tobytes(),
          f"the server's pagerank reply {h_s} is not the streamed bytes")
    check(h_hit.get("cache") == "hit"
          and out_hit["ranks"].tobytes() == ranks.tobytes(),
          "a key-only repeat was not a hit with the same bytes")
    check(shed == "shed", f"under {TIER_SHED_BUDGET} bytes the request "
                          f"was answered {shed}")
    touched = np.unique(add_src // plan0.block)
    kept = [p for p in range(plan0.n_blocks)
            if plan1.blocks[p] is plan0.blocks[p]]
    check(sorted(set(range(plan0.n_blocks)) - set(kept))
          == touched.tolist(),
          f"the commit re-packed blocks other than {touched.tolist()}")
    check(moved1["repacked"] - repacked0 == len(touched)
          and moved1["reused"] - reused0 == plan0.n_blocks - len(touched),
          f"the re-pack counters ({moved1}, from {repacked0} and "
          f"{reused0}) do not match the {len(touched)} touched blocks")
    check(h_l.get("tier") == "streamed" and h_l["warm_started"]
          and local == {"repacked": 1, "reused": plan1.n_blocks - 1,
                        "kept": list(range(1, plan1.n_blocks))},
          f"a commit out of block 0 re-packed {local} ({h_l})")
    fresh = T.plan_tier(src1, dst1, None, n, n_blocks=plan1.n_blocks)
    for p in range(plan1.n_blocks):
        rows = []
        for t in (plan1, fresh):
            rc = int(t.blocks[p].payload["rc"])
            rows.append((t.scsr.src[p][:rc], t.scsr.dst[p][:rc],
                         t.scsr.weights[p][:rc]))
        check(all(np.array_equal(x, y) for x, y in zip(*rows)),
              f"block {p} after the commit differs from a fresh plan's")
    ref1 = reference_pagerank(src1, dst1, n, iterations=KS_REF_ITERATIONS)
    warm_err = float(np.abs(out_w["ranks"] - ref1).max() / ref1.max())
    check(h_w.get("tier") == "streamed" and h_w["warm_started"]
          and h_w["iters"] < h_c["iters"] and warm_err <= F32_REL_TOL,
          f"the warm streamed run {h_w} (cold {h_c}, {warm_err} off "
          f"float64)")

    # device peaks against the streamed estimate
    peaks = []
    for algo, p, fn in (
            ("pagerank", "f32", lambda: ST.pagerank_streamed(
                t32, max_iterations=2, tol=0.0, device="cuda")),
            ("pagerank", "bf16", lambda: ST.pagerank_streamed(
                tiers["bf16"], max_iterations=2, tol=0.0, device="cuda")),
            ("pagerank", "int8", lambda: ST.pagerank_streamed(
                tiers["int8"], max_iterations=2, tol=0.0, device="cuda")),
            ("katz", "f32", lambda: ST.katz_streamed(
                t32, max_iterations=2, tol=0.0, device="cuda")),
            ("wcc", "f32", lambda: ST.wcc_streamed(
                t32, max_iterations=2, device="cuda"))):
        peak = streamed_peak(fn)
        est = T.streamed_request_bytes(n, e, p, algorithm=algo)
        peaks.append({"algorithm": algo, "precision": p,
                      "peak_bytes": peak, "estimate_bytes": est,
                      "estimate_over_peak": est / max(peak, 1)})
    torch.cuda.empty_cache()
    s32 = stats["f32"]
    summary = {
        "n_nodes": n, "n_edges": e, "n_blocks": t32.n_blocks,
        "per": t32.per, "block": t32.block, "plan_s": plan_s,
        "wire_bytes_per_sweep": {p: t.wire_bytes_per_sweep
                                 for p, t in tiers.items()},
        "raw_bytes_per_sweep": t32.raw_bytes_per_sweep,
        "h2d_gb_per_s": s32["wire_bytes_per_sweep"]
        / max(s32["serial_transfer_s"], 1e-12) / 1e9,
        "stats": stats,
        "ms_per_iteration": {
            tag: secs[tag] / max(runs[tag][2], 1) * 1e3
            for tag in runs},
        "seconds": secs, "vs_float64": vs64, "reduced": reduced,
        "katz_vs_float64": katz_err, "bit_equal": bit_equal,
        "server": {"streamed": h_s, "cold": h_c, "warm": h_w,
                   "warm_vs_float64": warm_err, "shed": shed,
                   "touched_blocks": touched.tolist(), "local": h_l,
                   "local_blocks": local},
        "peaks": peaks, "launches": launches}
    print("tier", json.dumps(summary, default=float), flush=True)
    for ln in peaks:
        lo, hi = TIER_FOOTPRINT_RANGE
        check(lo <= ln["estimate_over_peak"] <= hi,
              f"the streamed estimate of {ln['algorithm']} "
              f"{ln['precision']} is {ln['estimate_over_peak']:.3f} x its "
              f"measured peak, outside [{lo}, {hi}]")
    return launches


TGN_SEED = 61
TGN_USERS, TGN_PAGES, TGN_EDGES = 8_227, 1_000, 157_474   # JODIE Wikipedia
TGN_SPAN_S = 2_678_400.0    # the stream's timestamps: 31 days of seconds
TGN_LOSS_TOL = 1e-5         # the first batch: card f32 against CPU float64
TGN_MEMORY_TOL = 1e-5       # plus the time encoding's f32 angle rounding
# one Adam step from zero moments moves a weight by lr g / (|g| + 1e-8):
# a gradient within f32 rounding (~1e-9) of zero moves by up to lr / 10
TGN_WEIGHT_TOL = 1e-3
EMB_NODES = 100_000
EMB_DIM, EMB_BATCH = 256, 2048
EMB_SEED = 67
EMB_TWINS = 100             # vertices planted with another's sentence
EMB_TOL = 1e-5              # a chunk against the float64 product
TRACE_REPS = 5              # disarmed / armed runs, in turns
TRACE_DISARMED_SLACK = 0.10
N2V2D_STEPS = 10
N2V2D_SEED = 71
N2V2D_LOSS_REL = 1e-5
# the tables: Adam's m / sqrt(v) amplifies the rounding of a gradient that
# nearly cancels, so a few entries move by more than the rest; the bulk
# is held tighter
N2V2D_TABLE_REL = 1e-4      # every entry, of the largest entry
N2V2D_BULK_REL = 1e-6       # ... and all but a share N2V2D_BULK_SHARE
N2V2D_BULK_SHARE = 1e-4


def tgn_stream():
    """The synthetic JODIE-Wikipedia-scale stream: (src, dst, ts) with
    user gids [0, TGN_USERS) and page gids after them; users' activity
    and pages' popularity skewed (rand**2, rand**3), timestamps sorted
    uniform over 31 days."""
    rng = np.random.default_rng(TGN_SEED)
    users = (rng.random(TGN_EDGES) ** 2 * TGN_USERS).astype(np.int64)
    pages = TGN_USERS + (rng.random(TGN_EDGES) ** 3
                         * TGN_PAGES).astype(np.int64)
    ts = np.sort(rng.uniform(0.0, TGN_SPAN_S, TGN_EDGES)).astype(np.float32)
    return users, pages, ts


def phase_tgn(base: dict):
    """The temporal graph network on the card (``tgn`` line): see the
    module docstring's item 28.  Counts set to 0 just before the epochs,
    read just after: no hand-written kernel runs on this path."""
    import torch
    from memgraph_tpu_torch.northstar import CooSource
    from memgraph_tpu_torch.procedures import tgn_module as TT

    users, pages, ts = tgn_stream()
    source = CooSource(users, pages, TGN_USERS + TGN_PAGES, weights=ts)
    w0 = TT.init_weights(32, 8, seed=7, device="cpu")
    runs = []
    reset_all_counts()
    for _ in range(2):
        TT.set_params({}, device="cuda", weights=w0)
        t0 = time.perf_counter()
        rows = TT.train_and_eval(source, 1, timestamp_property="weight",
                                 device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = TT._STATE["tgn"]
        runs.append({"rows": rows, "s": secs, "batches": st.step,
                     "losses": np.asarray(st.train_losses + st.eval_scores),
                     "memory": st.memory.cpu().numpy(),
                     "last_seen": st.last_seen.cpu().numpy()})
    launches = all_counts()
    TT.reset()
    a, b = runs
    check(all(v == 0 for v in launches.values()),
          f"the tgn path launched a kernel: {launches}")
    n_batches = -(-int(TGN_EDGES * 0.8) // 64) \
        + -(-(TGN_EDGES - int(TGN_EDGES * 0.8)) // 64)
    check(a["batches"] == n_batches and len(a["losses"]) == n_batches,
          f"an epoch ran {a['batches']} batches, not {n_batches}")
    check(bool(np.isfinite(a["losses"]).all()), "a tgn loss is not finite")
    check(all(np.array_equal(a[k], b[k])
              for k in ("losses", "memory", "last_seen")),
          "two tgn epochs from one seed differ")
    # the stream's first batch: the card in f32 against the CPU in float64
    first = TT.edges_by_time(source, "weight")[:64]
    card = TT.TgnState({}, device="cuda", weights=w0)
    ref = TT.TgnState({}, device="cpu", weights=w0, dtype=torch.float64)
    loss_c, loss_r = card.ingest(first, True), ref.ingest(first, True)
    mem_err = float((card.memory.cpu().double() - ref.memory).abs().max())
    # sin / cos of δ e^{-i}: f32 rounds e^{-i} and the product, 2^-24
    # each, so the angle is off by up to 2 * 2^-24 * δ (radians)
    mem_tol = TGN_MEMORY_TOL + 2.0 * 2.0 ** -24 * max(e[2] for e in first)
    w_err = max(float((card.weights[k].detach().cpu().double()
                       - ref.weights[k].detach()).abs().max())
                for k in card.weights)
    check(abs(loss_c - loss_r) <= TGN_LOSS_TOL
          and mem_err <= mem_tol and w_err <= TGN_WEIGHT_TOL,
          f"a tgn batch on the card off float64: loss {loss_c} vs "
          f"{loss_r}, memory {mem_err}, weights {w_err}")
    ms = b["s"] * 1e3 / b["batches"]
    summary = {
        "users": TGN_USERS, "pages": TGN_PAGES, "edges": TGN_EDGES,
        "batches": b["batches"], "epoch_s": [a["s"], b["s"]],
        "ms_a_batch": ms, "batches_per_s": 1e3 / ms,
        "train_loss": float(b["rows"]["train_loss"][0]),
        "eval_loss": float(b["rows"]["eval_loss"][0]),
        "first_batch_vs_float64": {"loss": abs(loss_c - loss_r),
                                   "memory": mem_err, "memory_tol": mem_tol,
                                   "weights": w_err},
        "launches": launches}
    print("tgn", json.dumps(summary), flush=True)
    return launches


class TextSource:
    """``EMB_NODES`` vertices, each with a label and three properties
    (``name``, ``age``, ``city``), for the embeddings: the two reads the
    text procedures make (``vertices``, ``vertex_records``)."""

    LABELS = ("Person", "Company", "City", "Product")
    WORDS = ("ada", "grace", "alan", "edsger", "barbara", "donald", "john",
             "frances", "ken", "dennis", "leslie", "tony", "margaret",
             "radia", "whitfield", "shafi", "silvio", "judea", "yann")

    def __init__(self):
        rng = np.random.default_rng(EMB_SEED)
        n = EMB_NODES
        self.storage = self
        self.label = rng.integers(0, len(self.LABELS), n)
        self.first = rng.integers(0, len(self.WORDS), n)
        self.last = rng.integers(0, len(self.WORDS), n)
        self.age = rng.integers(18, 90, n)
        self.city = rng.integers(0, 500, n)
        # twins: the last EMB_TWINS vertices copy vertices of other chunks
        self.twins = np.arange(EMB_TWINS)
        for a in ("label", "first", "last", "age", "city"):
            col = getattr(self, a)
            col[n - EMB_TWINS:] = col[self.twins]

    def vertices(self, label_filter=None):
        return np.arange(EMB_NODES, dtype=np.int64)

    def vertex_records(self, gids):
        W = self.WORDS
        return [([self.LABELS[self.label[g]]],
                 {"name": f"{W[self.first[g]]} {W[self.last[g]]}",
                  "age": int(self.age[g]), "city": f"city-{self.city[g]}"})
                for g in np.asarray(gids).tolist()]


def phase_embeddings(base: dict):
    """Node text embeddings on the card (``embeddings`` line): see the
    module docstring's item 29."""
    import torch
    from memgraph_tpu_torch.procedures import embeddings_module as TE

    source = TextSource()
    # the path's host hashing, timed where it runs (its chunks' counts
    # kept for the float64 check)
    counts, hash_s = [], [0.0]
    chunk_counts = TE.chunk_counts

    def timed_counts(texts, batch_size):
        t0 = time.perf_counter()
        out = chunk_counts(texts, batch_size)
        hash_s[0] += time.perf_counter() - t0
        if not counts:
            counts.append(out)
        return out

    TE.chunk_counts = timed_counts
    try:
        reset_all_counts()
        out, secs = timed_run(lambda: TE.compute_embeddings(
            source, {"dimension": EMB_DIM, "batch_size": EMB_BATCH},
            device="cuda"))
        launches = all_counts()
    finally:
        TE.chunk_counts = chunk_counts
    check(all(v == 0 for v in launches.values()),
          f"the embeddings path launched a kernel: {launches}")
    vecs = out["embedding"]
    check(vecs.shape == (EMB_NODES, EMB_DIM) and int(out["count"][0])
          == EMB_NODES, f"embeddings of shape {vecs.shape}")
    norm_err = float(np.abs(np.linalg.norm(vecs.astype(np.float64), axis=1)
                            - 1.0).max())
    check(norm_err <= 1e-6, f"an embedding's norm is off 1 by {norm_err}")
    twins = EMB_NODES - EMB_TWINS + np.arange(EMB_TWINS)
    check(np.array_equal(vecs[twins], vecs[source.twins]),
          "equal sentences got different vectors")
    # one chunk's product on the card, and against float64
    proj = TE.default_projection(EMB_DIM, "cuda")
    c0 = torch.from_numpy(counts[0]).cuda()
    chunk_ms = cuda_ms(lambda: TE.encode_chunk(c0, proj), 20)
    upload_ms = cuda_ms(lambda: torch.from_numpy(counts[0]).cuda(), 5)
    ref = counts[0].astype(np.float64) @ proj.cpu().numpy().astype(
        np.float64)
    ref /= np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-12)
    chunk_err = float(np.abs(vecs[:EMB_BATCH] - ref).max())
    check(chunk_err <= EMB_TOL,
          f"a chunk off the float64 product by {chunk_err}")
    summary = {"nodes": EMB_NODES, "dimension": EMB_DIM,
               "batch": EMB_BATCH, "chunks": -(-EMB_NODES // EMB_BATCH),
               "compute_embeddings_s": secs, "hash_s": hash_s[0],
               "chunk_ms": chunk_ms, "chunk_upload_ms": upload_ms,
               "norm_err": norm_err, "chunk_vs_float64": chunk_err,
               "device": TE.model_info(device="cuda")["device"][0],
               "launches": launches}
    print("embeddings", json.dumps(summary), flush=True)
    return launches


def phase_trace(base: dict):
    """Spans and stage extents on the card (``trace`` line): see the
    module docstring's item 30."""
    import tempfile
    import torch
    from memgraph_tpu_torch.observability import stats as tstats
    from memgraph_tpu_torch.observability import trace as ttrace
    from memgraph_tpu_torch.ops.csr import GraphCache
    from memgraph_tpu_torch.ops.pagerank import pagerank
    from memgraph_tpu_torch.server import kernel_server as ks

    seg, ssrc, sdst, _ = segment_source()
    g = GraphCache().get(seg, device="cuda")

    def per_iteration_ms():
        t0 = time.perf_counter()
        _, _, iters = pagerank(g, tol=0.0, max_iterations=ITERATIONS,
                               device="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    reset_all_counts()
    per_iteration_ms()                               # warm
    disarmed, armed = [], []
    for _ in range(TRACE_REPS):
        ttrace.disable()
        disarmed.append(per_iteration_ms())
        ttrace.enable(sample=1.0)
        root = ttrace.begin_trace("query")
        with ttrace.activate(root.ctx), tstats.collecting_stages():
            armed.append(per_iteration_ms())
        root.finish()
    ttrace.disable()
    local = all_counts()
    check(local["csr_spmm_sum"] > 0,
          f"the in-process segment runs launched no K1: {local}")
    check(min(disarmed) <= (1 + TRACE_DISARMED_SLACK) * min(armed),
          f"disarmed tracing costs: {min(disarmed)} ms an iteration "
          f"against {min(armed)} armed")
    check(ttrace.span("device.chunk") is ttrace._NOOP,
          "a disarmed span is not the no-op")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sock = os.path.join(tempfile.mkdtemp(prefix="mgtr"), "ks.sock")
    env = dict(os.environ, MEMGRAPH_TPU_TRACE="1")
    try:
        client = ks.ensure_server(sock, spawn_timeout_s=KS_TIMEOUT,
                                  idle_timeout_s=KS_TIMEOUT, device="cuda",
                                  env=env)
    except RuntimeError as e:
        fail(f"the traced kernel server did not start: {e}")
    if client is None:
        print(ks.log_tail(sock), file=sys.stderr, flush=True)
        fail("the traced kernel server did not answer")
    sup = ks.SupervisedKernelClient(sock, spawn=False, deadline_s=KS_TIMEOUT,
                                    device="cuda")
    ttrace.enable(sample=1.0)
    requests = {}
    try:
        h0 = client.health()["launches"]
        for name, call in (
                ("pagerank", lambda: sup.pagerank(
                    src=ssrc, dst=sdst, n_nodes=SEGMENT_NODES,
                    graph_key="trace", graph_version=1, tol=1e-6)),
                ("ppr", lambda: sup.ppr(
                    [3], src=ssrc, dst=sdst, n_nodes=SEGMENT_NODES,
                    graph_key="trace-ppr", graph_version=1, tol=1e-6))):
            acc = tstats.StageAccumulator()
            root = ttrace.begin_trace("query")
            t0 = time.perf_counter()
            with ttrace.activate(root.ctx), tstats.collecting_stages(acc):
                call()
            wall = time.perf_counter() - t0
            root.finish()
            (spans,) = ttrace.traces_json(root.trace_id)
            by_id = {s["span_id"]: s for s in spans}
            names = [s["name"] for s in spans]
            check(all(n in ttrace.SPAN_NAMES for n in names)
                  and all(s["trace_id"] == root.trace_id for s in spans)
                  and all(s["parent_id"] is None or s["parent_id"] in by_id
                          for s in spans),
                  f"the {name} request's spans do not nest: {names}")
            disp = [s for s in spans if s["name"] == "kernel.dispatch"]
            check(len(disp) == 1 and names.count("kernel.request") == 1
                  and by_id[disp[0]["parent_id"]]["name"]
                  == "kernel.request" and disp[0]["pid"] != os.getpid(),
                  f"the daemon's dispatch span did not come home under "
                  f"the request: {names}")
            stages = acc.snapshot()
            check("kernel_dispatch" in stages and all(
                s["seconds"] <= wall for s in stages.values()),
                  f"the {name} request's stages pass its wall {wall}: "
                  f"{stages}")
            chunks = [s for s in spans if s["name"] == "device.chunk"]
            check(all(by_id[c["parent_id"]]["name"] == "kernel.dispatch"
                      for c in chunks),
                  f"a device.chunk outside the dispatch: {names}")
            requests[name] = {"wall_ms": wall * 1e3, "spans": len(spans),
                              "names": sorted(set(names)),
                              "device_chunks": len(chunks),
                              "stages": stages}
        check(requests["pagerank"]["device_chunks"] > 0,
              "the pagerank op's chunks opened no span")
        daemon = {k: v - h0[k]
                  for k, v in client.health()["launches"].items()}
    finally:
        ttrace.disable()
        ttrace.TRACER.reset()
        sup.close()
        client.shutdown()
        client.close()
        try:
            client.process.wait(timeout=60)
        except subprocess.TimeoutExpired:
            client.process.kill()
            client.process.wait()
    check(daemon["csr_spmm_sum"] > 0,
          f"the traced requests launched no K1 in the daemon: {daemon}")
    launches = {k: local.get(k, 0) + daemon.get(k, 0)
                for k in {*local, *daemon}}
    summary = {"graph": {"n_nodes": SEGMENT_NODES, "n_edges": SEGMENT_EDGES},
               "segment_iteration_ms": {"disarmed": disarmed,
                                        "armed": armed,
                                        "disarmed_min": min(disarmed),
                                        "armed_min": min(armed)},
               "requests": requests, "launches": launches,
               "launches_in_process": local, "launches_daemon": daemon}
    print("trace", json.dumps(summary), flush=True)
    return launches


def phase_node2vec_sharded(base: dict):
    """node2vec's 2-D sharded step on the card (``node2vec_sharded``
    line): see the module docstring's item 31."""
    import torch
    from memgraph_tpu_torch.models import node2vec as N
    from memgraph_tpu_torch.northstar import N_NODES, generate_graph
    from memgraph_tpu_torch.ops.gnn import adam
    from memgraph_tpu_torch.parallel.mesh import make_mesh_2d

    cfg = N.Node2VecConfig()
    dim, B, K = cfg.embedding_dim, cfg.batch_size, cfg.negatives
    n_pad = 1 << int(np.ceil(np.log2(N_NODES + 1)))
    src, dst = base.get("src"), base.get("dst")
    if src is None:
        src, dst = generate_graph()
    rng = np.random.default_rng(N2V2D_SEED)
    batches = []
    for k in range(N2V2D_STEPS):
        e = rng.integers(0, len(src), B)
        c = np.asarray(src[e], dtype=np.int64)
        t = np.asarray(dst[e], dtype=np.int64)
        if k == N2V2D_STEPS - 1:                  # a padded last batch
            c[-100:], t[-100:] = -1, -1
        neg = rng.integers(0, N_NODES, (B, K))
        batches.append(tuple(torch.from_numpy(a).cuda()
                             for a in (c, t, neg)))
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)
    tables0 = N.init_params(n_pad, dim, gen, "cuda")

    def single():
        tables = {k: v.clone().requires_grad_(True)
                  for k, v in tables0.items()}
        opt = adam(list(tables.values()), cfg.learning_rate)
        losses = [N.train_step(tables, opt, *b) for b in batches]
        return {k: v.detach() for k, v in tables.items()}, losses

    def sharded(mesh):
        step, layout, _ = N.build_sharded_train_step(
            mesh, lambda ts: adam(ts, cfg.learning_rate))
        placed = {k: layout[k].place(tables0[k]) for k in ("in", "out")}
        state = step.init(placed)
        losses = []
        for b in batches:
            placed, state, loss = step(placed, state, *b)
            losses.append(loss)
        return {k: layout[k].gather(placed[k]) for k in placed}, losses

    def ms_a_step(run):
        run()                                    # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / N2V2D_STEPS

    mesh = make_mesh_2d(2, 2, devices=("cuda:0",) * 4)
    # the path: counts set to 0 just before, read just after
    reset_all_counts()
    got, got_losses = sharded(mesh)
    torch.cuda.synchronize()
    launches = all_counts()
    want_k1 = 3 * 4 * N2V2D_STEPS
    check(launches["csr_spmm_sum"] == want_k1
          and all(v == 0 for k, v in launches.items()
                  if k != "csr_spmm_sum"),
          f"the 2-D step's launches {launches}, not {want_k1} K1")
    again, again_losses = sharded(mesh)
    check(all(torch.equal(got[k], again[k]) for k in got)
          and all(torch.equal(a, b) for a, b in zip(got_losses,
                                                    again_losses)),
          "two 2-D node2vec runs differ")
    want, want_losses = single()
    loss_rel = max(abs(float(a) - float(b)) / abs(float(b))
                   for a, b in zip(got_losses, want_losses))
    rel = {k: (got[k] - want[k]).abs() / want[k].abs().max() for k in got}
    table_rel = max(float(r.max()) for r in rel.values())
    bulk_share = max(float((r > N2V2D_BULK_REL).float().mean())
                     for r in rel.values())
    check(loss_rel <= N2V2D_LOSS_REL and table_rel <= N2V2D_TABLE_REL
          and bulk_share <= N2V2D_BULK_SHARE,
          f"the 2-D step off the single-card step: loss {loss_rel}, "
          f"tables {table_rel}, share past {N2V2D_BULK_REL}: {bulk_share}")
    del rel
    check(all(np.isfinite(float(x)) for x in got_losses),
          "a 2-D step's loss is not finite")
    del again, want
    torch.cuda.empty_cache()
    timing = {"1x1": ms_a_step(lambda: sharded(make_mesh_2d(
                  1, 1, devices=("cuda:0",)))),
              "2x2": ms_a_step(lambda: sharded(mesh)),
              "single_train_step": ms_a_step(single)}
    summary = {"n_nodes": N_NODES, "n_pad": n_pad, "dim": dim, "batch": B,
               "negatives": K, "steps": N2V2D_STEPS, "mesh": mesh.shape,
               "losses": [float(x) for x in got_losses],
               "vs_single_card": {"loss_rel": loss_rel,
                                  "table_rel": table_rel,
                                  "share_past_bulk_rel": bulk_share},
               "ms_a_step": timing, "launches": launches}
    print("node2vec_sharded", json.dumps(summary), flush=True)
    del got, tables0
    torch.cuda.empty_cache()
    return launches


# the cypher phase: the north star's generator at a fifth of its size (the
# host storage holds a graph as Python objects: 10M edges would take
# ~200 s of ingest and ~11 GB), edges in chunks of batch_insert, a
# commit of 1,000 edges, lane thresholds 1% and 75% of the ids
CYPHER_NODES = 200_000
CYPHER_EDGES = 2_000_000
CYPHER_CHUNK = 250_000
CYPHER_COMMIT = 1_000
CYPHER_COMMIT_SEED = 23
CYPHER_LANE_K = (2_000, 150_000)
# the bolt step: its commit's seed (the cypher phase's is 23), the tenant's
# graph (under MXU_MIN_EDGES, so the segment route runs), its seed
BOLT_COMMIT_SEED = 29
BOLT_TENANT_NODES = 10_000
BOLT_TENANT_EDGES = 50_000
BOLT_TENANT_SEED = 31
#: the reference's failure codes (memgraph_tpu/server/bolt.py): a refused
#: login, and an error that is no syntax, semantic or transaction error
BOLT_UNAUTHENTICATED = "Memgraph.ClientError.Security.Unauthenticated"
BOLT_GENERAL_ERROR = "Memgraph.TransientError.General.Error"


def peak_rss_mb() -> float:
    """This process's peak resident set (MB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


@contextlib.contextmanager
def cypher_split(P, sync):
    """Seconds of a cold ``pagerank.get`` by stage while inside: the
    snapshot's export (``ops.csr.export_csr`` and ``export_csr_delta``),
    the plan (``spmv_mxu.build_plan``, ``build_delta_plan``,
    ``place_plan``) and the whole of ``ops.pagerank.pagerank`` as
    ``procedures/graph_algorithms.py`` calls it; iterations are the
    latter less the plan; ``sync`` waits for the device.  Yields the dict
    of seconds and calls."""
    from memgraph_tpu_torch.ops import csr as CSR
    from memgraph_tpu_torch.ops import spmv_mxu
    split = {"export_s": 0.0, "plan_s": 0.0, "pagerank_s": 0.0,
             "calls": {}}
    real = {(CSR, "export_csr"): "export_s",
            (CSR, "export_csr_delta"): "export_s",
            (spmv_mxu, "build_plan"): "plan_s",
            (spmv_mxu, "build_delta_plan"): "plan_s",
            (spmv_mxu, "place_plan"): "plan_s",
            (P, "pagerank"): "pagerank_s"}
    saved = {k: getattr(*k) for k in real}

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            split[real[key]] += time.perf_counter() - t0
            split["calls"][key[1]] = split["calls"].get(key[1], 0) + 1
            return out
        return run

    for key, fn in saved.items():
        setattr(*key, timed(key, fn))
    try:
        yield split
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
        split["iterations_s"] = split["pagerank_s"] - split["plan_s"]


def phase_cypher(base: dict, n_nodes: int = CYPHER_NODES,
                 n_edges: int = CYPHER_EDGES, device: str = "cuda"):
    """The Cypher engine on the card (``cypher`` line): the port's own
    storage and interpreter, built by its composition root
    (``main.build_database``: a ``DbmsHandler`` on the card), driven as
    a user drives them.

    The graph is ``northstar.generate_graph(200_000, 2_000_000)``, the
    north star's generator cut to a fifth of its nodes and edges: the
    host storage keeps every vertex and edge as Python objects, so the
    north star's 10M edges would take ~200 s of ingest and ~11 GB of host
    memory in it.  Vertices go in by Cypher through the bulk lane
    (``UNWIND range(0, $n - 1) AS i CREATE (:User {id: i})``), then
    ``CREATE INDEX ON :User(id)``, then the edges as ``FOLLOWS`` through
    ``Accessor.batch_insert`` in chunks of ``CYPHER_CHUNK``, a transaction
    each; the ingest seconds and the process's peak RSS are printed.

    With the counts set to 0 just before and read just after, the path:
    1. ``CALL pagerank.get() YIELD node, rank RETURN node.id AS id,
       rank`` cold (the snapshot exported, the MXU plan built and placed:
       2M edges take the MXU route), split into export, plan and
       iterations, then warm (the warm pool's hit).  Held within the
       ``pagerank.get`` L1 bound of a converged float64 PageRank on the
       same edges, bit-equal to ``procedures.graph_algorithms.
       pagerank_get`` recomputing on the same snapshot with a warm pool
       of its own, and ``benes_mid_gather`` / ``benes_outer_gather``
       launched.
    2. A commit of ``CYPHER_COMMIT`` edges by Cypher (``UNWIND $pairs AS
       p MATCH (a:User {id: p[0]}), (b:User {id: p[1]}) CREATE
       (a)-[:FOLLOWS]->(b)``), then the CALL again: the snapshot comes
       by a delta export, the plan by a DeltaPlan (no plan built), the
       delta net's gathers launch (3 mid gathers an iteration), the
       warm-start counter moves, and the answer is within the bound of
       float64 on the new edges.
    3. ``DROP INDEX ON :User(id)`` (with the index the planner serves an
       id range from it and no lane runs), then two lane-shaped reads at
       a selective and a broad threshold (``CYPHER_LANE_K``): ``MATCH
       (n:User) WHERE n.id < $k RETURN count(n)`` and the 2-hop count
       ``MATCH (n:User)-[:FOLLOWS]->()-[:FOLLOWS]->(m) WHERE n.id < $k
       RETURN count(m)``, against numpy / scipy on the same arrays; no
       fallback for their fingerprints; K1 and K2 launched.  ms of each
       read cold (the columnar export and staging) and warm.

    4. Before the storage is freed, ``bolt_step`` serves it over Bolt
       (its own ``phase_s bolt`` and ``bolt`` lines).

    ``n_nodes``, ``n_edges`` and ``device`` exist to rehearse the phase
    small on the CPU; the script runs it at the sizes above on the card.
    Returns the path's launches and the Bolt step's."""
    import torch
    from memgraph_tpu_torch.northstar import generate_graph
    from memgraph_tpu_torch.ops import pipeline as PL
    from memgraph_tpu_torch.ops import spmv_mxu
    from memgraph_tpu_torch.ops.csr import GLOBAL_GRAPH_CACHE
    from memgraph_tpu_torch.ops.delta import LocalWarmPool
    from memgraph_tpu_torch import main as M
    from memgraph_tpu_torch.dbms.dbms import DbmsHandler
    from memgraph_tpu_torch.procedures import graph_algorithms as P
    from memgraph_tpu_torch.query.interpreter import Interpreter
    from memgraph_tpu_torch.storage.source import StorageSource
    from memgraph_tpu_torch.utils.metrics import global_metrics

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    summary = {"card": card_line() if device != "cpu" else "cpu",
               "n_nodes": n_nodes, "n_edges": n_edges}
    src, dst = generate_graph(n_nodes=n_nodes, n_edges=n_edges)
    # the port's composition root, as a server builds its database (its
    # periodic GC and memory watcher off: the phase times its own work)
    ictx = M.build_database(M.build_config(
        ["--device", device, "--storage-gc-cycle-sec", "0",
         "--memory-warning-threshold", "0"]))
    storage = ictx.storage
    check(ictx.device.type == device and isinstance(ictx.dbms, DbmsHandler),
          f"the context runs on {ictx.device}, under {ictx.dbms}")
    interp = Interpreter(ictx)

    # --- ingest ------------------------------------------------------------
    t_all = time.perf_counter()
    _, t_v = timed(lambda: interp.execute(
        "UNWIND range(0, $n - 1) AS i CREATE (:User {id: i})",
        {"n": n_nodes}))
    _, t_ix = timed(lambda: interp.execute("CREATE INDEX ON :User(id)"))
    rows = interp.execute("MATCH (n:User) RETURN n.id, id(n)")[1]
    check(len(rows) == n_nodes, f"{len(rows)} users, not {n_nodes}")
    vertex_of = [None] * n_nodes
    for uid, gid in rows:
        vertex_of[uid] = storage._vertices[gid]
    id_of_gid = {gid: uid for uid, gid in rows}
    del rows
    follows = storage.edge_type_mapper.name_to_id("FOLLOWS")
    t0 = time.perf_counter()
    for lo in range(0, n_edges, CYPHER_CHUNK):
        acc = storage.access()
        acc.batch_insert(edges=[
            (follows, vertex_of[s], vertex_of[d], {})
            for s, d in zip(src[lo:lo + CYPHER_CHUNK].tolist(),
                            dst[lo:lo + CYPHER_CHUNK].tolist())])
        acc.commit()
    t_e = time.perf_counter() - t0
    del vertex_of
    summary["ingest"] = {"vertices_s": t_v, "index_s": t_ix, "edges_s": t_e,
                         "total_s": time.perf_counter() - t_all,
                         "peak_rss_mb": peak_rss_mb()}
    print("cypher ingest", json.dumps({"card": summary["card"],
                                       **summary["ingest"]}), flush=True)

    call = ("CALL pagerank.get() YIELD node, rank "
            "RETURN node.id AS id, rank")

    def ranks_by_id(rows_):
        out = np.full(n_nodes, np.nan)
        for uid, r in rows_:
            out[uid] = r
        return out

    def vs64(ranks, s_, d_):
        ref = reference_pagerank(s_, d_, n_nodes,
                                 iterations=PR_PROC_REF_ITERATIONS)
        check(np.isfinite(ranks).all(), "pagerank.get: a rank is missing "
                                        "or not finite")
        return float(np.abs(ranks - ref).sum())

    # --- the path: counts set to 0 just before, read just after ---------
    reset_all_counts()
    cnt0 = counts()
    with cypher_split(P, sync) as split:
        (cols, rows, _), t_cold = timed(lambda: interp.execute(call))
    check(cols == ["id", "rank"] and len(rows) == n_nodes,
          f"the CALL gave {cols} and {len(rows)} rows")
    cold_launches = counts()
    check(split["calls"].get("build_plan") == 1,
          f"the cold CALL built {split['calls']} plans, not one MXU plan")
    for name in ("benes_mid_gather", "benes_outer_gather"):
        check(cold_launches[name] > cnt0[name],
              f"the cold CALL launched no {name}: {cold_launches}")
    ranks = ranks_by_id(rows)
    l1 = vs64(ranks, src, dst)
    check(l1 <= PR_PROC_L1,
          f"pagerank.get through Cypher off float64 by L1 {l1} > "
          f"{PR_PROC_L1}")
    (_, rows_w, _), t_warm = timed(lambda: interp.execute(call))
    check(np.array_equal(ranks_by_id(rows_w), ranks),
          "the warm CALL's ranks are not the cold CALL's")
    # the library call on the same snapshot, recomputed (a pool of its
    # own): bit-equal
    acc = storage.access()
    try:
        lib = P.pagerank_get(StorageSource(acc), pool=LocalWarmPool(),
                             device=device)
    finally:
        acc.abort()
    lib_ranks = np.full(n_nodes, np.nan)
    lib_ranks[[id_of_gid[int(g)] for g in lib["node_gids"]]] = lib["rank"]
    check(np.array_equal(lib_ranks, ranks),
          "pagerank.get through Cypher is not bit-equal to the library "
          "call on the same snapshot")
    summary["call"] = {
        "cold_s": t_cold, "warm_s": t_warm,
        "split": {k: split[k] for k in ("export_s", "plan_s",
                                        "iterations_s")},
        "rows_s": t_cold - split["export_s"] - split["pagerank_s"],
        "l1_vs_float64": l1, "l1_limit": PR_PROC_L1,
        "bit_equal_library": True,
        "gathers": {k: cold_launches[k] - cnt0[k]
                    for k in ("benes_mid_gather", "benes_outer_gather")}}

    # --- commit, then CALL -------------------------------------------------
    rng = np.random.default_rng(CYPHER_COMMIT_SEED)
    add_s = rng.integers(0, n_nodes, CYPHER_COMMIT)
    add_d = (rng.random(CYPHER_COMMIT) ** 2 * n_nodes).astype(np.int64)
    pairs = np.stack([add_s, add_d], 1).tolist()
    _, t_commit = timed(lambda: interp.execute(
        "UNWIND $pairs AS p MATCH (a:User {id: p[0]}), (b:User {id: p[1]}) "
        "CREATE (a)-[:FOLLOWS]->(b)", {"pairs": pairs}))
    delta0 = GLOBAL_GRAPH_CACHE.counters["export.delta"]
    warm0 = global_metrics.value("delta.warm_start_total")
    before = counts()
    with cypher_split(P, sync) as split2:
        (_, rows2, _), t_call2 = timed(lambda: interp.execute(call))
    after = counts()
    check(GLOBAL_GRAPH_CACHE.counters["export.delta"] == delta0 + 1,
          "the CALL after the commit did not refresh its snapshot by delta")
    check(split2["calls"].get("build_plan") is None
          and split2["calls"].get("build_delta_plan") == 1,
          f"the CALL after the commit planned {split2['calls']}, not one "
          "DeltaPlan")
    check(global_metrics.value("delta.warm_start_total") == warm0 + 1,
          "the CALL after the commit did not warm-start")
    moved = {k: after[k] - before[k]
             for k in ("benes_mid_gather", "benes_outer_gather")}
    check(moved["benes_mid_gather"] > 0 and moved["benes_outer_gather"] > 0,
          f"the refreshed CALL launched no gathers: {moved}")
    src2, dst2 = np.concatenate([src, add_s]), np.concatenate([dst, add_d])
    ranks2 = ranks_by_id(rows2)
    l1_2 = vs64(ranks2, src2, dst2)
    check(l1_2 <= PR_PROC_L1,
          f"pagerank.get after the commit off float64 by L1 {l1_2}")
    sol = P.GLOBAL_WARM_POOL.solution(storage, "pagerank")
    summary["commit_then_call"] = {
        "commit_s": t_commit, "call_s": t_call2,
        "split": {k: split2[k] for k in ("export_s", "plan_s",
                                         "iterations_s")},
        "iterations_warm": None if sol is None else sol.iters,
        "l1_vs_float64": l1_2, "gathers": moved,
        "mid_gathers_an_iteration": None if sol is None or not sol.iters
        else moved["benes_mid_gather"] / sol.iters}

    # --- the lane ----------------------------------------------------------
    interp.execute("DROP INDEX ON :User(id)")
    PL.LANE_REGISTRY.reset()
    seg0 = seg_counts()
    queries = {
        "count": "MATCH (n:User) WHERE n.id < $k RETURN count(n)",
        "two_hop": "MATCH (n:User)-[:FOLLOWS]->()-[:FOLLOWS]->(m) "
                   "WHERE n.id < $k RETURN count(m)"}
    out_deg = np.bincount(src2, minlength=n_nodes)
    lane = {}
    for k in CYPHER_LANE_K:
        smask = np.arange(n_nodes) < k
        ones = np.ones(n_nodes, bool)
        want = {"count": int(smask.sum()),
                "two_hop": lane_hops64(src2, dst2, np.ones(len(src2), bool),
                                       smask, ones, ones, n_nodes, 2,
                                       False, True)["rows"]}
        for name, q in queries.items():
            (_, r1, _), cold = timed(lambda: interp.execute(q, {"k": k}))
            (_, r2, _), warm = timed(lambda: interp.execute(q, {"k": k}))
            check(r1 == r2 == [[want[name]]],
                  f"lane {name} at k={k}: {r1}, {r2}, not {want[name]}")
            lane[f"{name}@{k}"] = {"cold_ms": cold * 1e3,
                                   "warm_ms": warm * 1e3,
                                   "answer": want[name]}
    fps = PL.LANE_REGISTRY.snapshot()
    check(len(fps) == 2 and all(not e["fallbacks"] and e["hits"] == 4
                                for e in fps.values()),
          f"the lane's fingerprints: {fps}")
    seg1 = seg_counts()
    lane_launches = {k: seg1[k] - seg0[k] for k in seg1}
    check(all(v > 0 for v in lane_launches.values()),
          f"the lane reads launched {lane_launches}")
    summary["lane"] = {"reads": lane, "fingerprints": fps,
                       "launches": lane_launches,
                       "out_degree_max": int(out_deg.max())}
    launches = all_counts()
    summary["launches"] = launches
    summary["peak_rss_mb"] = peak_rss_mb()
    print("cypher", json.dumps(summary), flush=True)

    # --- the Bolt entry point serves this database before it is freed ---
    t0 = time.perf_counter()
    bolt_launches = bolt_step(
        ictx, interp, n_nodes, src2, dst2, call, ranks_by_id, vs64, sync,
        device,
        lane_k=CYPHER_LANE_K[0],
        lane_want=lane[f"two_hop@{CYPHER_LANE_K[0]}"]["answer"])
    print(f"phase_s bolt {time.perf_counter() - t0:.3f}", flush=True)
    del interp, ictx, storage
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return launches, bolt_launches


@contextlib.contextmanager
def interpreter_seconds():
    """Seconds spent in ``Interpreter.prepare`` and ``pull`` while inside,
    on any thread: the server's side of a Bolt request (parse, plan,
    execute, the rows), not its wire (pack, send, unpack)."""
    from memgraph_tpu_torch.query.interpreter import Interpreter
    spent = {"s": 0.0, "calls": 0}
    saved = Interpreter.prepare, Interpreter.pull

    def wrap(fn):
        def run(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kw)
            finally:
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return run

    Interpreter.prepare, Interpreter.pull = wrap(saved[0]), wrap(saved[1])
    try:
        yield spent
    finally:
        Interpreter.prepare, Interpreter.pull = saved


def bolt_step(ictx, interp, n_nodes, src, dst, call, ranks_by_id, vs64,
              sync, device, lane_k, lane_want):
    """The Bolt entry point on the card (``bolt`` line).  A ``BoltServer``
    (``server/bolt.py``) serves the ``cypher`` phase's database (``src``,
    ``dst``: its edges after the phase's commit; ``interp``: the phase's
    in-process session) on 127.0.0.1 with an ``Auth`` store, and the
    step drives it only through the port's ``BoltClient``.  The counts
    are set to 0 just before each step and read just after:

    1. Auth: the first user creates an admin (every privilege) and a
       reader (MATCH); a wrong password fails with the reference's
       Security code, the reader's MATCH succeeds and its write fails
       with the reference's code.
    2. The lane: the 2-hop count at ``lane_k``, twice, equal to numpy /
       scipy (``lane_want``), the lane hitting with no fallback, K1 and
       K2 launched.
    3. A commit over Bolt: BEGIN, the ``UNWIND $pairs ... CREATE`` of
       ``CYPHER_COMMIT`` edges (seed ``BOLT_COMMIT_SEED``; the id index
       made again for its lookups), COMMIT.
    4. ``CALL pagerank.get()`` over Bolt, its 200,000 rows pulled in the
       client's batches: a delta export and a DeltaPlan, no plan built,
       ``benes_mid_gather`` / ``benes_outer_gather`` launched during the
       request, the rows bit-equal to the same CALL in process on the
       same version and within ``PR_PROC_L1`` of a converged float64
       PageRank on the new edges.  The server's seconds (prepare and
       pull), the wire's (the rest of the client's wall) and rows a
       second.
    5. A tenant: ``CREATE DATABASE tenant2; USE DATABASE tenant2`` on one
       session, 0 vertices there, a graph of ``BOLT_TENANT_NODES`` /
       ``BOLT_TENANT_EDGES`` by Cypher (the segment route), its
       ``CALL pagerank.get()`` on K1 within the bound of float64, and the
       default database unchanged.
    6. ``SHOW LICENSE INFO`` and ``SHOW ACTIVE USERS INFO`` answer, one
       session a connection that logged in.

    Returns the step's launches, kernel by kernel."""
    from memgraph_tpu_torch.ops import pipeline as PL
    from memgraph_tpu_torch.ops.csr import GLOBAL_GRAPH_CACHE
    from memgraph_tpu_torch.procedures import graph_algorithms as P
    from memgraph_tpu_torch.server.bolt import BoltServer
    from memgraph_tpu_torch.server.client import BoltClient, BoltClientError

    summary = {"card": card_line() if device != "cpu" else "cpu"}
    launches = dict.fromkeys(all_counts(), 0)

    @contextlib.contextmanager
    def counted(name):
        """The counts set to 0 before a step and added after it."""
        reset_all_counts()
        moved = {}
        t0 = time.perf_counter()
        yield moved
        sync()
        moved.update(all_counts())
        for k, v in moved.items():
            launches[k] += v
        summary.setdefault("steps_s", {})[name] = time.perf_counter() - t0

    def refused(client_call):
        """(code, message) of the call's Bolt failure, or None."""
        try:
            client_call()
        except BoltClientError as e:
            return e.code, str(e)
        return None

    auth = ictx.auth_store          # main.build_database's, empty
    check(not auth.users(), f"the store holds users: {auth.users()}")
    server = BoltServer(ictx, "127.0.0.1", 0, auth)
    thread, loop = server.run_in_thread()
    port = server._server.sockets[0].getsockname()[1]
    admin_pw = "admin-pw"
    clients = []

    def connect(user="", password=""):
        c = BoltClient(port=port, username=user, password=password,
                       timeout=600.0)
        clients.append(c)
        return c

    # --- 1. auth -----------------------------------------------------------
    with counted("auth"):
        first = connect()
        first.execute("CREATE USER admin IDENTIFIED BY $pw",
                      {"pw": admin_pw})
        first.close()
        clients.remove(first)
        admin = connect("admin", admin_pw)
        admin.execute("CREATE USER reader IDENTIFIED BY 'reader-pw'")
        admin.execute("GRANT MATCH TO reader")
        wrong = refused(lambda: BoltClient(port=port, username="admin",
                                           password="wrong", timeout=60.0))
        check(wrong is not None and wrong[0] == BOLT_UNAUTHENTICATED,
              f"a wrong password gave {wrong}")
        reader = connect("reader", "reader-pw")
        got = reader.execute("MATCH (n:User) WHERE n.id < 10 "
                             "RETURN count(n)")[1]
        check(got == [[10]], f"the reader's MATCH gave {got}")
        write = refused(lambda: reader.execute("CREATE (:Nope)"))
        check(write is not None and write[0] == BOLT_GENERAL_ERROR
              and "missing privilege CREATE" in write[1],
              f"the reader's write gave {write}")
        reader.reset()
    # the phase's in-process session goes on as the admin
    interp.username = "admin"
    summary["auth"] = {"users": auth.users(), "wrong_password": wrong[0],
                       "reader_write": write[0]}

    # --- 2. the lane over Bolt (before the commit) -------------------------
    q_lane = ("MATCH (n:User)-[:FOLLOWS]->()-[:FOLLOWS]->(m) "
              "WHERE n.id < $k RETURN count(m)")
    PL.LANE_REGISTRY.reset()
    with counted("lane") as lane_moved:
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            rows = admin.execute(q_lane, {"k": lane_k})[1]
            ms.append((time.perf_counter() - t0) * 1e3)
            check(rows == [[lane_want]],
                  f"the lane's 2-hop count over Bolt: {rows}, not "
                  f"{lane_want}")
    fps = PL.LANE_REGISTRY.snapshot()
    check(len(fps) == 1 and all(not e["fallbacks"] and e["hits"] == 2
                                for e in fps.values()),
          f"the lane over Bolt: {fps}")
    check(lane_moved["csr_spmm_sum"] > 0 and lane_moved["lane_sum"] > 0,
          f"the lane over Bolt launched {lane_moved}")
    summary["lane"] = {"k": lane_k, "answer": lane_want, "ms": ms,
                       "fingerprints": fps, "launches": dict(lane_moved)}

    # --- 3. a commit over Bolt ---------------------------------------------
    rng = np.random.default_rng(BOLT_COMMIT_SEED)
    add_s = rng.integers(0, n_nodes, CYPHER_COMMIT)
    add_d = (rng.random(CYPHER_COMMIT) ** 2 * n_nodes).astype(np.int64)
    with counted("commit"):
        admin.execute("CREATE INDEX ON :User(id)")
        t0 = time.perf_counter()
        admin.begin()
        _, _, commit_summary = admin.execute(
            "UNWIND $pairs AS p MATCH (a:User {id: p[0]}), "
            "(b:User {id: p[1]}) CREATE (a)-[:FOLLOWS]->(b)",
            {"pairs": np.stack([add_s, add_d], 1).tolist()})
        admin.commit()
        t_commit = time.perf_counter() - t0
    created = (commit_summary.get("stats") or {}).get(
        "relationships-created")
    check(created == CYPHER_COMMIT,
          f"the commit over Bolt created {created} edges")
    src3 = np.concatenate([src, add_s])
    dst3 = np.concatenate([dst, add_d])

    # --- 4. CALL pagerank.get() over Bolt ----------------------------------
    delta0 = GLOBAL_GRAPH_CACHE.counters["export.delta"]
    with counted("call") as call_moved, \
            cypher_split(P, sync) as split, interpreter_seconds() as server_s:
        t0 = time.perf_counter()
        cols, rows, _ = admin.execute(call)
        t_call = time.perf_counter() - t0
    check(cols == ["id", "rank"] and len(rows) == n_nodes,
          f"the CALL over Bolt gave {cols} and {len(rows)} rows")
    check(GLOBAL_GRAPH_CACHE.counters["export.delta"] == delta0 + 1,
          "the CALL over Bolt did not refresh its snapshot by delta")
    check(split["calls"].get("build_plan") is None
          and split["calls"].get("build_delta_plan") == 1,
          f"the CALL over Bolt planned {split['calls']}, not one DeltaPlan")
    for name in ("benes_mid_gather", "benes_outer_gather"):
        check(call_moved[name] > 0,
              f"the CALL over Bolt launched no {name}: {call_moved}")
    ranks = ranks_by_id(rows)
    in_process = ranks_by_id(interp.execute(call)[1])
    check(np.array_equal(ranks, in_process),
          "the CALL over Bolt is not bit-equal to the CALL in process on "
          "the same version")
    l1 = vs64(ranks, src3, dst3)
    check(l1 <= PR_PROC_L1,
          f"pagerank.get over Bolt off float64 by L1 {l1} > {PR_PROC_L1}")
    summary["call"] = {
        "rows": len(rows), "client_s": t_call, "server_s": server_s["s"],
        "server_calls": server_s["calls"],
        "wire_s": t_call - server_s["s"], "rows_a_s": len(rows) / t_call,
        "split": {k: split[k] for k in ("export_s", "plan_s",
                                        "iterations_s")},
        "commit_s": t_commit, "l1_vs_float64": l1, "l1_limit": PR_PROC_L1,
        "bit_equal_in_process": True,
        "gathers": {k: call_moved[k] for k in ("benes_mid_gather",
                                               "benes_outer_gather")}}

    # --- 5. a tenant -------------------------------------------------------
    n_t, e_t = BOLT_TENANT_NODES, BOLT_TENANT_EDGES
    rng = np.random.default_rng(BOLT_TENANT_SEED)
    t_src = rng.integers(0, n_t, e_t)
    t_dst = (rng.random(e_t) ** 2 * n_t).astype(np.int64)
    default_users = interp.execute("MATCH (n) RETURN count(n)")[1]
    with counted("tenant") as tenant_moved:
        admin.execute("CREATE DATABASE tenant2")
        admin.execute("USE DATABASE tenant2")
        empty = admin.execute("MATCH (n) RETURN count(n)")[1]
        t0 = time.perf_counter()
        admin.execute("UNWIND range(0, $n - 1) AS i CREATE (:User {id: i})",
                      {"n": n_t})
        admin.execute("CREATE INDEX ON :User(id)")
        admin.execute("UNWIND $pairs AS p MATCH (a:User {id: p[0]}), "
                      "(b:User {id: p[1]}) CREATE (a)-[:FOLLOWS]->(b)",
                      {"pairs": np.stack([t_src, t_dst], 1).tolist()})
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, t_rows, _ = admin.execute(call)
        t_tcall = time.perf_counter() - t0
    check(empty == [[0]], f"a new tenant holds {empty} vertices")
    check(tenant_moved["csr_spmm_sum"] > 0,
          f"the tenant's CALL launched no K1: {tenant_moved}")
    t_ranks = np.full(n_t, np.nan)
    for uid, r in t_rows:
        t_ranks[uid] = r
    check(len(t_rows) == n_t and np.isfinite(t_ranks).all(),
          f"the tenant's CALL gave {len(t_rows)} rows")
    t_ref = reference_pagerank(t_src, t_dst, n_t,
                               iterations=PR_PROC_REF_ITERATIONS)
    t_l1 = float(np.abs(t_ranks - t_ref).sum())
    check(t_l1 <= PR_PROC_L1,
          f"the tenant's pagerank.get off float64 by L1 {t_l1}")
    check(interp.execute("MATCH (n) RETURN count(n)")[1] == default_users
          == [[n_nodes]], "the tenant's work changed the default database")
    check(np.array_equal(ranks_by_id(interp.execute(call)[1]), ranks),
          "the default database's CALL changed after the tenant's work")
    summary["tenant"] = {
        "nodes": n_t, "edges": e_t, "build_s": t_build, "call_s": t_tcall,
        "l1_vs_float64": t_l1, "launches": dict(tenant_moved)}

    # --- 6. info queries ---------------------------------------------------
    with counted("info"):
        admin.execute("USE DATABASE memgraph")
        lic = dict(admin.execute("SHOW LICENSE INFO")[1])
        active = admin.execute("SHOW ACTIVE USERS INFO")[1]
    check(set(lic) >= {"organization_name", "is_valid", "status"},
          f"SHOW LICENSE INFO gave {lic}")
    check(sorted(r[0] for r in active) == ["admin", "reader"]
          and len(active) == len(clients),
          f"SHOW ACTIVE USERS INFO gave {active} for {len(clients)} "
          "connections")
    summary["info"] = {"license": lic, "active_sessions": len(active)}

    for c in clients:
        c.close()
    deadline = time.monotonic() + 10
    while server._live_sessions and time.monotonic() < deadline:
        time.sleep(0.01)
    server.stop()
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    check(not thread.is_alive(), "the Bolt server's thread did not stop")
    ictx.dbms.drop("tenant2")
    summary["launches"] = launches
    print("bolt", json.dumps(summary), flush=True)
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    from memgraph_tpu_torch.ops import benes_cuda as BC
    from memgraph_tpu_torch.ops import segment_cuda as SC
    from memgraph_tpu_torch.ops._build import load_kernels
    from memgraph_tpu_torch.ops.native import get_csr_builder, get_router

    card = card_line()
    print("card", card, flush=True)
    # the benes phase's permutations route on the host (the native router
    # runs outside the GIL) while nvcc builds the kernels
    from concurrent.futures import ThreadPoolExecutor
    router = ThreadPoolExecutor(max_workers=1)
    routed = {n: router.submit(routed_permutation, n)
              for n in sorted(BENES_SIZES, reverse=True)}
    router.shutdown(wait=False)
    t0 = time.perf_counter()
    load_kernels()
    check(get_router() is not None, "host Benes router did not build")
    check(get_csr_builder() is not None, "native CSR builder did not build")
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"phase_s {name} {time.perf_counter() - t0:.3f}", flush=True)
        return out

    timed("benes", phase_benes, routed)
    micro_launches, micro_lines = timed("micro", phase_micro, sm_clock_hz())
    micro_after = micro_counts()        # the phase's own comparisons too
    # the segment kernels' counts over the MXU paths too (they stay 0)
    seg_before = {}

    def mxu_path(name, phase, *args):
        SC.reset_launch_counts()
        out = timed(name, phase, *args)
        seg_before[name] = seg_counts()
        return out

    launches, shapes, base = mxu_path("main_path", phase_main_path)
    base["path_k1_lines"] = []
    katz_launches = mxu_path("katz", phase_katz, base)
    server_launches = timed("kernel_server", phase_kernel_server, base)
    refresh_launches, refresh_shapes = mxu_path("refresh", phase_refresh,
                                                base)
    snapshot_launches = mxu_path("snapshot", phase_snapshot, base)
    by_path = {"procedures": timed("procedures", phase_procedures, base),
               "dense_procedures": timed("dense_procedures",
                                         phase_dense_procedures, base),
               "rag_procedures": timed("rag_procedures",
                                       phase_rag_procedures, base),
               "training_procedures": timed("training_procedures",
                                            phase_training_procedures,
                                            base),
               "kernel_server": server_launches,
               "warm_pool": timed("warm_pool", phase_warm_pool, base),
               "vector_delta": timed("vector_delta", phase_vector_delta,
                                     base)}
    timed("snapshot_log", phase_snapshot_log, base)
    seg_lines = timed("segment_kernels", phase_segment_kernels, base)
    by_path.update({
        "segment": timed("segment", phase_segment, base),
        "ppr": timed("ppr", phase_ppr, base),
        "traversal": timed("traversal", phase_traversal, base),
        "mesh": timed("mesh", phase_mesh, base),
        "labelprop": timed("labelprop", phase_labelprop, base),
        "betweenness": timed("betweenness", phase_betweenness, base),
        "gnn": timed("gnn", phase_gnn, base),
        "knn": timed("knn", phase_knn, base),
        "kmeans": timed("kmeans", phase_kmeans, base),
        "ivf": timed("ivf", phase_ivf, base),
        "similarity": timed("similarity", phase_similarity, base),
        "node2vec": timed("node2vec", phase_node2vec, base),
        "gnn_train": timed("gnn_train", phase_gnn_train, base),
        "communities": timed("communities", phase_communities, base),
        "lane": timed("lane", phase_lane, base),
        "tier": timed("tier", phase_tier, base),
        "tgn": timed("tgn", phase_tgn, base),
        "embeddings": timed("embeddings", phase_embeddings, base),
        "trace": timed("trace", phase_trace, base),
        "node2vec_sharded": timed("node2vec_sharded",
                                  phase_node2vec_sharded, base),
    })
    by_path["cypher"], by_path["bolt"] = timed("cypher", phase_cypher, base)
    seg_lines["csr_spmm_sum"] += base.pop("path_k1_lines")
    del base

    replaces = {"benes_mid_gather": "memgraph_tpu/ops/benes_pallas.py:225",
                "benes_mid": "memgraph_tpu/ops/benes_pallas.py:225",
                "benes_outer_gather": "memgraph_tpu/ops/benes_pallas.py:208",
                "benes_outer": "memgraph_tpu/ops/benes_pallas.py:208"}
    roles = {"benes_mid_gather": "middle pass, once per routed net an "
                                 "iteration (2 on the main path, 3 on a "
                                 "refresh)",
             "benes_mid": "placement: composes the middle stages into "
                          "mid_idx, once per network and placement",
             "benes_outer_gather": "outer passes, two per net past one "
                                   "tile an iteration (4 on the main "
                                   "path, 6 on a refresh)",
             "benes_outer": "placement: composes each outer side into "
                            "outer_idx, twice per network and placement"}
    check(refresh_launches["benes_mid_gather"] > 0
          and refresh_launches["benes_outer_gather"] > 0,
          f"the refresh path launched no gather: {refresh_launches}")
    shapes.update(refresh_shapes)
    kernels = []
    for name in ("benes_mid_gather", "benes_mid", "benes_outer_gather",
                 "benes_outer"):
        main = shapes["edge_f32"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "memgraph_tpu_torch/ops/csrc/benes.cu",
            "replaces": replaces[name], "role": roles[name],
            "launches": launches[name],
            "launches_by_path": {"main_path": launches[name],
                                 "katz": katz_launches[name],
                                 "refresh": refresh_launches[name],
                                 "snapshot": snapshot_launches[name],
                                 **{p: c[name] for p, c in by_path.items()}},
            "max_abs_err": max(s[name]["max_abs_err"]
                               for s in shapes.values() if name in s),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "at": "edge net, f32",
            "shapes": {k: s[name] for k, s in shapes.items() if name in s}})
    check(micro_counts() == micro_after,
          f"a micro kernel ran after the micro phase: {micro_counts()}")
    kernels += micro_kernel_entries(micro_launches, micro_lines,
                                    [*seg_before, *by_path])
    check(all(c == dict.fromkeys(c, 0) for c in seg_before.values()),
          f"a segment kernel ran on an MXU path: {seg_before}")
    kernels += segment_kernel_entries(seg_lines, seg_before, by_path)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
