#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   sm_90a into the git-ignored ``build/kernels/``, one ``nvcc`` per source,
   all started together.
3. Kernel phase, K3: checks ptxas's report of the build (every bf16 K3
   kernel and every TMA-route K4 kernel without a spill), then holds the
   flash-attention kernel against
   its plain torch version on the card (f32 to 2e-4, bf16 to 3e-2 and
   element-wise to ``bf16_bound``, which must reject the planted
   ``bf16_faults`` at every bf16 serving shape of ``FAULT_SHAPES``) over
   the kernel test shapes, head dim 256 cases, the serving slices' prefill
   shapes (tinyllama; recurrentgemma's windowed hd-256 attention;
   transformer-wmt's encoder, decoder and cross-attention,
   ``WMT_ATTN_CASES``; whisper-medium's 1500-frame encoder, decoder prompt
   and cross-attention, internvl2-2b's hd-128 prefill and the moe
   family's, llama4-maverick's hd 128 and kimi-k2's hd 112, whole and
   at a model rank's heads, ``FAMILY_ATTN_CASES``) and the edges of the
   TMA/wgmma kernel at hd 64, 128 and 256 (``TMA_EDGE_CASES``); times
   the kernel, the plain version and ``F.scaled_dot_product_attention``
   (the library yardstick, used nowhere in the port; a boolean mask for
   a window, and at the
   recurrentgemma shape also the unwindowed causal call) against the
   roofline bound.  Every kernel time is taken with the queue filled first
   (``timed``), so that it is the device's and not the wrapper's host
   time, which is printed on its own line.
4. Kernel phase, K1/K2: the butterfly combine kernels against their plain
   versions, bit-identical (``torch.equal``), in f32 and bf16 at scales 1
   and 0.25, over small and lane-unaligned sizes, the training slice's
   real stacked bucket sizes and ragged pair lists of both pointer
   alignments, the ranks phase's own operands (``rank_combines``: a
   rank's float32 buckets at scale 1/2, each K1 size and the K2 batch of
   a group step), the elastic phase's (``elastic_combines``: the same
   in each world of 8, 4 and 2 rows, at scale 1/2), the FSDP phase's
   (``fsdp_combines``: the 22-layer sharded plan's ``(4, n_b)`` buffers
   at scale 1/2) and the streamed phase's (``streamed_combines``: the
   22-layer grouped plan's) and the fsdp ranks phase's
   (``fsdp_rank_combines``: a rank's ``(1, n_b / 2)`` slices of the
   2-layer sharded plan's buckets) and its streamed ranks part's
   (``streamed_rank_combines``: the same of the 2-layer grouped plan's)
   and the fsdp model phase's (``fsdp_model_combines``: a rank's ``(1,
   n_b / 2)`` slices of its model coordinate's buckets, gather-all and
   grouped); times each against
   the HBM bound ``3*n*itemsize/3.35e12 s``,
   the plain version and, at scale 1, ``torch.add``/``torch._foreach_add``;
   every case also in place (``out`` is ``w``), and K1 against
   ``torch.add`` in turns at the slice's largest bucket, out of place and
   in place (K1, add, K1 in place, add in place, repeated).
   Kernel phase, K4: the RG-LRU scan kernel against its plain version,
   bit-identical, over tests/test_kernels.py's RGLRU_CASES in f32 and bf16,
   the recurrentgemma slice's prefill shape with and without h0, its decode
   shape and a ragged W, each on the route the rule picks (printed); times
   each against the HBM bound (no single PyTorch call computes the
   recurrence, so no library time).  Then ``K4_EDGE_CASES``, the TMA
   route's edges, on the rule's route and the walk route (a TMA request the
   rule turns down must be refused), and the two routes in turns (walk,
   tma, tma, walk) at the prefill shape.
5. Serving phase: ``ServeScheduler`` serves tinyllama-1.1b at full width in
   bf16 (random weights from a seeded torch generator) over 8 ragged
   requests with a pool small enough to force a recompute preemption; checks
   that every prefill attention went through K3, that every request
   finishes with in-vocab tokens, and, for 2 requests, that the first token
   and the first paged decode step's logits match the dense uncontended
   serving path.  Two profiler windows.
   Handoff phase (slice 8), (a), (b) and (d): the same model and requests
   through ``DisaggregatedScheduler``, the prefill worker on its own copy
   of the weights, each request's KV blocks staged through pinned host
   memory and the ``LinkCostedConnector``'s in-process wire into the
   decode pool (``handoff_phase``).  Checks (a) every request's tokens
   equal the colocated run's, K3 once a layer a prefill and K1/K2/K4
   never, one insert a prefill and ``kv_payload_bytes`` of each prefill's
   ``ceil((prompt + 1) / 16)`` blocks; (d) one request served through a
   wire that flips the top exponent bit of its first V element must fail
   (a).  Prints (b): bytes a prefill, the device-to-host, connector and
   host-to-device host-clock ms, TTFT against the colocated run, and the
   transfer time modeled on the DCN link class (a model, not this
   machine).
6. Training phase: the port's ``Trainer`` runs the WAGMA step on
   tinyllama-1.1b at full width cut to 6 layers, bf16, 8 replicas as rows
   of one state, group size 4, tau 5, SGD with momentum 0.9, seq 512,
   global batch 64, for 12 steps (all 3 phase offsets and the syncs at t=4
   and t=9).  Checks (a) each group step's K1 + K2 launches equal what the
   wavefront schedule predicts for the plan's bucket count, with at least
   one multi-pair K2 launch; (b) after a group step each group's replicas
   are bit-identical and the groups differ, after a sync all rows are;
   (c) on the first step's pre-averaging params the fused K1/K2 average is
   bit-identical to the plan's per-leaf path; (d) every loss is finite and
   no update is skipped.  Prints losses, step time, tokens/s, the host
   split, peak memory and a profiler window over one group step.
   Handoff check (c) on this run: right after the tau-sync at t = 9,
   ``Trainer.consolidated()`` must be row 0 of every leaf bit for bit;
   after the profiled step (rows apart by group) the consolidated weights
   serve the first 4 requests at 6 layers through both schedulers with
   equal tokens, each run's first decode step within 5% of the dense path.
   Elastic phase (slice 6, ``elastic_phase``): the same model (6 layers,
   seq 512, 8 sequences a replica) through ``ElasticTrainer`` over a pool
   of 8 rows, tau 4, S 2, lr 0.05, seed 0: ``chaos_demo``'s schedule
   (a hang and a crash, detector-driven: worlds 8, 4, 8, 4, 8),
   ``kill_rejoin_demo``'s script over a pool of 4 (worlds 4, 2, 4), then
   the chaos schedule again.  Checks (a) each group step's K1/K2 = the
   schedule of that epoch's plan, syncs and K3/K4 none, and each world's
   combine operands are those the K1/K2 phase held; (b) after every
   transition the new rows are the old rows it keeps (params, moments,
   counts) bit for bit, and after every regrow and at the last sync every
   row is row 0; (c) the host-side logs (events, records' world, epoch
   and skip age, staleness, each transition's topology diff) equal those
   of the same schedule and script run on the CPU at smoke size in this
   run, peak age in [1, tau], every transition evicts a plan; (d) finite
   losses, no skip; (e) the replay's logs and losses equal and its final
   state (params, moments, counts, step, phase) the first run's bit for
   bit, compared on the card (``torch.equal``); (f) a regrow off the
   barrier must raise the guard, and joiners seated on row 0 from before
   the sync must fail (b); (g) after each transition and its first step
   at most 1 GiB more than the world size's steady state.  Prints step
   ms by world, each transition's ms (row selection, release, rebuild
   and plan compile as one) and its first step's, K1/K2 by epoch, peak
   memory and the phase's seconds.
   FSDP phase (slice 7a, ``fsdp_phase``): tinyllama-1.1b at full width and
   all 22 layers, bf16, 8 replicas as 4 pods of 2 that share one set of
   ``(4, n_b)`` shard buffers (``Trainer(cfg, 2, pod_axis=4,
   sharding="fsdp")`` over ``Topology.hierarchical(("data", "pod"), (2,
   4))``, sharded over data), S 2, tau 5, lr 0.1, seq 512, 8 sequences a
   member, 5 steps ending on a sync.  Checks (a) each group step's
   K1/K2 = the sharded plan's schedule (9 shard buckets, one stage: 7 +
   1), syncs none, K3/K4 none, and the run's combine operands are those
   the K1/K2 phase held (``fsdp_combines``, ``check_fsdp_held``); (b)
   after each group step the group's pods equal and the groups apart,
   after a sync all four equal, and once an offset the sharded average of
   the pre-average buffers equals the replicated plan over
   ``eff_topology`` (its per-leaf path) on the unpacked pod rows bit for
   bit; (c) at one step pod 0's gradient recomputed from its members'
   ``value_and_grad``, ``bucketing.pack`` in float32, the sum and the
   scale equals the step's grad shards bit for bit; (d) on a 2-layer copy
   at full width, ``replicated_to_fsdp_state(fsdp_to_replicated_state(
   s))`` is ``s`` and ``consolidate_state`` after a sync every pod's row,
   bit for bit; (e) the final state's consolidated weights and pod 0's
   unpacked tree serve 4 requests with the same tokens, K3 22 a prefill;
   (f) the peak under 80 GB, printed beside ``fsdp_reckoning`` and the
   replicated layout's reckoning; (g) finite losses, no skip, and a pod
   buffer nudged by one ulp before the average fails (b).  Prints step ms,
   tokens/s, the host split, peak memory and the phase's seconds.  It
   keeps its losses, pod 0's final params and momentum as canonical trees
   and its consolidated weights for the streamed phase.
   Streamed phase (slice 7b, ``streamed_phase``): the same run through the
   layer-streamed engine (``Trainer(..., sharding="fsdp",
   streamed=True)``): 22 spans of one layer, 24 grouped shard buckets.
   Checks (a) each group step's K1/K2 = the grouped plan's schedule,
   syncs and K3/K4 none, the buckets ``stream_unshard`` reads a pod's
   fwd+bwd = ``expected_stream_gathers`` (46), the schedule valid and the
   combine operands those the K1/K2 phase held (``streamed_combines``);
   (b) at one step pod 0's streamed float32 grad buffers, unpacked and
   merged, equal bit for bit the gather-all plan's ``grad_shards`` of the
   same pre-step pod tree; (c) every loss equals the FSDP phase's at the
   same step, the pods equal after the sync, and pod 0's final params and
   momentum equal the FSDP phase's bit for bit; (d) at 2 layers,
   streamed -> replicated -> streamed and streamed -> gather-all ->
   streamed come back bit for bit, and the final state's serving weights
   equal the FSDP phase's consolidated weights; (e) the grads pass's own
   peak for both phases beside ``grads_pass_reckoning``, the step's peak
   under 80 GB, the streamed peak gathered bytes beside the full tree's;
   (f) finite losses, no skip, and a one-ulp nudge in one span's grad
   buffer fails (b).
   Ranks phase (``ranks_phase``): the same model and step with one replica
   a rank: 4 ranks started by ``torch.distributed.run`` (this script with
   ``--ranks-worker``), gloo, all on the one card (the kernels built
   before they start), each a ``Trainer`` over its rank world, S 2, tau 5,
   global batch 32, 6 steps.  Checks (a) each rank's K1/K2 launches equal
   the schedule for one wire stage a group step, syncs and K3/K4 none; (b)
   after every group step the ranks of each group hold bit-identical
   params, after each sync all four (each rank's sha256 of its params
   gathered to rank 0); (c) once an
   offset, the pre-average params gathered on rank 0 and averaged there by
   the one-process stacked plan equal the wire's average (``torch.equal``);
   (d) finite losses, no skipped update; (e) rank 0's checkpoint
   (``Trainer.save_checkpoint``) reloads into a template with every leaf's
   sha256 equal to the gathered state's, and the one-process stacked
   ``Trainer`` with the same config, seed and batches stays within
   ``RANKS_LOSS_RTOL`` of the ranks' losses and ends with params
   bit-identical to the checkpoint's, which must have moved from the
   initial ones (the first step at which the losses part and the largest
   change from the initial params printed); (g) on every rank and group
   step the wire's event log (``RankWire.events``) follows
   ``pipeline_schedule``: bucket k+1's exchange issued before bucket k's
   receipt is resolved, each resolve before its combine, at least 2 and
   at most ``overlap.max_in_flight`` receipts in flight, no more host
   slots than that; (h) once, the same pre-average rows averaged with
   ``overlap=False`` (the same buckets) and asynchronously are
   ``torch.equal`` on every rank (their exposed wait, span, staging and
   the rest printed side by side), and the wavefront handing bucket k's
   combine bucket k+1's receipt must fail check (c).  Prints the median
   step, its split (grads, update, exchange as device-to-host, exposed
   wait and host-to-device, combine; the sync), each rank's peak memory,
   the device's idle share over a profiled step and the phase's wall
   time.
   Fsdp ranks phase (slice 7c-1, ``fsdp_ranks_phase``): gather-all FSDP
   over a rank world: 8 ranks started by ``torch.distributed.run`` (this
   script with ``--fsdp-ranks-worker``), gloo, all on the one card, data
   2 (the shard axis) x pod 4 on the FSDP phase's topology, each rank one
   member of its pod holding its column slice ``(1, n_b / 2)`` of the
   pod's shard buckets, the ranks phase's model and depth, S 2, tau 5,
   global batch 64, 5 steps.  Checks (a) each rank's K1/K2 a group step =
   one stage of the sharded plan's shard buckets, the sync none, K3/K4
   none, and its combine operands those the K1/K2 phase held
   (``fsdp_rank_combines``); (b) after each group step at each shard
   coordinate the slices of a group's pods have equal sha256 and the
   groups differ, after the sync all four pods agree, and once an offset
   the one-process sharded plan's ``_average_sharded`` of the pre-average
   slices gathered to rank 0 as ``(4, n_b)`` buffers, sliced as each rank
   holds them, has the sha256 of every rank's post-average slices; (c) at
   step 2 each rank's all-gathered buckets have the sha256 of its pod's
   row of the state, and pod 0's reduce-scattered float32 slices joined
   in shard-axis order equal the one-process ``grad_shards`` of its two
   members' gradients bit for bit, joined in swapped order they must
   not; (d) the one-process ``Trainer(sharding="fsdp")`` with the same
   config, seed and batches (run in this process once the ranks' steps
   are done) within ``RANKS_LOSS_RTOL`` of the ranks' losses, and every
   leaf of its own save with the sha256 of the ranks' checkpoint state
   (gathered to rank 0 and converted as the checkpoint writes it), the
   same step and phase, its manifest naming the same leaves; (e) finite losses, no skip, and
   in one more step a NaN in one element of a member's gradient (it
   lands in one member's slice) skips its whole pod (pod 1) under the MIN
   over the pod, while in pod 2, whose guard leaves the MIN out (planted),
   the same NaN parts the members' counts.  Prints rank 0's
   step split (the all-gather, fwd+bwd, the reduce-scatter with their
   bytes, update, the butterfly's exchange and combine, the sync), each
   rank's peak memory, the device's idle share over a profiled step (the
   union of the 8 ranks' device intervals) and the phase's seconds.
   Its streamed ranks part (slice 7c-2, ``streamed_ranks_run``; its own
   key ``streamed_ranks``): on the same ranks, after the gather-all steps
   and before check (e)'s planted NaN, a ``Trainer(sharding="fsdp",
   streamed=True)`` with the same config, seed, batches and steps, each
   rank holding ``(1, n_b / 2)`` of the grouped buckets, each span's
   all-gathers posted before the previous span computes and its
   reduce-scatters as soon as its VJP ends.  Checks (a) K1/K2 a group
   step = one stage of the grouped plan's buckets, the sync none, K3/K4
   none, the operands those the K1/K2 phase held
   (``streamed_rank_combines``); (b) every rank's and step's event log
   passes ``streaming.check_stream_event_log`` (gathers
   ``expected_stream_gathers``, at most 2 span gathers live and 2
   groups' reduce-scatters in flight, live gathered bytes at most
   ``stream_peak_gathered_bytes``); (c) every loss ``==`` the gather-all
   ranks', pod 0's step-2 reduce-scattered slices, unpacked through the
   grouped layout and merged, = the gather-all ranks' bit for bit, and
   the final gathered state merged to the canonical tree has every
   leaf's sha256 of the gather-all ranks'; (d) one fwd+bwd with every
   receipt resolved at once ``torch.equal`` to the asynchronous one on
   every rank (host ms side by side), and with span k's compute handed
   span k+1's gather (planted) parting from it; (e) finite, no skip.
   Prints rank 0's split (the all-gathers' issue and exposed wait,
   fwd+bwd, the reduce-scatters' issue and exposed wait, each with its
   bytes; update, exchange, combine, sync), peaks and the idle share
   beside the gather-all run's.
   Fsdp model phase (slice 7c-3, ``fsdp_model_phase``): FSDP under a
   model axis: 8 ranks started by ``torch.distributed.run`` (this script
   with ``--fsdp-model-worker``), gloo, all on the one card, pod 2 x data
   2 (the shard axis) x model 2, each rank one member of its pod at one
   model coordinate holding ``(1, n_b / 2)`` of that coordinate's shard
   buckets (the plan compiled over its slice tree), the ranks phase's
   model and depth, S 2, tau 5, global batch 32, 5 steps gather-all and
   then 5 streamed on the same ranks.  Checks (a) each rank's K1/K2 a
   group step = one stage of its plan's buckets, the sync none, K3/K4
   none, the operands those the K1/K2 phase held (``fsdp_model_combines``);
   (b) after each step at every (shard, model) coordinate the pods'
   slices have equal sha256, and once an offset each coordinate's
   one-process plan averages the pre-average slices gathered to rank 0
   into every rank's post-average sha256, while a pod view pairing the
   other model coordinate's members (planted) must part; (c) the leaves
   held whole (the norm scales) bit-identical over every model group
   after every step; (d) at step 2 pod 0's reduce-scattered float32
   slices at each model coordinate, joined in shard-axis order, = the
   one-process ``grad_shards`` of its members' slice gradients bit for
   bit, joined swapped (planted) they must part; (e) the one-process
   model-1 ``Trainer(sharding="fsdp")`` (same config, seed, batches)
   within ``MODEL_LOSS_RTOL`` of the ranks' losses, the gathered state in
   its layout (buckets, leaves, step and phase); (f) the streamed run's
   event logs held to the schedule on every rank and step, every loss
   ``==`` the gather-all run's, the final states merged to the canonical
   tree with equal sha256 by leaf, serial fwd+bwd ``torch.equal`` to the
   asynchronous one; (g) finite, no skip, and in one more step a NaN in
   one member's gradient of pod 1 at model rank 1 skips all four of pod
   1's ranks while pod 0 updates, and under the pod's MIN alone
   (planted) a model group's counts part.  Prints rank 0's split of
   each run (the all-gathers' and reduce-scatters' issue and exposed
   wait, fwd+bwd with its TP all-reduces apart, update, exchange,
   combine, sync; the bytes of each), each rank's peak and the idle
   share over the union of the 8 ranks' device intervals.
   Model phase (slice 4b, ``model_phase``): the same model and step with
   each of 4 replicas split over 2 model ranks (Megatron's split): 8 ranks
   started by ``torch.distributed.run`` (this script with
   ``--model-worker``), gloo, all on the one card, model minor, each a
   ``Trainer`` over its rank world, S 2, tau 5, global batch 32, 6 steps;
   then a fresh tinyllama-1.1b at full width and 6 layers served on
   the same ranks, 2 prompts of 512 tokens a dp rank, 16 decode steps
   through ``build_prefill``/``build_serve_step`` (K3 at the rank's 16
   heads over 2 KV heads), against rank 0 serving the whole model on all
   8 prompts.  Checks (a) each rank's K1/K2 launches a group step equal
   the schedule of its plan over its slices (the plan whose operands the
   K1/K2 phase held), a sync none, training no K3 or K4, a prefill K3 22
   times, a decode step nothing; (b) after each group step the dp ranks
   of a group hold equal slices at each model coordinate and the groups
   differ, after the sync all four, and once an offset the stacked plan's
   average of each coordinate's gathered pre-average slices equals the
   wire's (``torch.equal``); (c) the leaves held whole (norm scales)
   bit-identical over every model group after every step; (d) the mean
   losses within ``MODEL_LOSS_RTOL`` of the one-process stacked
   ``Trainer``'s (model 1, same config, seed and batches); (e) the
   prefill's and the first decode step's gathered logits within
   ``LOGIT_RTOL`` of the largest one-rank logit, the tokens equal at every
   step whose one-rank top-2 margin exceeds the logit gap there (the
   counts printed); (f) finite losses, no skip, and a step whose layer-2
   MLP leaves out f's backward all-reduce must fail (c); (g) and (h) as
   the ranks phase's, the mispaired receipts failing (b).  Prints the
   step's split (grads, the TP all-reduces' time and bytes, update, the dp
   exchange), each rank's peak memory, the device's idle share over a
   profiled step and the phase's seconds.
   rg model phase (slice 4c, first part): the model phase's run and
   checks for recurrentgemma-2b at 3 layers over data 2 x model 2 ranks,
   then 6-layer serving of one 3000-token prompt a dp rank
   (``rg_model_spec``; K4 on a rank's 1,280 channels, K3 at its 5 heads).
   Attn model phase (slice 4c, second part, ``attn_model_phase``): 2
   ranks started by ``torch.distributed.run`` (this script with
   ``--attn-model-worker``), gloo, data 1 x model 2 on the one card,
   serving only.  (1) whisper-medium (24 + 24 layers, 1500 frames, a
   4-token prompt), internvl2-2b (24 layers, 256 patches + 512 tokens)
   and transformer-wmt (6 + 6 layers, 64 source tokens, a 16-token
   prompt) at full published width, random weights, one prompt a dp
   rank, a prefill and 16 greedy decode steps through
   ``build_prefill``/``build_serve_step`` on the rank's heads, each
   against rank 0 serving the whole model fed the world's tokens.  (2)
   ``ServeScheduler`` over the same ranks on tinyllama-1.1b at 6 layers:
   8 requests of distinct prompt lengths in [64, 512], 16 new tokens,
   from a pool with no block to spare, each request then through the
   dense model-world steps fed its tokens.  Checks (a) K3 72 a whisper
   prefill (24 by role), 24 an internvl2 one, 18 a transformer-wmt one,
   22 a scheduler (and dense) prefill, none on a decode step, K1, K2 and
   K4 never; (b) each family model's prefill and first decode step's
   gathered logits within ``LOGIT_RTOL`` of the largest one-rank logit,
   the same token at every step whose one-rank top-2 margin exceeds the
   gap; (c) the scheduler preempts, both ranks hold equal tokens,
   admissions, preemptions and decode shapes, and each request holds to
   its dense model-world run by (b)'s rule; (d) the pinned host buffers
   the collectives staged through (``common._HOST``) within their bound,
   one a power-of-two capacity and dtype, printed; (e) transformer-wmt
   served with the cross-attention's g left out must fail (b), and the
   paged steps keeping the rank-local greedy pick must fail (c); (f)
   finite logits, in-vocab tokens; (g) the same 8 requests through
   ``DisaggregatedScheduler`` over the ranks (each rank's prefill worker
   exports its KV heads through its own connector) give the paged run's
   tokens, admissions, preemptions and decode shapes, K3 22 a prefill,
   each rank's connector one insert a prefill of its KV heads' 180,224
   bytes a block, and rank 1's wire flipping the top exponent bit of
   request 0's first V element must fail (g).  Prints each model's
   serving seconds by rank, each rank's staging ms, peak memory and the
   phase's seconds.
   Ep model phase (slice 4c, third part, ``ep_model_phase``): 2 ranks
   started by ``torch.distributed.run`` (this script with
   ``--ep-model-worker``), gloo, data 1 x model 2 on the one card,
   serving only: xlstm-350m (24 layers, in float32, one prompt of 256
   tokens) split by its heads, and llama4-maverick-400b-a17b and
   kimi-k2-1t-a32b at published width, experts, top-k and vocab, 2
   layers, one row of 512 tokens at capacity factor E/k (drop-free by
   construction), through the expert-parallel ``moe_ffn`` (each rank 64
   or 192 experts, one float32 all-reduce a chunk); every rank draws only
   its slices; a prefill and 16 greedy decode steps each, then rank 0
   serves each model whole, fed the world's tokens, once both ranks have
   freed their slices.  Checks (a) K3 2 a moe prefill on each rank, none
   on xlstm's or on a decode step, K1, K2 and K4 never; (b) the model
   phase's check (e) against the one-rank run, no drop in either run,
   the share of assignments routed to another expert than the one-rank
   run's printed; (c) each moe layer's prefill makes ``moe_chunks``
   routed all-reduces and each decode step one (``common.tp_stats``),
   each rank's peak under half the card; (d) a rank reading the slot
   map's rows of experts [0, E/M) (llama4) and an mLSTM reading the next
   rank's ``z`` columns must fail (b); (e) finite logits, in-vocab
   tokens.  Prints each model's init, prefill and decode times by rank
   and one rank whole, the collectives' count and seconds, peaks and the
   phase's seconds.
7. recurrentgemma phase: recurrentgemma-2b at full width and all 26 layers
   in bf16 (random weights from a seeded torch generator) serves a batch of
   4 prompts of 3000 tokens (past the 2048-token window, not a multiple of
   64) and 32 greedy new tokens through ``build_prefill`` and
   ``build_serve_step``.  Checks (a) K4 runs 18 times, all on the TMA
   route, and K3 8 times per prefill, K4 18 times, all on the walk route,
   and K3 never per decode step; (b) the last decode
   step's logits match a fresh prefill over prompt + fed tokens to 5% of
   the largest reference logit; (c) a float32 copy of the model (batch 1, a
   2100-token prompt, 4 decode steps) matches its own ``forward`` at every
   step to 2e-3; (d) every logit finite, every token in the vocab.  Prints
   prefill tokens/s, TTFT, decode ms/step, peak memory and two profiler
   windows (a prefill, a decode step) with K4's and K3's shares.
8. recurrentgemma training phase: first check (e), ``rglru_scan_train`` at
   one training layer's shape (8, 512, 2560) f32 with h0, its output and
   its gradients for a, x and h0 bit-identical between K4 and the plain
   scan on the same CUDA tensors, with the forward K4 launch, the whole
   backward, its K4 launch and its flips timed against the byte bound.
   Then the port's ``Trainer`` on recurrentgemma-2b at full width and the
   published vocab (256000, tied, bf16), depth cut to 5 layers (one
   superblock and both trailing recurrent layers), 4 replicas, group size
   2, tau 5, SGD with momentum 0.9, lr 0.1, seq 512, global batch 32, 12
   steps.  Checks (a) K1/K2 launches as the schedule predicts; (b) K4
   launched 3 times per superblock recurrent layer (forward, recompute,
   backward) and 2 per trailing one, per replica and step, all on the TMA
   route, K3 never; (c) each group's rows bit-identical after each step
   (and the fused average equal to the per-leaf one); (d) finite losses, no
   skipped update.  Prints the step time, tokens/s, the host split, peak
   memory and a profiler window over one group step.
9. Paper phase: transformer-wmt (the paper's own model) at full width and
   depth (6 + 6 layers, d 512, 8 heads, d_ff 2048, vocab 32768 tied, bf16;
   79,724,544 params a replica, random weights from a seeded torch
   generator).  (1) Training, depth cut to ``PAPER_TRAIN_LAYERS`` (one
   encoder and one decoder layer, the least with every block kind; the
   step is host-bound, its time about in proportion to the layers): the
   port's ``Trainer`` with 16 replicas as rows of one state, SGD momentum
   0.9, lr 0.1, target seq 256 over 64
   source tokens, global batch 64, under each of the paper's seven
   averagers: 10 steps of ``wagma`` at S 4 and tau 10 and of
   ``local_sgd`` syncing every 10 (both offsets and the sync at t = 9);
   the steps check (b) needs of the others
   (``allreduce`` and ``eager_sgd`` 3, ``dpsgd`` 2, ``sgp`` and ``adpsgd``
   5, one a phase and one more, ``paper_steps``).  Checks (a) WAGMA's
   group steps launch the K1/K2 the schedule predicts, every sync and
   every baseline step none, and no step K3 or K4; (b) WAGMA's groups bit-identical, and its fused K1/K2
   average bit-identical to the plan's plain per-leaf average of the same
   rows on the first step of each phase offset; Allreduce-SGD's and
   Eager-SGD's rows bit-identical after every step, local SGD's apart
   before its sync and identical at it, and the gossip baselines' mix of
   the rows on the card bit-identical to the CPU's mix of the same rows on
   the first step of each phase (4 at P 16 for SGP and AD-PSGD, 1 for
   D-PSGD; the CPU mixes run on a thread behind the steps that follow,
   ``GossipChecks``, settled at the phase's end); (c) finite losses, no
   skipped update.  Prints each averager's
   step time, tokens/s, host split and peak memory, and a profiler window
   over one step of ``wagma`` and of ``allreduce``.  (2) Paper Fig. 5 at
   that width: ``staleness.wagma_sim_step`` under two stragglers an
   iteration against Allreduce-SGD, 40 iterations each, printing both loss
   curves, the means of their last 8 and the ratio (a finding, not a
   check).  (3) Translation serving in bf16: batch 8, 64 source tokens,
   16-token prompts, 32 greedy new tokens through ``build_prefill``/
   ``build_serve_step``.  Checks (a) K3 18 launches a prefill (by role: 6
   encoder, 6 decoder, 6 cross) and none a decode step; (b) the last
   decode step's logits against a fresh prefill to 5% of the largest; (c)
   a float32 copy's decode against its own ``forward`` to 2e-3; (d)
   finite logits, in-vocab tokens.  Two profiler windows (a prefill, a
   decode step).
10. Family phase: whisper-medium (24 + 24 layers, d 1024, 16 heads of 64,
   batch 4 x 1500 frame embeddings, a 4-token prompt), internvl2-2b (24
   layers, d 2048, 16 heads of 128 over 8 KV heads, batch 4 x 256 patch
   embeddings + 512 tokens, decode positions after the patches) and
   xlstm-350m (12 mLSTM + 12 sLSTM blocks, d 1024, batch 4 x 512 tokens)
   at full published width and depth in bf16, random weights from a seeded
   torch generator, 32 greedy new tokens each through ``build_prefill``/
   ``build_serve_step`` (``family_serve_phase``).  Checks (a) K3 72 a
   whisper prefill (24 encoder, 24 decoder, 24 cross by role), 24 an
   internvl2 prefill, none on xlstm's path and none a decode step, K1, K2
   and K4 never; (b) the last decode step against a fresh prefill to 5% of
   the largest logit; (c) a float32 copy's decode against its own
   ``forward`` to 2e-3; (d) finite logits, in-vocab tokens.  Prints TTFT,
   prefill positions/s, decode ms/step, peak memory and two profiler
   windows each.
11. Moe phase (``moe_serve_phase``): llama4-maverick-400b-a17b (128
   experts, top-1, a dense + moe superblock) and kimi-k2-1t-a32b (384
   experts, top-8, the first dense layer + one moe layer, head dim 112)
   at published width, expert count, top-k and vocab in bf16, depth cut
   to 2 layers (18.6 and 19.6 B params), random weights drawn one matrix
   at a time, batch 4 x 512 tokens, 32 greedy new tokens at the config's
   capacity factor (the timed prefill's dropped share printed).  Checks
   (a) K3 2 a prefill, none a decode step, K1, K2, K4 never; (b) the
   last decode step against a fresh prefill to 5% of the largest logit,
   at capacity factor ``MOE_DROPFREE_FACTOR``, where both prefills and
   every decode step must drop nothing; (c) a float32 copy of the first 16 experts against its own
   ``forward`` to 2e-3, drop-free; (d) finite logits, in-vocab tokens.
   Two profiler windows each; memory freed between the two models.
12. Prints a ``kernels`` JSON line (K3 once a serving path: tinyllama,
   its launches by path (colocated, disaggregated, the trained state's),
   recurrentgemma's hd 256, transformer-wmt's and whisper-medium's encoder
   shapes with their launches and times by role, internvl2-2b's hd-128
   prefill, llama4-maverick's hd-128 and kimi-k2's hd-112 prefill; K4
   twice: ``rglru_scan`` on its TMA
   route at the prefill shape, with all of its main-path launches, serving
   and training, and their split by route and path, and its training
   scan's times; ``rglru_scan_decode`` on the walk route at the decode
   shape, with the walk route's launches; K1/K2 with their launches on the
   six training paths, the elastic, the ranks' and the FSDP one among
   them, and those paths' own shapes and times, ``elastic_row`` by world,
   ``fsdp_row``, ``ranks_row``, ``model_row`` and ``fsdp_ranks_row``, a
   rank's slice buckets;
   K3 also at the model phase's prefill, a rank's 16 heads over 2 KV
   heads, at the attn model phase's rank shapes and at the ep model
   phase's moe prefills, a rank's 20 or 32 heads over 4 KV heads), then
   ``{"ok": true,
   "device": ...}`` last.

Exits non-zero, printing no result, without CUDA or without the repo's
``src/`` beside it.  TF32 is off for matmuls and cuDNN so float32 means
float32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# rate, float32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# tests/test_kernels.py ATTN_CASES: (b, sq, sk, h, kh, hd, causal, window, dtype)
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, "float32"),
    (1, 256, 256, 4, 4, 32, True, 64, "float32"),
    (2, 100, 100, 2, 1, 64, False, None, "float32"),
    (1, 128, 256, 4, 2, 128, True, None, "float32"),
    (1, 64, 64, 2, 2, 64, True, None, "bfloat16"),
    (1, 72, 72, 3, 1, 48, True, 16, "float32"),
]
# each shape in both dtypes: the kernel has a float32 and a bfloat16 path
KERNEL_CASES = list(dict.fromkeys(c[:8] + (dt,) for c in ATTN_CASES
                                  for dt in ("float32", "bfloat16")))
# tinyllama-1.1b prefill at B=1: H=32, KH=4, hd=64, bf16, causal
SLICE_LENGTHS = (1, 100, 1024, 2048)
SLICE_SHAPE_FOR_LINE = 1024          # the kernels line reports this shape
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# bf16 K3 is also held element by element to the float32 result on the same
# bf16 inputs: |got - want| <= BF16_RTOL * mag + BF16_ATOL, with mag the
# attention over |v| (sum_k p_k |v_k|), which scales the weighted sum's
# rounding (P and the output each rounded to bf16: <= 2^-8 * mag together).
# An absolute 3e-2 is the size of a typical output at 2048 visible keys;
# this bound rejects the planted faults of bf16_faults.
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3
FAULT_TILE = 64    # keys: K3's KV tile at hd 256, half of one at hd 64
# K3 at head dim 256, each in both dtypes, then recurrentgemma-2b's
# attention: the bf16 serving prefill and the f32 check's prefill
HD256_CASES = [c + (dt,) for c in ((1, 128, 128, 2, 1, 256, True, None),
                                   (2, 100, 100, 4, 2, 256, False, None),
                                   (1, 300, 300, 2, 1, 256, True, 64))
               for dt in ("float32", "bfloat16")]
RG_ATTN_SHAPE = (4, 3000, 3000, 10, 1, 256, True, 2048, "bfloat16")
# the rg model phase's prefill on one rank: recurrentgemma's 10 heads split
# over 2 model ranks, its one KV head held whole, one prompt a dp rank
RG_MODEL_ATTN = (1, 3000, 3000, 5, 1, 256, True, 2048, "bfloat16")
HD256_CASES += [RG_ATTN_SHAPE, RG_MODEL_ATTN,
                (1, 2100, 2100, 10, 1, 256, True, 2048, "float32")]
# transformer-wmt serving's attentions (8 heads of 64, no GQA) in both
# dtypes: the encoder (non-causal, Sq = Sk = 64 source tokens), the
# decoder's prompt (causal, 16 tokens), the cross-attention (non-causal, 16
# queries over 64 keys), and a ragged non-causal edge (300 keys, not a
# multiple of the KV tile, more keys than queries)
WMT_ATTN_ROLES = {"encoder": (8, 64, 64, 8, 8, 64, False, None),
                  "decoder": (8, 16, 16, 8, 8, 64, True, None),
                  "cross": (8, 16, 64, 8, 8, 64, False, None)}
WMT_ATTN_CASES = [c + (dt,) for c in list(WMT_ATTN_ROLES.values())
                  + [(1, 100, 300, 4, 4, 64, False, None)]
                  for dt in ("float32", "bfloat16")]
# whisper-medium serving's attentions (16 heads of 64, no GQA) at batch 4:
# the encoder over the published 1500 frames (non-causal, not a multiple of
# the KV tile), the decoder's 4-token prompt (causal) and the
# cross-attention of those 4 queries over the 1500 frames; internvl2-2b's
# prefill at head dim 128 (16 heads, 8 KV) over 256 patches + 512 tokens
WHISPER_ATTN_ROLES = {"encoder": (4, 1500, 1500, 16, 16, 64, False, None),
                      "decoder": (4, 4, 4, 16, 16, 64, True, None),
                      "cross": (4, 4, 1500, 16, 16, 64, False, None)}
VLM_ATTN = (4, 768, 768, 16, 8, 128, True, None)
# the moe family's prefill at batch 4 x 512 tokens: llama4-maverick's 40
# heads of 128 over 8 KV heads, kimi-k2's 64 heads of 112 (7168 / 64) over
# 8, which the bf16 kernel pads to 128 columns by the TMA's zero fill
LLAMA4_ATTN = (4, 512, 512, 40, 8, 128, True, None)
KIMI_ATTN = (4, 512, 512, 64, 8, 112, True, None)
# the model phase's prefill on one rank: tinyllama's 32 heads and 4 KV
# heads split over 2 model ranks, 2 prompts of 512 a dp rank
MODEL_ATTN = (2, 512, 512, 16, 2, 64, True, None)
# the attn model phase's prefills on one rank of data 1 x model 2, one
# prompt a dp rank: whisper-medium's and transformer-wmt's roles at half
# their heads, internvl2-2b's 256 patches + 512 tokens at 8 of its 16 heads
# over 4 of its 8 KV heads, and the paged scheduler's longest tinyllama
# prompt at 16 heads over 2 KV heads (its lengths: SCHED_PROMPT's range,
# SCHED_SEED's draw)
WHISPER_RANK_ROLES = {"encoder": (1, 1500, 1500, 8, 8, 64, False, None),
                      "decoder": (1, 4, 4, 8, 8, 64, True, None),
                      "cross": (1, 4, 1500, 8, 8, 64, False, None)}
WMT_RANK_ROLES = {"encoder": (1, 64, 64, 4, 4, 64, False, None),
                  "decoder": (1, 16, 16, 4, 4, 64, True, None),
                  "cross": (1, 16, 64, 4, 4, 64, False, None)}
VLM_RANK_ATTN = (1, 768, 768, 8, 4, 128, True, None)
# the ep model phase's moe prefills on one rank of data 1 x model 2, one
# row of 512 tokens: llama4-maverick's 40 heads over 8 KV heads and
# kimi-k2's 64 over 8 (hd 112, the TMA's zero fill to 128) at half their
# heads
LLAMA4_RANK_ATTN = (1, 512, 512, 20, 4, 128, True, None)
KIMI_RANK_ATTN = (1, 512, 512, 32, 4, 112, True, None)
SCHED_REQUESTS, SCHED_PROMPT, SCHED_SEED = 8, (64, 512), 5


def sched_lengths(lo_hi=SCHED_PROMPT) -> list:
    """The paged scheduler's ``SCHED_REQUESTS`` distinct prompt lengths in
    ``lo_hi``, from ``SCHED_SEED``."""
    lo, hi = lo_hi
    return [int(n) for n in np.random.default_rng(SCHED_SEED).choice(
        np.arange(lo, hi + 1), SCHED_REQUESTS, replace=False)]


SCHED_RANK_ATTN = (1, max(sched_lengths()), max(sched_lengths()), 16, 2, 64,
                   True, None)
FAMILY_ATTN_CASES = [c + (dt,) for c in list(WHISPER_ATTN_ROLES.values())
                     + [VLM_ATTN, LLAMA4_ATTN, KIMI_ATTN, MODEL_ATTN]
                     + list(WHISPER_RANK_ROLES.values())
                     + list(WMT_RANK_ROLES.values())
                     + [VLM_RANK_ATTN, SCHED_RANK_ATTN, LLAMA4_RANK_ATTN,
                        KIMI_RANK_ATTN]
                     for dt in ("float32", "bfloat16")]
# the tinyllama prefill shape the kernels line reports
TL_ATTN_SHAPE = (1, SLICE_SHAPE_FOR_LINE, SLICE_SHAPE_FOR_LINE, 32, 4, 64,
                 True, None, "bfloat16")
# the bf16 serving shapes at which the bound must reject bf16_faults
FAULT_SHAPES = {TL_ATTN_SHAPE, RG_ATTN_SHAPE, RG_MODEL_ATTN} | {
    c for c in FAMILY_ATTN_CASES if c[8] == "bfloat16"}
# Edges of the TMA/wgmma bf16 kernel (tiles of 128 keys and a 4-stage ring
# at hd 64, 128 keys and 2 stages at hd 128, 64 keys and 2 stages at hd 256;
# 128 query rows a block), at the three serving head dims: Sk under one
# tile; Sk past a ring wrap and not a
# tile multiple; B = 3 with a ragged Sq; a window under a tile, also
# non-causal with Sq > Sk so that whole blocks see no key; windows of at
# least Sk; GQA at rep 8 and 10; non-causal with Sq != Sk both ways.  Then
# bf16 head dims that the TMA's zero fill pads to 64 or 128 columns.
TMA_EDGE_CASES = [c[:5] + (hd,) + c[5:] + ("bfloat16",)
                  for hd in (64, 128, 256)
                  for c in ((2, 40, 40, 4, 2, True, None),
                            (1, 130, 1100, 4, 1, False, None),
                            (1, 1100, 1100, 2, 1, True, None),
                            (3, 200, 200, 4, 2, True, None),
                            (1, 300, 300, 4, 2, True, 16),
                            (1, 300, 100, 2, 1, False, 16),
                            (1, 300, 300, 4, 2, True, 300),
                            (1, 300, 300, 4, 2, True, 1000),
                            (1, 256, 256, 8, 1, True, None),
                            (2, 256, 256, 10, 1, True, None),
                            (2, 100, 300, 4, 2, False, None),
                            (1, 300, 100, 4, 2, False, None))] + [
    (1, 100, 100, 4, 2, hd, True, None, "bfloat16") for hd in (16, 80, 96, 112)]
# card cycles per second used to size the queue-filling sleep (above the
# H100's 1.98 GHz boost clock, so the sleep is never shorter than asked)
SLEEP_CYCLES_PER_S = 2.0e9

# K4 kernel phase: tests/test_kernels.py RGLRU_CASES (b, s, w, with_h0) in
# both dtypes, recurrentgemma-2b's prefill scan with and without h0, its
# decode scan and a ragged W
RGLRU_CASES = [(3, 200, 96, True), (1, 17, 130, False), (8, 128, 128, True),
               (2, 300, 64, False)]
RG_SCAN_SHAPE = (4, 3000, 2560, False, "float32")
RG_DECODE_SCAN_SHAPE = (4, 1, 2560, True, "float32")
# the rg model phase's scans on a rank's 1280 channels: the prefill of one
# 3000-token prompt, a training layer's (4 rows x 512, with h0 as the
# backward's), a decode step
RG_MODEL_SCAN_SHAPES = {"prefill": (1, 3000, 1280, False, "float32"),
                        "train": (4, 512, 1280, True, "float32"),
                        "decode": (1, 1, 1280, True, "float32")}
K4_CASES = ([c + (dt,) for c in RGLRU_CASES for dt in ("float32", "bfloat16")]
            + [RG_SCAN_SHAPE, (4, 3000, 2560, True, "float32"),
               RG_DECODE_SCAN_SHAPE, (2, 37, 1001, True, "float32"),
               (2, 37, 1001, True, "bfloat16")]
            + list(RG_MODEL_SCAN_SHAPES.values()))
# K4's dtypes by name: (a's, x's); "mixed" is a bf16 gate on an f32 input
K4_DTYPES = {"float32": ("float32", "float32"),
             "bfloat16": ("bfloat16", "bfloat16"),
             "mixed": ("bfloat16", "float32")}
# Edges of K4's TMA route (slots of 32 steps, boxes of 64 channels): S one
# under a slot, one slot, one over, the same about two slots, the
# prefill's; W under one box, a ragged box, the prefill's, one box and 8
# channels past it; each at B 1 and 5, with and without h0, in every dtype
# pair.  Each runs the route the rule picks and the walk route, both
# bit-identical to the plain loop.
K4_EDGE_CASES = [(b, s, w, h0, dt) for s in (31, 32, 33, 63, 64, 65, 3000)
                 for w in (32, 40, 2560, 2568) for b in (1, 5)
                 for h0 in (False, True) for dt in K4_DTYPES]
# paired timings, in turns within one call: K4's routes at the prefill
# shape (walk, tma, tma, walk); K1 and torch.add at the slice's largest
# stacked bucket, out of place and in place
PAIR_ROUNDS = 4

# K1/K2 kernel phase: sizes in elements (0 returns w unlaunched; 127, 1000
# and 2**20+3 leave a scalar tail), both storage dtypes, both scales the
# butterfly uses; ragged lists for K2, each pair also taken at an offset of
# one element so that its pointers are not 16-byte aligned
GA_SIZES = (0, 1, 127, 128, 1000, 2 ** 20 + 3)
GA_RAGGED = (1000, 1, 128, 127, 0, 4099, 2 ** 20 + 3, 77)
GA_SCALES = (1.0, 0.25)
GA_DTYPES = ("float32", "bfloat16")

# training phase: tinyllama-1.1b at full width, depth cut to 6 layers so
# that 8 replicas' bf16 params, fp32 momentum and the fp32 averaging
# buffers fit one 80 GB card
TRAIN_LAYERS, TRAIN_P, TRAIN_S, TRAIN_TAU = 6, 8, 4, 5
TRAIN_SEQ, TRAIN_GB, TRAIN_STEPS, TRAIN_LR = 512, 64, 12, 0.1
K1, K2, K3, K4 = ("group_average_combine", "group_average_combine_multi",
                  "flash_attention", "rglru_scan")

# elastic phase (slice 6): the training phase's model (6 layers, seq 512, 8
# sequences a replica) through ElasticTrainer over a pool of ELASTIC_POOL
# rows at the reference demos' tau, S, lr and seed: chaos_demo's schedule
# (12 steps), kill_rejoin_demo's script over a pool of ELASTIC_KILL_POOL
# (8 steps, worker 2 leaves and rejoins at t = 2), the chaos schedule
# again (the replay); check (c)'s twin runs both on the CPU at smoke size
# with a sequence of ELASTIC_TWIN_SEQ
ELASTIC_POOL, ELASTIC_KILL_POOL, ELASTIC_TAU, ELASTIC_S = 8, 4, 4, 2
ELASTIC_LR, ELASTIC_CHAOS_STEPS, ELASTIC_KILL_STEPS = 0.05, 12, 8
ELASTIC_KILL_STEP, ELASTIC_KILL_WORKER, ELASTIC_TWIN_SEQ = 2, 2, 16
# the worlds the two runs visit: the pools and the shrinks of the pool of 4
ELASTIC_WORLDS = (ELASTIC_POOL, ELASTIC_KILL_POOL, ELASTIC_KILL_POOL // 2)
# check (g): after a transition and after its first step the card holds at
# most this much more than the same world size's steady state
ELASTIC_MEMORY_SLACK = 1 << 30
K4_TMA, K4_WALK = "rglru_scan_tma", "rglru_scan_walk"    # K4's route counts

# FSDP phase (slice 7a): tinyllama-1.1b at full width and all 22 layers, 8
# replicas as 4 pods of 2 sharing one set of shard buffers
# (Topology.hierarchical(("data", "pod"), (2, 4)) sharded over data: P 8,
# P_eff 4), S 2, tau 5, SGD 0.9 at the training phase's lr, seq 512, 8
# sequences a member, 5 steps (t = 0..3 group steps, both offsets twice;
# the sync at t = 4, so the run ends on a sync for check (e)).  Check (c) at
# step FSDP_GRAD_STEP; check (d) on a copy of FSDP_CONV_LAYERS layers at
# full width (the replicated form of 22 layers needs 52.8 GB); check (e)
# serves the first FSDP_REQUESTS requests of the serving phase's set
FSDP_DATA, FSDP_POD, FSDP_S, FSDP_TAU, FSDP_STEPS = 2, 4, 2, 5, 5
FSDP_GB = 8 * FSDP_DATA * FSDP_POD
FSDP_GRAD_STEP, FSDP_CONV_LAYERS, FSDP_REQUESTS = 2, 2, 4
FSDP_PATH = f"tinyllama-1.1b fsdp, {FSDP_POD} pods x {FSDP_DATA}"
# streamed phase (slice 7b): the FSDP phase's run through the layer-streamed
# engine (Trainer(..., streamed=True)), the same model, topology, seed and
# steps; check (b) at step FSDP_GRAD_STEP, check (d) at FSDP_CONV_LAYERS
STREAMED_PATH = f"tinyllama-1.1b fsdp streamed, {FSDP_POD} pods x {FSDP_DATA}"

# ranks phase: the training phase's model with one replica a rank: RANKS_P
# ranks started by torchrun over gloo, all on the one card (NCCL refuses
# two ranks on one card), S 2 (the default at P 4), tau, lr and sequence
# as the training phase, global batch 32 (8 rows a replica, as 64 over 8
# there), 10 steps (both offsets and the syncs at t = 4 and 9), at
# RANKS_LAYERS layers (6 until the rg model phase needed the room: none
# of its checks depends on depth, and its checkpoint shrinks ~45%)
RANKS_P, RANKS_S, RANKS_GB, RANKS_STEPS = 4, 2, 32, 10
RANKS_LAYERS = 2
RANKS_TIMEOUT = 600
RANKS_WORKER_FLAG = "--ranks-worker"
# check (e): the ranks against the one-process stacked Trainer (PERF.md
# §2): every param bit-identical, the mean losses to 1e-6 relative (the
# four ranks' losses are the twin's rows' bit for bit; only the order of
# their float32 mean differs, a few units in the last place)
RANKS_LOSS_RTOL = 1e-6

# fsdp ranks phase (slice 7c-1): gather-all FSDP over a rank world, the
# FSDP phase's topology (data 2 x pod 4, sharded over data, P_eff 4) with
# one member a gloo rank, all on the one card, at the ranks phase's depth,
# S 2, tau 5, lr and sequence as the training phase, 8 rows a rank, 5
# steps (group steps on both offsets twice, the sync at t = 4; cut from 6
# for time, PERF.md §6); check (c) at step FSDP_RANKS_GRAD_STEP, the
# profiled window step FSDP_RANKS_PROFILED; check (e)'s planted NaN in
# the gradient of one member of each pod of FSDP_RANKS_BAD_PODS: the
# first keeps the MIN over the pod, the second runs the planted guard
# without it, in one step
FSDP_RANKS_P, FSDP_RANKS_STEPS = FSDP_DATA * FSDP_POD, 5
FSDP_RANKS_GB = 8 * FSDP_RANKS_P
FSDP_RANKS_GRAD_STEP, FSDP_RANKS_PROFILED = 2, 3
FSDP_RANKS_BAD_PODS = (1, 2)
FSDP_RANKS_TIMEOUT = 600
FSDP_RANKS_WORKER_FLAG = "--fsdp-ranks-worker"
FSDP_RANKS_PATH = (f"tinyllama-1.1b fsdp, data {FSDP_DATA} x pod {FSDP_POD} "
                   f"ranks")
# the fsdp ranks phase's streamed ranks part (slice 7c-2): the same ranks,
# config, batches and steps through the layer-streamed engine, after the
# gather-all steps and before check (e)'s planted NaN
STREAMED_RANKS_PATH = (f"tinyllama-1.1b fsdp streamed, data {FSDP_DATA} x "
                       f"pod {FSDP_POD} ranks")

# model phase (slice 4b): the ranks phase's model and step with each
# replica's model split over MODEL_M ranks (Megatron's split, model minor):
# MODEL_DATA x MODEL_M ranks started by torchrun over gloo, all on the one
# card, S 2, tau, lr and sequence as the training phase, global batch 32
# (8 rows a replica), 6 steps (both offsets and the sync at t = 4); then a
# fresh model at MODEL_SERVE_LAYERS layers served on the same ranks,
# MODEL_ROWS prompts of MODEL_PROMPT tokens a dp rank and MODEL_NEW decode
# steps, against rank 0 serving the whole model on every prompt
MODEL_DATA, MODEL_M, MODEL_S, MODEL_GB, MODEL_STEPS = 4, 2, 2, 32, 6
# the model phase's training depth: 6 (the training phase's) until the
# attn model phase needed the room; none of its checks depends on depth
MODEL_LAYERS = 2
# the model phases' serving depths and the attn model phase's scheduler's:
# each model's own (22 tinyllama, 26 recurrentgemma) until the fsdp ranks
# phase needed the time; no check depends on depth, and 6 recurrentgemma
# layers hold both block kinds twice
MODEL_SERVE_LAYERS, RG_MODEL_SERVE_LAYERS, SCHED_LAYERS = 6, 6, 6
MODEL_ROWS, MODEL_PROMPT, MODEL_NEW, MODEL_SERVE_SEED = 2, 512, 16, 3
MODEL_TIMEOUT = 600
MODEL_WORKER_FLAG = "--model-worker"
# check (f)'s planted fault: the layer whose MLP leaves out f's all-reduce
MODEL_FAULT_LAYER = 2
# check (d): the model ranks' mean losses against the one-process stacked
# Trainer's (PERF.md §2): the TP sums of bf16 partial products round in
# another order than one matmul's; the gap measured 2.44e-5 on the H100
# (6 steps), the bound four times that
MODEL_LOSS_RTOL = 1e-4

# fsdp model phase (slice 7c-3): FSDP under a model axis, pod 2 x data 2
# (the shard axis) x model MODEL_M gloo ranks on the one card, each one
# member of its pod at one model coordinate holding its (1, n_b / 2)
# slice of that coordinate's shard buckets (P_eff 2: one group spans both
# pods), the ranks phase's depth, S 2, tau 5, lr and sequence as the
# training phase, 8 rows a replica, 5 steps gather-all and then 5
# streamed on the same ranks; check (d) at step FSDP_MODEL_GRAD_STEP, the
# profiled step FSDP_MODEL_PROFILED; check (g)'s NaN in the gradient of
# dp rank FSDP_MODEL_BAD (pod 1) at model rank 1
FSDP_MODEL_POD, FSDP_MODEL_STEPS = 2, 5
FSDP_MODEL_P = FSDP_DATA * FSDP_MODEL_POD
FSDP_MODEL_RANKS = FSDP_MODEL_P * MODEL_M
FSDP_MODEL_GB = 8 * FSDP_MODEL_P
FSDP_MODEL_GRAD_STEP, FSDP_MODEL_PROFILED, FSDP_MODEL_BAD = 2, 3, 3
FSDP_MODEL_TIMEOUT = 600
FSDP_MODEL_WORKER_FLAG = "--fsdp-model-worker"
FSDP_MODEL_PATH = (f"tinyllama-1.1b fsdp, pod {FSDP_MODEL_POD} x data "
                   f"{FSDP_DATA} x model {MODEL_M} ranks")
STREAMED_MODEL_PATH = (f"tinyllama-1.1b fsdp streamed, pod {FSDP_MODEL_POD} "
                       f"x data {FSDP_DATA} x model {MODEL_M} ranks")

# rg model phase (slice 4c): the model phase's run for recurrentgemma-2b at
# full width and vocab, RG_MODEL_LAYERS layers (one superblock: two
# recurrent layers and the local attention, the smallest depth with every
# block kind), each replica split over MODEL_M model ranks, RG_MODEL_DATA
# x MODEL_M gloo ranks on the one card, S 2, tau, lr and sequence as the
# recurrentgemma training phase, 4 rows a replica, 5 steps (t = 0..3 group
# steps, both offsets twice, the sync at t = 4); then a fresh model at
# RG_MODEL_SERVE_LAYERS layers served on the same ranks, RG_MODEL_ROWS
# prompt of RG_MODEL_PROMPT tokens (past the 2048-token window) a dp rank
# and MODEL_NEW decode steps, against rank 0 serving the whole model; check
# (f)'s planted fault leaves out the sum that makes w_r's gradient whole
# in the first recurrent layer
RG_MODEL_DATA, RG_MODEL_LAYERS, RG_MODEL_GB, RG_MODEL_STEPS = 2, 3, 8, 5
RG_MODEL_ROWS, RG_MODEL_PROMPT = 1, 3000
# attn model phase (slice 4c, second part): serving only, over data
# ATTN_MODEL_DATA x MODEL_M gloo ranks on the one card: whisper-medium (24
# + 24 layers, 1500 frames), internvl2-2b (24 layers, 256 patches) and
# transformer-wmt (6 + 6 layers, WMT_SRC source tokens) at full published
# width and depth, random weights from ATTN_MODEL_SEED, one prompt of
# ATTN_MODEL_PROMPTS[arch] tokens a dp rank and MODEL_NEW decode steps,
# each against rank 0 serving the whole model; then the paged scheduler on
# tinyllama-1.1b at SCHED_LAYERS layers over the same ranks, SCHED_REQUESTS
# requests of distinct lengths (SCHED_PROMPT's range) and SCHED_NEW new
# tokens each from a pool with no block to spare, each request against
# the dense model-world run of it; check (e)'s rank-local pick on the
# first SCHED_FAULT_REQUESTS requests
ATTN_MODEL_DATA, ATTN_MODEL_SEED, ATTN_MODEL_TIMEOUT = 1, 4, 600
ATTN_MODEL_WORKER_FLAG = "--attn-model-worker"
SCHED_NEW, SCHED_FAULT_REQUESTS = 8, 2

# serving phase
ARCH = "tinyllama-1.1b"
N_REQUESTS, PROMPT_MIN, PROMPT_MAX, MAX_NEW = 8, 64, 1024, 32
BLOCK_SIZE, MAX_BLOCKS_PER_REQ, MAX_BATCH = 16, 96, 8
SPARE_BLOCKS = 2                     # pool = prompts + SPARE: growth preempts
CHECKED_REQUESTS = (0, 1)
# Paged vs dense first-step logits: the same bf16 model at batch 8 vs 1
# runs other matmul tilings, so the results round differently in bf16 across
# 22 layers.  Held to 5% of the largest reference logit.
LOGIT_RTOL = 0.05

# handoff phase (slice 8): the serving phase's model and requests through
# DisaggregatedScheduler, the prefill worker on its own weight copy; check
# (c) consolidates the training phase's state right after its tau-sync at
# step HANDOFF_SYNC_STEP, and serves its consolidated weights at the end on
# the first HANDOFF_REQUESTS requests
HANDOFF_SYNC_STEP, HANDOFF_REQUESTS = 9, 4

# recurrentgemma phase: batch, prompt length (past the 2048 window, not a
# multiple of 64), new tokens; the float32 check's prompt and decode steps,
# held to the JAX package's test_decode_matches_forward tolerance
RG_ARCH = "recurrentgemma-2b"
RG_BATCH, RG_PROMPT, RG_NEW = 4, 3000, 32
RG_F32_PROMPT, RG_F32_STEPS, RG_F32_TOL = 2100, 4, 2e-3

# recurrentgemma training phase: full width and the published vocab (256000,
# tied), depth cut to 5 layers (one superblock and both trailing recurrent
# layers, so that every block type runs), 4 replicas (each holds ~10 bytes a
# param: bf16 params, fp32 momentum, the fp32 averaging bucket; at 8 the
# 655,360,000-param embedding alone needs 52 GB), group size 2; tau, lr,
# sequence and steps as the tinyllama phase, 8 rows a replica
RG_TRAIN_LAYERS, RG_TRAIN_P, RG_TRAIN_S, RG_TRAIN_GB = 5, 4, 2, 32
# one training layer's scan: (rows a replica, TRAIN_SEQ, lru_width)
SCAN_TRAIN_SHAPE = (RG_TRAIN_GB // RG_TRAIN_P, TRAIN_SEQ, 2560)

# paper phase: transformer-wmt (the paper's own model) at full width in
# bf16, the Trainer's runs at PAPER_TRAIN_LAYERS encoder and decoder
# layers (6 + 6 until the fsdp ranks phase needed the time: none of their
# checks depends on depth; Fig. 5 and serving keep all 12), P = 16 replicas (Fig. 5's worker count), S = 4 (the default
# group size at 16), tau = 10 (so both phase offsets and the sync at t = 9
# run), SGD momentum 0.9, lr 0.1, target seq 256 over the synthetic
# batch's 64 source tokens, global batch 64 (4 rows a replica), under each
# of the paper's seven averagers
PAPER_ARCH = "transformer-wmt"
PAPER_AVERAGERS = ("wagma", "allreduce", "local_sgd", "dpsgd", "sgp",
                   "adpsgd", "eager_sgd")
PAPER_P, PAPER_S, PAPER_TAU = 16, 4, 10
PAPER_TRAIN_LAYERS = 1
PAPER_SEQ, PAPER_GB, PAPER_STEPS, PAPER_LR = 256, 64, 10, 0.1
PAPER_PROFILED = ("wagma", "allreduce")
# the gossip baselines, whose card mix is held to the CPU's, bit for bit
GOSSIP = ("dpsgd", "sgp", "adpsgd")
# Fig. 5 at the same width: WAGMA under stragglers against Allreduce-SGD
FIG5_STEPS, FIG5_TAIL = 40, 8
# a baseline runs only the steps its check (b) needs: Allreduce-SGD and
# Eager-SGD 3, D-PSGD (one phase) 2, SGP and AD-PSGD one a phase and one
# more; WAGMA and local SGD run all PAPER_STEPS (both offsets, the syncs)
PAPER_BASELINE_STEPS = {"allreduce": 3, "eager_sgd": 3, "dpsgd": 2}
# transformer-wmt serving: batch, source tokens, target prompt, new tokens;
# the float32 check's decode steps
WMT_BATCH, WMT_SRC, WMT_PROMPT, WMT_NEW, WMT_F32_STEPS = 8, 64, 16, 32, 8

# the other families served at full published width and depth in bf16:
# whisper-medium (batch 4 x the 1500 frame embeddings, a 4-token decoder
# prompt), internvl2-2b (batch 4 x 256 patch embeddings + 512 text tokens)
# and xlstm-350m (batch 4 x 512 tokens), 32 greedy new tokens each; each
# float32 check at batch 1 over the prompt (xlstm: 128 tokens) and a few
# decode steps
WHISPER_ARCH, VLM_ARCH, XLSTM_ARCH = "whisper-medium", "internvl2-2b", \
    "xlstm-350m"
FAMILY_BATCH, FAMILY_NEW = 4, 32
WHISPER_PROMPT, WHISPER_F32_STEPS = 4, 8
VLM_PROMPT, VLM_F32_STEPS = 512, 4
XLSTM_PROMPT, XLSTM_F32_PROMPT, XLSTM_F32_STEPS = 512, 128, 4
# the attn model phase's family models and their prompts
ATTN_MODEL_ARCHS = ("whisper-medium", "internvl2-2b", "transformer-wmt")
ATTN_MODEL_PROMPTS = {"whisper-medium": WHISPER_PROMPT,
                      "internvl2-2b": VLM_PROMPT,
                      "transformer-wmt": WMT_PROMPT}
# xlstm's profiled prefill: ~40 torch ops a token and superblock, so the
# trace of a whole prompt takes the profiler minutes to read back
XLSTM_PROFILE_PROMPT = 64

# the moe family at published width, expert count, top-k and vocab in bf16,
# depth cut to 2 layers (llama4-maverick: one dense + moe superblock;
# kimi-k2: the first dense layer + one moe layer): one moe layer is 16-17 B
# params, 32-34 GB, so a second would need 70-73 GB of weights alone.
# Batch 4 x 512-token prompts, 32 greedy new tokens, at the config's
# capacity factor (1.25).  Check (b) runs at capacity factor
# MOE_DROPFREE_FACTOR, under which both of its prefills and every decode
# step must drop nothing (drops legally differ between prefills of other
# lengths; 8 is the least factor of 2, 4, 8 that was drop-free for both
# models on these weights, C 128 and 341); check (c) on a float32
# copy of the first MOE_F32_EXPERTS experts (top-k unchanged; a float32
# copy of every expert is 74-78 GB) at capacity factor 2E/k, so C >= T.
MOE_ARCHS = ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
MOE_LAYERS, MOE_PROMPT = 2, 512
MOE_DROPFREE_FACTOR = 8.0
MOE_F32_EXPERTS, MOE_F32_PROMPT, MOE_F32_STEPS = 16, 128, 4
# ep model phase (slice 4c, third part): serving only, over data
# EP_MODEL_DATA x MODEL_M gloo ranks on the one card: xlstm-350m at all 24
# layers (one prompt of EP_MODEL_PROMPTS tokens) and the moe family at
# published width, experts, top-k and vocab, cut to MOE_LAYERS (one row
# of MOE_PROMPT tokens) at capacity factor E/k, so that C = T and nothing
# can drop (a token's k experts are distinct; the moe phase's 8 dropped
# 4.3% of llama4's assignments at this one row), random
# weights from EP_MODEL_SEED drawn by each rank for its slices only,
# MODEL_NEW decode steps, each model against rank 0 serving it whole
# once both ranks have freed their slices (a moe model whole is 37-39
# GB, a rank's slices 18-20); check (d)'s planted faults by arch.  xlstm
# serves in float32 here: at 24 layers two bf16 runs whose sums round in
# another order part by about 30% of the largest logit (its exponential
# gates amplify one rounding; 0.84 of 2.94 between the ranks and one rank,
# both bf16, in the first run of this phase on the H100), which check (b)
# could not tell from a fault
EP_MODEL_DATA, EP_MODEL_SEED, EP_MODEL_TIMEOUT = 1, 6, 600
EP_MODEL_WORKER_FLAG = "--ep-model-worker"
EP_MODEL_ARCHS = (XLSTM_ARCH,) + MOE_ARCHS
EP_MODEL_PROMPTS = {XLSTM_ARCH: 256, MOE_ARCHS[0]: MOE_PROMPT,
                    MOE_ARCHS[1]: MOE_PROMPT}
EP_MODEL_FAULTS = {XLSTM_ARCH: "z_from_next_rank",
                   MOE_ARCHS[0]: "rows_of_rank_0"}
EP_MODEL_DTYPES = {XLSTM_ARCH: "float32"}


def free_memory(label: str):
    """Print what is still allocated, then again after collecting garbage
    (a reference cycle that holds a phase's tensors shows as the
    difference), and return the allocator's cache to the card."""
    import gc
    import torch
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory after {label}: {held / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB after collecting"
          f" cycles", flush=True)


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def timed(fn, iters: int = 20, warmup: int = 3):
    """(device ms, host us) per call of ``fn()`` over ``iters`` back-to-back
    calls.  The host time is that of enqueueing the calls.  Before the
    timed calls the card is put to sleep for twice that time, so the queue
    holds every timed launch when the start event runs: the events then
    measure the device, even where a call costs the host more than the
    kernel costs the card."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = (time.perf_counter() - t) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * iters * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e6


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call of ``fn()`` (see :func:`timed`)."""
    return timed(fn, iters, warmup)[0]


def visible_mask(sq, sk, causal, window, device, leak: int = 0):
    """(sq, sk) bool: key j visible to query i; ``leak`` moves the causal
    edge that many keys past the diagonal."""
    import torch
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos + leak
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_bound(b, sq, sk, h, kh, hd, causal, window, dtype):
    """(bound_ms, bound_by): max of bytes over HBM rate and FLOPs over the
    dtype's peak.  Each of q, k, v read once and o written once; 4 FLOPs
    per visible (query, key) pair and head dim (QK^T and PV)."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * b * sq * h * hd + 2 * b * sk * kh * hd)
    pairs = int(visible_mask(sq, sk, causal, window, "cpu").sum())
    flops = 4.0 * b * h * hd * pairs
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def bf16_bound(q, k, v, causal, window):
    """``excess(out)``: max |out - want| / (BF16_RTOL * mag + BF16_ATOL)
    over the elements, want and mag from K3's plain version in float32 on
    the same inputs; a result passes when its excess is <= 1."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    qf, kf, vf = q.float(), k.float(), v.float()
    want = fa.flash_attention_plain(qf, kf, vf, causal=causal, window=window)
    mag = fa.flash_attention_plain(qf, kf, vf.abs(), causal=causal,
                                   window=window)
    denom = BF16_RTOL * mag + BF16_ATOL
    del qf, kf, vf, mag

    def excess(out):
        e = ((out.float() - want).abs() / denom).max()
        return float(e) if bool(torch.isfinite(e)) else math.inf
    return excess


def _masked_sdpa(q, k, v, mask):
    """Attention over ``mask`` in float32 by SDPA, returned in q's dtype;
    a row with no visible key sees key 0, so its softmax stays defined."""
    import torch.nn.functional as F
    rep = q.shape[2] // k.shape[2]
    mask[~mask.any(-1), 0] = True
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))
    kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask).transpose(1, 2).to(q.dtype)


def bf16_faults(q, k, v, causal, window):
    """What a faulty K3 would return, in bf16: the window one key short,
    the causal edge one key late (key q+1 visible), and the middle KV tile
    skipped (SDPA in float32 over a boolean mask)."""
    from repro_torch.kernels import flash_attention as fa
    sq, sk = q.shape[1], k.shape[1]
    faults = {}
    if window is not None and window > 1:
        faults["window_minus_1"] = fa.flash_attention_plain(
            q, k, v, causal=causal, window=window - 1)
    if causal:
        faults["causal_leak"] = _masked_sdpa(
            q, k, v, visible_mask(sq, sk, causal, window, q.device, leak=1))
    mask = visible_mask(sq, sk, causal, window, q.device)
    t0 = sk // 2 // FAULT_TILE * FAULT_TILE
    mask[:, t0:t0 + FAULT_TILE] = False
    faults[f"tile_{t0}_skipped"] = _masked_sdpa(q, k, v, mask)
    return faults


def kernel_phase(device="cuda"):
    """K3 against its plain version at every listed shape; returns rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    cases = KERNEL_CASES + [(1, L, L, 32, 4, 64, True, None, "bfloat16")
                            for L in SLICE_LENGTHS] + HD256_CASES \
        + TMA_EDGE_CASES + WMT_ATTN_CASES + FAMILY_ATTN_CASES
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for case in cases:
        b, sq, sk, h, kh, hd, causal, window, dtype = case
        dt = getattr(torch, dtype)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device).to(dt)

        q, k, v = randn(b, sq, h, hd), randn(b, sk, kh, hd), randn(b, sk, kh, hd)
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        if not math.isfinite(err) or err > TOL[dtype]:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{case}: max abs err {err} > {TOL[dtype]}")
        scaled = faults = None
        if dtype == "bfloat16":
            excess = bf16_bound(q, k, v, causal, window)
            scaled = excess(out)
            if scaled > 1:
                raise AssertionError(
                    f"K3 bf16 exceeds {BF16_RTOL} * mag + {BF16_ATOL} at "
                    f"{case}: excess {scaled}")
            if case in FAULT_SHAPES:
                faults = {name: excess(o) for name, o in
                          bf16_faults(q, k, v, causal, window).items()}
                if min(faults.values()) <= 1:
                    raise AssertionError(f"the bf16 bound accepts a planted "
                                         f"fault at {case}: {faults}")
            del excess
        kernel_ms, host_us = timed(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, window=window))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), iters=5, warmup=1)
        library_ms = library_causal_ms = None
        if not causal or sq == sk:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask = None                # a window needs an explicit mask
            if window is not None:
                mask = visible_mask(sq, sk, causal, window, device)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=kh != h))
            if case == RG_ATTN_SHAPE:
                # the flash backend's causal call, no window: more work
                # (every causal pair) than the window leaves, not the same
                # function; a tighter yardstick than the masked call
                library_causal_ms = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=kh != h))
            del qt, kt, vt, mask
        bound_ms, bound_by = attention_bound(b, sq, sk, h, kh, hd, causal,
                                             window, dtype)
        rows.append({"shape": [b, sq, sk, h, kh, hd], "causal": causal,
                     "window": window, "dtype": dtype, "max_abs_err": err,
                     "tol": TOL[dtype], "bf16_excess": scaled,
                     "fault_excess": faults, "ms": kernel_ms,
                     "host_us": host_us, "plain_ms": plain_ms,
                     "library_ms": library_ms,
                     "library_causal_ms": library_causal_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
    return rows


def ptxas_report(report: str) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    the output of ``nvcc -Xptxas -v``."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, m.groups())))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            name = None
    return out


def check_no_spills(report: str, key: str, what: str) -> dict:
    """The kernels whose name holds ``key`` as ptxas built them; raises if
    there is none or any spills."""
    kernels = {n: r for n, r in ptxas_report(report).items() if key in n}
    if not kernels:
        raise AssertionError(f"no {what} kernel in the ptxas report")
    spilled = {n: r for n, r in kernels.items()
               if r.get("spill_stores") or r.get("spill_loads")}
    if spilled:
        raise AssertionError(f"{what} kernels spill: {spilled}")
    return kernels


def check_k3_build(report: str) -> dict:
    """K3's bf16 kernels (``attn_fwd_wgmma``, one per padded head dim)."""
    return check_no_spills(report, "attn_fwd_wgmma", "bf16 K3")


def check_k4_build(report: str) -> dict:
    """K4's TMA-route kernels (one per dtype pair)."""
    return check_no_spills(report, "rglru_scan_tma_kernel", "K4 TMA")


def paired_ms(fns: dict, order, rounds: int = PAIR_ROUNDS) -> dict:
    """Mean device ms of each named call, timed in turns (``order`` of the
    names, repeated ``rounds`` times) within one call, and each timing."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in order:
            times[name].append(time_ms(fns[name]))
    return {name: {"mean_ms": statistics.fmean(t), "ms": t}
            for name, t in times.items()}


def combine_bound_ms(n_total: int, itemsize: int) -> float:
    """Least time for the combine: each of w, recv read once and out
    written once, over the HBM rate (2 flops per element is far below the
    operation bound)."""
    return 3 * n_total * itemsize / PEAK_BYTES * 1e3


def train_config():
    from repro_torch.configs import get_config
    return get_config(ARCH).variant(n_layers=TRAIN_LAYERS)


def fsdp_config(smoke: bool = False):
    """The FSDP phase's model: tinyllama-1.1b at full width and depth."""
    from repro_torch.configs import get_config
    return get_config(ARCH, smoke=smoke)


def slice_plan(cfg, replicas: int = TRAIN_P, group_size: int = TRAIN_S):
    """A training slice's compiled plan (one replica's tree structure)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.models import transformer as tfm
    return plan_mod.compile_plan(
        plan_mod.Topology.flat(("data",), (replicas,)), tfm.param_specs(cfg),
        plan_mod.AveragingConfig(group_size=group_size, tau=TRAIN_TAU))


def scale_groups(n_buckets: int, n_stages: int):
    """The combine launches of one group step's overlapped butterfly: per
    wavefront batch, one group of bucket indices per distinct scale (the
    last stage's scale is 1/S, the others' 1.0).  A group of one pair is a
    K1 launch, a larger one a K2 launch."""
    from repro_torch.core import overlap
    out = []
    for batch in overlap.combine_batches(
            overlap.pipeline_schedule(n_buckets, n_stages)):
        by_scale = {}
        for k, stage in batch:
            by_scale.setdefault(stage == n_stages - 1, []).append(k)
        out.extend((last, ks) for last, ks in by_scale.items())
    return out


def expected_combine_launches(n_buckets: int, n_stages: int):
    """(K1, K2) launches of one group step."""
    sizes = Counter(len(ks) > 1 for _, ks in scale_groups(n_buckets,
                                                          n_stages))
    return sizes[False], sizes[True]


def plan_combines(plan, rows: int, per_rank: bool = False):
    """The combine operands of one group step of ``plan`` over ``(rows,
    n_b)`` float32 buckets: the (elements, scale) of every K1 launch and
    the sizes and scale of its multi-pair K2 batch (None if it has none:
    a smoke config's few buckets).  A sharded plan's buckets are its
    shard layout's; ``per_rank``, a rank's column slices of them (FSDP
    over ranks)."""
    sizes = (plan.shard_layout if plan.sharding.is_sharded
             else plan.class_layout(0)).bucket_sizes
    if per_rank:
        sizes = [n // plan.shard_size for n in sizes]
    n_stages = len(plan.runs_for_offset(0)[0].bits)
    groups = [(0.5 ** n_stages if last else 1.0,
               [rows * sizes[k] for k in ks])
              for last, ks in scale_groups(len(sizes), n_stages)]
    k1 = sorted({(ns[0], scale) for scale, ns in groups if len(ns) == 1})
    tail = next(((ns, scale) for scale, ns in groups if len(ns) > 1), None)
    return k1, tail


def ranks_config():
    """The ranks phase's model: tinyllama-1.1b at ``RANKS_LAYERS``."""
    from repro_torch.configs import get_config
    return get_config(ARCH).variant(n_layers=RANKS_LAYERS)


def rank_combines(cfg):
    """The ranks path's combine operands, one rank's ``(1, n_b)``
    buckets."""
    return plan_combines(slice_plan(cfg, RANKS_P, RANKS_S), 1)


def elastic_combines(cfg):
    """The elastic path's combine operands in each world it runs
    (``ELASTIC_WORLDS``), the world's ``(P, n_b)`` buckets at S 2."""
    return {p: plan_combines(slice_plan(cfg, p, ELASTIC_S), p)
            for p in ELASTIC_WORLDS}


def combine_kernel_phase(device="cuda"):
    """K1/K2 against their plain versions on every case; returns (rows,
    line entries for K1 and K2, for each on the ranks path, under
    ``"elastic"`` each elastic world's operands and rows, under ``"fsdp"``
    the FSDP path's, under ``"streamed"`` the streamed path's)."""
    import torch
    from repro_torch.kernels import group_average as ga

    plan = slice_plan(train_config())
    layout = plan.class_layout(0)
    real = sorted(set(TRAIN_P * n for n in layout.bucket_sizes))
    stages = len(plan.runs_for_offset(0)[0].bits)
    tail = next(ks for _, ks in scale_groups(layout.n_buckets, stages)
                if len(ks) > 1)
    tail_sizes = [TRAIN_P * layout.bucket_sizes[k] for k in tail]
    rank_k1, (rank_tail, rank_scale) = rank_combines(ranks_config())
    gen = torch.Generator(device=device).manual_seed(1)

    def operands(n, dtype, offset=0):
        base = torch.randn(2, n + offset, generator=gen, device=device,
                           dtype=torch.float32).to(getattr(torch, dtype))
        return base[0, offset:], base[1, offset:]

    def k1_row(n, dtype, scale, offset=0, case=""):
        """One K1 case: out of place and in place against the plain
        version, then timed; returns (row, (w, r, out)) for more timing."""
        w, r = operands(n, dtype, offset)
        got = ga.group_average_combine_cuda(w, r, scale)
        want = ga.group_average_combine_plain(w, r, scale)
        inplace = w.clone()                         # out is w, as in training
        ga.group_average_combine_cuda(inplace, r, scale, out=inplace)
        torch.cuda.synchronize()
        item = 4 if dtype == "float32" else 2
        row = {"kernel": "K1", "case": case, "dtype": dtype, "scale": scale,
               "n": [n], "aligned": offset == 0,
               "equal": bool(torch.equal(got, want)
                             and torch.equal(inplace, want)),
               "max_abs_err": float((got.float() - want.float()
                                     ).abs().max()) if n else 0.0,
               "bound_ms": combine_bound_ms(n, item)}
        o = torch.empty_like(w)
        if n:                              # n == 0 launches nothing
            row["ms"], row["host_us"] = timed(
                lambda: ga.group_average_combine_cuda(w, r, scale, out=o))
            row["plain_ms"] = time_ms(
                lambda: ga.group_average_combine_plain(w, r, scale),
                iters=5, warmup=1)
            row["library_ms"] = (time_ms(lambda: torch.add(w, r, out=o))
                                 if scale == 1.0 else None)
        return row, (w, r, o)

    def k2_row(case, sizes, offsets, dtype, scale):
        """One K2 case, checked and timed as :func:`k1_row`'s."""
        pairs = [operands(n, dtype, off) for n, off in zip(sizes, offsets)]
        ws, rs = [p[0] for p in pairs], [p[1] for p in pairs]
        got = ga.group_average_combine_multi_cuda(ws, rs, scale)
        want = ga.group_average_combine_multi_plain(ws, rs, scale)
        inplace = [w.clone() for w in ws]
        ga.group_average_combine_multi_cuda(inplace, rs, scale, outs=inplace)
        torch.cuda.synchronize()
        item = 4 if dtype == "float32" else 2
        row = {"kernel": "K2", "case": case, "dtype": dtype, "scale": scale,
               "n": list(sizes),
               "equal": all(torch.equal(a, b) and torch.equal(c, b)
                            for a, b, c in zip(got, want, inplace)),
               "max_abs_err": max(float((a.float() - b.float()).abs().max())
                                  for a, b in zip(got, want) if a.numel()),
               "bound_ms": combine_bound_ms(sum(sizes), item)}
        os_ = [torch.empty_like(w) for w in ws]
        row["ms"], row["host_us"] = timed(
            lambda: ga.group_average_combine_multi_cuda(ws, rs, scale,
                                                        outs=os_))
        row["plain_ms"] = time_ms(
            lambda: ga.group_average_combine_multi_plain(ws, rs, scale),
            iters=5, warmup=1)
        row["library_ms"] = (time_ms(lambda: torch._foreach_add(ws, rs))
                             if scale == 1.0 else None)
        return row

    rows = []
    line = {}
    for dtype in GA_DTYPES:
        for scale in GA_SCALES:
            # K1: one pair per case
            for n, offset in ([(n, 0) for n in GA_SIZES + tuple(real)]
                              + [(1000, 1), (2 ** 20 + 3, 1)]):
                row, (w, r, o) = k1_row(n, dtype, scale, offset)
                rows.append(row)
                if (dtype, scale, n) == ("float32", 1.0, real[-1]):
                    line["K1"] = row
                    # out of place, then in place as training calls it
                    # (w grows by r each call; the time does not depend
                    # on the values)
                    order = ("K1", "torch.add", "K1 in place",
                             "torch.add in place")
                    line["K1_vs_add"] = paired_ms(
                        {"K1": lambda: ga.group_average_combine_cuda(
                            w, r, scale, out=o),
                         "torch.add": lambda: torch.add(w, r, out=o),
                         "K1 in place": lambda: ga.group_average_combine_cuda(
                            w, r, scale, out=w),
                         "torch.add in place": lambda: w.add_(r)}, order)
                del w, r, o
            # K2: the slice's real multi-pair batch, ragged lists of both
            # alignments, and a list longer than one launch's table
            for name, sizes, offsets in (
                    ("slice tail batch", tail_sizes, [0] * len(tail_sizes)),
                    ("ragged aligned", GA_RAGGED, [0] * len(GA_RAGGED)),
                    ("ragged mixed", GA_RAGGED,
                     [i % 2 for i in range(len(GA_RAGGED))]),
                    ("70 pairs", [97 + 13 * i for i in range(70)],
                     [i % 2 for i in range(70)])):
                row = k2_row(name, sizes, offsets, dtype, scale)
                if (name, dtype, scale) == ("slice tail batch", "float32",
                                            1.0):
                    line["K2"] = row
                rows.append(row)
    # the ranks path's own launches: each K1 size of a rank's buckets and
    # its K2 batch, float32 at the path's scale
    for n, scale in rank_k1:
        row, _ = k1_row(n, "float32", scale, case="ranks")
        rows.append(row)
    line["K1 ranks"] = max((r for r in rows if r["case"] == "ranks"),
                           key=lambda r: r["n"][0])
    line["K2 ranks"] = k2_row("ranks tail batch", rank_tail,
                              [0] * len(rank_tail), "float32", rank_scale)
    rows.append(line["K2 ranks"])
    # the model path's: each K1 size of a rank's buckets of its slices and
    # its K2 batch (check (a) ties them to the plan the ranks compiled)
    for key, combines in (
            ("model", model_combines(model_config())),
            ("rg model", model_combines(rg_model_config(), RG_MODEL_DATA))):
        k1, (tail_n, tail_scale) = combines
        k1_rows = [k1_row(n, "float32", scale, case=key)[0]
                   for n, scale in k1]
        line[f"K1 {key}"] = max(k1_rows, key=lambda r: r["n"][0])
        line[f"K2 {key}"] = k2_row(f"{key} tail batch", tail_n,
                                   [0] * len(tail_n), "float32", tail_scale)
        rows.extend(k1_rows + [line[f"K2 {key}"]])
    # the elastic path's: each world's K1 sizes and K2 batch (check (a)
    # holds them to the plans the elastic run compiled)
    line["elastic"] = {}
    for world, combines in elastic_combines(train_config()).items():
        k1, (tail_n, tail_scale) = combines
        case = f"elastic world {world}"
        k1_rows = [k1_row(n, "float32", scale, case=case)[0]
                   for n, scale in k1]
        k2 = k2_row(f"{case} tail batch", tail_n, [0] * len(tail_n),
                    "float32", tail_scale)
        rows.extend(k1_rows + [k2])
        line["elastic"][world] = {
            "combines": combines, "K2": k2,
            "K1": max(k1_rows, key=lambda r: r["n"][0])}
    # the FSDP path's: the 22-layer sharded plan's K1 sizes and K2 batch
    # over its (P_eff, n_b) float32 shard buffers at scale 1/S (check (a)
    # ties them to the plan the FSDP phase compiled)
    combines = fsdp_combines(fsdp_config())
    k1, (tail_n, tail_scale) = combines
    k1_rows = [k1_row(n, "float32", scale, case="fsdp")[0]
               for n, scale in k1]
    k2 = k2_row("fsdp tail batch", tail_n, [0] * len(tail_n), "float32",
                tail_scale)
    rows.extend(k1_rows + [k2])
    line["fsdp"] = {"combines": combines, "K2": k2,
                    "K1": max(k1_rows, key=lambda r: r["n"][0])}
    # the fsdp ranks path's: a rank's (1, n_b / 2) float32 slices of the
    # sharded plan's buckets at the ranks phase's depth (check (a) of the
    # fsdp ranks phase ties them to the plan its ranks compiled)
    combines = fsdp_rank_combines(ranks_config())
    k1, tail = combines
    k1_rows = [k1_row(n, "float32", scale, case="fsdp ranks")[0]
               for n, scale in k1]
    rows.extend(k1_rows)
    line["fsdp ranks"] = {"combines": combines,
                          "K1": max(k1_rows, key=lambda r: r["n"][0])}
    # torch.add at the largest slice (the sum alone, no scale: beside
    # the row, not its library call)
    w, r = operands(line["fsdp ranks"]["K1"]["n"][0], "float32")
    o = torch.empty_like(w)
    line["fsdp ranks"]["K1"]["add_ms"] = time_ms(
        lambda: torch.add(w, r, out=o))
    del w, r, o
    if tail is not None:
        line["fsdp ranks"]["K2"] = k2_row(
            "fsdp ranks tail batch", tail[0], [0] * len(tail[0]), "float32",
            tail[1])
        rows.append(line["fsdp ranks"]["K2"])
    # the streamed ranks path's: a rank's (1, n_b / 2) float32 slices of
    # the grouped plan's buckets at the ranks phase's depth (check (a) of
    # the streamed ranks part ties them to the plan its ranks compiled)
    k1, tail = streamed_rank_combines(ranks_config())
    k1_rows = [k1_row(n, "float32", scale, case="streamed ranks")[0]
               for n, scale in k1]
    rows.extend(k1_rows)
    line["streamed ranks"] = {"combines": (k1, tail),
                              "K1": max(k1_rows, key=lambda r: r["n"][0])}
    if tail is not None:
        line["streamed ranks"]["K2"] = k2_row(
            "streamed ranks tail batch", tail[0], [0] * len(tail[0]),
            "float32", tail[1])
        rows.append(line["streamed ranks"]["K2"])
    # the fsdp model path's: a rank's (1, n_b / 2) float32 slices of its
    # model coordinate's buckets, gather-all and layer-streamed (check (a)
    # of the fsdp model phase ties them to the plans its ranks compiled)
    for key, streamed in (("fsdp model", False), ("streamed model", True)):
        k1, tail = fsdp_model_combines(ranks_config(), streamed)
        k1_rows = [k1_row(n, "float32", scale, case=key)[0]
                   for n, scale in k1]
        rows.extend(k1_rows)
        line[key] = {"combines": (k1, tail),
                     "K1": max(k1_rows, key=lambda r: r["n"][0])}
        if tail is not None:
            line[key]["K2"] = k2_row(f"{key} tail batch", tail[0],
                                     [0] * len(tail[0]), "float32", tail[1])
            rows.append(line[key]["K2"])
    # torch.add at the gather-all path's largest slice (beside the row)
    w, r = operands(line["fsdp model"]["K1"]["n"][0], "float32")
    o = torch.empty_like(w)
    line["fsdp model"]["K1"]["add_ms"] = time_ms(
        lambda: torch.add(w, r, out=o))
    del w, r, o
    # the streamed path's: the 22-layer grouped plan's K1 sizes and K2
    # batch over its (P_eff, n_b) float32 shard buffers at scale 1/S
    combines = streamed_combines(fsdp_config())
    k1, (tail_n, tail_scale) = combines
    k1_rows = [k1_row(n, "float32", scale, case="streamed")[0]
               for n, scale in k1]
    k2 = k2_row("streamed tail batch", tail_n, [0] * len(tail_n), "float32",
                tail_scale)
    rows.extend(k1_rows + [k2])
    line["streamed"] = {"combines": combines, "K2": k2,
                        "K1": max(k1_rows, key=lambda r: r["n"][0])}
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"K1/K2 differ from their plain versions: {bad}")
    return rows, line


def scan_bound_ms(b, s, w, a_item, x_item, with_h0) -> float:
    """Least time for the scan: a and x read once, h written once in x's
    type, h0 read once, over the HBM rate (2 flops per element is far below
    the operation bound)."""
    nbytes = b * s * w * (a_item + 2 * x_item) + (4 * b * w if with_h0 else 0)
    return nbytes / PEAK_BYTES * 1e3


def k4_inputs(gen, b, s, w, with_h0, dtype, device="cuda"):
    """a uniform in [0.5, 0.999) and x normal * 0.1, as
    tests/test_kernels.py draws them, in the dtypes ``K4_DTYPES`` names
    (or ``dtype`` for both); h0 normal float32 or None."""
    import torch
    a_dt, x_dt = K4_DTYPES.get(dtype, (dtype, dtype))
    a = (torch.rand((b, s, w), generator=gen, device=device) * 0.499
         + 0.5).to(getattr(torch, a_dt))
    x = (torch.randn((b, s, w), generator=gen, device=device) * 0.1
         ).to(getattr(torch, x_dt))
    h0 = (torch.randn((b, w), generator=gen, device=device)
          if with_h0 else None)
    return a, x, h0


def k4_launch(a, x, h0, via=None):
    """K4 on route ``via`` (the rule's by default): (out, the route its
    launch was counted on)."""
    from repro_torch.kernels import rglru_scan as rg
    before = dict(rg.route_launches)
    out = rg.rglru_scan_cuda(a, x, h0, via=via)
    return out, next(k for k, n in rg.route_launches.items()
                     if n != before[k])


def rglru_kernel_phase(device="cuda"):
    """K4 against its plain version, bit for bit: the timed cases on the
    route the rule picks; the TMA route's edges on both routes (a TMA
    request the rule turns down must be refused); and the two routes timed
    in turns at the prefill shape.  Returns (rows, edge rows, pair)."""
    import torch
    from repro_torch.kernels import rglru_scan as rg

    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    for b, s, w, with_h0, dtype in K4_CASES:
        a, x, h0 = k4_inputs(gen, b, s, w, with_h0, dtype, device)
        got, via = k4_launch(a, x, h0)
        want = rg.rglru_scan_plain(a, x, h0)
        torch.cuda.synchronize()
        item = 4 if dtype == "float32" else 2
        kernel_ms, host_us = timed(lambda: rg.rglru_scan_cuda(a, x, h0))
        rows.append({
            "shape": [b, s, w], "h0": with_h0, "dtype": dtype, "route": via,
            "equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "ms": kernel_ms, "host_us": host_us,
            "plain_ms": time_ms(lambda: rg.rglru_scan_plain(a, x, h0),
                                iters=5, warmup=1),
            "bound_ms": scan_bound_ms(b, s, w, item, item, with_h0),
            "bound_by": "bytes", "library_ms": None})
        del a, x, h0, got, want
    edges = []
    for b, s, w, with_h0, dtype in K4_EDGE_CASES:
        a, x, h0 = k4_inputs(gen, b, s, w, with_h0, dtype, device)
        want = rg.rglru_scan_plain(a, x, h0)
        got, via = k4_launch(a, x, h0)
        walk, _ = k4_launch(a, x, h0, via="walk")
        refused = None
        if via == "walk":
            try:
                k4_launch(a, x, h0, via="tma")
                refused = False
            except RuntimeError:
                refused = True
        torch.cuda.synchronize()
        edges.append({"shape": [b, s, w], "h0": with_h0, "dtype": dtype,
                      "route": via, "equal": bool(torch.equal(got, want)),
                      "walk_equal": bool(torch.equal(walk, want)),
                      "tma_refused": refused,
                      "max_abs_err": float((got.float() - want.float()
                                            ).abs().max())})
        del a, x, h0, got, walk, want
    b, s, w, with_h0, dtype = RG_SCAN_SHAPE
    a, x, h0 = k4_inputs(gen, b, s, w, with_h0, dtype, device)
    pair = paired_ms({via: (lambda via=via: rg.rglru_scan_cuda(a, x, h0,
                                                                 via=via))
                      for via in ("walk", "tma")},
                     ("walk", "tma", "tma", "walk"))
    del a, x, h0
    torch.cuda.empty_cache()
    bad = [r for r in rows + edges if not r["equal"]
           or not r.get("walk_equal", True) or r.get("tma_refused") is False]
    if bad:
        raise AssertionError(f"K4 differs from its plain version or took a "
                             f"TMA request it must refuse: {bad}")
    return rows, edges, pair


def group_rows_agree(params, groups) -> tuple:
    """(every group's rows bit-identical, at least two groups differ)."""
    import torch
    from repro_torch.core import tree as tr
    leaves = tr.tree_leaves(params)
    same = all(torch.equal(leaf[m], leaf[g[0]]) for leaf in leaves
               for g in groups for m in g[1:])
    differ = len(groups) > 1 and any(
        not torch.equal(leaf[groups[0][0]], leaf[groups[1][0]])
        for leaf in leaves)
    return same, differ


def split_timer(split: dict, device):
    """``timed(key, fn)``: ``fn`` wrapped so that each call's host time,
    between two synchronisations, adds to ``split[key]``."""
    def timed(key, fn):
        def run(*args, **kw):
            _sync(device)
            t = time.perf_counter()
            out = fn(*args, **kw)
            _sync(device)
            split[key] += time.perf_counter() - t
            return out
        return run
    return timed


def per_leaf_plan(plan):
    """``plan``'s per-leaf twin: each leaf averaged on its own in plain
    torch, no K1/K2."""
    from repro_torch.core import plan as plan_mod
    return plan_mod.compile_plan(plan.topology, plan.storage_struct,
                                 dataclasses.replace(plan.cfg, fused=False))


def fused_equals_per_leaf(ref_plan, out, tree, offset: int) -> bool:
    """The fused K1/K2 average ``out`` of ``tree`` at ``offset`` equals
    ``ref_plan``'s per-leaf average bit for bit; one leaf's reference at a
    time holds the least memory."""
    import torch
    from repro_torch.core import tree as tr
    return all(torch.equal(a, ref_plan.average_offset(b, offset))
               for a, b in zip(tr.tree_leaves(out), tr.tree_leaves(tree)))


def train_phase(cfg, device="cuda", steps: int = TRAIN_STEPS,
                seq_len: int = TRAIN_SEQ, global_batch: int = TRAIN_GB,
                topology=None, replicas: int = TRAIN_P,
                group_size: int = TRAIN_S, on_step=None):
    """Drive the port's ``Trainer`` for ``steps`` steps with checks (b),
    (c) and (d), calling ``on_step(t, trainer)`` after each step (outside
    its timing); returns the run's numbers, the per-step launch counts for
    check (a) and the trainer (for the profile window)."""
    import torch
    from repro_torch.core import grouping
    from repro_torch.core import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.train import train_step

    t0 = time.perf_counter()
    trainer = Trainer(cfg, replicas, device=device, group_size=group_size,
                      tau=TRAIN_TAU, learning_rate=TRAIN_LR, seq_len=seq_len,
                      global_batch=global_batch, seed=0, topology=topology)
    _sync(device)
    init_s = time.perf_counter() - t0
    plan = trainer.plan()
    n_buckets = plan.class_layout(0).n_buckets
    n_stages = len(plan.runs_for_offset(0)[0].bits)
    split = {"grads": 0.0, "update": 0.0, "average": 0.0}
    timed = split_timer(split, device)
    trainer.opt = Optimizer(trainer.opt.init,
                            timed("update", trainer.opt.update))
    checked = {}
    comm = timed("average", trainer.averager.comm)

    def comm_checked(tree, phase):
        out = comm(tree, phase)
        if "fused_equals_per_leaf" not in checked:     # check (c), once
            checked["fused_equals_per_leaf"] = fused_equals_per_leaf(
                per_leaf_plan(plan), out, tree, plan.offsets[phase])
        return out

    trainer.averager.comm = comm_checked
    trainer.averager.sync = timed("average", trainer.averager.sync)

    value_and_grad = train_step.value_and_grad
    train_step.value_and_grad = timed("grads", value_and_grad)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    log = []
    peak_first = None
    ops.reset_launch_counts()
    for t in range(steps):
        split.update(grads=0.0, update=0.0, average=0.0)
        before = ops.launch_counts()
        _sync(device)
        t_start = time.perf_counter()
        loss = trainer.step_once(t)
        _sync(device)
        step_s = time.perf_counter() - t_start
        after = ops.launch_counts()
        sync = trainer.averager.sync_due(t)
        offset = None if sync else plan.offsets[trainer.averager.phase_for_step(t)]
        groups = ((tuple(range(replicas)),) if sync else
                  grouping.groups_for_offset(replicas, group_size, offset))
        same, differ = group_rows_agree(trainer.state.params, groups)
        if not same or (not sync and not differ):          # check (b)
            raise AssertionError(
                f"step {t} ({'sync' if sync else f'offset {offset}'}): "
                f"rows of a group bit-identical {same}, groups differ "
                f"{differ}, groups {groups}")
        log.append({"t": t, "loss": loss, "sync": sync, "offset": offset,
                    "step_ms": step_s * 1e3,
                    "update_ms": split["update"] * 1e3,
                    "average_ms": split["average"] * 1e3,
                    "grads_ms": split["grads"] * 1e3,
                    # the batch's host-to-device copy, the finite checks,
                    # the row writes and the metrics
                    "other_ms": (step_s - split["grads"] - split["update"]
                                 - split["average"]) * 1e3,
                    "skipped": trainer.last_metrics["skipped_nonfinite"],
                    **{key: after[name] - before[name] for key, name in (
                        ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4),
                        ("k4_tma", K4_TMA), ("k4_walk", K4_WALK))}})
        if on_card and t == 0:
            # the first step also runs check (c)'s per-leaf average
            peak_first = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        if on_step is not None:
            on_step(t, trainer)
    train_step.value_and_grad = value_and_grad
    launches = ops.launch_counts()
    peak_rest = torch.cuda.max_memory_allocated() if on_card else None
    if not checked.get("fused_equals_per_leaf"):                # check (c)
        raise AssertionError("the fused K1/K2 average differs from the "
                             "plan's per-leaf path")
    bad = [e for e in log if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (d)
        raise AssertionError(f"non-finite losses or skipped updates: {bad}")
    steady = log[1:] or log
    med = lambda key: statistics.median(e[key] for e in steady)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "replicas": replicas, "group_size": group_size,
        "tau": TRAIN_TAU, "seq_len": seq_len, "global_batch": global_batch,
        "params_per_replica": sum(l.numel() for l in tr.tree_leaves(
            trainer.state.params)) // replicas,
        "n_buckets": n_buckets, "bucket_bytes": plan.class_bucket_bytes[0],
        "expected_k1_k2_per_group_step": expected_combine_launches(
            n_buckets, n_stages),
        "init_s": init_s, "losses": [e["loss"] for e in log],
        "steps": log, "launches": launches,
        "median_step_ms": med("step_ms"),
        "tokens_per_s": global_batch * seq_len / (med("step_ms") / 1e3),
        "median_split_ms": {k: med(k + "_ms")
                            for k in ("grads", "update", "average",
                                      "other")},
        "max_memory_allocated": (max(peak_first, peak_rest)
                                 if on_card else None),
        "max_memory_allocated_after_first": peak_rest,
        "fused_equals_per_leaf": checked["fused_equals_per_leaf"],
    }, trainer


def check_train_launches(stats):
    """Check (a): every group step launched the predicted K1 and K2
    counts, at least one K2 launch combined several pairs, and no sync step
    launched either."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    for e in stats["steps"]:
        want = (0, 0) if e["sync"] else (want_k1, want_k2)
        if (e["k1"], e["k2"]) != want:
            raise AssertionError(f"step {e['t']}: K1/K2 launched "
                                 f"{(e['k1'], e['k2'])}, the schedule "
                                 f"predicts {want}")
    if want_k2 < 1 or stats["launches"][K2] < 1:
        raise AssertionError("no multi-pair K2 launch on the training path")


def train_profile(trainer, t: int, device="cuda", shares=None):
    """One group step (global step ``t``) under the profiler; ``shares`` as
    :func:`_window` takes them."""
    from torch.profiler import profile
    with profile(activities=_activities(device)) as prof:
        t0 = time.perf_counter()
        trainer.step_once(t)
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _window(prof, wall_ms, shares=shares)


# ---------------------------------------------------------------------------
# Elastic phase: membership changes over the replica rows (K1, K2)
# ---------------------------------------------------------------------------

def bits(t):
    """``t``'s bits as integers of its width: equal bits, which ``==`` does
    not test (-0.0 == 0.0, NaN != NaN)."""
    import torch
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def rows_bit_identical(params) -> bool:
    """Every stacked leaf's rows equal its row 0, bit for bit."""
    import torch
    from repro_torch.core import tree as tr
    for leaf in tr.tree_leaves(params):
        b = bits(leaf)
        if not torch.equal(b[1:], b[:1].expand_as(b[1:])):
            return False
    return True


def rows_taken(new, old, rows) -> bool:
    """Row i of every leaf of the ReplicaState ``new`` (params, moments,
    count) is row ``rows[i]`` of ``old``'s, bit for bit."""
    import torch
    from repro_torch.core import tree as tr
    pairs = zip(tr.tree_leaves((new.params, new.opt_state)),
                tr.tree_leaves((old.params, old.opt_state)))
    return all(torch.equal(bits(a[i]), bits(b[r]))
               for a, b in pairs for i, r in enumerate(rows))


def planted_joiner_fails(params, pre_sync_row0, n_old: int) -> bool:
    """Check (f): the regrown rows with every joiner seated on row 0 as it
    was before the sync (``pre_sync_row0``, a host copy) instead of after
    it must fail check (b)."""
    import torch
    from repro_torch.core import tree as tr
    planted = tr.tree_map(
        lambda a, r: torch.cat([a[:n_old], r.to(a.device).unsqueeze(0)
                                .expand(a.shape[0] - n_old, *r.shape)]),
        params, pre_sync_row0)
    return not rows_bit_identical(planted)


def transition_rows(ev) -> list:
    """The old world's row behind each row of the new one: a shrink's
    ``keep_rows``; after a regrow the survivors in order, then row 0 (the
    post-sync consensus) for each joiner."""
    if ev.kind == "shrink":
        return list(ev.keep_rows)
    n_old = len(ev.world) - ev.n_joined
    return list(range(n_old)) + [0] * ev.n_joined


def elastic_trainer(cfg, pool: int, device="cuda", seq_len: int = TRAIN_SEQ,
                    plant: bool = False, keep: bool = False, against=None):
    """An ``ElasticTrainer`` over ``pool`` rows with this phase's probes.
    Its ``probe_step``, passed to ``run``/``run_under_faults`` as
    ``step``, records per step the launches and what the epoch's plan
    predicts (check (a)), the plan's combine operands, loss, skipped
    share, time and memory.  Per transition, timed as a whole with the new
    plan compiled: check (b) and the memory after.  With ``plant``, check
    (f): a regrow attempted after step 0 (rows apart) must raise the
    barrier guard, and every regrow's joiners seated on row 0 from before
    the sync must fail (b).  Its final state (``state_digest``) stays on
    the card: with ``keep`` a copy of its leaves (``kept``), with
    ``against`` (another run's ``kept``) ``state_equal``, whether its
    leaves are those bit for bit (``torch.equal``)."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.core.elastic import MembershipEvent
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic as el

    memory = (torch.cuda.memory_allocated
              if torch.device(device).type == "cuda" else (lambda: None))

    class Probed(el.ElasticTrainer):
        def __init__(self):
            self.steps, self.transitions, self.planted = [], [], {}
            self.combines = {}
            self.pre_sync_row0 = None
            self.digest_s = 0.0
            self.first = True
            t0 = time.perf_counter()
            super().__init__(cfg, pool, device=device, tau=ELASTIC_TAU,
                             group_size=ELASTIC_S, seed=0,
                             learning_rate=ELASTIC_LR, seq_len=seq_len)
            self.init_s = time.perf_counter() - t0

        def probe_step(self, trainer, t):
            plan = trainer.plan()
            sync = trainer.averager.sync_due(t)
            if plant and sync:
                self.pre_sync_row0 = tr.tree_map(lambda a: a[0].cpu(),
                                                 trainer.state.params)
            offset = plan.offsets[trainer.averager.phase_for_step(t)]
            want = (0, 0) if sync else expected_combine_launches(
                plan.class_layout(0).n_buckets,
                len(plan.runs_for_offset(offset)[0].bits))
            self.combines[trainer.n_dp] = plan_combines(plan, trainer.n_dp)
            before = ops.launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            loss = trainer.step_once(t)
            _sync(device)
            step_ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            self.steps.append({
                "t": t, "world": trainer.n_dp, "epoch": self.controller.epoch,
                "sync": sync, "loss": loss, "step_ms": step_ms,
                "first": self.first, "memory": memory(), "want": list(want),
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
            self.first = False
            if plant and t == 0:
                self.planted["regrow_off_barrier_raises"] = \
                    self._regrow_off_barrier_raises()
            return loss

        def _regrow_off_barrier_raises(self) -> bool:
            world = self.controller.membership.active
            try:
                self._transition(MembershipEvent(
                    "regrow", self.controller.epoch, world))
            except AssertionError as e:
                return "outside the tau-sync barrier" in str(e)
            return False

        def _transition(self, ev):
            old = self.trainer.state
            rows = transition_rows(ev)
            _sync(device)
            t0 = time.perf_counter()
            super()._transition(ev)
            self.trainer.plan()            # compiled here, inside the time
            _sync(device)
            rec = {"after_steps": len(self.steps), "epoch": ev.epoch,
                   "kind": ev.kind, "world": len(ev.world),
                   "transition_ms": (time.perf_counter() - t0) * 1e3,
                   "rows_taken": rows_taken(self.trainer.state, old, rows),
                   "rows_identical": (
                       rows_bit_identical(self.trainer.state.params)
                       if ev.kind == "regrow" else None)}
            del old
            self.first = True
            if plant and ev.kind == "regrow":
                rec["planted_joiner_fails"] = planted_joiner_fails(
                    self.trainer.state.params, self.pre_sync_row0,
                    len(rows) - ev.n_joined)
            rec["memory"] = memory()
            self.transitions.append(rec)
            if not rec["rows_taken"] or rec["rows_identical"] is False:
                raise AssertionError(
                    f"check (b): epoch {ev.epoch} {ev.kind}: new rows are "
                    f"the old rows {rows} bit for bit {rec['rows_taken']}, "
                    f"rows identical after a regrow {rec['rows_identical']}")

        def state_digest(self):
            # check (e) compares the states themselves on the card, in
            # place of a sha256 of the ~19 GB of 8 rows on the host
            t0 = time.perf_counter()
            st = self.trainer.state
            leaves = tr.tree_leaves((st.params, st.opt_state)) + [
                torch.tensor([st.step, st.phase], device=device)]
            if keep:
                self.kept = [a.detach().clone() for a in leaves]
            if against is not None:
                self.state_equal = len(leaves) == len(against) and all(
                    torch.equal(a, b) for a, b in zip(leaves, against))
            _sync(device)
            self.digest_s += time.perf_counter() - t0
            return f"{len(leaves)} leaves, compared on the card"

    return Probed()


def elastic_run(et, kind: str, seconds: float, launches: dict, rep=None,
                records=None) -> dict:
    """One elastic run's numbers and logs (``kind`` chaos or kill)."""
    if rep is not None:
        records = rep["records"]
    out = {"kind": kind, "pool": et.pool, "seconds": seconds,
           "init_s": et.init_s, "launches": launches, "records": records,
           "epoch_log": et.epoch_log, "steps": et.steps,
           "transitions": et.transitions, "planted": et.planted,
           "losses": [r["loss"] for r in records],
           "combines": et.combines, "digest_s": et.digest_s,
           "state_equal": getattr(et, "state_equal", None)}
    if rep is not None:
        out.update({k: rep[k] for k in ("events", "staleness",
                                        "schedule_fingerprint",
                                        "state_digest")})
    return out


def elastic_log(run: dict) -> dict:
    """What check (c) holds equal between the card and the CPU: the event
    log, each record's world, epoch and skip age, the staleness snapshot
    and the epoch log's transitions and topology diffs (not the plans each
    evicted: that count depends on what else the process compiled)."""
    return {"events": run.get("events"),
            "records": [{k: v for k, v in r.items() if k != "loss"}
                        for r in run["records"]],
            "staleness": run.get("staleness"),
            "epoch_log": [{k: v for k, v in e.items() if k != "plans_evicted"}
                          for e in run["epoch_log"]]}


def drive_chaos(et) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic as el
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = et.run_under_faults(ELASTIC_CHAOS_STEPS, el.CHAOS_SCHEDULE,
                              step=et.probe_step)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    el.check_chaos(et, rep, steps=ELASTIC_CHAOS_STEPS)
    return elastic_run(et, "chaos", seconds, launches, rep=rep)


def drive_kill(et) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.launch import elastic as el
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    records = et.run(ELASTIC_KILL_STEPS, events=el.kill_rejoin_events(
        ELASTIC_KILL_STEP, ELASTIC_KILL_WORKER), step=et.probe_step)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    el.check_kill_rejoin(et, records, steps=ELASTIC_KILL_STEPS,
                         leave_step=ELASTIC_KILL_STEP)
    return elastic_run(et, "kill", seconds, launches, records=records)


def elastic_twin(cfg) -> dict:
    """Check (c)'s twin: the chaos schedule and the kill script through the
    port's plain ``ElasticTrainer`` on the CPU at smoke size, on one
    intra-op thread (many tiny ops: more threads only contend)."""
    import torch
    from repro_torch.launch import elastic as el
    kw = dict(device="cpu", tau=ELASTIC_TAU, group_size=ELASTIC_S, seed=0,
              learning_rate=ELASTIC_LR, seq_len=ELASTIC_TWIN_SEQ)
    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        et = el.ElasticTrainer(cfg, ELASTIC_POOL, **kw)
        rep = et.run_under_faults(ELASTIC_CHAOS_STEPS, el.CHAOS_SCHEDULE)
        chaos = dict(rep, epoch_log=et.epoch_log)
        et = el.ElasticTrainer(cfg, ELASTIC_KILL_POOL, **kw)
        records = et.run(ELASTIC_KILL_STEPS, events=el.kill_rejoin_events(
            ELASTIC_KILL_STEP, ELASTIC_KILL_WORKER))
    finally:
        torch.set_num_threads(threads)
    return {"chaos": elastic_log(chaos),
            "kill": elastic_log({"records": records,
                                 "epoch_log": et.epoch_log}),
            "seconds": time.perf_counter() - t0}


def elastic_phase(cfg, device="cuda", seq_len: int = TRAIN_SEQ) -> dict:
    """The elastic phase: chaos, kill and rejoin, replay on ``device``
    with checks (b)-(f) (check (a) and (g) are
    :func:`check_elastic_launches` and :func:`check_elastic_memory`);
    returns the runs and the twin's logs."""
    import torch
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    runs, kept = {}, None
    for name, pool, drive, plant in (
            ("chaos", ELASTIC_POOL, drive_chaos, False),
            ("kill", ELASTIC_KILL_POOL, drive_kill, True),
            ("replay", ELASTIC_POOL, drive_chaos, False)):
        et = elastic_trainer(cfg, pool, device, seq_len, plant,
                             keep=name == "chaos",
                             against=kept if name == "replay" else None)
        runs[name] = drive(et)
        if name == "chaos":
            kept = et.kept
        del et
    del kept
    twin = elastic_twin(get_config(ARCH, smoke=True))
    stats = {"arch": cfg.name, "n_layers": cfg.n_layers, "seq_len": seq_len,
             "runs": runs, "twin_seconds": twin["seconds"],
             "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                      if on_card else None)}
    for name, twin_name in (("chaos", "chaos"), ("kill", "kill"),
                            ("replay", "chaos")):           # check (c)
        log = elastic_log(runs[name])
        if log != twin[twin_name]:
            raise AssertionError(
                f"check (c): the {name} run's host-side log differs from "
                f"the CPU's in {[k for k in log if log[k] != twin[twin_name][k]]}"
                f": {log} vs {twin[twin_name]}")
    for run in runs.values():
        if not all(e["plans_evicted"] >= 1 for e in run["epoch_log"]):
            raise AssertionError(f"check (c): a {run['kind']} transition "
                                 f"evicted no plan: {run['epoch_log']}")
    bad = [(name, s["t"]) for name, run in runs.items() for s in run["steps"]
           if not math.isfinite(s["loss"]) or s["skipped"]]
    if bad:                                                     # check (d)
        raise AssertionError(f"check (d): non-finite loss or skipped update "
                             f"at {bad}")
    chaos, replay = runs["chaos"], runs["replay"]
    replayed = {k: chaos[k] == replay[k] for k in (
        "events", "records", "staleness")}
    replayed["state"] = replay["state_equal"] is True
    if not all(replayed.values()):                              # check (e)
        raise AssertionError(f"check (e): the replay differs: {replayed}")
    planted = runs["kill"]["planted"]
    joiners = [t["planted_joiner_fails"] for t in runs["kill"]["transitions"]
               if t["kind"] == "regrow"]
    if not (planted.get("regrow_off_barrier_raises") and joiners
            and all(joiners)):                                  # check (f)
        raise AssertionError(f"check (f): a planted fault passed: regrow "
                             f"off the barrier raised "
                             f"{planted.get('regrow_off_barrier_raises')}, "
                             f"pre-sync joiners failed (b) {joiners}")
    stats["replayed"] = replayed
    stats["seconds"] = time.perf_counter() - t_phase
    return stats


def check_elastic_launches(stats):
    """Check (a): every step of every elastic run launched the K1/K2 its
    epoch's plan predicts (none on a sync) and no K3 or K4, and the runs
    launched nothing outside their steps."""
    for name, run in stats["runs"].items():
        for s in run["steps"]:
            if [s["k1"], s["k2"]] != s["want"] or s["k3"] or s["k4"]:
                raise AssertionError(
                    f"check (a): {name} step {s['t']} (world {s['world']}): "
                    f"K1, K2, K3, K4 launched "
                    f"{(s['k1'], s['k2'], s['k3'], s['k4'])}, the plan "
                    f"predicts {tuple(s['want'])}, 0, 0")
        for key, kernel in (("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4)):
            if run["launches"][kernel] != sum(s[key] for s in run["steps"]):
                raise AssertionError(f"check (a): {name} launched {kernel} "
                                     f"outside its steps")


def check_elastic_held(stats, held: dict):
    """Check (a), the operands: every world's combines in the elastic runs
    (each K1 size and scale, the K2 batch) are those the K1/K2 phase held
    to the plain versions (``held``, its ``line["elastic"]``)."""
    for name, run in stats["runs"].items():
        for world, combines in run["combines"].items():
            if world not in held or held[world]["combines"] != combines:
                raise AssertionError(
                    f"check (a): {name}'s world {world} combines {combines}"
                    f", the K1/K2 phase held "
                    f"{held.get(world, {}).get('combines')}")


def check_elastic_memory(stats):
    """Check (g): after every transition, and after the first step that
    follows it, the card holds at most ``ELASTIC_MEMORY_SLACK`` more than
    the least it holds after a later step of a world of that size in the
    same run."""
    for name, run in stats["runs"].items():
        steady = {}
        for s in run["steps"]:
            if s["memory"] is None:
                raise AssertionError("check (g): no device memory measured")
            if not s["first"]:
                steady[s["world"]] = min(steady.get(s["world"], s["memory"]),
                                         s["memory"])
        for tr_ in run["transitions"]:
            after = run["steps"][tr_["after_steps"]:tr_["after_steps"] + 1]
            for what, mem in [("transition", tr_["memory"])] + [
                    ("first step", s["memory"]) for s in after]:
                if mem > steady[tr_["world"]] + ELASTIC_MEMORY_SLACK:
                    raise AssertionError(
                        f"check (g): {name} epoch {tr_['epoch']}: "
                        f"{mem / 2**30:.2f} GiB after the {what}, steady "
                        f"state of world {tr_['world']} "
                        f"{steady[tr_['world']] / 2**30:.2f} GiB")


def elastic_summary(stats) -> dict:
    """Step ms by world size (median of the steps that are not the first
    of their world), each transition's ms, K1/K2 launches by epoch."""
    out = {"step_ms_by_world": {}, "transitions": [], "k1_k2_by_epoch": {}}
    for name, run in stats["runs"].items():
        by_world = {}
        for s in run["steps"]:
            if not s["first"]:
                by_world.setdefault(s["world"], []).append(s["step_ms"])
            key = f"{name} epoch {s['epoch']}"
            k = out["k1_k2_by_epoch"].setdefault(key, [0, 0])
            k[0] += s["k1"]
            k[1] += s["k2"]
        out["step_ms_by_world"][name] = {
            w: statistics.median(v) for w, v in sorted(by_world.items())}
        for tr_ in run["transitions"]:
            after = run["steps"][tr_["after_steps"]:tr_["after_steps"] + 1]
            out["transitions"].append({
                "run": name, "epoch": tr_["epoch"], "kind": tr_["kind"],
                "world": tr_["world"], "transition_ms": tr_["transition_ms"],
                "first_step_ms": after[0]["step_ms"] if after else None})
    return out


def print_elastic(stats, card: str):
    s = elastic_summary(stats)
    runs = stats["runs"]
    for name, run in runs.items():
        print(f"elastic {name} [{card}]: pool {run['pool']}, worlds "
              f"{[r['world'] for r in run['records']]}, epochs "
              f"{[e['kind'] for e in run['epoch_log']]}, losses "
              f"{[round(x, 4) for x in run['losses']]}, {run['seconds']:.2f}"
              f" s (trainer init {run['init_s']:.2f} s, final state kept or "
              f"compared on the card "
              f"{run['digest_s']:.2f} s), launches K1 {run['launches'][K1]} "
              f"K2 {run['launches'][K2]}", flush=True)
        print(f"elastic {name} step ms by world (median after the first) "
              f"{ {w: round(v, 1) for w, v in s['step_ms_by_world'][name].items()} }"
              f" [{card}]", flush=True)
    for t in s["transitions"]:
        fmt = lambda v: "-" if v is None else f"{v:.1f}"
        print(f"elastic {t['run']} epoch {t['epoch']} {t['kind']} to "
              f"{t['world']}: transition (row selection, release, rebuild, "
              f"plan compile) {fmt(t['transition_ms'])} ms, first step "
              f"after {fmt(t['first_step_ms'])} ms [{card}]", flush=True)
    print(f"elastic K1/K2 launches by epoch {s['k1_k2_by_epoch']}",
          flush=True)
    stale = runs["chaos"]["staleness"]
    print(f"elastic checks: (b) every transition's rows bit for bit, every "
          f"regrow at consensus; (c) host-side logs equal to the CPU "
          f"twin's ({stats['twin_seconds']:.1f} s), peak age "
          f"{stale['peak_age']} <= tau {ELASTIC_TAU}; (e) replay "
          f"{stats['replayed']}; (f) regrow off the barrier raised "
          f"{runs['kill']['planted']['regrow_off_barrier_raises']}, pre-sync "
          f"joiners failed (b); peak memory "
          + (f"{stats['max_memory_allocated'] / 2**30:.2f} GiB"
             if stats["max_memory_allocated"] is not None else "-")
          + f"; phase {stats['seconds']:.1f} s [{card}]", flush=True)


# ---------------------------------------------------------------------------
# FSDP phase: 4 pods of 2 sharing shard buffers, 22 layers (K1, K2; K3)
# ---------------------------------------------------------------------------

def fsdp_topology(pod: int = FSDP_POD):
    """``Topology.hierarchical(("data", "pod"), (2, pod))``: data rides ICI
    (the shard axis), pod rides DCN (the pod-to-pod butterfly)."""
    from repro_torch.core.plan import Topology
    return Topology.hierarchical(("data", "pod"), (FSDP_DATA, pod),
                                 dcn_axes=("pod",))


def fsdp_plan(cfg):
    """The FSDP phase's sharded plan (the Trainer's: the plan cache hands
    both the same object)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.replica import ShardingPolicy
    from repro_torch.models import transformer as tfm
    return plan_mod.compile_plan(
        fsdp_topology(), tfm.param_specs(cfg),
        plan_mod.AveragingConfig(group_size=FSDP_S, tau=FSDP_TAU),
        ShardingPolicy.fsdp_within_pod("data"))


def fsdp_combines(cfg):
    """The FSDP path's combine operands: each K1 size and the K2 tail
    batch of one group step of the sharded plan over its ``(P_eff, n_b)``
    float32 shard buffers, at scale 1/S."""
    plan = fsdp_plan(cfg)
    return plan_combines(plan, plan.P_eff)


def fsdp_rank_combines(cfg):
    """The fsdp ranks path's combine operands: each K1 size and the K2
    tail batch of one group step of the sharded plan over a rank's ``(1,
    n_b / 2)`` float32 slices, at scale 1/S."""
    return plan_combines(fsdp_plan(cfg), 1, per_rank=True)


def streamed_plan(cfg):
    """The streamed phase's plan: the FSDP phase's topology and config,
    the layer-streamed policy, over the layered tree (the Trainer's: the
    plan cache hands both the same object)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.replica import ShardingPolicy
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model
    layered = build_model(cfg, device="cpu").layered
    return plan_mod.compile_plan(
        fsdp_topology(), layered.split(tfm.param_specs(cfg)),
        plan_mod.AveragingConfig(group_size=FSDP_S, tau=FSDP_TAU),
        ShardingPolicy.fsdp_within_pod("data", streamed=True))


def streamed_combines(cfg):
    """The streamed path's combine operands: each K1 size and the K2 tail
    batch of one group step of the grouped plan over its ``(P_eff, n_b)``
    float32 shard buffers, at scale 1/S."""
    plan = streamed_plan(cfg)
    return plan_combines(plan, plan.P_eff)


def streamed_rank_combines(cfg):
    """The streamed ranks path's combine operands: each K1 size and the K2
    tail batch of one group step of the grouped plan over a rank's ``(1,
    n_b / 2)`` float32 slices, at scale 1/S."""
    return plan_combines(streamed_plan(cfg), 1, per_rank=True)


def fsdp_model_plan(cfg, streamed: bool = False):
    """The fsdp model phase's sharded plan of one model coordinate: the
    plan over a rank's slice tree (``MODEL_M`` model ranks) on data 2 x
    pod ``FSDP_MODEL_POD``, gather-all or layer-streamed, in one process
    (its ranks' plans have its layout)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.replica import ShardingPolicy
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model
    specs = tfm.param_specs(cfg)
    local = cm.take_slices(specs, cm.placement(cfg, specs, MODEL_M),
                           cm.ModelWorld(MODEL_M, 0))
    if streamed:
        local = build_model(cfg, device="cpu").layered.split(local)
    return plan_mod.compile_plan(
        fsdp_topology(FSDP_MODEL_POD), local,
        plan_mod.AveragingConfig(group_size=FSDP_S, tau=FSDP_TAU),
        ShardingPolicy.fsdp_within_pod("data", streamed=streamed))


def fsdp_model_combines(cfg, streamed: bool = False):
    """The fsdp model path's combine operands: each K1 size and the K2
    tail batch of one group step over a rank's ``(1, n_b / 2)`` float32
    slices of its model coordinate's buckets, at scale 1/S."""
    return plan_combines(fsdp_model_plan(cfg, streamed), 1, per_rank=True)


def grads_pass_reckoning(plan, cfg, seq_len: int, rows: int) -> dict:
    """Device bytes one pod's gradient pass adds to the state it starts
    from, reckoned from the code before the run (``train_step``,
    ``plan.grad_shards``, ``streaming.streamed_loss_and_grad_shards``).

    Both paths: the pod's float32 accumulator, one layer's recomputed
    attention scores and their gradient, the float32 logits and their
    gradient.  Gather-all: one member's whole gradient tree in the
    params' dtypes and every layer's input kept by ``checkpoint``.
    Streamed: one group's gradients (the largest group), and every
    member's span-boundary carries (detached, kept across the pass)."""
    lay = plan.shard_layout
    elems = sum(lay.bucket_sizes)
    store = sum(s * d.itemsize for s, d in zip(lay.bucket_sizes,
                                                lay.bucket_dtypes))
    tokens = rows * seq_len
    carry = tokens * cfg.d_model * 2
    common = (4 * elems + 2 * rows * cfg.n_heads * seq_len ** 2 * 4
              + 2 * tokens * cfg.vocab_padded * 4)
    if plan.sharding.streamed:
        grads = max(lay.group_bytes(g) for g in set(lay.bucket_groups))
        kept = plan.shard_size * plan.n_stream_spans * carry
    else:
        grads, kept = store, cfg.n_layers * carry
    return {"accumulator": 4 * elems, "grads": grads, "carries": kept,
            "own_peak": common + grads + kept}


def fsdp_reckoning(plan, cfg, seq_len: int, rows: int) -> dict:
    """Device bytes the FSDP step needs at its two peaks, reckoned from
    the code before the run (``train_step``, ``plan``), beside those of
    the replicated layout of the same model and replica count.

    Training a pod: the ``(P_eff, n_b)`` params and float32 momentum, one
    float32 accumulator (``grad_shards``), one member's gradients in the
    params' dtypes (the pod's tree is a view of its row) and the member's
    activations (each layer's input kept by ``checkpoint``, one layer's
    recomputed scores and their gradient, the float32 logits and their
    gradient).  The average: the old and the new storage buffers, the
    momentum, a float32 copy of every buffer, two buckets' exchanges in
    flight."""
    from repro_torch.core import tree as tr
    lay = plan.shard_layout
    elems = sum(lay.bucket_sizes)
    store = sum(s * d.itemsize for s, d in zip(lay.bucket_sizes,
                                                lay.bucket_dtypes))
    tokens = rows * seq_len
    activations = (cfg.n_layers * tokens * cfg.d_model * 2
                   + 2 * rows * cfg.n_heads * seq_len ** 2 * 4
                   + 2 * tokens * cfg.vocab_padded * 4)
    # rows of storage, float32 momentum, float32 average copies and the
    # averaged storage beside the old
    averaging = lambda n, store, elems: n * (2 * store + 8 * elems)
    specs = tr.tree_leaves(plan.storage_struct)
    r_elems = sum(math.prod(s.shape) for s in specs)
    r_store = sum(math.prod(s.shape) * s.dtype.itemsize for s in specs)
    train = (plan.P_eff * (store + 4 * elems) + 4 * elems + store
             + activations)
    average = (averaging(plan.P_eff, store, elems)
               + 2 * plan.P_eff * max(lay.bucket_sizes) * 4)
    return {"params": plan.P_eff * store, "momentum": plan.P_eff * 4 * elems,
            "accumulator": 4 * elems, "member_grads": store,
            "activations": activations, "train_peak": train,
            "average_peak": average, "peak": max(train, average),
            "replicated_state": plan.P * (r_store + 4 * r_elems),
            "replicated_peak": averaging(plan.P, r_store, r_elems)}


def ulp_nudge(buf):
    """``buf`` (a bf16 or f32 row) with every element moved one ulp away
    from zero: its bit pattern plus one."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return (buf.view(ints[buf.dtype]) + 1).view(buf.dtype)


def sharded_average_matches(plan, rep_plan, pre, out, offset: int) -> bool:
    """Check (b): the sharded average ``out`` of the shard buffers ``pre``
    at ``offset`` equals, bit for bit, the port's replicated plan over
    ``eff_topology`` (its per-leaf path, one leaf at a time, no K1/K2)
    applied to the unpacked pod rows."""
    return fused_equals_per_leaf(per_leaf_plan(rep_plan),
                                 plan.unshard_tree(out),
                                 plan.unshard_tree(pre), offset)


def planted_ulp(plan, pre, offset: int):
    """Check (g)'s planted fault: ``pre`` with one element of one pod's
    row nudged by one ulp, where the nudge changes that group's mean
    (half the elements: the mean of two bf16 rows is rounded back to
    bf16).  Only the nudged bucket is copied."""
    import torch
    from repro_torch.core import grouping
    bit = grouping.mask_bits_for_offset(plan.P_eff, plan.S, offset)[0]
    b = max(range(len(pre)), key=lambda i: pre[i].numel())
    row, partner = 0, 1 << bit
    a, p = pre[b][row], pre[b][partner]
    nudged = ulp_nudge(a)
    mean = lambda x: ((x.float() + p.float()) * 0.5).to(a.dtype)
    moved = (mean(nudged) != mean(a)).nonzero()
    if not len(moved):
        raise AssertionError("no one-ulp nudge moves the group mean")
    i = int(moved[0])
    bucket = pre[b].clone()
    bucket[row, i] = nudged[i]
    return tuple(bucket if j == b else x for j, x in enumerate(pre))


class PeakMeter:
    """The card's peak allocation over a phase, and the own peak of one
    pass inside it: ``start()`` banks the peak so far and resets the
    counter, ``stop()`` reads the pass's peak above what was allocated at
    its start; ``phase_peak()`` is the largest of every banked peak and
    the counter's.  ``None`` everywhere off the card."""

    def __init__(self, on_card: bool):
        import torch
        self.on_card, self.banked, self.pass_ = on_card, [], None
        if on_card:
            torch.cuda.reset_peak_memory_stats()

    def start(self):
        import torch
        if self.on_card:
            self.banked.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()

    def stop(self):
        import torch
        if self.on_card:
            peak = torch.cuda.max_memory_allocated()
            self.pass_ = {"peak": peak, "base": self.base,
                          "own": peak - self.base}

    def phase_peak(self):
        import torch
        if not self.on_card:
            return None
        return max(self.banked + [torch.cuda.max_memory_allocated()])


def fsdp_phase(cfg, device="cuda", steps: int = FSDP_STEPS,
               seq_len: int = TRAIN_SEQ, global_batch: int = FSDP_GB,
               conv_layers: int = FSDP_CONV_LAYERS,
               n_requests: int = FSDP_REQUESTS, keep=None) -> dict:
    """The FSDP phase with checks (b)-(e) and (g) (check (a) is
    :func:`check_fsdp_launches`, (f) :func:`check_fsdp_memory`): the
    port's ``Trainer(sharding="fsdp")``, 4 pods of 2, for ``steps`` steps;
    returns the run's numbers.  ``keep`` (a dict) receives, for the
    streamed phase, pod 0's final params and momentum as canonical trees
    (``params``, ``momentum``) and the consolidated weights
    (``weights``)."""
    import torch
    from repro_torch.core import bucketing, grouping
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.serve.handoff import serving_weights_from_state
    from repro_torch.train import train_step

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    rows = global_batch // (FSDP_DATA * FSDP_POD)
    plan = fsdp_plan(cfg)
    reckoning = fsdp_reckoning(plan, cfg, seq_len, rows)
    grads_reckoning = grads_pass_reckoning(plan, cfg, seq_len, rows)
    meter = PeakMeter(on_card)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, FSDP_DATA, pod_axis=FSDP_POD, device=device,
                      sharding="fsdp", topology=fsdp_topology(),
                      group_size=FSDP_S, tau=FSDP_TAU,
                      learning_rate=TRAIN_LR, seq_len=seq_len,
                      global_batch=global_batch, seed=0)
    _sync(device)
    init_s = time.perf_counter() - t0
    if trainer.plan() is not plan:
        raise AssertionError("the Trainer compiled another plan than "
                             "fsdp_plan")
    rep_plan = plan_mod.compile_plan(plan.eff_topology, plan.storage_struct,
                                     plan_mod.AveragingConfig(
                                         group_size=FSDP_S, tau=FSDP_TAU))
    n_buckets = plan.shard_layout.n_buckets
    split = {"grads": 0.0, "update": 0.0, "average": 0.0}
    timed = split_timer(split, device)
    trainer.opt = Optimizer(trainer.opt.init,
                            timed("update", trainer.opt.update))
    averaged = []
    comm = timed("average", trainer.averager.comm)

    def comm_kept(tree, phase):
        out = comm(tree, phase)
        averaged.append((tree, out, plan.offsets[phase]))
        return out

    trainer.averager.comm = comm_kept
    trainer.averager.sync = timed("average", trainer.averager.sync)
    recorded = {}
    grad_shards = plan.grad_shards

    def grad_shards_kept(member_grads):
        if recorded.get("armed"):                 # pod 0 of the check step
            meter.start()
        out = grad_shards(member_grads)
        if recorded.get("armed"):
            meter.stop()
            recorded.update(armed=False, grads=tuple(g.clone() for g in out))
        return out

    plan.grad_shards = grad_shards_kept
    value_and_grad = train_step.value_and_grad
    train_step.value_and_grad = timed("grads", value_and_grad)
    log, checked, planted = [], {}, None
    ops.reset_launch_counts()
    try:
        for t in range(steps):
            split.update(grads=0.0, update=0.0, average=0.0)
            if t == FSDP_GRAD_STEP:
                pod0 = tuple(b[0].clone() for b in trainer.state.params)
                recorded["armed"] = True
            before = ops.launch_counts()
            _sync(device)
            t_start = time.perf_counter()
            loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t_start
            after = ops.launch_counts()
            sync = trainer.averager.sync_due(t)
            offset = (None if sync else
                      plan.offsets[trainer.averager.phase_for_step(t)])
            log.append({
                "t": t, "loss": loss, "sync": sync, "offset": offset,
                "step_ms": step_s * 1e3,
                **{k + "_ms": split[k] * 1e3 for k in split},
                "other_ms": (step_s - sum(split.values())) * 1e3,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
            groups = ((tuple(range(plan.P_eff)),) if sync else
                      grouping.groups_for_offset(plan.P_eff, FSDP_S, offset))
            same, differ = group_rows_agree(trainer.state.params, groups)
            if not same or (not sync and not differ):          # check (b)
                raise AssertionError(
                    f"check (b): step {t} ({'sync' if sync else offset}): "
                    f"pods of a group bit-identical {same}, groups differ "
                    f"{differ}, groups {groups}")
            if averaged:
                pre, out, off = averaged.pop()
                if off not in checked:                          # check (b)
                    checked[off] = sharded_average_matches(plan, rep_plan,
                                                           pre, out, off)
                    if planted is None:                         # check (g)
                        planted = not sharded_average_matches(
                            plan, rep_plan, planted_ulp(plan, pre, off),
                            out, off)
                del pre, out
            if t == FSDP_GRAD_STEP:                             # check (c)
                checked["pod_mean_grads"] = pod_grads_equal(
                    trainer, plan, pod0, t, recorded.pop("grads"))
                del pod0
    finally:
        train_step.value_and_grad = value_and_grad
        del plan.grad_shards
    peak = meter.phase_peak()
    launches = ops.launch_counts()
    offsets_checked = sorted(k for k in checked if k != "pod_mean_grads")
    if offsets_checked != sorted(plan.offsets) or not all(checked.values()):
        raise AssertionError(f"check (b)/(c): {checked} over offsets "
                             f"{plan.offsets}")
    if not planted:                                             # check (g)
        raise AssertionError("check (g): the average of a pod buffer "
                             "nudged by one ulp passed check (b)")
    bad = [e for e in log if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (g)
        raise AssertionError(f"check (g): non-finite losses or skipped "
                             f"updates: {bad}")
    if not trainer.averager.sync_due(steps - 1):
        raise AssertionError("the phase must end on a sync (check (e))")
    # check (e): the final (post-sync) state's consolidated weights served
    # through the paged engine, against pod 0's unpacked tree served alone
    t0 = time.perf_counter()
    weights = serving_weights_from_state(trainer.state, plan=plan)
    prompts = make_requests(cfg)[:n_requests]
    served = {}
    for name, params in (("consolidated", weights),
                         ("pod 0", plan.unshard_tree(trainer.state.params,
                                                     0))):
        before = ops.launch_counts()
        tokens, sched = serve_tokens(trainer.model, params, prompts)
        after = ops.launch_counts()
        served[name] = {"tokens": tokens, "n_prefills": sched.n_prefills,
                        "launches": {k: after[k] - before[k]
                                     for k in after}}
    if served["consolidated"]["tokens"] != served["pod 0"]["tokens"]:
        raise AssertionError("check (e): the consolidated weights serve "
                             "other tokens than pod 0's tree")
    serve_s = time.perf_counter() - t0
    combines = plan_combines(plan, plan.P_eff)
    if keep is not None:
        st = trainer.state
        pod0 = lambda bufs: tr.tree_map(torch.clone, bucketing.unpack(
            tuple(b[0] for b in bufs), plan.shard_layout, cast=False))
        keep.update(params=pod0(st.params),
                    momentum=pod0(st.opt_state.momentum), weights=weights)
    del weights, trainer
    conversions = fsdp_conversions(cfg.variant(n_layers=conv_layers),
                                   device, seq_len, global_batch)
    steady = log[1:] or log
    med = lambda key: statistics.median(e[key] for e in steady)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "pods": plan.P_eff, "pod_size": plan.shard_size,
        "replicas": plan.P, "group_size": FSDP_S, "tau": FSDP_TAU,
        "seq_len": seq_len, "global_batch": global_batch,
        "n_buckets": n_buckets, "bucket_bytes": plan.shard_bucket_bytes,
        "expected_k1_k2_per_group_step": expected_combine_launches(
            n_buckets, len(plan.runs_for_offset(plan.offsets[0])[0].bits)),
        "combines": combines, "init_s": init_s,
        "losses": [e["loss"] for e in log], "steps": log,
        "launches": launches, "checked": checked, "planted_fails": planted,
        "median_step_ms": med("step_ms"),
        "tokens_per_s": global_batch * seq_len / (med("step_ms") / 1e3),
        "median_split_ms": {k: med(k + "_ms") for k in (
            "grads", "update", "average", "other")},
        "reckoning": reckoning, "max_memory_allocated": peak,
        "grads_pass": meter.pass_, "grads_pass_reckoning": grads_reckoning,
        "serving": {k: {kk: v[kk] for kk in ("n_prefills", "launches")}
                    for k, v in served.items()},
        "serve_s": serve_s,
        "conversions": conversions,
        "seconds": time.perf_counter() - t_phase,
    }


def pod_grads_equal(trainer, plan, pod0, t: int, got) -> bool:
    """Check (c): pod 0's gradient at step ``t`` recomputed through the
    replicated path's public pieces (``train_step.value_and_grad`` of each
    member on the unpacked pre-step pod tree, ``bucketing.pack`` in
    float32, the sum in member order, the scale by 1/pod size) equals the
    step's grad shards bit for bit."""
    import torch
    from repro_torch.core import bucketing, replica
    from repro_torch.train import train_step
    batch = trainer._put_batch(t)
    b = trainer.shape.global_batch // plan.P
    tree = bucketing.unpack(pod0, plan.shard_layout)
    acc = None
    for r in replica.pod_members(plan, 0):
        g, _ = train_step.value_and_grad(
            trainer.model, tree, {k: v[r * b:(r + 1) * b]
                                  for k, v in batch.items()})
        packed = bucketing.pack(g, plan.shard_layout, dtype=torch.float32)
        del g
        acc = packed if acc is None else tuple(
            a + p for a, p in zip(acc, packed))
        del packed
    twin = tuple(a * (1.0 / plan.shard_size) for a in acc)
    return all(bits(a).equal(bits(w)) for a, w in zip(got, twin))


def fsdp_conversions(cfg, device, seq_len: int, global_batch: int) -> dict:
    """Check (d) at ``cfg``'s depth (full width): one step of a tau-1
    FSDP Trainer (a sync), then ``replicated_to_fsdp_state(
    fsdp_to_replicated_state(s))`` must be ``s`` bit for bit and
    ``consolidate_state`` each pod's unpacked row bit for bit."""
    from repro_torch.core import replica
    from repro_torch.core import tree as tr
    from repro_torch.launch.train import Trainer
    t0 = time.perf_counter()
    trainer = Trainer(cfg, FSDP_DATA, pod_axis=FSDP_POD, device=device,
                      sharding="fsdp", topology=fsdp_topology(),
                      group_size=FSDP_S, tau=1, learning_rate=TRAIN_LR,
                      seq_len=seq_len, global_batch=global_batch, seed=0)
    trainer.step_once(0)
    plan, s = trainer.plan(), trainer.state
    back = replica.replicated_to_fsdp_state(
        replica.fsdp_to_replicated_state(s, plan), plan)
    leaves = lambda st: tr.tree_leaves((st.params, st.opt_state))
    round_trip = (len(leaves(back)) == len(leaves(s)) and all(
        a.dtype == b.dtype and bits(a).equal(bits(b))
        for a, b in zip(leaves(back), leaves(s))))
    del back
    cons = tr.tree_leaves(replica.consolidate_state(s, plan))
    consolidated = all(
        bits(c).equal(bits(p)) for e in range(plan.P_eff)
        for c, p in zip(cons, tr.tree_leaves(plan.unshard_tree(s.params, e))))
    if not (round_trip and consolidated):
        raise AssertionError(f"check (d) at {cfg.n_layers} layers: round "
                             f"trip {round_trip}, consolidation = every "
                             f"pod's row {consolidated}")
    return {"n_layers": cfg.n_layers, "round_trip": round_trip,
            "consolidated_equals_pods": consolidated,
            "seconds": time.perf_counter() - t0}



def check_fsdp_launches(stats):
    """Check (a): each group step launched the K1/K2 of the sharded plan's
    schedule (its shard buckets, one stage at S 2), each sync none, no
    step K3 or K4, and nothing launched outside the steps; check (e)'s
    serving runs K3 once a layer a prefill and nothing else."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    for e in stats["steps"]:
        want = (0, 0) if e["sync"] else (want_k1, want_k2)
        if (e["k1"], e["k2"]) != want or e["k3"] or e["k4"]:
            raise AssertionError(
                f"check (a): FSDP step {e['t']}: K1, K2, K3, K4 launched "
                f"{(e['k1'], e['k2'], e['k3'], e['k4'])}, the schedule "
                f"predicts {want}, 0, 0")
    for key, kernel in (("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4)):
        if stats["launches"][kernel] != sum(e[key] for e in stats["steps"]):
            raise AssertionError(f"check (a): the FSDP phase launched "
                                 f"{kernel} outside its steps")
    if want_k2 < 1:
        raise AssertionError("check (a): no multi-pair K2 launch on the "
                             "FSDP path")
    for run in stats["serving"].values():           # check (e)'s serving
        check_serving_launches(run, stats["n_layers"])


def check_fsdp_held(stats, held: dict):
    """Check (a), the operands: the FSDP run's combines (each K1 size and
    scale, the K2 batch) are those the K1/K2 phase held to the plain
    versions (``held``, its ``line["fsdp"]``)."""
    if held.get("combines") != stats["combines"]:
        raise AssertionError(f"check (a): the FSDP run's combines "
                             f"{stats['combines']}, the K1/K2 phase held "
                             f"{held.get('combines')}")


def check_fsdp_memory(stats, limit: int = 80 * 10 ** 9):
    """Check (f): the measured peak stays under the card's 80 GB."""
    peak = stats["max_memory_allocated"]
    if peak is None or peak >= limit:
        raise AssertionError(f"check (f): peak {peak} bytes, limit {limit}")


def print_fsdp(stats, card: str):
    r = stats["reckoning"]
    gb = lambda b: f"{b / 1e9:.2f} GB"
    print(f"fsdp [{card}]: {stats['arch']} full width, {stats['n_layers']} "
          f"layers, {stats['replicas']} replicas as {stats['pods']} pods of "
          f"{stats['pod_size']}, S={stats['group_size']} tau={stats['tau']},"
          f" {stats['n_buckets']} shard buckets of "
          f"{stats['bucket_bytes'] >> 20} MiB; K1/K2 a group step "
          f"{stats['expected_k1_k2_per_group_step']}, launches "
          f"{stats['launches']}", flush=True)
    print(f"fsdp losses: {[round(x, 4) for x in stats['losses']]}",
          flush=True)
    print(f"fsdp [{card}]: median step {stats['median_step_ms']:.1f} ms "
          f"after the first, {stats['tokens_per_s']:.0f} tokens/s, host "
          f"split { {k: round(v, 1) for k, v in stats['median_split_ms'].items()} }"
          f" ms, trainer init {stats['init_s']:.2f} s", flush=True)
    peak = stats["max_memory_allocated"]
    print(f"fsdp memory [{card}]: peak "
          + ("-" if peak is None else gb(peak))
          + f" against the reckoning {gb(r['peak'])} (training "
          f"{gb(r['train_peak'])}: params {gb(r['params'])}, momentum "
          f"{gb(r['momentum'])}, accumulator {gb(r['accumulator'])}, a "
          f"member's grads {gb(r['member_grads'])}, activations "
          f"{gb(r['activations'])}; average {gb(r['average_peak'])}); the "
          f"replicated layout of the same {stats['replicas']} replicas "
          f"{gb(r['replicated_peak'])} (its state alone "
          f"{gb(r['replicated_state'])})", flush=True)
    conv = stats["conversions"]
    print(f"fsdp checks: (b) sharded average = replicated plan on the pod "
          f"rows by offset { {k: v for k, v in stats['checked'].items() if k != 'pod_mean_grads'} }"
          f", a one-ulp nudge fails it {stats['planted_fails']}; (c) pod 0's "
          f"gradient = its members' packed mean {stats['checked']['pod_mean_grads']}"
          f"; (d) at {conv['n_layers']} layers round trip "
          f"{conv['round_trip']}, consolidation = every pod "
          f"{conv['consolidated_equals_pods']}; (e) consolidated and pod 0 "
          f"serve the same tokens, K3 {stats['serving']['consolidated']['launches'][K3]}"
          f" + {stats['serving']['pod 0']['launches'][K3]} over "
          f"{stats['serving']['consolidated']['n_prefills']} prefills each "
          f"({stats['serve_s']:.1f} s); phase {stats['seconds']:.1f} s "
          f"[{card}]", flush=True)


# ---------------------------------------------------------------------------
# Streamed phase: the FSDP run through the layer-streamed engine (K1, K2)
# ---------------------------------------------------------------------------

def streamed_phase(cfg, fsdp: dict, kept: dict, device="cuda",
                   steps: int = FSDP_STEPS, seq_len: int = TRAIN_SEQ,
                   global_batch: int = FSDP_GB,
                   conv_layers: int = FSDP_CONV_LAYERS) -> dict:
    """The streamed phase with checks (b)-(d) and (f) (checks (a) and (e)
    are :func:`check_streamed_launches`, :func:`check_streamed_held` and
    :func:`check_streamed_memory`): ``Trainer(..., sharding="fsdp",
    streamed=True)``, the FSDP phase's run (``fsdp``: its numbers;
    ``kept``: what :func:`fsdp_phase` kept); returns the run's numbers."""
    import torch
    from repro_torch.core import bucketing, grouping, streaming
    from repro_torch.core import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.serve.handoff import serving_weights_from_state

    t_phase = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    rows = global_batch // (FSDP_DATA * FSDP_POD)
    plan = streamed_plan(cfg)
    n = plan.n_stream_spans
    streaming.validate_stream_schedule(streaming.stream_schedule(n), n)
    grads_reckoning = grads_pass_reckoning(plan, cfg, seq_len, rows)
    meter = PeakMeter(on_card)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, FSDP_DATA, pod_axis=FSDP_POD, device=device,
                      sharding="fsdp", streamed=True,
                      topology=fsdp_topology(), group_size=FSDP_S,
                      tau=FSDP_TAU, learning_rate=TRAIN_LR, seq_len=seq_len,
                      global_batch=global_batch, seed=0)
    _sync(device)
    init_s = time.perf_counter() - t0
    if trainer.plan() is not plan:
        raise AssertionError("the Trainer compiled another plan than "
                             "streamed_plan")
    layered = trainer.model.layered
    split = {"grads": 0.0, "update": 0.0, "average": 0.0}
    timed = split_timer(split, device)
    trainer.opt = Optimizer(trainer.opt.init,
                            timed("update", trainer.opt.update))
    trainer.averager.comm = timed("average", trainer.averager.comm)
    trainer.averager.sync = timed("average", trainer.averager.sync)
    recorded = {}
    engine = streaming.streamed_loss_and_grad_shards

    def engine_kept(*args, **kw):
        armed = recorded.pop("armed", False)    # pod 0 of the check step
        if armed:
            meter.start()
        out = engine(*args, **kw)
        if armed:
            meter.stop()
            recorded["grads"] = tuple(g.clone() for g in out[2])
        return out

    streaming.streamed_loss_and_grad_shards = timed("grads", engine_kept)
    log, checked = [], {}
    ops.reset_launch_counts()
    try:
        for t in range(steps):
            split.update(grads=0.0, update=0.0, average=0.0)
            if t == FSDP_GRAD_STEP:
                pod0 = tuple(b[0].clone() for b in trainer.state.params)
                recorded["armed"] = True
            before = ops.launch_counts()
            gathers = plan.stream_gathers
            _sync(device)
            t_start = time.perf_counter()
            loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t_start
            after = ops.launch_counts()
            sync = trainer.averager.sync_due(t)
            offset = (None if sync else
                      plan.offsets[trainer.averager.phase_for_step(t)])
            log.append({
                "t": t, "loss": loss, "sync": sync, "offset": offset,
                "step_ms": step_s * 1e3,
                **{k + "_ms": split[k] * 1e3 for k in split},
                "other_ms": (step_s - sum(split.values())) * 1e3,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                "gathers_per_pod": (plan.stream_gathers - gathers)
                / plan.P_eff,
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
            if t == FSDP_GRAD_STEP:                             # check (b)
                got = recorded.pop("grads")
                want = gather_all_pod_grads(trainer, plan, pod0, t)
                checked["grads"] = grads_match(plan, got, want)
                b = plan.stream_bucket_indices(streaming.span_group(0))[0]
                nudged = tuple(ulp_nudge(g) if i == b else g
                               for i, g in enumerate(got))
                checked["planted_fails"] = not grads_match(
                    plan, nudged, want)                         # check (f)
                del pod0, got, want, nudged
    finally:
        streaming.streamed_loss_and_grad_shards = engine
    peak = meter.phase_peak()
    launches = ops.launch_counts()
    losses = [e["loss"] for e in log]
    # check (c): the FSDP phase's run, step for step and bit for bit
    st = trainer.state
    unpack0 = lambda bufs: bucketing.unpack(tuple(b[0] for b in bufs),
                                            plan.shard_layout, cast=False)
    same = lambda got, want: all(
        bits(a).equal(bits(b)) for a, b in zip(
            tr.tree_leaves(got), tr.tree_leaves(layered.split(want))))
    checked.update(
        losses_equal=losses == fsdp["losses"][:steps],
        pods_equal_after_sync=rows_bit_identical(st.params),
        params_equal=same(unpack0(st.params), kept["params"]),
        momentum_equal=same(unpack0(st.opt_state.momentum),
                            kept["momentum"]))
    # check (d): the final state's serving weights are the FSDP phase's
    weights = serving_weights_from_state(st, plan=plan, model=trainer.model)
    checked["weights_equal"] = all(
        bits(a).equal(bits(b)) for a, b in zip(
            tr.tree_leaves(weights), tr.tree_leaves(kept["weights"])))
    del weights
    bad = [k for k, v in checked.items() if not v]
    if bad:
        raise AssertionError(f"streamed checks (b)-(d), (f) failed: {bad} "
                             f"({checked}); losses {losses} against the "
                             f"FSDP phase's {fsdp['losses']}")
    bad = [e for e in log if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (f)
        raise AssertionError(f"check (f): non-finite losses or skipped "
                             f"updates: {bad}")
    combines = plan_combines(plan, plan.P_eff)
    gathered = {"stream_peak": plan.stream_peak_gathered_bytes(),
                "full": plan.full_gathered_bytes()}
    del trainer, st
    conversions = streamed_conversions(cfg.variant(n_layers=conv_layers),
                                       device, seq_len, global_batch)
    steady = log[1:] or log
    med = lambda key: statistics.median(e[key] for e in steady)
    return {
        "arch": cfg.name, "n_layers": cfg.n_layers, "n_spans": n,
        "pods": plan.P_eff, "pod_size": plan.shard_size,
        "replicas": plan.P, "n_buckets": plan.shard_layout.n_buckets,
        "layer_map": plan.shard_layout.describe_groups(),
        "bucket_sizes": list(plan.shard_layout.bucket_sizes),
        "expected_k1_k2_per_group_step": expected_combine_launches(
            plan.shard_layout.n_buckets,
            len(plan.runs_for_offset(plan.offsets[0])[0].bits)),
        "expected_stream_gathers": streaming.expected_stream_gathers(plan),
        "combines": combines, "init_s": init_s, "losses": losses,
        "steps": log, "launches": launches, "checked": checked,
        "median_step_ms": med("step_ms"),
        "fsdp_median_step_ms": fsdp["median_step_ms"],
        "tokens_per_s": global_batch * seq_len / (med("step_ms") / 1e3),
        "median_split_ms": {k: med(k + "_ms") for k in (
            "grads", "update", "average", "other")},
        "max_memory_allocated": peak, "grads_pass": meter.pass_,
        "grads_pass_reckoning": grads_reckoning,
        "fsdp_grads_pass": fsdp["grads_pass"],
        "fsdp_grads_pass_reckoning": fsdp["grads_pass_reckoning"],
        "gathered_bytes": gathered, "conversions": conversions,
        "seconds": time.perf_counter() - t_phase,
    }


def gather_all_pod_grads(trainer, plan, pod0, t: int):
    """Pod 0's gradient at step ``t`` on the gather-all path: the FSDP
    phase's plan's ``grad_shards`` of its members' ``value_and_grad`` on
    the pre-step pod tree (``pod0``, the streamed row merged to the
    canonical tree), unpacked through its layout and split into the
    layered tree (views of its float32 buffers)."""
    from repro_torch.core import bucketing, replica
    from repro_torch.train import train_step
    layered = trainer.model.layered
    ga = fsdp_plan(trainer.cfg)
    batch = trainer._put_batch(t)
    b = trainer.shape.global_batch // plan.P
    tree = layered.merge(bucketing.unpack(pod0, plan.shard_layout))
    want = ga.grad_shards(
        train_step.value_and_grad(trainer.model, tree, {
            k: v[r * b:(r + 1) * b] for k, v in batch.items()})[0]
        for r in replica.pod_members(plan, 0))
    return layered.split(bucketing.unpack(want, ga.shard_layout, cast=False))


def grads_match(plan, got, want) -> bool:
    """Check (b): the streamed float32 grad buffers ``got``, unpacked
    through the grouped layout, equal ``want`` (:func:`gather_all_pod_grads`)
    bit for bit."""
    from repro_torch.core import bucketing
    from repro_torch.core import tree as tr
    mine = bucketing.unpack(got, plan.shard_layout, cast=False)
    return all(bits(a).equal(bits(w)) for a, w in zip(
        tr.tree_leaves(mine), tr.tree_leaves(want)))


def streamed_conversions(cfg, device, seq_len: int, global_batch: int
                         ) -> dict:
    """Check (d) at ``cfg``'s depth (full width): one step of a tau-1
    streamed Trainer (a sync), then streamed -> replicated -> streamed and
    streamed -> gather-all -> streamed (through ``merge_layered_state``/
    ``split_layered_state`` and the FSDP conversions) must be the state
    bit for bit."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import replica
    from repro_torch.core import tree as tr
    from repro_torch.launch.train import Trainer
    t0 = time.perf_counter()
    trainer = Trainer(cfg, FSDP_DATA, pod_axis=FSDP_POD, device=device,
                      sharding="fsdp", streamed=True,
                      topology=fsdp_topology(), group_size=FSDP_S, tau=1,
                      learning_rate=TRAIN_LR, seq_len=seq_len,
                      global_batch=global_batch, seed=0)
    trainer.step_once(0)
    plan, s, layered = trainer.plan(), trainer.state, trainer.model.layered
    ga = plan_mod.compile_plan(plan.topology, layered.merge(
        plan.storage_struct), plan.cfg,
        replica.ShardingPolicy.fsdp_within_pod("data"))
    leaves = lambda st: tr.tree_leaves((st.params, st.opt_state))

    def equal(back) -> bool:
        return len(leaves(back)) == len(leaves(s)) and all(
            a.dtype == b.dtype and bits(a).equal(bits(b))
            for a, b in zip(leaves(back), leaves(s)))

    rep = replica.fsdp_to_replicated_state(s, plan)
    via_replicated = equal(replica.replicated_to_fsdp_state(rep, plan))
    gather_all = replica.replicated_to_fsdp_state(
        replica.merge_layered_state(rep, layered), ga)
    del rep
    rep = replica.fsdp_to_replicated_state(gather_all, ga)
    del gather_all
    via_gather_all = equal(replica.replicated_to_fsdp_state(
        replica.split_layered_state(rep, layered), plan))
    del rep
    if not (via_replicated and via_gather_all):
        raise AssertionError(f"check (d) at {cfg.n_layers} layers: "
                             f"streamed -> replicated -> streamed "
                             f"{via_replicated}, streamed -> gather-all -> "
                             f"streamed {via_gather_all}")
    return {"n_layers": cfg.n_layers, "via_replicated": via_replicated,
            "via_gather_all": via_gather_all,
            "seconds": time.perf_counter() - t0}


def check_streamed_launches(stats):
    """Check (a): each group step launched the K1/K2 of the grouped plan's
    schedule, each sync none, no step K3 or K4, nothing outside the steps,
    and every pod's fwd+bwd read ``expected_stream_gathers`` buckets."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    for e in stats["steps"]:
        want = (0, 0) if e["sync"] else (want_k1, want_k2)
        if (e["k1"], e["k2"]) != want or e["k3"] or e["k4"]:
            raise AssertionError(
                f"check (a): streamed step {e['t']}: K1, K2, K3, K4 "
                f"launched {(e['k1'], e['k2'], e['k3'], e['k4'])}, the "
                f"schedule predicts {want}, 0, 0")
        if e["gathers_per_pod"] != stats["expected_stream_gathers"]:
            raise AssertionError(
                f"check (a): streamed step {e['t']} read "
                f"{e['gathers_per_pod']} buckets a pod, the schedule "
                f"{stats['expected_stream_gathers']}")
    for key, kernel in (("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4)):
        if stats["launches"][kernel] != sum(e[key] for e in stats["steps"]):
            raise AssertionError(f"check (a): the streamed phase launched "
                                 f"{kernel} outside its steps")
    if want_k2 < 1:
        raise AssertionError("check (a): no multi-pair K2 launch on the "
                             "streamed path")


def check_streamed_held(stats, held: dict):
    """Check (a), the operands: the streamed run's combines are those the
    K1/K2 phase held (``held``, its ``line["streamed"]``)."""
    if held.get("combines") != stats["combines"]:
        raise AssertionError(f"check (a): the streamed run's combines "
                             f"{stats['combines']}, the K1/K2 phase held "
                             f"{held.get('combines')}")


def check_streamed_memory(stats, limit: int = 80 * 10 ** 9):
    """Check (e): both grads passes measured, the step's peak under the
    card's 80 GB."""
    peak = stats["max_memory_allocated"]
    if (peak is None or peak >= limit or stats["grads_pass"] is None
            or stats["fsdp_grads_pass"] is None):
        raise AssertionError(f"check (e): peak {peak} bytes (limit "
                             f"{limit}), grads passes "
                             f"{stats['grads_pass']} and "
                             f"{stats['fsdp_grads_pass']}")


def print_streamed(stats, card: str):
    gb = lambda b: f"{b / 1e9:.2f} GB"
    print(f"streamed [{card}]: {stats['arch']} full width, "
          f"{stats['n_layers']} layers in {stats['n_spans']} spans, "
          f"{stats['replicas']} replicas as {stats['pods']} pods of "
          f"{stats['pod_size']}, {stats['n_buckets']} grouped shard buckets "
          f"({stats['layer_map']}); K1/K2 a group step "
          f"{stats['expected_k1_k2_per_group_step']}, bucket gathers a "
          f"pod's fwd+bwd {stats['expected_stream_gathers']}, launches "
          f"{stats['launches']}", flush=True)
    print(f"streamed losses: {stats['losses']}", flush=True)
    print(f"streamed [{card}]: median step {stats['median_step_ms']:.1f} "
          f"ms after the first (the FSDP phase's "
          f"{stats['fsdp_median_step_ms']:.1f} ms), "
          f"{stats['tokens_per_s']:.0f} tokens/s, host split "
          f"{ {k: round(v, 1) for k, v in stats['median_split_ms'].items()} }"
          f" ms, trainer init {stats['init_s']:.2f} s", flush=True)
    for name, meas, reck in (
            ("gather-all", stats["fsdp_grads_pass"],
             stats["fsdp_grads_pass_reckoning"]),
            ("streamed", stats["grads_pass"],
             stats["grads_pass_reckoning"])):
        print(f"streamed memory [{card}]: {name} grads pass of pod 0 own "
              f"peak " + ("-" if meas is None else
                          f"{gb(meas['own'])} (peak {gb(meas['peak'])} "
                          f"above {gb(meas['base'])})")
              + f", reckoned {gb(reck['own_peak'])} (accumulator "
              f"{gb(reck['accumulator'])}, gradients {gb(reck['grads'])}, "
              f"kept carries {gb(reck['carries'])})", flush=True)
    peak = stats["max_memory_allocated"]
    g = stats["gathered_bytes"]
    print(f"streamed memory [{card}]: step peak "
          + ("-" if peak is None else gb(peak))
          + f"; the schedule's peak gathered {gb(g['stream_peak'])} against "
          f"the full tree's {gb(g['full'])} (on one card both are views "
          f"of the pod's row: no bytes move)", flush=True)
    conv = stats["conversions"]
    c = stats["checked"]
    print(f"streamed checks: (b) pod 0's streamed grads = gather-all "
          f"{c['grads']}, a one-ulp nudge fails it {c['planted_fails']}; "
          f"(c) losses = the FSDP phase's {c['losses_equal']}, pods equal "
          f"after the sync {c['pods_equal_after_sync']}, pod 0 params "
          f"{c['params_equal']} and momentum {c['momentum_equal']} = the "
          f"FSDP phase's; (d) at {conv['n_layers']} layers via replicated "
          f"{conv['via_replicated']}, via gather-all "
          f"{conv['via_gather_all']}, serving weights = the FSDP phase's "
          f"{c['weights_equal']}; phase {stats['seconds']:.1f} s [{card}]",
          flush=True)


# ---------------------------------------------------------------------------
# Ranks phase: one replica a rank over torch.distributed
# ---------------------------------------------------------------------------

def ranks_spec(device="cuda", smoke: bool = False,
               n_layers: Optional[int] = RANKS_LAYERS,
               seq_len: int = TRAIN_SEQ, global_batch: int = RANKS_GB,
               steps: int = RANKS_STEPS,
               bucket_bytes: Optional[int] = None) -> dict:
    """What the ranks and the parent's stacked twin both run (JSON, handed
    to every rank on its command line); ``bucket_bytes`` pins the plan's
    budget (:func:`spec_topology`)."""
    return {"device": device, "smoke": smoke, "n_layers": n_layers,
            "seq_len": seq_len, "global_batch": global_batch,
            "steps": steps, "bucket_bytes": bucket_bytes}


def spec_topology(spec: dict, data: int):
    """A rank phase's topology: ``None`` (the Trainer's own, its budget
    chosen by the cost model) unless ``spec["bucket_bytes"]`` pins the
    link's budget, as a rehearsal at smoke size does so that a group step
    has several buckets in flight."""
    from repro_torch.core import plan as plan_mod
    if not spec.get("bucket_bytes"):
        return None
    return plan_mod.Topology.flat(("data",), (data,), link=plan_mod.LinkClass(
        "link", bucket_bytes=spec["bucket_bytes"]))


def ranks_trainer(spec: dict, world=None):
    """The phase's ``Trainer``: one replica on a rank of ``world``, or all
    ``RANKS_P`` as the rows of one state on ``spec["device"]``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer
    cfg = get_config(ARCH, smoke=spec["smoke"])
    if spec["n_layers"]:
        cfg = cfg.variant(n_layers=spec["n_layers"])
    kw = {"world": world} if world is not None else {"device":
                                                     spec["device"]}
    return Trainer(cfg, RANKS_P, group_size=RANKS_S, tau=TRAIN_TAU,
                   learning_rate=TRAIN_LR, seq_len=spec["seq_len"],
                   global_batch=spec["global_batch"], seed=0,
                   topology=spec_topology(spec, RANKS_P), **kw)


def tensor_digest(t) -> str:
    """sha256 of a tensor's bytes (its dtype's bytes, not a cast)."""
    import hashlib
    import torch
    return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(
        torch.uint8).numpy()).hexdigest()


def digests(tensors) -> list:
    """:func:`tensor_digest` of each tensor, hashed on 8 threads (hashlib
    lets go of the GIL over large buffers)."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(tensor_digest, tensors))


def row_digests(tree) -> list:
    """One digest a row of a stacked tree: the digests of its leaves'
    rows, hashed together."""
    import hashlib
    from repro_torch.core import tree as tr
    leaves = tr.tree_leaves(tree)
    rows = leaves[0].shape[0]
    per_leaf = digests([a[r] for r in range(rows) for a in leaves])
    n = len(leaves)
    return [hashlib.sha256("".join(per_leaf[r * n:(r + 1) * n]).encode()
                           ).hexdigest() for r in range(rows)]


def state_digests(state) -> list:
    """One digest a leaf of a ReplicaState's params and optimiser state,
    in the trees' leaf order."""
    from repro_torch.core import tree as tr
    return digests(tr.tree_leaves((state.params, state.opt_state)))


def device_intervals(prof) -> list:
    """(start, end) ns of every device activity of a profiled window, on
    the host's clock (``torch.profiler`` converts the device's), so that
    the windows of processes sharing a card can be merged."""
    from torch.autograd import DeviceType
    return [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def union_ns(intervals) -> int:
    """Length of the union of ``intervals``."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def instrument_rank_trainer(trainer, world, plan):
    """Time a rank ``Trainer``'s step parts into ``split`` (grads, update,
    average, sync; host clock, synchronised), add the wire's seconds and
    counts of each average and sync into ``wire`` (``plan.wire_stats``;
    its running ``in_flight_max`` left out: check (g) reads a step's from
    the event log), and gather the rows ``comm`` averages
    (``mesh.gather_rows``) into ``pending`` once an offset not yet in
    ``checked``, their seconds in ``check_s[0]``; the first such offset
    also keeps this rank's own pre-average rows in ``own`` (check (h)).
    Returns (split, wire, pending, checked, check_s, own)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    from repro_torch.launch import mesh
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.train import train_step
    avg = trainer.averager
    split = dict.fromkeys(("grads", "update", "average", "sync"), 0.0)
    timed_ = split_timer(split, world.device)
    wire = {}

    def with_wire(fn):
        def run(*args):
            before = plan_mod.wire_stats()
            res = fn(*args)
            for k, v in plan_mod.wire_stats().items():
                if k != "in_flight_max":
                    wire[k] = wire.get(k, 0) + v - before[k]
            return res
        return run

    trainer.opt = Optimizer(trainer.opt.init,
                            timed_("update", trainer.opt.update))
    comm = timed_("average", with_wire(avg.comm))
    pending, checked, check_s, own = {}, {}, [0.0], {}

    def comm_checked(tree, phase):
        offset = plan.offsets[phase]
        if offset not in checked and offset not in pending:
            t0 = time.perf_counter()
            pending[offset] = mesh.gather_rows(world, tree)
            if not checked and not own:
                own[offset] = tr.tree_map(lambda a: a.clone(), tree)
            check_s[0] += time.perf_counter() - t0
        return comm(tree, phase)

    avg.comm = comm_checked
    avg.sync = timed_("sync", with_wire(avg.sync))
    train_step.value_and_grad = timed_("grads", train_step.value_and_grad)
    return split, wire, pending, checked, check_s, own


def receipt_events(wire, n_buckets: int, n_stages: int) -> dict:
    """Check (g) of a rank group step: every wavefront the wire logged
    (``wire.events``) follows ``pipeline_schedule``
    (``overlap.check_event_log``: bucket k+1's issue before bucket k's
    resolve, each resolve before its combine, at least 2 and at most the
    schedule's count in flight), and the wire's slots are at most
    ``max_in_flight(n_buckets, n_stages)``.  Returns the step's receipts
    issued, the most in flight, that bound, the span from the first issue
    to the last resolve (ms) and the slots."""
    from repro_torch.core import overlap
    if not wire.events:
        raise AssertionError("check (g): a group step logged no wavefront")
    runs = [overlap.check_event_log(r) for r in wire.events]
    bound = overlap.max_in_flight(n_buckets, n_stages)
    if wire.n_slots > bound:
        raise AssertionError(f"check (g): {wire.n_slots} host slots; the "
                             f"schedule has {bound} in flight")
    return {"issued": sum(r["issued"] for r in runs),
            "in_flight_max": max(r["in_flight_max"] for r in runs),
            "bound": bound, "slots": wire.n_slots,
            "span_ms": sum(r["span_s"] for r in runs) * 1e3}


def mispaired_receipts():
    """Check (h)'s planted fault: the wavefront hands bucket k's combine
    bucket k+1's receipt where it is in flight (read into bucket k's
    delivery as far as both reach); returns the undo."""
    from repro_torch.core import overlap
    take = overlap.take_receipt

    def mispaired(inflight, k):
        own = overlap.resolve(inflight.pop(k))
        if k + 1 not in inflight:
            return own
        other = overlap.resolve(inflight[k + 1]).reshape(-1)
        wrong = own.clone()
        n = min(own.numel(), other.numel())
        wrong.view(-1)[:n] = other[:n]
        return wrong
    overlap.take_receipt = mispaired

    def undo():
        overlap.take_receipt = take
    return undo


def rows_equal(want, got) -> bool:
    """Every leaf of ``want`` (on any device) ``torch.equal`` to ``got``'s
    (CPU)."""
    import torch
    from repro_torch.core import tree as tr
    return all(torch.equal(a.cpu(), b) for a, b in
               zip(tr.tree_leaves(want), tr.tree_leaves(got)))


def overlap_pair(world, plan, pre, offset) -> tuple:
    """Check (h) on this rank: ``pre`` (its own pre-average rows of a
    group step at ``offset``) averaged by ``plan`` with ``overlap=False``
    (the same buckets) and by ``plan`` itself (the asynchronous
    wavefront), ``torch.equal`` leaf by leaf; each timed on the host
    clock, synchronised, beside its exposed wait, the span with a receipt
    pending, the staging and the rest (the combines and packing).  Then
    the planted fault: ``pre`` averaged with :func:`mispaired_receipts`,
    gathered to the coordinate's dp rank 0 (``mesh.gather_rows``) for
    the stacked comparison.  Returns (the numbers, the faulty rows or
    ``None``)."""
    import torch
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    from repro_torch.launch import mesh
    serial = plan_mod.compile_plan(
        plan.topology, plan.storage_struct, dataclasses.replace(
            plan.cfg, overlap=False, bucket_bytes=plan.class_bucket_bytes[0]),
        world=world)
    out, res = {}, {}
    for name, p in (("serial", serial), ("async", plan)):
        _sync(world.device)
        before, t0 = plan_mod.wire_stats(), time.perf_counter()
        res[name] = p.average_offset(pre, offset)
        _sync(world.device)
        ms = (time.perf_counter() - t0) * 1e3
        d = {k: (v - before[k]) * 1e3 for k, v in plan_mod.wire_stats(
        ).items() if k.endswith("_s")}
        staging = d["d2h_s"] + d["h2d_s"]
        out[name] = {"ms": ms, "exposed_wait_ms": d["wire_s"],
                     "span_ms": d["span_s"], "staging_ms": staging,
                     "rest_ms": ms - d["wire_s"] - staging}
    out["equal"] = all(torch.equal(a, b) for a, b in zip(
        tr.tree_leaves(res["serial"]), tr.tree_leaves(res["async"])))
    del res
    undo = mispaired_receipts()
    try:
        faulty = plan.average_offset(pre, offset)
    finally:
        undo()
    return out, mesh.gather_rows(world, faulty)


def profiled_step(trainer, t: int, device) -> dict:
    """Step ``t`` under ``torch.profiler`` (after one warm start of it):
    its host-clock start and end, the device intervals (on the card) and
    :func:`_window`'s summary."""
    return profiled_call(lambda: trainer.step_once(t), device)[1]


def device_idle(windows) -> dict:
    """The device's busy ms and idle share over the profiled windows of
    processes sharing a card: the union of every window's device
    intervals on the host's clock, over the span from the first start to
    the last end (``None`` off the card)."""
    start = min(w["start_ns"] for w in windows)
    end = max(w["end_ns"] for w in windows)
    intervals = [(max(a, start), min(b, end)) for w in windows
                 for a, b in (w["intervals"] or ()) if b > start and a < end]
    on_card = all(w["intervals"] is not None for w in windows)
    busy_ms = union_ns(intervals) / 1e6 if on_card else None
    wall_ms = (end - start) / 1e6
    return {"profile_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if on_card else None}


def start_torchrun(n: int, flag: str, spec: dict, out: Path) -> dict:
    """Start ``python -m torch.distributed.run`` of ``n`` ranks of this
    script with ``flag SPEC OUT`` over gloo (their log in
    ``out/torchrun.log``); :func:`wait_torchrun` ends it."""
    import os
    log_path = out / "torchrun.log"
    env = dict(os.environ, REPRO_TORCH_BACKEND="gloo",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in [os.environ.get(
                       "PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"), flag,
           json.dumps(spec), str(out)]
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            env=env, start_new_session=True)
    return {"proc": proc, "log": log, "path": log_path,
            "t0": time.perf_counter()}


def wait_torchrun(run: dict, timeout: float) -> float:
    """Wait for :func:`start_torchrun`'s ranks, at most ``timeout``
    seconds from their start (then kill them all); fails unless torchrun
    exits 0.  Returns its seconds."""
    import os
    import signal
    proc = run["proc"]
    try:
        rc = proc.wait(timeout=max(timeout - (time.perf_counter()
                                              - run["t0"]), 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "timeout"
    run["log"].close()
    if rc != 0:
        raise AssertionError(f"torchrun exited {rc}; its log ends:\n"
                             + run["path"].read_text()[-6000:])
    return time.perf_counter() - run["t0"]


def run_torchrun(n: int, flag: str, spec: dict, out: Path,
                 timeout: int) -> float:
    """``python -m torch.distributed.run`` of ``n`` ranks of this script
    with ``flag SPEC OUT`` over gloo (their log in ``out/torchrun.log``);
    fails if torchrun does not exit 0 within ``timeout``.  Returns its
    seconds."""
    return wait_torchrun(start_torchrun(n, flag, spec, out), timeout)


def ranks_worker(spec: dict, out: str) -> int:
    """One rank of the ranks phase, started by torchrun: the port's
    ``Trainer`` on this rank's replica for ``spec["steps"]`` steps with
    checks (a)-(d), the checkpoint of check (e), one profiled step; rank 0
    writes ``out/ranks.json``."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.core import grouping
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = mesh.init_rank_world(RANKS_P,
                                 backend=os.environ["REPRO_TORCH_BACKEND"],
                                 device_type=spec["device"])
    device = world.device
    on_card = device.type == "cuda"
    try:
        trainer = ranks_trainer(spec, world)
        init_s = time.perf_counter() - t_start
        avg = trainer.averager
        plan = trainer.plan()
        stacked_plan = plan_mod.compile_plan(plan.topology,
                                             plan.storage_struct, plan.cfg)
        n_buckets = plan.class_layout(0).n_buckets
        n_stages = len(plan.runs_for_offset(0)[0].bits)
        split, wire, pending, checked, check_s, own = \
            instrument_rank_trainer(trainer, world, plan)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        log, peak_checks, check_h = [], None, None
        for t in range(spec["steps"]):
            for k in split:
                split[k] = 0.0
            wire.clear()
            check_s[0] = 0.0
            plan.wire.events = []
            before = ops.launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t0 - check_s[0]
            after = ops.launch_counts()
            sync = avg.sync_due(t)
            offset = None if sync else plan.offsets[avg.phase_for_step(t)]
            g = None if sync else receipt_events(plan.wire, n_buckets,
                                                 n_stages)   # check (g)
            plan.wire.events = None
            # check (b) on rank 0, from every rank's digest of its params
            t0 = time.perf_counter()
            rows = [None] * RANKS_P if world.rank == 0 else None
            dist.gather_object(row_digests(trainer.state.params)[0], rows,
                               dst=0)
            if world.rank == 0:
                groups = ((tuple(range(RANKS_P)),) if sync else
                          grouping.groups_for_offset(RANKS_P, RANKS_S,
                                                     offset))
                same = all(rows[m] == rows[g[0]] for g in groups for m in g)
                differ = len({rows[g[0]] for g in groups}) == len(groups)
                if not same or (not sync and not differ):
                    raise AssertionError(
                        f"step {t}: ranks of a group bit-identical {same}, "
                        f"groups differ {differ}, groups {groups}")
            # check (c), once an offset, on the rows gathered to rank 0;
            # check (h) and its fault at the first
            if offset in pending:
                pre = pending.pop(offset)
                post = mesh.gather_rows(world, trainer.state.params)
                checked[offset] = None         # rank 0 holds the verdict
                faulty = None
                if offset in own:
                    check_h, faulty = overlap_pair(world, plan,
                                                   own.pop(offset), offset)
                if world.rank == 0:
                    want = stacked_plan.average_offset(
                        tr.tree_map(lambda a: a.to(device), pre), offset)
                    checked[offset] = rows_equal(want, post)
                    if not checked[offset]:
                        raise AssertionError(
                            f"step {t}: the wire average at offset "
                            f"{offset} differs from the stacked plan's")
                    if faulty is not None:
                        check_h["fault_parts"] = not rows_equal(want,
                                                                faulty)
                    del want
                del pre, post, faulty
            log.append({
                "t": t, "loss": loss, "sync": sync, "offset": offset,
                "step_ms": step_s * 1e3,
                **{k + "_ms": v * 1e3 for k, v in split.items()},
                "exchange_ms": {k[:-2]: wire.get(k, 0.0) * 1e3
                                for k in ("d2h_s", "wire_s", "h2d_s")},
                "wire_bytes": wire.get("bytes", 0),
                "wire_ops": wire.get("ops", 0), "check_g": g,
                "check_ms": (check_s[0] + time.perf_counter() - t0) * 1e3,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
            if on_card and t == 1:
                # check (c) ran on steps 0 and 1: rank 0's stacked average
                peak_checks = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
        peak = torch.cuda.max_memory_allocated() if on_card else None
        ckpt_split = {"gather": 0.0}
        trainer.gathered_state = split_timer(ckpt_split, device)(
            "gather", trainer.gathered_state)
        t0 = time.perf_counter()
        state = trainer.save_checkpoint(str(Path(out) / "ckpt"))
        ckpt_split["write"] = time.perf_counter() - t0 - ckpt_split["gather"]
        t0 = time.perf_counter()
        state_sums = state_digests(state) if state is not None else None
        ckpt_split["digests"] = time.perf_counter() - t0
        del state
        window = profiled_step(trainer, spec["steps"], device)
        mine = {"rank": world.rank, "device": str(device), "log": log,
                "peak": peak, "peak_steps_0_1": peak_checks,
                "window": window, "init_s": init_s, "check_h": check_h}
        everyone = [None] * RANKS_P if world.rank == 0 else None
        dist.gather_object(mine, everyone, dst=0)
        if world.rank == 0:
            result = {
                "world": {"P": world.P, "axes": dict(zip(
                    world.axis_names, world.axis_sizes)),
                    "backend": world.backend},
                "n_buckets": n_buckets, "n_stages": n_stages,
                "bucket_bytes": plan.class_bucket_bytes[0],
                "expected_k1_k2_per_group_step": expected_combine_launches(
                    n_buckets, n_stages),
                "stacked_equals_wire": checked, "ckpt_s": ckpt_split,
                "digests": state_sums, "ranks": everyone,
                "worker_s": time.perf_counter() - t_start}
            (Path(out) / "ranks.json").write_text(json.dumps(result))
        return 0
    finally:
        mesh.shutdown()


def check_overlap(stats) -> dict:
    """Checks (g) and (h) of a rank phase on what its ranks report: (g)
    every rank logged and held every group step's wavefront to the
    schedule (:func:`receipt_events`, in the worker); (h) on every rank
    the serial and the asynchronous average of the same pre-step rows
    are equal, and, wherever a group step has a second bucket (on the
    card it always has), the mispaired receipts part from the stacked
    plan at every coordinate's dp rank 0.  Returns what the phase prints:
    rank 0's (g) numbers over its group steps and (h)'s."""
    for r in stats["ranks"]:
        for e in r["log"]:
            if not e["sync"] and not e["check_g"]:
                raise AssertionError(f"check (g): rank {r['rank']} step "
                                     f"{e['t']} logged no wavefront")
    hs = [r["check_h"] for r in stats["ranks"]]
    if any(h is None or not h["equal"] for h in hs):
        raise AssertionError(f"check (h): the serial and the asynchronous "
                             f"average part: {hs}")
    parts = [h["fault_parts"] for h in hs if "fault_parts" in h]
    if stats["n_buckets"] >= 2 and not (parts and all(parts)):
        raise AssertionError(f"check (h): mispaired receipts passed the "
                             f"stacked-plan equality ({parts})")
    g = [e["check_g"] for e in stats["ranks"][0]["log"] if e["check_g"]]
    return {"issued": g[0]["issued"],
            "in_flight_max": max(x["in_flight_max"] for x in g),
            "bound": g[0]["bound"], "slots": g[-1]["slots"],
            "span_ms": statistics.median(x["span_ms"] for x in g),
            "h": {k: hs[0][k] for k in ("serial", "async")},
            "fault_parts": parts}


def check_ranks_launches(stats):
    """Check (a) of the ranks phase, on every rank: each group step
    launched the K1 and K2 counts the wavefront schedule predicts for one
    wire stage a step; syncs neither; no step K3 or K4."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    for r in stats["ranks"]:
        for e in r["log"]:
            want = (0, 0) if e["sync"] else (want_k1, want_k2)
            got = (e["k1"], e["k2"], e["k3"], e["k4"])
            if got != want + (0, 0):
                raise AssertionError(f"rank {r['rank']} step {e['t']}: K1, "
                                     f"K2, K3, K4 launched {got}; the "
                                     f"schedule predicts {want + (0, 0)}")


def ranks_summary(stats: dict) -> dict:
    """The phase's numbers: rank 0's median step after the first and its
    split (group steps: grads, update, average = exchange + combine; the
    sync steps' sync), each rank's peak memory, and the device's idle
    share over the profiled step: the union of every rank's device
    activity on the host's clock, over the window from the first rank's
    start to the last rank's end."""
    steady = stats["ranks"][0]["log"][1:]
    group = [e for e in steady if not e["sync"]]
    med = lambda es, f: statistics.median(f(e) for e in es) if es else None
    exchange = {k: med(group, lambda e: e["exchange_ms"][k])
                for k in ("d2h", "wire", "h2d")}
    windows = [r["window"] for r in stats["ranks"]]
    return {
        "median_step_ms": med(steady, lambda e: e["step_ms"]),
        "median_group_step_ms": med(group, lambda e: e["step_ms"]),
        "median_sync_step_ms": med([e for e in steady if e["sync"]],
                                   lambda e: e["step_ms"]),
        "group_split_ms": {
            "grads": med(group, lambda e: e["grads_ms"]),
            "update": med(group, lambda e: e["update_ms"]),
            "exchange": exchange,
            "combine": med(group, lambda e: e["average_ms"] - sum(
                e["exchange_ms"].values())),
            "other": med(group, lambda e: e["step_ms"] - e["grads_ms"]
                         - e["update_ms"] - e["average_ms"])},
        "sync_ms": med([e for e in steady if e["sync"]],
                       lambda e: e["sync_ms"]),
        "wire_bytes_a_group_step": group[0]["wire_bytes"] if group else None,
        "peak_bytes_by_rank": [r["peak"] for r in stats["ranks"]],
        "rank0_peak_bytes_steps_0_1": stats["ranks"][0]["peak_steps_0_1"],
        "device_busy_ms_by_rank": [w["device_busy_ms"] for w in windows],
        **device_idle(windows),
    }


def print_overlap(label: str, o: dict, card: str):
    """Checks (g) and (h) of a rank phase (:func:`check_overlap`): the
    asynchronous wavefront's numbers on rank 0 and the serial and the
    asynchronous average of one group step's pre-average rows side by
    side (host clock, synchronised; no limit)."""
    side = lambda k: " vs ".join(f"{o['h'][n][k]:.1f}"
                                 for n in ("serial", "async"))
    print(f"{label} checks (g), (h) [{card}]: a group step issues "
          f"{o['issued']} receipts, at most {o['in_flight_max']} in flight "
          f"(the schedule's {o['bound']}), {o['slots']} host slots, median "
          f"span first issue to last resolve {o['span_ms']:.1f} ms; one "
          f"average of the same rows, serial vs async: {side('ms')} ms, "
          f"exposed wait {side('exposed_wait_ms')}, span with a receipt "
          f"pending {side('span_ms')}, staging {side('staging_ms')}, the "
          f"rest {side('rest_ms')} ms; equal on every rank; mispaired "
          f"receipts part from the stacked plan {o['fault_parts']}",
          flush=True)


def print_ranks(stats: dict, card: str):
    s = stats["summary"]
    e = stats["check_e"]
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    print(f"ranks [{card}]: {ARCH} full width, {stats['spec']['n_layers']} "
          f"layers, "
          f"{RANKS_P} ranks over {stats['world']['backend']} on one card, "
          f"S={RANKS_S} tau={TRAIN_TAU}, {stats['n_buckets']} buckets of "
          f"{stats['bucket_bytes'] >> 20} MiB, K1/K2 a group step "
          f"{stats['expected_k1_k2_per_group_step']}; phase "
          f"{stats['phase_s']:.1f} s (torchrun {stats['torchrun_s']:.1f} s)",
          flush=True)
    print(f"ranks losses: {[round(x['loss'], 4) for x in stats['ranks'][0]['log']]}",
          flush=True)
    print(f"ranks [{card}]: median step {s['median_step_ms']:.1f} ms after "
          f"the first (group {s['median_group_step_ms']:.1f}, sync "
          f"{s['median_sync_step_ms']} ms); group step split "
          f"{json.dumps(s['group_split_ms'])} ms, "
          f"{s['wire_bytes_a_group_step']} wire bytes a rank; sync "
          f"{s['sync_ms']} ms; peak memory by rank "
          f"{[gib(b) for b in s['peak_bytes_by_rank']]} GiB (rank 0 with "
          f"check (c)'s stacked average {gib(s['rank0_peak_bytes_steps_0_1'])}"
          f" GiB); profiled step: wall {s['profile_wall_ms']:.1f} ms, device "
          f"busy {s['device_busy_ms']} ms (by rank, overlaps counted "
          f"twice: {s['device_busy_ms_by_rank']}), idle share "
          f"{s['device_idle_share']}", flush=True)
    print_overlap("ranks", stats["overlap"], card)
    print(f"ranks checkpoint: {json.dumps(stats['ckpt_s'])} s on rank 0, "
          f"reload {json.dumps(stats['reload_s'])} s, stacked twin "
          f"{stats['stacked_s']:.1f} s", flush=True)
    print(f"ranks checks: (c) wire = stacked by offset "
          f"{stats['stacked_equals_wire']}; (e) checkpoint reload = gathered "
          f"state, stacked trainer first parts at step "
          f"{e['first_parting_step']}, max loss rel diff "
          f"{e['max_loss_rel_diff']:.3g} (tol {e['loss_rtol']}), params "
          f"bit-identical {e['params_bit_identical']} "
          f"({e['differing_elements']} of {e['elements']} differ, max "
          f"{e['max_param_abs_diff']:.3g}; largest change from the initial "
          f"params {e['max_param_change']:.3g})", flush=True)


def ranks_state_template(spec: dict):
    """A ``(P, ...)`` ReplicaState of Specs of the phase's model (SGD)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tree as tr
    from repro_torch.core.replica import ReplicaState
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.sgd import SGDState
    cfg = get_config(ARCH, smoke=spec["smoke"])
    if spec["n_layers"]:
        cfg = cfg.variant(n_layers=spec["n_layers"])
    params = tr.tree_map(lambda s: tr.Spec((RANKS_P,) + s.shape, s.dtype),
                         tfm.param_specs(cfg))
    f32 = tr.tree_map(lambda s: tr.Spec(s.shape, torch.float32), params)
    return ReplicaState(params, SGDState(f32, tr.Spec((RANKS_P,),
                                                      torch.int32)))


def ranks_phase(spec: dict, out: Path, timeout: int = RANKS_TIMEOUT) -> dict:
    """Start ``RANKS_P`` ranks through torchrun (gloo, all on one card),
    check (d) on their losses, then check (e): reload rank 0's
    checkpoint, hold every leaf to the state the ranks gathered (sha256),
    and run the one-process stacked ``Trainer`` with the same config, seed
    and batches against the ranks' losses and the checkpoint's params.  A
    rank that fails fails the phase.  ``out`` is the phase's own directory
    (emptied first): the ranks' log, their result and the checkpoint."""
    import shutil
    import torch
    from repro_torch.checkpoint import load_replica_state
    from repro_torch.core import tree as tr

    t_phase = time.perf_counter()
    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ranks_s = run_torchrun(RANKS_P, RANKS_WORKER_FLAG, spec, out, timeout)
    stats = json.loads((out / "ranks.json").read_text())
    stats["spec"], stats["torchrun_s"] = spec, ranks_s
    log0 = stats["ranks"][0]["log"]
    bad = [e for r in stats["ranks"] for e in r["log"]
           if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (d)
        raise AssertionError(f"non-finite losses or skipped updates: {bad}")
    if any(e["loss"] != f["loss"] for r in stats["ranks"]
           for e, f in zip(r["log"], log0)):
        raise AssertionError("the ranks report different mean losses")
    stats["overlap"] = check_overlap(stats)                     # (g), (h)

    # check (e): the checkpoint, then the stacked twin
    t0 = time.perf_counter()
    state = load_replica_state(str(out / "ckpt"), ranks_state_template(spec))
    t1 = time.perf_counter()
    if state_digests(state) != stats["digests"]:
        raise AssertionError("the reloaded checkpoint differs from the "
                             "state the ranks gathered")
    stats["reload_s"] = {"load": t1 - t0,
                         "digests": time.perf_counter() - t1}
    shutil.rmtree(out / "ckpt")
    t0 = time.perf_counter()
    trainer = ranks_trainer(spec)
    initial = [a.clone() for a in tr.tree_leaves(trainer.state.params)]
    losses = [trainer.step_once(t) for t in range(spec["steps"])]
    stats["stacked_s"] = time.perf_counter() - t0
    rank_losses = [e["loss"] for e in log0]
    parted = [t for t, (a, b) in enumerate(zip(losses, rank_losses))
              if a != b]
    leaves = []
    for got, want, first in zip(tr.tree_leaves(state.params),
                                tr.tree_leaves(trainer.state.params),
                                initial):
        w = want.cpu()
        leaves.append({
            "equal": bool(torch.equal(got, w)),
            "differing": int((got != w).sum()), "numel": got.numel(),
            "max_abs_diff": float((got.float() - w.float()).abs().max()),
            "max_change": float((want.float() - first.float()).abs().max())})
    del trainer, state, initial
    if torch.device(spec["device"]).type == "cuda":
        torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rank_losses))
    stats["check_e"] = {
        "stacked_losses": losses, "first_parting_step": (parted[0] if parted
                                                         else None),
        "max_loss_rel_diff": loss_rel, "loss_rtol": RANKS_LOSS_RTOL,
        "params_bit_identical": all(l["equal"] for l in leaves),
        "differing_elements": sum(l["differing"] for l in leaves),
        "elements": sum(l["numel"] for l in leaves),
        "max_param_abs_diff": max(l["max_abs_diff"] for l in leaves),
        "max_param_change": max(l["max_change"] for l in leaves)}
    e = stats["check_e"]
    if (loss_rel > RANKS_LOSS_RTOL or not e["params_bit_identical"]
            or e["max_param_change"] == 0.0):
        raise AssertionError(f"check (e): the ranks and the stacked trainer "
                             f"part (or the params never moved): {e}")
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["summary"] = ranks_summary(stats)
    return stats


# ---------------------------------------------------------------------------
# FSDP ranks phase: gather-all FSDP over a rank world (K1, K2 on the slices)
# ---------------------------------------------------------------------------

def fsdp_ranks_spec(device="cuda", smoke: bool = False,
                    n_layers: Optional[int] = RANKS_LAYERS,
                    seq_len: int = TRAIN_SEQ,
                    global_batch: int = FSDP_RANKS_GB,
                    steps: int = FSDP_RANKS_STEPS,
                    bucket_bytes: Optional[int] = None) -> dict:
    """What the ranks and the parent's one-process twin both run (JSON,
    handed to every rank); ``bucket_bytes`` pins both link classes'
    budget, as a rehearsal at smoke size does so that a group step has
    several shard buckets."""
    return {"device": device, "smoke": smoke, "n_layers": n_layers,
            "seq_len": seq_len, "global_batch": global_batch,
            "steps": steps, "bucket_bytes": bucket_bytes}


def fsdp_ranks_trainer(spec: dict, world=None, streamed: bool = False,
                       pod: int = FSDP_POD):
    """The phase's FSDP ``Trainer`` (gather-all, or layer-streamed) over
    data 2 x ``pod``: one member on a rank of ``world`` (with its model
    axis), or every pod as a row of one state on ``spec["device"]`` (the
    twin)."""
    from repro_torch.configs import get_config
    from repro_torch.core import plan as plan_mod
    from repro_torch.launch.train import Trainer
    cfg = get_config(ARCH, smoke=spec["smoke"])
    if spec["n_layers"]:
        cfg = cfg.variant(n_layers=spec["n_layers"])
    topology = fsdp_topology(pod)
    if spec.get("bucket_bytes"):
        pin = lambda l: dataclasses.replace(l, bucket_bytes=spec[
            "bucket_bytes"])
        topology = plan_mod.Topology(
            topology.axis_names, topology.axis_sizes,
            tuple(pin(l) for l in topology.link_classes), topology.axis_class)
    kw = {"world": world} if world is not None else {"device":
                                                     spec["device"]}
    return Trainer(cfg, FSDP_DATA, pod_axis=pod, group_size=FSDP_S,
                   tau=FSDP_TAU, learning_rate=TRAIN_LR,
                   seq_len=spec["seq_len"], global_batch=spec["global_batch"],
                   seed=0, topology=topology, sharding="fsdp",
                   streamed=streamed, **kw)


def profiled_call(fn, device) -> tuple:
    """``fn()`` under ``torch.profiler`` (after one warm start of it): its
    result, and its host-clock start and end, the device intervals (on
    the card) and :func:`_window`'s summary."""
    import torch
    from torch.profiler import profile
    with profile(activities=_activities(device)):   # the profiler's
        torch.ones(1, device=device).add_(1)        # first start
        _sync(device)
    with profile(activities=_activities(device)) as prof:
        start_ns = time.time_ns()
        out = fn()
        _sync(device)
        end_ns = time.time_ns()
    return out, {"start_ns": start_ns, "end_ns": end_ns,
                 "intervals": (device_intervals(prof)
                               if device.type == "cuda" else None),
                 **_window(prof, (end_ns - start_ns) / 1e6)}


def instrument_fsdp_ranks(trainer, world, plan, step_no: list):
    """Time an FSDP rank ``Trainer``'s step parts into ``split`` (the
    all-gather, the members' fwd+bwd, the reduce-scatter, update,
    average, sync; host clock, synchronised) with the wire's counts of
    each into ``wire``; gather the slices ``comm`` averages to rank 0 as
    ``(P_eff, n_b)`` buffers (``pending``) once an offset not yet in
    ``checked``, their seconds in ``check_s[0]``; at step
    ``FSDP_RANKS_GRAD_STEP`` (``step_no[0]``) keep in ``grab`` the digest
    of each gathered bucket, this member's gradient and its reduce-
    scattered slices (check (c)).  Returns (split, wire, pending,
    checked, check_s, grab)."""
    from repro_torch.core import overlap
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    from repro_torch.core.replica import join_rank_slices
    from repro_torch.launch import mesh
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.train import train_step
    avg = trainer.averager
    split = dict.fromkeys(("gather", "fwd_bwd", "scatter", "update",
                           "average", "sync"), 0.0)
    timed_ = split_timer(split, world.device)
    wire, grab = {}, {}
    at_grad_step = lambda: step_no[0] == FSDP_RANKS_GRAD_STEP

    def with_wire(key, fn):
        def run(*args):
            before = plan_mod.wire_stats()
            res = fn(*args)
            d = wire.setdefault(key, {})
            for k, v in plan_mod.wire_stats().items():
                if k != "in_flight_max":
                    d[k] = d.get(k, 0) + v - before[k]
            return res
        return run

    vag = train_step.value_and_grad

    def vag_noting(model, params, batch):
        grads, metrics = vag(model, params, batch)
        if at_grad_step():
            grab["grads"] = tr.tree_map(lambda a: a.clone(), grads)
        return grads, metrics

    all_gather = plan.shard_wire.shard_all_gather

    def all_gather_noting(buf, axis):
        out = all_gather(buf, axis)
        if at_grad_step():              # unshard_tree resolves it at once
            out = overlap.resolve(out)
            grab.setdefault("gathered", []).append(tensor_digest(out))
        return out

    grad_shards = plan.grad_shards

    def grad_shards_noting(member_grads):
        out = grad_shards(member_grads)
        if at_grad_step():
            grab["slices"] = tuple(b.clone() for b in out)
        return out

    train_step.value_and_grad = timed_("fwd_bwd", vag_noting)
    plan.shard_wire.shard_all_gather = all_gather_noting
    plan.unshard_tree = timed_("gather", with_wire("gather",
                                                   plan.unshard_tree))
    plan.grad_shards = timed_("scatter", with_wire("scatter",
                                                   grad_shards_noting))
    trainer.opt = Optimizer(trainer.opt.init,
                            timed_("update", trainer.opt.update))
    comm = timed_("average", with_wire("average", avg.comm))
    pending, checked, check_s = {}, {}, [0.0]

    def comm_checked(tree, phase):
        offset = plan.offsets[phase]
        if offset not in checked and offset not in pending:
            t0 = time.perf_counter()
            got = mesh.gather_rows(world, tree)
            pending[offset] = (None if got is None else join_rank_slices(
                tuple(b.to(world.device) for b in got), plan))
            check_s[0] += time.perf_counter() - t0
        return comm(tree, phase)

    avg.comm = comm_checked
    avg.sync = timed_("sync", with_wire("sync", avg.sync))
    return split, wire, pending, checked, check_s, grab


def slice_digest(buffers, pod: int, coord: int) -> str:
    """The digest :func:`row_digests` gives the rank of pod ``pod`` at
    shard coordinate ``coord`` of its slices, from ``(P_eff, n_b)``
    global buffers (pods of ``FSDP_DATA``)."""
    import hashlib
    per_bucket = digests([b[pod].view(FSDP_DATA, -1)[coord]
                          for b in buffers])
    return hashlib.sha256("".join(per_bucket).encode()).hexdigest()


def saved_digests(state) -> dict:
    """sha256 of every array a checkpoint of ``state`` holds, by its npz
    key (``checkpoint.ckpt``'s own conversion of each leaf), hashed on 8
    threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.checkpoint import ckpt
    out = {}
    for name, tree in (("params", state.params),
                       ("opt_state", state.opt_state)):
        arrays = ckpt._flatten(tree)
        with ThreadPoolExecutor(8) as pool:
            sums = pool.map(lambda a: hashlib.sha256(
                np.ascontiguousarray(a).reshape(-1).view(np.uint8)
            ).hexdigest(), arrays.values())
            out.update({f"{name}/{k}": d for k, d in zip(arrays, sums)})
    return out


def fsdp_ranks_check_c(world, plan, stacked_plan, grab, kept) -> dict:
    """Check (c) at ``FSDP_RANKS_GRAD_STEP`` (rank 0 decides): every
    rank's gathered buckets have the sha256 of its pod's row of the
    state before the step (``kept`` on rank 0: check (b)'s one-process
    average, which every rank's slices equal), and pod 0's reduce-
    scattered float32 slices, joined in shard-axis order, equal the
    one-process ``grad_shards`` of its members' gradients (gathered to
    rank 0 over the pod's group) bit for bit; joined in swapped order
    (the planted fault) they must not.  Returns rank 0's verdicts
    (``None`` elsewhere)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import tree as tr
    from repro_torch.core.replica import effective_rank_map
    from repro_torch.launch import mesh
    axis = plan.sharding.shard_axis
    members = world.shard_members(axis)
    digests_ = [None] * world.P if world.rank == 0 else None
    dist.gather_object(grab["gathered"], digests_, dst=0)
    size = len(members)
    if world.pod_of(axis) != 0:
        grab.clear()
        return None
    treedef = tr.tree_flatten(grab["grads"])[1]
    grads = mesh._gather_leaves(world, tr.tree_map(lambda a: a[None],
                                                   grab["grads"]), size,
                                world.shard_group, dst=members[0])
    slices = mesh._gather_leaves(world, tuple(b[None] for b in
                                              grab["slices"]), size,
                                 world.shard_group, dst=members[0])
    grab.clear()
    if world.rank != 0:
        return None
    device = world.device
    eff = effective_rank_map(world.axis_sizes, world.axis_names.index(axis))
    rows = [[tensor_digest(b[p]) for b in kept if b.numel()]
            for p in range(plan.P_eff)]
    gathered_equal = all(digests_[r] == rows[eff[r]]
                         for r in range(world.P))
    per_member = [tr.tree_unflatten(treedef, [g[m].to(device)
                                              for g in grads])
                  for m in range(size)]
    want = stacked_plan.grad_shards(iter(per_member))
    del per_member, grads
    nonempty = [i for i, b in enumerate(want) if b.numel()]
    join = lambda order: [torch.cat([slices[i][m] for m in order]
                                    ).to(device) for i in nonempty]
    joined, swapped = join(range(size)), join(range(size)[::-1])
    grads_equal = all(torch.equal(a, want[i])
                      for a, i in zip(joined, nonempty))
    swapped_parts = not all(torch.equal(a, want[i])
                            for a, i in zip(swapped, nonempty))
    if not (gathered_equal and grads_equal and swapped_parts):
        raise AssertionError(
            f"check (c): gathered trees = pods' rows {gathered_equal}, "
            f"joined slices = grad_shards {grads_equal}, swapped join "
            f"parts {swapped_parts}")
    return {"gathered_equal": gathered_equal, "grads_equal": grads_equal,
            "swapped_join_parts": swapped_parts,
            "buckets": len(nonempty)}


def fsdp_ranks_guard(trainer, world, t: int) -> Optional[list]:
    """Check (e)'s planted NaN, in one step ``t`` from this state: the
    last member of each pod of ``FSDP_RANKS_BAD_PODS`` puts a NaN in the
    first element of its gradient (it lands in the pod's first member's
    slice); the first pod keeps the MIN over the pod, so both its members
    must skip, the second runs a guard without it (the planted fault), so
    its members must part; every other member updates.  The state is put
    back after.  Returns rank 0's gathered counts (``None`` elsewhere)."""
    import torch.distributed as dist
    from repro_torch.core import tree as tr
    from repro_torch.core.replica import ReplicaState, map_opt_state
    from repro_torch.train import train_step
    saved = trainer.state
    clone = lambda t_: tr.tree_map(lambda a: a.clone(), t_)
    vag, guard = train_step.value_and_grad, train_step.pod_all_finite
    pod, coord = world.pod_of("data"), world.shard_coord("data")

    def poisoned(model, params, batch):
        grads, metrics = vag(model, params, batch)
        tr.tree_leaves(grads)[0].view(-1)[0] = float("nan")
        return grads, metrics

    trainer.state = ReplicaState(clone(saved.params), map_opt_state(
        saved.opt_state, clone, lambda c: c.clone()), saved.step,
        saved.phase)
    if pod in FSDP_RANKS_BAD_PODS and coord == FSDP_DATA - 1:
        train_step.value_and_grad = poisoned
    if pod == FSDP_RANKS_BAD_PODS[1]:
        train_step.pod_all_finite = lambda plan, finite: finite
    try:
        trainer.step_once(t)
    finally:
        train_step.value_and_grad, train_step.pod_all_finite = vag, guard
    counts = [None] * world.P if world.rank == 0 else None
    dist.gather_object(int(trainer.state.opt_state.count[0]), counts, dst=0)
    trainer.state = saved
    return counts


def instrument_streamed_ranks(trainer, plan, step_no: list):
    """Time a streamed FSDP rank ``Trainer``'s step parts into ``split``
    (host clock): the engine's fwd+bwd (between two synchronisations);
    the all-gathers' and the reduce-scatters' issue (the post, its copy to
    the host included) and exposed wait (the resolve: the wait, the copy
    back's issue and, for a reduce-scatter, the ordered sum); update,
    average and sync; with the wire's counts of each into ``wire``.  At
    step ``FSDP_RANKS_GRAD_STEP`` (``step_no[0]``) keep this member's
    reduce-scattered slices in ``grab`` (check (c)).  Returns (split,
    wire, grab, restore): ``restore()`` takes the wrappers off the shared
    wire and the engine."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import streaming
    from repro_torch.optim.sgd import Optimizer
    avg, shard_wire = trainer.averager, plan.shard_wire
    split = dict.fromkeys(("engine", "gather_issue", "gather_wait",
                           "scatter_issue", "scatter_wait", "update",
                           "average", "sync"), 0.0)
    timed_ = split_timer(split, trainer.device)
    wire, grab, kinds = {}, {}, {}

    def counted(key, before):
        d = wire.setdefault(key, {})
        for k, v in plan_mod.wire_stats().items():
            if k != "in_flight_max":
                d[k] = d.get(k, 0) + v - before[k]

    def with_wire(key, fn):
        def run(*args):
            before = plan_mod.wire_stats()
            out = fn(*args)
            counted(key, before)
            return out
        return run

    def posting(kind, fn):
        def run(buf, axis):
            before, t = plan_mod.wire_stats(), time.perf_counter()
            receipt = fn(buf, axis)
            split[kind + "_issue"] += time.perf_counter() - t
            counted(kind, before)
            kinds[id(receipt)] = kind
            return receipt
        return run

    resolve = shard_wire._resolve

    def resolving(receipt):
        kind = kinds.pop(id(receipt), None)
        before, t = plan_mod.wire_stats(), time.perf_counter()
        out = resolve(receipt)
        if kind is not None:
            split[kind + "_wait"] += time.perf_counter() - t
            counted(kind, before)
        return out

    engine = streaming.streamed_loss_and_grad_shards

    def engine_noting(*args, **kw):
        out = engine(*args, **kw)
        if step_no[0] == FSDP_RANKS_GRAD_STEP:
            grab["slices"] = tuple(b.clone() for b in out[2])
        return out

    shard_wire.shard_all_gather = posting("gather",
                                          shard_wire.shard_all_gather)
    shard_wire.shard_reduce_scatter = posting(
        "scatter", shard_wire.shard_reduce_scatter)
    shard_wire._resolve = resolving
    streaming.streamed_loss_and_grad_shards = timed_("engine", engine_noting)
    trainer.opt = Optimizer(trainer.opt.init,
                            timed_("update", trainer.opt.update))
    avg.comm = timed_("average", with_wire("average", avg.comm))
    avg.sync = timed_("sync", with_wire("sync", avg.sync))

    def restore():
        for name in ("shard_all_gather", "shard_reduce_scatter", "_resolve"):
            vars(shard_wire).pop(name, None)
        streaming.streamed_loss_and_grad_shards = engine
    return split, wire, grab, restore


def mispaired_gathered(gathered, g):
    """The gather the streamed engine must not hand group ``g``'s compute
    (the planted fault of check (d)): group g+1's, where it is in flight
    and has the same shapes (span k+1's, at span k's forward)."""
    from repro_torch.core import overlap
    from repro_torch.core import tree as tr
    own = overlap.resolve(gathered.pop(g))
    if g + 1 not in gathered:
        return own
    other = overlap.resolve(gathered[g + 1])
    shapes = lambda t: [tuple(l.shape) for l in tr.tree_leaves(t)]
    return other if shapes(other) == shapes(own) else own


def streamed_pair(trainer, world, t: int) -> dict:
    """Check (d): one fwd+bwd of this member's batch of step ``t`` on the
    trainer's state (nothing updated) asynchronously, with every receipt
    resolved as soon as it is posted (serial), and with span k's compute
    handed span k+1's gather (planted, :func:`mispaired_gathered`):
    serial must equal asynchronous (the loss and ``torch.equal`` slices),
    the planted run must part from it.  Returns this rank's verdicts and
    host ms (synchronised)."""
    import torch
    from repro_torch.core import streaming
    plan, device = trainer.plan(), trainer.device
    batch = trainer._put_batch(t)
    pod = world.pod_of("data")
    out, ms = {}, {}
    take = streaming.take_gathered
    for name, overlap in (("async", True), ("serial", False),
                          ("mispaired", True)):
        if name == "mispaired":
            streaming.take_gathered = mispaired_gathered
        try:
            _sync(device)
            t0 = time.perf_counter()
            losses, _, grads = streaming.streamed_loss_and_grad_shards(
                plan, trainer.model.layered, trainer.state.params, [batch],
                pod=pod, overlap=overlap)
            _sync(device)
            ms[name] = (time.perf_counter() - t0) * 1e3
        finally:
            streaming.take_gathered = take
        out[name] = (float(losses[0]), grads)
    same = lambda a, b: a[0] == b[0] and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))
    return {"serial_equal": same(out["serial"], out["async"]),
            "mispaired_parts": not same(out["mispaired"], out["async"]),
            "async_ms": ms["async"], "serial_ms": ms["serial"],
            "mispaired_ms": ms["mispaired"]}


def canonical_digests(state, plan, layered=None) -> dict:
    """sha256 of every leaf of a gathered ``(P_eff, n_b)`` FSDP state's
    pod trees, params and momentum, unpacked through ``plan``'s shard
    layout (and merged to the canonical tree by ``layered`` for a
    streamed state), beside its counts, step and phase: the same dict for
    two layouts of one state."""
    from repro_torch.core import bucketing
    from repro_torch.core import tree as tr
    out = {}
    for name, bufs in (("params", state.params),
                       ("momentum", state.opt_state.momentum)):
        tree = bucketing.unpack(tuple(bufs), plan.shard_layout, cast=False)
        if layered is not None:
            tree = layered.merge(tree, lead=1)
        leaves = tr.tree_leaves(tree)
        out.update({f"{name}/{i}": d for i, d in enumerate(digests(leaves))})
    out["count"] = state.opt_state.count.tolist()
    out["step_phase"] = [int(state.step), int(state.phase)]
    return out


def streamed_ranks_check_c(world, plan, ga_plan, layered, mine, ga_mine):
    """Check (c)'s slices (rank 0 decides): pod 0's streamed
    reduce-scattered float32 slices at ``FSDP_RANKS_GRAD_STEP`` (``mine``
    on each member), joined in shard-axis order and unpacked through the
    grouped layout, merged to the canonical tree, equal the gather-all
    ranks' slices of the same step (``ga_mine``) unpacked through the
    flat layout, leaf for leaf bit for bit.  Returns rank 0's verdict
    (``None`` elsewhere)."""
    import torch
    from repro_torch.core import bucketing
    from repro_torch.core import tree as tr
    from repro_torch.launch import mesh
    axis = plan.sharding.shard_axis
    if world.pod_of(axis) != 0:
        return None
    members = world.shard_members(axis)
    size = len(members)

    def joined(slices):
        live = [b for b in slices if b.numel()]
        rows = mesh._gather_leaves(world, tuple(b[None] for b in live),
                                   size, world.shard_group, dst=members[0])
        if rows is None:
            return None
        rows = iter(rows)
        return tuple(torch.cat(list(next(rows))) if b.numel() else b.cpu()
                     for b in slices)
    got, want = joined(mine), joined(ga_mine)
    if world.rank != 0:
        return None
    got = layered.merge(bucketing.unpack(got, plan.shard_layout, cast=False))
    want = bucketing.unpack(want, ga_plan.shard_layout, cast=False)
    pairs = list(zip(tr.tree_leaves(got), tr.tree_leaves(want)))
    equal = len(pairs) == len(tr.tree_leaves(want)) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
    if not equal:
        raise AssertionError("check (c): pod 0's streamed reduce-scattered "
                             "slices differ from the gather-all ranks' at "
                             f"step {FSDP_RANKS_GRAD_STEP}")
    return {"slices_equal": equal, "leaves": len(pairs)}


def streamed_ranks_run(spec: dict, world, ga_plan, ga_losses: list,
                       ga_slices) -> dict:
    """The streamed ranks part of the fsdp ranks phase on this rank: a
    second ``Trainer(sharding="fsdp", streamed=True)`` with the gather-all
    run's config, seed, batches and steps, its checks (b) every step's
    event log held to the schedule (``check_stream_event_log``: 2 span
    gathers live at most, 2 groups' reduce-scatters in flight at most,
    the bucket gathers ``expected_stream_gathers``, the live gathered
    bytes at most ``stream_peak_gathered_bytes``), (c) every loss the
    gather-all run's, step 2's slices (:func:`streamed_ranks_check_c`),
    (d) :func:`streamed_pair` once after the steps; its final state's
    canonical digests on rank 0 (check (c) against the gather-all
    state's, in the worker).  Returns this rank's record: the per-step
    log (split, wire counts, launches, the event logs' counts), peak
    memory, the profiled window and (rank 0) the checks."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import streaming
    from repro_torch.kernels import ops
    t_start = time.perf_counter()
    device = world.device
    on_card = device.type == "cuda"
    trainer = fsdp_ranks_trainer(spec, world, streamed=True)
    init_s = time.perf_counter() - t_start
    avg, plan = trainer.averager, trainer.plan()
    layered = trainer.model.layered
    step_no = [-1]
    split, wire, grab, restore = instrument_streamed_ranks(trainer, plan,
                                                           step_no)
    plan.stream_log = []
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        log, window = [], None
        for t in range(spec["steps"]):
            for k in split:
                split[k] = 0.0
            wire.clear()
            step_no[0] = t
            before = ops.launch_counts()
            if t == FSDP_RANKS_PROFILED:
                dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            if t == FSDP_RANKS_PROFILED:
                loss, window = profiled_call(lambda: trainer.step_once(t),
                                             device)
            else:
                loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t0
            after = ops.launch_counts()
            events = [streaming.check_stream_event_log(r, plan)   # (b)
                      for r in plan.stream_log]
            plan.stream_log.clear()
            if loss != ga_losses[t]:                              # (c)
                raise AssertionError(f"check (c): step {t} loss {loss} "
                                     f"!= the gather-all ranks' "
                                     f"{ga_losses[t]}")
            sync = avg.sync_due(t)
            exposed = sum(split[k] for k in ("gather_issue", "gather_wait",
                                             "scatter_issue",
                                             "scatter_wait"))
            log.append({
                "t": t, "loss": loss, "sync": sync,
                "offset": None if sync else plan.offsets[
                    avg.phase_for_step(t)],
                "step_ms": step_s * 1e3,
                "profiled": t == FSDP_RANKS_PROFILED,
                **{k + "_ms": v * 1e3 for k, v in split.items()},
                "fwd_bwd_ms": (split["engine"] - exposed) * 1e3,
                "wire": {part: {k: (v * 1e3 if k.endswith("_s") else v)
                                for k, v in d.items()}
                         for part, d in wire.items()},
                "events": events,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
        step_no[0] = -1
        peak = torch.cuda.max_memory_allocated() if on_card else None
        check_c = streamed_ranks_check_c(world, plan, ga_plan, layered,
                                         grab.pop("slices"), ga_slices)
        pair = streamed_pair(trainer, world, spec["steps"])       # (d)
        pairs = [None] * world.P if world.rank == 0 else None
        dist.gather_object(pair, pairs, dst=0)
        if world.rank == 0 and not all(p["serial_equal"]
                                       and p["mispaired_parts"]
                                       for p in pairs):
            raise AssertionError(f"check (d): serial = asynchronous and the "
                                 f"mispaired gathers parting, by rank: "
                                 f"{pairs}")
        t0 = time.perf_counter()
        state = trainer.gathered_state()
        canon = (canonical_digests(state, plan, layered)
                 if state is not None else None)
        gather_s = time.perf_counter() - t0
        del state
    finally:
        restore()
        plan.stream_log = None
    lay = plan.shard_layout
    record = {"rank": world.rank, "pod": world.pod_of("data"), "log": log,
              "peak": peak, "window": window, "init_s": init_s,
              "pair": pair,
              "combines": plan_combines(plan, 1, per_rank=True),
              "seconds": time.perf_counter() - t_start}
    if world.rank == 0:
        record.update({
            "n_buckets": lay.n_buckets,
            "n_stages": len(plan.runs_for_offset(0)[0].bits),
            "bucket_bytes": plan.shard_bucket_bytes,
            "group_bytes": plan.stream_group_bytes(),
            "expected_gathers": streaming.expected_stream_gathers(plan),
            "peak_gathered_bound": plan.stream_peak_gathered_bytes(),
            "full_gathered_bytes": plan.full_gathered_bytes(),
            "check_c": check_c, "pairs": pairs, "canonical": canon,
            "gather_s": gather_s})
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    return record


def fsdp_ranks_worker(spec: dict, out: str) -> int:
    """One rank (one pod member) of the fsdp ranks phase, started by
    torchrun: the port's FSDP ``Trainer`` on this rank's slices for
    ``spec["steps"]`` steps with checks (a)-(c) and (e), step
    ``FSDP_RANKS_PROFILED`` profiled, check (e)'s planted NaN, then
    (``out/steps_done`` tells the parent its twin may start) check (d)'s
    gathered state, the one ``Trainer.save_checkpoint`` writes, hashed on
    rank 0 as the checkpoint converts it (its write under torchrun is the
    CPU tests'); rank 0 writes ``out/fsdp_ranks.json``."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.core import grouping
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = mesh.init_rank_world(FSDP_DATA, FSDP_POD,
                                 backend=os.environ["REPRO_TORCH_BACKEND"],
                                 device_type=spec["device"],
                                 shard_axis="data")
    device = world.device
    on_card = device.type == "cuda"
    try:
        trainer = fsdp_ranks_trainer(spec, world)
        init_s = time.perf_counter() - t_start
        avg = trainer.averager
        plan = trainer.plan()
        stacked_plan = plan_mod.compile_plan(plan.topology,
                                             plan.storage_struct, plan.cfg,
                                             plan.sharding)
        n_buckets = plan.shard_layout.n_buckets
        n_stages = len(plan.runs_for_offset(0)[0].bits)
        step_no = [-1]
        split, wire, pending, checked, check_s, grab = \
            instrument_fsdp_ranks(trainer, world, plan, step_no)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        log, kept, check_c, window = [], None, None, None
        steps = spec["steps"]
        for t in range(steps):
            for k in split:
                split[k] = 0.0
            wire.clear()
            check_s[0] = 0.0
            step_no[0] = t
            before = ops.launch_counts()
            if t == FSDP_RANKS_PROFILED:    # every rank's window: one step
                dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            if t == FSDP_RANKS_PROFILED:
                loss, window = profiled_call(lambda: trainer.step_once(t),
                                             device)
            else:
                loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t0 - check_s[0]
            after = ops.launch_counts()
            sync = avg.sync_due(t)
            offset = None if sync else plan.offsets[avg.phase_for_step(t)]
            # check (b): at each shard coordinate the slices of a group's
            # pods equal, the groups apart; after a sync all four
            t0 = time.perf_counter()
            rows = [None] * world.P if world.rank == 0 else None
            dist.gather_object(row_digests(trainer.state.params)[0], rows,
                               dst=0)
            if world.rank == 0:
                groups = ((tuple(range(plan.P_eff)),) if sync else
                          grouping.groups_for_offset(plan.P_eff, FSDP_S,
                                                     offset))
                for c in range(FSDP_DATA):
                    at = lambda p: rows[p * FSDP_DATA + c]
                    same = all(at(m) == at(g[0]) for g in groups for m in g)
                    differ = len({at(g[0]) for g in groups}) == len(groups)
                    if not same or (not sync and not differ):
                        raise AssertionError(
                            f"step {t} coordinate {c}: a group's pods equal "
                            f"{same}, groups apart {differ}, {groups}")
            if offset in pending:
                # the one-process average of the gathered pre-average
                # buffers, sliced as each rank holds them, against every
                # rank's post-average slices (their sha256, gathered above)
                pre = pending.pop(offset)
                checked[offset] = None          # rank 0 holds the verdict
                if world.rank == 0:
                    want = stacked_plan._average_sharded(pre, offset)
                    checked[offset] = rows == [
                        slice_digest(want, r // FSDP_DATA, r % FSDP_DATA)
                        for r in range(world.P)]
                    if not checked[offset]:
                        raise AssertionError(
                            f"step {t}: the ranks' average at offset "
                            f"{offset} differs from the one-process plan's")
                    if t == FSDP_RANKS_GRAD_STEP - 1:
                        kept = want             # the state step 2 starts from
                    del want
                del pre
            if t == FSDP_RANKS_GRAD_STEP:
                ga_slices = tuple(b.clone() for b in grab["slices"])
                check_c = fsdp_ranks_check_c(world, plan, stacked_plan,
                                             grab, kept)
                kept = None
            log.append({
                "t": t, "loss": loss, "sync": sync, "offset": offset,
                "step_ms": step_s * 1e3,
                "profiled": t == FSDP_RANKS_PROFILED,
                **{k + "_ms": v * 1e3 for k, v in split.items()},
                "wire": {part: {k: (v * 1e3 if k.endswith("_s") else v)
                                for k, v in d.items()}
                         for part, d in wire.items()},
                "check_ms": (check_s[0] + time.perf_counter() - t0) * 1e3,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
        step_no[0] = -1
        peak = torch.cuda.max_memory_allocated() if on_card else None
        # the streamed ranks part, on the wire the gather-all steps used
        # (their all-gather's wrapper taken off it first)
        vars(plan.shard_wire).pop("shard_all_gather", None)
        streamed = streamed_ranks_run(spec, world, plan,
                                      [e["loss"] for e in log], ga_slices)
        del ga_slices
        t0 = time.perf_counter()
        guard = fsdp_ranks_guard(trainer, world, steps)
        guard_s = time.perf_counter() - t0
        if on_card:                 # room on the card for the parent's twin
            torch.cuda.empty_cache()
        dist.barrier()
        if world.rank == 0:             # the parent's twin may start now
            (Path(out) / "steps_done").write_text(json.dumps(
                [e["loss"] for e in log]))
        t0 = time.perf_counter()
        state = trainer.gathered_state()
        ckpt_s = time.perf_counter() - t0
        saved = saved_digests(state) if state is not None else None
        step_phase = ([int(state.step), int(state.phase)]
                      if state is not None else None)
        if state is not None:       # check (c): the streamed final state
            canon = canonical_digests(state, plan)
            streamed["state_equal"] = streamed.pop("canonical") == canon
            streamed["state_leaves"] = len(canon) - 2
            if not streamed["state_equal"]:
                raise AssertionError(
                    "check (c): the streamed ranks' final state, merged to "
                    "the canonical tree, differs from the gather-all "
                    "ranks'")
        del state
        mine = {"rank": world.rank, "pod": world.pod_of("data"),
                "device": str(device), "log": log, "peak": peak,
                "window": window, "init_s": init_s,
                "combines": plan_combines(plan, 1, per_rank=True),
                "streamed": streamed}
        everyone = [None] * world.P if world.rank == 0 else None
        dist.gather_object(mine, everyone, dst=0)
        if world.rank == 0:
            result = {
                "world": {"P": world.P, "axes": dict(zip(
                    world.axis_names, world.axis_sizes)),
                    "backend": world.backend},
                "pods": plan.P_eff, "pod_size": plan.shard_size,
                "n_buckets": n_buckets, "n_stages": n_stages,
                "bucket_bytes": plan.shard_bucket_bytes,
                "expected_k1_k2_per_group_step": expected_combine_launches(
                    n_buckets, n_stages),
                "stacked_equals_wire": checked, "check_c": check_c,
                "guard": guard, "guard_s": guard_s, "ckpt_s": ckpt_s,
                "saved_digests": saved, "step_phase": step_phase,
                "ranks": everyone,
                "worker_s": time.perf_counter() - t_start}
            (Path(out) / "fsdp_ranks.json").write_text(json.dumps(result))
        return 0
    finally:
        mesh.shutdown()


def check_fsdp_ranks_launches(stats, held: Optional[dict] = None):
    """Check (a) of the fsdp ranks phase, on every rank: each group step
    launched the K1 and K2 counts of one stage of the sharded plan's
    shard buckets, the sync none, no step K3 or K4; and (where ``held``,
    the K1/K2 phase's ``fsdp ranks`` entry, is given) each rank's combine
    operands are those the K1/K2 phase held."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    for r in stats["ranks"]:
        for e in r["log"]:
            want = (0, 0) if e["sync"] else (want_k1, want_k2)
            got = (e["k1"], e["k2"], e["k3"], e["k4"])
            if got != want + (0, 0):
                raise AssertionError(f"rank {r['rank']} step {e['t']}: K1, "
                                     f"K2, K3, K4 launched {got}; the "
                                     f"schedule predicts {want + (0, 0)}")
        if held is not None and json.loads(json.dumps(
                held["combines"])) != r["combines"]:
            raise AssertionError(
                f"rank {r['rank']}: combine operands {r['combines']}; the "
                f"K1/K2 phase held {held['combines']}")


def check_fsdp_ranks_guard(counts: list) -> dict:
    """Check (e)'s planted NaN on the counts rank 0 gathered (one a
    member, in rank order): the pod that keeps the MIN over the pod keeps
    its count on both members and every pod without a NaN counts one
    more; the pod whose guard leaves the MIN out (the planted fault) must
    part its members.  Returns the verdicts."""
    pods = [counts[e * FSDP_DATA:(e + 1) * FSDP_DATA]
            for e in range(len(counts) // FSDP_DATA)]
    kept, planted = FSDP_RANKS_BAD_PODS
    base = pods[kept][0]
    whole = (set(pods[kept]) == {base} and all(
        set(c) == {base + 1} for e, c in enumerate(pods)
        if e not in FSDP_RANKS_BAD_PODS))
    parted = len(set(pods[planted])) > 1
    if not (whole and parted):
        raise AssertionError(f"check (e): the pod MIN skips the whole pod "
                             f"{whole}, without it the members part "
                             f"{parted}: {counts}")
    return {"pod_skipped_whole": whole, "without_min_members_part": parted}


def fsdp_ranks_summary(stats: dict) -> dict:
    """The phase's numbers: rank 0's median group step (the profiled one
    left out) and its split (the all-gather, the members' fwd+bwd and the
    reduce-scatter, each with its wire bytes; update; the butterfly's
    exchange and combine; the sync), each rank's peak memory, and the
    device's idle share over the profiled step, the union of every
    rank's device activity on the host's clock."""
    steady = [e for e in stats["ranks"][0]["log"][1:] if not e["profiled"]]
    group = [e for e in steady if not e["sync"]]
    med = lambda es, f: statistics.median(f(e) for e in es) if es else None
    part = lambda e, p, k: e["wire"].get(p, {}).get(k, 0)
    exchange = {k: med(group, lambda e: part(e, "average", k + "_s"))
                for k in ("d2h", "wire", "h2d")}
    windows = [r["window"] for r in stats["ranks"]]
    return {
        "median_group_step_ms": med(group, lambda e: e["step_ms"]),
        "sync_step_ms": med([e for e in steady if e["sync"]],
                            lambda e: e["step_ms"]),
        # grad_shards takes the member's gradient from its generator, so
        # the scatter's timer holds the fwd+bwd
        "group_split_ms": {
            "grads": med(group, lambda e: e["gather_ms"] + e["scatter_ms"]),
            "all_gather": med(group, lambda e: e["gather_ms"]),
            "fwd_bwd": med(group, lambda e: e["fwd_bwd_ms"]),
            "reduce_scatter": med(group, lambda e: e["scatter_ms"]
                                  - e["fwd_bwd_ms"]),
            "update": med(group, lambda e: e["update_ms"]),
            "exchange": exchange,
            "combine": med(group, lambda e: e["average_ms"] - sum(
                part(e, "average", k) for k in ("d2h_s", "wire_s",
                                                "h2d_s"))),
            "other": med(group, lambda e: e["step_ms"] - e["gather_ms"]
                         - e["scatter_ms"] - e["update_ms"]
                         - e["average_ms"])},
        "bytes_a_group_step": {p: group[0]["wire"].get(p, {}).get("bytes")
                               for p in ("gather", "scatter", "average")}
        if group else None,
        "sync_ms": med([e for e in steady if e["sync"]],
                       lambda e: e["sync_ms"]),
        "sync_bytes": next((e["wire"].get("sync", {}).get("bytes")
                            for e in steady if e["sync"]), None),
        "peak_bytes_by_rank": [r["peak"] for r in stats["ranks"]],
        "device_busy_ms_by_rank": [w["device_busy_ms"] for w in windows],
        **device_idle(windows),
    }


def streamed_ranks_stats(stats: dict) -> dict:
    """The streamed ranks part's record, its own phase key, taken out of
    the fsdp ranks phase's ranks: rank 0's checks beside every rank's
    log; check (e) (finite losses, no skip) and the event logs' counts of
    check (b) over every rank and step, and the summary."""
    ranks = [r.pop("streamed") for r in stats["ranks"]]
    first = ranks[0]
    st = {k: first.pop(k) for k in (
        "n_buckets", "n_stages", "bucket_bytes", "group_bytes",
        "expected_gathers", "peak_gathered_bound", "full_gathered_bytes",
        "check_c", "pairs", "gather_s", "state_equal", "state_leaves")}
    st.update({"ranks": ranks, "pods": stats["pods"],
               "pod_size": stats["pod_size"], "spec": stats["spec"],
               "seconds": first["seconds"],
               "expected_k1_k2_per_group_step": expected_combine_launches(
                   st["n_buckets"], st["n_stages"])})
    bad = [e for r in ranks for e in r["log"]
           if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (e)
        raise AssertionError(f"streamed ranks: non-finite losses or skipped "
                             f"updates: {bad}")
    events = [c for r in ranks for e in r["log"] for c in e["events"]]
    st["check_b"] = {
        "logs": len(events),
        "gathers": sorted({c["gathers"] for c in events}),
        "span_gathers_live_max": max(c["span_gathers_live_max"]
                                     for c in events),
        "scatters_in_flight_max": max(c["scatters_in_flight_max"]
                                      for c in events),
        "peak_gathered_bytes": max(c["peak_gathered_bytes"] for c in events),
        "peak_bound": st["peak_gathered_bound"]}
    steps = sum(len(r["log"]) for r in ranks)
    if (len(events) != steps or st["check_b"]["gathers"]
            != [st["expected_gathers"]]):                       # check (b)
        raise AssertionError(f"check (b): {len(events)} event logs for "
                             f"{steps} rank steps: {st['check_b']}")
    st["check_e"] = {"finite": True, "skipped": 0}
    st["summary"] = streamed_ranks_summary(st)
    return st


def streamed_ranks_summary(st: dict) -> dict:
    """The streamed ranks part's numbers: rank 0's median group step (the
    profiled one left out) and its split (the all-gathers' issue and
    exposed wait, fwd+bwd, the reduce-scatters' issue and exposed wait,
    each with its wire bytes; update; the butterfly's exchange and
    combine; the sync), each rank's peak memory, check (d)'s host ms and
    the device's idle share over the profiled step."""
    steady = [e for e in st["ranks"][0]["log"][1:] if not e["profiled"]]
    group = [e for e in steady if not e["sync"]]
    med = lambda es, f: statistics.median(f(e) for e in es) if es else None
    part = lambda e, p, k: e["wire"].get(p, {}).get(k, 0)
    windows = [r["window"] for r in st["ranks"]]
    return {
        "median_group_step_ms": med(group, lambda e: e["step_ms"]),
        "sync_step_ms": med([e for e in steady if e["sync"]],
                            lambda e: e["step_ms"]),
        "group_split_ms": {
            "all_gather_issue": med(group, lambda e: e["gather_issue_ms"]),
            "all_gather_wait": med(group, lambda e: e["gather_wait_ms"]),
            "fwd_bwd": med(group, lambda e: e["fwd_bwd_ms"]),
            "reduce_scatter_issue": med(group,
                                        lambda e: e["scatter_issue_ms"]),
            "reduce_scatter_wait": med(group,
                                       lambda e: e["scatter_wait_ms"]),
            "engine": med(group, lambda e: e["engine_ms"]),
            "update": med(group, lambda e: e["update_ms"]),
            "exchange": {k: med(group, lambda e: part(e, "average",
                                                      k + "_s"))
                         for k in ("d2h", "wire", "h2d")},
            "combine": med(group, lambda e: e["average_ms"] - sum(
                part(e, "average", k) for k in ("d2h_s", "wire_s",
                                                "h2d_s"))),
            "other": med(group, lambda e: e["step_ms"] - e["engine_ms"]
                         - e["update_ms"] - e["average_ms"])},
        "bytes_a_group_step": {p: group[0]["wire"].get(p, {}).get("bytes")
                               for p in ("gather", "scatter", "average")}
        if group else None,
        "gathers_a_group_step": part(group[0], "gather", "issued")
        if group else None,
        "sync_ms": med([e for e in steady if e["sync"]],
                       lambda e: e["sync_ms"]),
        "pair_ms_by_rank": [{k: r["pair"][k] for k in ("async_ms",
                                                        "serial_ms")}
                            for r in st["ranks"]],
        "peak_bytes_by_rank": [r["peak"] for r in st["ranks"]],
        "device_busy_ms_by_rank": [w["device_busy_ms"] for w in windows],
        **device_idle(windows),
    }


def print_streamed_ranks(st: dict, ga: dict, card: str):
    """The streamed ranks part's lines, its numbers beside the gather-all
    run's (``ga``: the fsdp ranks phase's summary)."""
    s = st["summary"]
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    print(f"streamed ranks [{card}]: {ARCH} full width, "
          f"{st['spec']['n_layers']} layers, data {FSDP_DATA} x pod "
          f"{FSDP_POD} gloo ranks on one card, {st['n_buckets']} grouped "
          f"shard buckets {json.dumps(st['group_bytes'])} bytes by group, "
          f"{st['expected_gathers']} bucket gathers a fwd+bwd, peak "
          f"gathered {st['peak_gathered_bound']} of "
          f"{st['full_gathered_bytes']} bytes, K1/K2 a group step "
          f"{st['expected_k1_k2_per_group_step']}; part "
          f"{st['seconds']:.1f} s (final state gathered "
          f"{st['gather_s']:.1f} s)", flush=True)
    print(f"streamed ranks losses: "
          f"{[round(x['loss'], 4) for x in st['ranks'][0]['log']]}",
          flush=True)
    print(f"streamed ranks [{card}]: rank 0 median group step "
          f"{s['median_group_step_ms']:.1f} ms (gather-all "
          f"{ga['median_group_step_ms']:.1f} ms), split "
          f"{json.dumps(s['group_split_ms'])} ms (gather-all "
          f"{json.dumps(ga['group_split_ms'])} ms), wire bytes a rank "
          f"{json.dumps(s['bytes_a_group_step'])} (gather-all "
          f"{json.dumps(ga['bytes_a_group_step'])}), all-gathers a group "
          f"step {s['gathers_a_group_step']}; sync step "
          f"{s['sync_step_ms']} ms (sync {s['sync_ms']} ms, gather-all "
          f"{ga['sync_ms']}); peak memory by rank "
          f"{[gib(b) for b in s['peak_bytes_by_rank']]} GiB (gather-all "
          f"{[gib(b) for b in ga['peak_bytes_by_rank']]}); profiled step: "
          f"wall {s['profile_wall_ms']:.1f} ms, device busy "
          f"{s['device_busy_ms']} ms, idle share {s['device_idle_share']} "
          f"(gather-all {ga['device_idle_share']})", flush=True)
    print(f"streamed ranks checks: (b) {json.dumps(st['check_b'])}; (c) "
          f"every loss = the gather-all ranks', step "
          f"{FSDP_RANKS_GRAD_STEP} slices {json.dumps(st['check_c'])}, "
          f"final state = the gather-all ranks' {st['state_equal']} "
          f"({st['state_leaves']} leaves); (d) serial = asynchronous and "
          f"the mispaired gathers parting on every rank, host ms "
          f"{json.dumps(s['pair_ms_by_rank'])}; (e) "
          f"{json.dumps(st['check_e'])}", flush=True)


def print_fsdp_ranks(stats: dict, card: str):
    s, d = stats["summary"], stats["check_d"]
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    print(f"fsdp ranks [{card}]: {ARCH} full width, "
          f"{stats['spec']['n_layers']} layers, data {FSDP_DATA} x pod "
          f"{FSDP_POD} = {FSDP_RANKS_P} gloo ranks on one card, pods of "
          f"{stats['pod_size']}, S={FSDP_S} tau={FSDP_TAU}, "
          f"{stats['n_buckets']} shard buckets of "
          f"{stats['bucket_bytes'] >> 20} MiB, K1/K2 a group step "
          f"{stats['expected_k1_k2_per_group_step']}; phase "
          f"{stats['phase_s']:.1f} s (torchrun {stats['torchrun_s']:.1f} s, "
          f"checkpoint state gathered {stats['ckpt_s']:.1f} s, twin "
          f"{json.dumps(d['twin_s'])} s)", flush=True)
    print(f"fsdp ranks losses: "
          f"{[round(x['loss'], 4) for x in stats['ranks'][0]['log']]}",
          flush=True)
    print(f"fsdp ranks [{card}]: rank 0 median group step "
          f"{s['median_group_step_ms']:.1f} ms, split "
          f"{json.dumps(s['group_split_ms'])} ms, wire bytes a rank "
          f"{json.dumps(s['bytes_a_group_step'])}; sync step "
          f"{s['sync_step_ms']} ms (sync {s['sync_ms']} ms, "
          f"{s['sync_bytes']} bytes); peak memory by rank "
          f"{[gib(b) for b in s['peak_bytes_by_rank']]} GiB; profiled "
          f"step: wall {s['profile_wall_ms']:.1f} ms, device busy "
          f"{s['device_busy_ms']} ms, idle share {s['device_idle_share']}",
          flush=True)
    print(f"fsdp ranks checks: (b) ranks = one-process average by offset "
          f"{stats['stacked_equals_wire']}; (c) {json.dumps(stats['check_c'])}"
          f"; (d) losses max rel diff {d['max_loss_rel_diff']:.3g} (tol "
          f"{d['loss_rtol']}), every leaf's sha256 = the twin's save "
          f"{d['state_bit_identical']} ({d['leaves']} leaves), step and "
          f"phase {d['step_phase_equal']}, its manifest names them "
          f"{d['manifest_names_the_leaves']}, largest "
          f"change from the initial params {d['max_param_change']:.3g}; "
          f"(e) {json.dumps(stats['check_e'])}", flush=True)


def fsdp_ranks_phase(spec: dict, out: Path,
                     timeout: int = FSDP_RANKS_TIMEOUT) -> dict:
    """Start ``FSDP_RANKS_P`` ranks through torchrun (gloo, all on one
    card); once their steps are done run check (d)'s one-process FSDP
    ``Trainer`` (same config, seed and batches) and its own save beside
    their gather of the checkpoint state; then check (e) on their losses
    and the planted NaN, and check (d): the twin's losses within
    ``RANKS_LOSS_RTOL`` of the ranks', and its save against the ranks'
    checkpoint state: every leaf's sha256 (its final params, momentum and
    counts bit for bit), the step and phase, and the leaves its manifest
    names.  A rank that fails fails the phase.  ``out`` is the
    phase's own directory (emptied first)."""
    import shutil
    import torch

    t_phase = time.perf_counter()
    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    run = start_torchrun(FSDP_RANKS_P, FSDP_RANKS_WORKER_FLAG, spec, out)
    try:
        # check (d)'s one-process twin runs once the ranks' steps are done
        # (their checkpoint and teardown go on beside it): its losses, its
        # own save, every leaf's sha256 of the arrays it saves
        while not (out / "steps_done").exists():
            if run["proc"].poll() is not None or \
                    time.perf_counter() - run["t0"] > timeout:
                wait_torchrun(run, timeout)
                raise AssertionError("the ranks ended before their steps")
            time.sleep(0.5)
        t0 = time.perf_counter()
        twin = fsdp_ranks_trainer(spec)
        initial = [a.clone() for a in twin.state.params]
        losses = [twin.step_once(t) for t in range(spec["steps"])]
        change = max(float((b.float() - a.float()).abs().max())
                     for a, b in zip(initial, twin.state.params))
        t1 = time.perf_counter()
        twin_state = twin.save_checkpoint(str(out / "twin"))
        t2 = time.perf_counter()
        twin_sums = saved_digests(twin_state)
        twin_step_phase = [int(twin_state.step), int(twin_state.phase)]
        del twin, initial, twin_state
        if torch.device(spec["device"]).type == "cuda":
            torch.cuda.empty_cache()
        twin_s = {"run": t1 - t0, "save": t2 - t1,
                  "digests": time.perf_counter() - t2}
        stats_s = wait_torchrun(run, timeout)
    finally:
        if run["proc"].poll() is None:          # the parent failed first
            import os
            import signal
            os.killpg(run["proc"].pid, signal.SIGKILL)
            run["proc"].wait()
    stats = json.loads((out / "fsdp_ranks.json").read_text())
    stats["spec"], stats["torchrun_s"] = spec, stats_s
    log0 = stats["ranks"][0]["log"]
    bad = [e for r in stats["ranks"] for e in r["log"]
           if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (e)
        raise AssertionError(f"non-finite losses or skipped updates: {bad}")
    if any(e["loss"] != f["loss"] for r in stats["ranks"]
           for e, f in zip(r["log"], log0)):
        raise AssertionError("the ranks report different mean losses")
    stats["check_e"] = check_fsdp_ranks_guard(stats["guard"])
    stats["streamed"] = streamed_ranks_stats(stats)

    # check (d): the twin's save against the ranks' checkpoint state:
    # every leaf's sha256 (the params, momentum and counts bit for bit),
    # the step and phase, and the leaves the twin's manifest names
    manifest = json.loads((out / "twin" / "manifest.json").read_text())
    named = sorted([f"params/{k}" for k in manifest["keys"]]
                   + [f"opt_state/{k}" for k in manifest["opt_checksums"]])
    rank_losses = [e["loss"] for e in log0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rank_losses))
    stats["check_d"] = {
        "twin_losses": losses, "max_loss_rel_diff": loss_rel,
        "loss_rtol": RANKS_LOSS_RTOL,
        "state_bit_identical": stats["saved_digests"] == twin_sums,
        "step_phase_equal": stats.pop("step_phase") == twin_step_phase,
        "manifest_names_the_leaves": named == sorted(
            stats.pop("saved_digests")),
        "leaves": len(twin_sums), "max_param_change": change,
        "twin_s": twin_s}
    d = stats["check_d"]
    if (loss_rel > RANKS_LOSS_RTOL or not d["state_bit_identical"]
            or not d["step_phase_equal"]
            or not d["manifest_names_the_leaves"] or change == 0.0):
        raise AssertionError(f"check (d): the ranks and the one-process "
                             f"twin part (or the params never moved): {d}")
    shutil.rmtree(out / "twin")
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["summary"] = fsdp_ranks_summary(stats)
    return stats


def fsdp_model_spec(device="cuda", smoke: bool = False,
                    n_layers: Optional[int] = RANKS_LAYERS,
                    seq_len: int = TRAIN_SEQ,
                    global_batch: int = FSDP_MODEL_GB,
                    steps: int = FSDP_MODEL_STEPS,
                    bucket_bytes: Optional[int] = None) -> dict:
    """What the fsdp model phase's ranks and its one-process twin run
    (:func:`fsdp_ranks_spec`'s keys)."""
    return fsdp_ranks_spec(device, smoke, n_layers, seq_len, global_batch,
                           steps, bucket_bytes)


def whole_leaf_slots(trainer, plan) -> list:
    """(bucket, start, end) of every piece of this rank's columns of its
    shard buckets that holds a leaf the placement keeps whole over the
    model ranks (the norm scales): a model group's ranks hold them at the
    same offsets, since every model coordinate's slice tree has one
    layout."""
    from repro_torch.models import common as cm
    whole = trainer.whole_plan().storage_struct
    held = []                   # a flag a leaf, in leaf order
    cm._zip_map(lambda leaf, d: held.append(d is None), whole,
                cm.placement(trainer.cfg, whole, MODEL_M))
    s = trainer.world.shard_coord("data")
    out = []
    for kept, slot in zip(held, plan.shard_layout.slots):
        if not kept:
            continue
        n = plan.shard_layout.bucket_sizes[slot.bucket] // plan.shard_size
        lo, hi = max(slot.offset, s * n), min(slot.offset + slot.size,
                                              (s + 1) * n)
        if lo < hi:
            out.append((slot.bucket, lo - s * n, hi - s * n))
    return out


def whole_leaf_digest(params, slots) -> tuple:
    """sha256 of this rank's pieces of the leaves held whole (``slots``
    from :func:`whole_leaf_slots`) and their element count."""
    import torch
    pieces = [params[b][0, lo:hi] for b, lo, hi in slots]
    if not pieces:
        return tensor_digest(torch.zeros(0)), 0
    joined = torch.cat(pieces)
    return tensor_digest(joined), joined.numel()


def instrument_fsdp_model(trainer, world, plan, step_no: list):
    """Time a rank's FSDP ``Trainer`` under a model axis (gather-all or
    streamed): :func:`instrument_streamed_ranks`'s split (the all-gathers'
    and reduce-scatters' issue and exposed wait, the engine, update,
    average, sync) and, gather-all, the fwd+bwd (``value_and_grad``); at
    step ``FSDP_MODEL_GRAD_STEP`` keep this member's gradient and its
    reduce-scattered slices in ``grab`` (check (d)); once an offset keep
    the slices ``comm`` averages in ``pending`` (check (b)): this rank's,
    and on torch rank 0 every rank's joined into each model coordinate's
    ``(P_eff, n_b)`` buffers (their seconds in ``check_s[0]``).  Returns
    (split, wire, grab, pending, check_s, restore)."""
    from repro_torch.core.replica import join_rank_slices
    from repro_torch.core import tree as tr
    from repro_torch.launch import mesh
    from repro_torch.train import train_step
    split, wire, grab, restore_wire = instrument_streamed_ranks(
        trainer, plan, step_no)
    split["fwd_bwd"] = 0.0
    timed_ = split_timer(split, trainer.device)
    at_grad_step = lambda: step_no[0] == FSDP_MODEL_GRAD_STEP
    vag, grad_shards = train_step.value_and_grad, plan.grad_shards

    def vag_noting(model, params, batch):
        grads, metrics = vag(model, params, batch)
        if at_grad_step():
            grab["grads"] = tr.tree_map(lambda a: a.clone(), grads)
        return grads, metrics

    def grad_shards_noting(member_grads):
        out = grad_shards(member_grads)
        if at_grad_step():
            grab["slices"] = tuple(b.clone() for b in out)
        return out

    train_step.value_and_grad = timed_("fwd_bwd", vag_noting)
    plan.grad_shards = grad_shards_noting
    avg = trainer.averager
    comm, pending, check_s = avg.comm, {}, [0.0]

    def comm_checked(tree, phase):
        offset = plan.offsets[phase]
        if offset not in pending:
            t0 = time.perf_counter()
            rows = mesh.gather_world_rows(world, tree)
            joined = None if rows is None else [join_rank_slices(
                tuple(b[m::MODEL_M].to(world.device) for b in rows), plan)
                for m in range(MODEL_M)]
            pending[offset] = (tuple(b.clone() for b in tree), joined)
            check_s[0] += time.perf_counter() - t0
        return comm(tree, phase)

    avg.comm = comm_checked

    def restore():
        restore_wire()
        train_step.value_and_grad = vag
        vars(plan).pop("grad_shards", None)
    return split, wire, grab, pending, check_s, restore


def fsdp_model_check_b(world, plan, stacked_plan, pending, offset, rows,
                       t: int) -> Optional[dict]:
    """Check (b) once an offset, after its step (rank 0 decides): each
    model coordinate's one-process plan (``stacked_plan``: its slice
    tree's layout) averages the pre-average ``(P_eff, n_b)`` buffers
    gathered on rank 0, and every rank's post-average slices
    (``rows``: their digests by torch rank) must carry the digest of its
    pod's and shard coordinate's slice of its coordinate's result; then
    every rank averages its own pre-average slices again with its pod
    view pairing the other model coordinate's members (planted), which
    must part from it on some rank."""
    import torch.distributed as dist
    from repro_torch.core import plan as plan_mod
    mine, joined = pending[offset]
    want = None
    if joined is not None:
        want = {}
        for m, pre in enumerate(joined):
            out = stacked_plan._average_sharded(pre, offset)
            for d in range(world.P):
                want[d * MODEL_M + m] = slice_digest(
                    out, d // FSDP_DATA, d % FSDP_DATA)
            del out
        equal = rows == [want[r] for r in range(len(rows))]
        if not equal:
            raise AssertionError(f"check (b): step {t}: the ranks' average "
                                 f"at offset {offset} differs from each "
                                 f"model coordinate's one-process plan's")
    real = plan.wire
    view = real.world
    plan.wire = plan_mod.RankWire(dataclasses.replace(
        view, torch_ranks=tuple(r if e == view.rank else r ^ 1
                                for e, r in enumerate(view.torch_ranks))))
    try:
        bad = plan._average_sharded(mine, offset)
    finally:
        plan.wire = real
    got = [None] * FSDP_MODEL_RANKS if world.torch_rank == 0 else None
    dist.gather_object(row_digests(bad)[0], got, dst=0)
    if want is None:
        return None
    parts = got != [want[r] for r in range(len(got))]
    if not parts:
        raise AssertionError("check (b): a pod view pairing the other model "
                             "coordinate's members averaged as the plan")
    return {"offset": offset, "equal": equal, "other_coordinate_parts": parts}


def fsdp_model_check_d(world, plan, stacked_plan, grab) -> Optional[dict]:
    """Check (d) at ``FSDP_MODEL_GRAD_STEP``: at each model coordinate
    pod 0's reduce-scattered float32 slices, joined in shard-axis order,
    equal the one-process ``grad_shards`` (``stacked_plan``, the slice
    tree's layout) of its two members' slice gradients, gathered over the
    pod's group to its first member (dp rank 0 at that coordinate), bit
    for bit; joined in swapped order (planted) they must part.  Returns
    every coordinate's verdict on torch rank 0 (``None`` elsewhere)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import tree as tr
    from repro_torch.launch import mesh
    verdict = None
    if world.pod_of("data") == 0:
        members = world.shard_members("data")
        size = len(members)
        treedef = tr.tree_flatten(grab["grads"])[1]
        grads = mesh._gather_leaves(world, tr.tree_map(
            lambda a: a[None], grab["grads"]), size, world.shard_group,
            dst=members[0])
        slices = mesh._gather_leaves(world, tuple(
            b[None] for b in grab["slices"]), size, world.shard_group,
            dst=members[0])
        if world.rank == 0:
            device = world.device
            per_member = [tr.tree_unflatten(treedef, [g[m].to(device)
                                                      for g in grads])
                          for m in range(size)]
            want = stacked_plan.grad_shards(iter(per_member))
            del per_member, grads
            live = [i for i, b in enumerate(want) if b.numel()]
            join = lambda order: [torch.cat([slices[i][m] for m in order]
                                            ).to(device) for i in live]
            verdict = {
                "model_rank": world.model_rank, "buckets": len(live),
                "grads_equal": all(torch.equal(a, want[i]) for a, i in zip(
                    join(range(size)), live)),
                "swapped_join_parts": not all(
                    torch.equal(a, want[i]) for a, i in zip(
                        join(range(size)[::-1]), live))}
    grab.clear()
    got = [None] * FSDP_MODEL_RANKS if world.torch_rank == 0 else None
    dist.gather_object(verdict, got, dst=0)
    if got is None:
        return None
    verdicts = [v for v in got if v is not None]
    if len(verdicts) != MODEL_M or not all(
            v["grads_equal"] and v["swapped_join_parts"] for v in verdicts):
        raise AssertionError(f"check (d): pod 0's joined slices against "
                             f"grad_shards by model coordinate: {verdicts}")
    return {"by_model_rank": verdicts}


def fsdp_model_run(spec: dict, world, streamed: bool,
                   ga_losses: Optional[list] = None) -> tuple:
    """One run of the fsdp model phase on this rank: the FSDP ``Trainer``
    (gather-all, or streamed) on this rank's slices for ``spec["steps"]``
    steps with checks (b) every step (the pods' slices equal at every
    shard and model coordinate; once an offset :func:`fsdp_model_check_b`)
    and (c) (the leaves held whole bit-identical over every model group),
    gather-all (d) at ``FSDP_MODEL_GRAD_STEP``, streamed (f) (every event
    log held to the schedule, every loss the gather-all run's, serial =
    asynchronous); step ``FSDP_MODEL_PROFILED`` profiled.  Returns (this
    rank's record, the trainer)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import streaming
    from repro_torch.kernels import ops
    from repro_torch.models import common as cm
    t_start = time.perf_counter()
    device = world.device
    on_card = device.type == "cuda"
    rank0 = world.torch_rank == 0
    trainer = fsdp_ranks_trainer(spec, world, streamed=streamed,
                                 pod=FSDP_MODEL_POD)
    init_s = time.perf_counter() - t_start
    avg, plan = trainer.averager, trainer.plan()
    stacked_plan = plan_mod.compile_plan(plan.topology, plan.storage_struct,
                                         plan.cfg, plan.sharding)
    slots = whole_leaf_slots(trainer, plan)
    step_no = [-1]
    split, wire, grab, pending, check_s, restore = instrument_fsdp_model(
        trainer, world, plan, step_no)
    plan.stream_log = [] if streamed else None
    checks = {"b": [], "c": [], "d": None}
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        log, window = [], None
        for t in range(spec["steps"]):
            for k in split:
                split[k] = 0.0
            wire.clear()
            check_s[0] = 0.0
            step_no[0] = t
            before, tp0 = ops.launch_counts(), cm.tp_stats()
            if t == FSDP_MODEL_PROFILED:
                dist.barrier()
            _sync(device)
            t0 = time.perf_counter()
            if t == FSDP_MODEL_PROFILED:
                loss, window = profiled_call(lambda: trainer.step_once(t),
                                             device)
            else:
                loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t0 - check_s[0]
            after, tp1 = ops.launch_counts(), cm.tp_stats()
            sync = avg.sync_due(t)
            offset = None if sync else plan.offsets[avg.phase_for_step(t)]
            events = []
            if streamed:                                        # (f)
                events = [streaming.check_stream_event_log(r, plan)
                          for r in plan.stream_log]
                plan.stream_log.clear()
                if loss != ga_losses[t]:
                    raise AssertionError(f"check (f): step {t} loss {loss} "
                                         f"!= the gather-all ranks' "
                                         f"{ga_losses[t]}")
            t0 = time.perf_counter()
            # (b) every pod's slices equal at each shard and model
            # coordinate (one group spans both pods); (c) the leaves held
            # whole equal over each model group
            rows = [None] * FSDP_MODEL_RANKS if rank0 else None
            dist.gather_object(row_digests(trainer.state.params)[0], rows,
                               dst=0)
            whole = [None] * FSDP_MODEL_RANKS if rank0 else None
            dist.gather_object(whole_leaf_digest(trainer.state.params,
                                                 slots), whole, dst=0)
            if rank0:
                for c in range(FSDP_DATA):
                    for m in range(MODEL_M):
                        at = {(d * MODEL_M + m) for d in range(world.P)
                              if d % FSDP_DATA == c}
                        if len({rows[r] for r in at}) != 1:
                            raise AssertionError(
                                f"check (b): step {t}: the pods' slices at "
                                f"shard {c}, model {m} differ")
                groups = [whole[d * MODEL_M:(d + 1) * MODEL_M]
                          for d in range(world.P)]
                held = all(len(set(g)) == 1 for g in groups)
                if not held or not any(n for _, n in whole):
                    raise AssertionError(f"check (c): step {t}: the leaves "
                                         f"held whole by model group "
                                         f"{groups}")
                checks["c"].append(sum(n for _, n in whole))
            if offset in pending and pending[offset] is not None:
                checks["b"].append(fsdp_model_check_b(
                    world, plan, stacked_plan, pending, offset, rows, t))
                pending[offset] = None
            if not streamed and t == FSDP_MODEL_GRAD_STEP:
                checks["d"] = fsdp_model_check_d(world, plan, stacked_plan,
                                                 grab)
            exposed = sum(split[k] for k in ("gather_issue", "gather_wait",
                                             "scatter_issue",
                                             "scatter_wait"))
            log.append({
                "t": t, "loss": loss, "sync": sync, "offset": offset,
                "step_ms": step_s * 1e3,
                "profiled": t == FSDP_MODEL_PROFILED,
                **{k + "_ms": v * 1e3 for k, v in split.items()},
                "fwd_bwd_ms": (split["fwd_bwd"] if not streamed else
                               split["engine"] - exposed) * 1e3,
                "tp_ms": (tp1["s"] - tp0["s"]) * 1e3,
                "tp_bytes": tp1["bytes"] - tp0["bytes"],
                "tp_ops": tp1["ops"] - tp0["ops"],
                "wire": {part: {k: (v * 1e3 if k.endswith("_s") else v)
                                for k, v in d.items()}
                         for part, d in wire.items()},
                "events": events,
                "check_ms": (check_s[0] + time.perf_counter() - t0) * 1e3,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
        step_no[0] = -1
        peak = torch.cuda.max_memory_allocated() if on_card else None
        pair = None
        if streamed:                                            # (f)
            pair = streamed_pair(trainer, world, spec["steps"])
            pairs = [None] * FSDP_MODEL_RANKS if rank0 else None
            dist.gather_object(pair, pairs, dst=0)
            if rank0 and not all(p["serial_equal"] for p in pairs):
                raise AssertionError(f"check (f): serial = asynchronous by "
                                     f"rank: {pairs}")
            checks["pairs"] = pairs
    finally:
        restore()
        plan.stream_log = None
    lay = plan.shard_layout
    record = {"rank": world.torch_rank, "dp_rank": world.rank,
              "model_rank": world.model_rank, "pod": world.pod_of("data"),
              "log": log, "peak": peak, "window": window, "init_s": init_s,
              "pair": pair,
              "combines": plan_combines(plan, 1, per_rank=True),
              "seconds": time.perf_counter() - t_start}
    if rank0:
        record.update({
            "n_buckets": lay.n_buckets,
            "bucket_sizes": list(lay.bucket_sizes),
            "n_stages": len(plan.runs_for_offset(0)[0].bits),
            "bucket_bytes": plan.shard_bucket_bytes, "checks": checks,
            "whole_bucket_sizes": list(
                trainer.whole_plan().shard_layout.bucket_sizes)})
    return record, trainer


def fsdp_model_guard(trainer, world, t: int) -> Optional[dict]:
    """Check (g)'s planted NaN, in step ``t`` from the trainer's state,
    twice (the state put back between and after): dp rank
    ``FSDP_MODEL_BAD`` (pod 1) puts a NaN in the first element of its
    gradient at model rank 1 alone.  Under the guard (the MIN over the
    model group, then over the pod) all four of pod 1's ranks skip and
    pod 0 updates; under a guard of the pod's MIN alone (planted) only
    the poisoned model coordinate skips, so a model group's counts part.
    Returns rank 0's verdicts and the counts by torch rank."""
    import torch.distributed as dist
    from repro_torch.core import tree as tr
    from repro_torch.core.replica import ReplicaState, map_opt_state
    from repro_torch.train import train_step
    saved = trainer.state
    clone = lambda t_: tr.tree_map(lambda a: a.clone(), t_)
    vag, finite = train_step.value_and_grad, train_step.replica_all_finite

    def poisoned(model, params, batch):
        grads, metrics = vag(model, params, batch)
        tr.tree_leaves(grads)[0].view(-1)[0] = float("nan")
        return grads, metrics

    counts = {}
    for name, planted in (("guard", False), ("pod_min_only", True)):
        trainer.state = ReplicaState(clone(saved.params), map_opt_state(
            saved.opt_state, clone, lambda c: c.clone()), saved.step,
            saved.phase)
        if world.rank == FSDP_MODEL_BAD and world.model_rank == 1:
            train_step.value_and_grad = poisoned
        if planted:
            train_step.replica_all_finite = \
                lambda model, grads: train_step.tree_all_finite(grads)
        try:
            trainer.step_once(t)
        finally:
            train_step.value_and_grad = vag
            train_step.replica_all_finite = finite
        got = [None] * FSDP_MODEL_RANKS if world.torch_rank == 0 else None
        dist.gather_object(int(trainer.state.opt_state.count[0]), got, dst=0)
        counts[name] = got
    trainer.state = saved
    if world.torch_rank != 0:
        return None
    return check_fsdp_model_guard(counts)


def check_fsdp_model_guard(counts: dict) -> dict:
    """Check (g)'s verdict on the counts by torch rank: under the guard
    pod 1's four ranks keep their count and pod 0's count one more; under
    the pod's MIN alone (planted) some model group's counts part."""
    pod_of = lambda r: r // MODEL_M // FSDP_DATA
    g = counts["guard"]
    base = g[-1]
    whole = g == [base if pod_of(r) == 1 else base + 1
                  for r in range(len(g))]
    p = counts["pod_min_only"]
    parted = any(len(set(p[d * MODEL_M:(d + 1) * MODEL_M])) > 1
                 for d in range(len(p) // MODEL_M))
    if not (whole and parted):
        raise AssertionError(f"check (g): the MIN over the model group and "
                             f"the pod skips pod 1 whole {whole}, the pod's "
                             f"MIN alone parts a model group {parted}: "
                             f"{counts}")
    return {"pod_skipped_whole": whole, "pod_min_only_parts": parted,
            "counts": counts}


def state_layout(state) -> dict:
    """An FSDP state's bucket shapes, the leaves a checkpoint of it names
    and its step and phase."""
    from repro_torch.checkpoint import ckpt
    leaves = lambda name, tree: [f"{name}/{k}" for k, _ in
                                 ckpt._leaves_with_paths(tree)]
    return {"bucket_shapes": [list(b.shape) for b in state.params],
            "leaves": sorted(leaves("params", state.params)
                             + leaves("opt_state", state.opt_state)),
            "step_phase": [int(state.step), int(state.phase)]}


def fsdp_model_worker(spec: dict, out: str) -> int:
    """One rank (one pod member at one model coordinate) of the fsdp model
    phase, started by torchrun: :func:`fsdp_model_run` gather-all, then
    streamed on the same ranks, then check (g)'s planted NaN on the
    gather-all trainer's final state; (``out/steps_done`` tells the
    parent its twin may start) the gathered states in the model-1 layout
    (check (e)'s leaves and bucket sizes, check (f)'s canonical digests);
    rank 0 writes ``out/fsdp_model.json``."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = mesh.init_rank_world(FSDP_DATA, FSDP_MODEL_POD, model=MODEL_M,
                                 backend=os.environ["REPRO_TORCH_BACKEND"],
                                 device_type=spec["device"],
                                 shard_axis="data")
    on_card = world.device.type == "cuda"
    rank0 = world.torch_rank == 0
    try:
        ga, ga_trainer = fsdp_model_run(spec, world, streamed=False)
        st, st_trainer = fsdp_model_run(spec, world, streamed=True,
                                        ga_losses=[e["loss"]
                                                   for e in ga["log"]])
        t0 = time.perf_counter()
        guard = fsdp_model_guard(ga_trainer, world, spec["steps"])
        guard_s = time.perf_counter() - t0
        if on_card:
            torch.cuda.empty_cache()
        dist.barrier()
        if rank0:                       # the parent's twin may start now
            (Path(out) / "steps_done").write_text("")
        t0 = time.perf_counter()
        canon, layout = {}, None
        for name, tr_ in (("gather_all", ga_trainer),
                          ("streamed", st_trainer)):
            state = tr_.gathered_state()
            if state is not None:
                whole = tr_.whole_plan()
                canon[name] = canonical_digests(
                    state, whole, tr_.model.layered
                    if tr_.sharding.streamed else None)
                if name == "gather_all":
                    layout = state_layout(state)
            del state
        ckpt_s = time.perf_counter() - t0
        del ga_trainer, st_trainer
        mine = {"ga": ga, "streamed": st, "device": str(world.device)}
        everyone = [None] * FSDP_MODEL_RANKS if rank0 else None
        dist.gather_object(mine, everyone, dst=0)
        if rank0:
            if canon["streamed"] != canon["gather_all"]:
                raise AssertionError("check (f): the streamed final state, "
                                     "merged to the canonical tree, "
                                     "differs from the gather-all one")
            result = {
                "world": {"ranks": FSDP_MODEL_RANKS, "axes": dict(zip(
                    world.axis_names, world.axis_sizes)),
                    "model": MODEL_M, "backend": world.backend},
                "pods": FSDP_MODEL_POD, "pod_size": FSDP_DATA,
                "guard": guard, "guard_s": guard_s, "ckpt_s": ckpt_s,
                "layout": layout, "state_leaves": len(canon["gather_all"])
                - 2, "streamed_state_equal": True,
                "ranks": [e["ga"] for e in everyone],
                "streamed_ranks": [e["streamed"] for e in everyone],
                "worker_s": time.perf_counter() - t_start}
            (Path(out) / "fsdp_model.json").write_text(json.dumps(result))
        return 0
    finally:
        mesh.shutdown()


def fsdp_model_stats(result: dict, key: str) -> dict:
    """One run's record (``"ranks"`` gather-all, ``"streamed_ranks"``)
    in the shape :func:`check_fsdp_ranks_launches` reads: rank 0's layout
    and checks beside every rank's log; check (g)'s first half (finite,
    no skip)."""
    ranks = result[key]
    first = ranks[0]
    st = {k: first.pop(k) for k in ("n_buckets", "bucket_sizes",
                                    "n_stages", "bucket_bytes", "checks",
                                    "whole_bucket_sizes")}
    st.update({"ranks": ranks, "seconds": first["seconds"],
               "expected_k1_k2_per_group_step": expected_combine_launches(
                   st["n_buckets"], st["n_stages"])})
    bad = [e for r in ranks for e in r["log"]
           if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # (g)
        raise AssertionError(f"{key}: non-finite losses or skipped updates: "
                             f"{bad}")
    losses = [[e["loss"] for e in r["log"]] for r in ranks]
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"{key}: the ranks report different mean "
                             f"losses")
    if key == "streamed_ranks":                                 # (f)
        events = [c for r in ranks for e in r["log"] for c in e["events"]]
        if len(events) != sum(len(r["log"]) for r in ranks):
            raise AssertionError(f"check (f): {len(events)} event logs")
        st["event_logs"] = len(events)
        st["span_gathers_live_max"] = max(c["span_gathers_live_max"]
                                          for c in events)
        st["scatters_in_flight_max"] = max(c["scatters_in_flight_max"]
                                           for c in events)
    st["summary"] = fsdp_model_summary(st)
    return st


def fsdp_model_summary(st: dict) -> dict:
    """A run's numbers: rank 0's median group step (the profiled one left
    out) and its split (the all-gathers' and reduce-scatters' issue and
    exposed wait, fwd+bwd with its TP all-reduces apart, update, the
    butterfly's exchange and combine, the sync; the bytes of each), each
    rank's peak memory and the device's idle share over the profiled
    step (the union of the 8 ranks' device intervals)."""
    steady = [e for e in st["ranks"][0]["log"][1:] if not e["profiled"]]
    group = [e for e in steady if not e["sync"]]
    med = lambda es, f: statistics.median(f(e) for e in es) if es else None
    part = lambda e, p, k: e["wire"].get(p, {}).get(k, 0)
    windows = [r["window"] for r in st["ranks"]]
    return {
        "median_group_step_ms": med(group, lambda e: e["step_ms"]),
        "sync_step_ms": med([e for e in steady if e["sync"]],
                            lambda e: e["step_ms"]),
        "group_split_ms": {
            "all_gather_issue": med(group, lambda e: e["gather_issue_ms"]),
            "all_gather_wait": med(group, lambda e: e["gather_wait_ms"]),
            "fwd_bwd": med(group, lambda e: e["fwd_bwd_ms"]),
            "of_it_tp_all_reduces": med(group, lambda e: e["tp_ms"]),
            "reduce_scatter_issue": med(group,
                                        lambda e: e["scatter_issue_ms"]),
            "reduce_scatter_wait": med(group,
                                       lambda e: e["scatter_wait_ms"]),
            "update": med(group, lambda e: e["update_ms"]),
            "exchange": {k: med(group, lambda e: part(e, "average",
                                                      k + "_s"))
                         for k in ("d2h", "wire", "h2d")},
            "combine": med(group, lambda e: e["average_ms"] - sum(
                part(e, "average", k) for k in ("d2h_s", "wire_s",
                                                "h2d_s")))},
        "bytes_a_group_step": dict({p: group[0]["wire"].get(p, {}).get(
            "bytes") for p in ("gather", "scatter", "average")},
            tp=group[0]["tp_bytes"], tp_ops=group[0]["tp_ops"])
        if group else None,
        "sync_ms": med([e for e in steady if e["sync"]],
                       lambda e: e["sync_ms"]),
        "sync_bytes": next((e["wire"].get("sync", {}).get("bytes")
                            for e in steady if e["sync"]), None),
        "peak_bytes_by_rank": [r["peak"] for r in st["ranks"]],
        "device_busy_ms_by_rank": [w["device_busy_ms"] for w in windows],
        **device_idle(windows),
    }


def fsdp_model_phase(spec: dict, out: Path,
                     timeout: int = FSDP_MODEL_TIMEOUT) -> dict:
    """Start ``FSDP_MODEL_RANKS`` ranks through torchrun (gloo, all on one
    card); once their steps are done run check (e)'s one-process model-1
    ``Trainer(sharding="fsdp")`` (same config, seed and batches) beside
    their gather of the final states; then check (e): the twin's losses
    within ``MODEL_LOSS_RTOL`` of the ranks', the gathered state in the
    twin's layout (the same buckets, the same leaves its save names, the
    same step and phase).  A rank that fails fails the phase.  ``out``
    is the phase's own directory (emptied first).  Returns the gather-all
    run's stats with the streamed run's under ``"streamed"``."""
    import shutil
    import torch
    t_phase = time.perf_counter()
    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    run = start_torchrun(FSDP_MODEL_RANKS, FSDP_MODEL_WORKER_FLAG, spec, out)
    try:
        while not (out / "steps_done").exists():
            if run["proc"].poll() is not None or \
                    time.perf_counter() - run["t0"] > timeout:
                wait_torchrun(run, timeout)
                raise AssertionError("the ranks ended before their steps")
            time.sleep(0.5)
        t0 = time.perf_counter()
        twin = fsdp_ranks_trainer(spec, pod=FSDP_MODEL_POD)
        losses = [twin.step_once(t) for t in range(spec["steps"])]
        twin_layout = state_layout(twin.state)
        del twin
        if torch.device(spec["device"]).type == "cuda":
            torch.cuda.empty_cache()
        twin_s = time.perf_counter() - t0
        torchrun_s = wait_torchrun(run, timeout)
    finally:
        if run["proc"].poll() is None:          # the parent failed first
            import os
            import signal
            os.killpg(run["proc"].pid, signal.SIGKILL)
            run["proc"].wait()
    result = json.loads((out / "fsdp_model.json").read_text())
    stats = fsdp_model_stats(result, "ranks")
    streamed = fsdp_model_stats(result, "streamed_ranks")
    for k in ("pods", "pod_size", "world"):
        stats[k] = streamed[k] = result[k]
    stats["spec"] = streamed["spec"] = spec
    streamed["state_equal"] = result["streamed_state_equal"]
    streamed["state_leaves"] = result["state_leaves"]
    rank_losses = [e["loss"] for e in stats["ranks"][0]["log"]]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, rank_losses))
    stats["check_e"] = {
        "twin_losses": losses, "max_loss_rel_diff": loss_rel,
        "loss_rtol": MODEL_LOSS_RTOL,
        "layout_is_the_twins": result["layout"] == twin_layout,
        "leaves": len(twin_layout["leaves"]), "twin_s": twin_s}
    if loss_rel > MODEL_LOSS_RTOL or not stats["check_e"][
            "layout_is_the_twins"]:
        raise AssertionError(f"check (e): the ranks and the one-process "
                             f"model-1 twin part: {stats['check_e']}, "
                             f"{result['layout']} vs {twin_layout}")
    stats["check_g"] = result["guard"]
    stats["guard_s"], stats["ckpt_s"] = result["guard_s"], result["ckpt_s"]
    stats["torchrun_s"] = torchrun_s
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["streamed"] = streamed
    return stats


def print_fsdp_model(stats: dict, card: str):
    """The phase's lines: each run's numbers, then the checks."""
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    st = stats["streamed"]
    print(f"fsdp model [{card}]: {ARCH} full width, "
          f"{stats['spec']['n_layers']} layers, pod {FSDP_MODEL_POD} x data "
          f"{FSDP_DATA} x model {MODEL_M} = {FSDP_MODEL_RANKS} gloo ranks on "
          f"one card, pods of {stats['pod_size']}, S={FSDP_S} "
          f"tau={FSDP_TAU}; a rank's slice buckets {stats['bucket_sizes']} "
          f"(whole tree {stats['whole_bucket_sizes']}), K1/K2 a group step "
          f"{stats['expected_k1_k2_per_group_step']}; streamed "
          f"{st['bucket_sizes']}, K1/K2 "
          f"{st['expected_k1_k2_per_group_step']}; phase "
          f"{stats['phase_s']:.1f} s (torchrun {stats['torchrun_s']:.1f} s, "
          f"gather-all {stats['seconds']:.1f} s, streamed "
          f"{st['seconds']:.1f} s, guard {stats['guard_s']:.1f} s, final "
          f"states gathered {stats['ckpt_s']:.1f} s, twin "
          f"{stats['check_e']['twin_s']:.1f} s)", flush=True)
    print(f"fsdp model losses: "
          f"{[round(x['loss'], 4) for x in stats['ranks'][0]['log']]}",
          flush=True)
    for name, run in (("gather-all", stats), ("streamed", st)):
        s = run["summary"]
        print(f"fsdp model {name} [{card}]: rank 0 median group step "
              f"{s['median_group_step_ms']:.1f} ms, split "
              f"{json.dumps(s['group_split_ms'])} ms, bytes a rank "
              f"{json.dumps(s['bytes_a_group_step'])}; sync step "
              f"{s['sync_step_ms']} ms (sync {s['sync_ms']} ms, "
              f"{s['sync_bytes']} bytes); peak memory by rank "
              f"{[gib(b) for b in s['peak_bytes_by_rank']]} GiB; profiled "
              f"step: wall {s['profile_wall_ms']:.1f} ms, device busy "
              f"{s['device_busy_ms']} ms, idle share "
              f"{s['device_idle_share']}", flush=True)
    c, e = stats["checks"], stats["check_e"]
    print(f"fsdp model checks: (b) {json.dumps(c['b'])}, the pods equal at "
          f"every coordinate after every step; (c) held-whole elements a "
          f"step over the 8 ranks {c['c']}; (d) {json.dumps(c['d'])}; (e) "
          f"losses max rel diff {e['max_loss_rel_diff']:.3g} (tol "
          f"{e['loss_rtol']}), the gathered state in the twin's layout "
          f"{e['layout_is_the_twins']} ({e['leaves']} leaves); (f) "
          f"{st['event_logs']} event logs held (span gathers live "
          f"{st['span_gathers_live_max']}, scatters in flight "
          f"{st['scatters_in_flight_max']}), every loss = gather-all's, "
          f"final state = gather-all's {st['state_equal']} "
          f"({st['state_leaves']} leaves), serial = asynchronous, host ms "
          f"{[round(p['async_ms'], 1) for p in st['checks']['pairs']]} / "
          f"{[round(p['serial_ms'], 1) for p in st['checks']['pairs']]}; "
          f"(g) {json.dumps(stats['check_g'])}", flush=True)


def model_spec(device="cuda", smoke: bool = False,
               n_layers: Optional[int] = MODEL_LAYERS,
               serve_layers: Optional[int] = None,
               seq_len: int = TRAIN_SEQ, global_batch: int = MODEL_GB,
               steps: int = MODEL_STEPS, prompt: int = MODEL_PROMPT,
               new: int = MODEL_NEW, arch: str = ARCH,
               data: int = MODEL_DATA, rows: int = MODEL_ROWS,
               bucket_bytes: Optional[int] = None) -> dict:
    """What a model phase's ranks and the parent's stacked twin run
    (JSON, handed to every rank on its command line): ``arch`` over
    ``data`` x ``MODEL_M`` ranks at S ``MODEL_S``, then ``rows`` prompts a
    dp rank served; ``serve_layers`` None serves the config's own
    depth; ``bucket_bytes`` as :func:`ranks_spec`'s."""
    return {"device": device, "smoke": smoke, "n_layers": n_layers,
            "serve_layers": serve_layers, "seq_len": seq_len,
            "global_batch": global_batch, "steps": steps, "prompt": prompt,
            "new": new, "arch": arch, "data": data, "rows": rows,
            "bucket_bytes": bucket_bytes}


def rg_model_spec(device="cuda", smoke: bool = False,
                  n_layers: Optional[int] = RG_MODEL_LAYERS,
                  serve_layers: Optional[int] = None,
                  seq_len: int = TRAIN_SEQ, global_batch: int = RG_MODEL_GB,
                  steps: int = RG_MODEL_STEPS, prompt: int = RG_MODEL_PROMPT,
                  new: int = MODEL_NEW,
                  bucket_bytes: Optional[int] = None) -> dict:
    """The rg model phase's spec: recurrentgemma-2b over data
    ``RG_MODEL_DATA`` x model ``MODEL_M`` ranks."""
    return model_spec(device, smoke, n_layers, serve_layers, seq_len,
                      global_batch, steps, prompt, new, arch=RG_ARCH,
                      data=RG_MODEL_DATA, rows=RG_MODEL_ROWS,
                      bucket_bytes=bucket_bytes)


def model_cfg(spec: dict, n_layers: Optional[int]):
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    return cfg.variant(n_layers=n_layers) if n_layers else cfg


def model_trainer(spec: dict, world=None):
    """The phase's ``Trainer``: one replica's slices on a rank of
    ``world`` (data ``spec["data"]`` x model ``MODEL_M``), or all
    ``spec["data"]`` replicas whole as the rows of one state on
    ``spec["device"]`` (the twin of check (d))."""
    from repro_torch.launch.train import Trainer
    kw = {"world": world} if world is not None else {"device":
                                                     spec["device"]}
    return Trainer(model_cfg(spec, spec["n_layers"]), spec["data"],
                   group_size=MODEL_S, tau=TRAIN_TAU, learning_rate=TRAIN_LR,
                   seq_len=spec["seq_len"], global_batch=spec["global_batch"],
                   seed=0, topology=spec_topology(spec, spec["data"]), **kw)


def model_slice_plan(cfg, data: int = MODEL_DATA,
                     bucket_bytes: Optional[int] = None):
    """A rank's compiled plan on a model path: the plan over one replica's
    slices (``MODEL_M`` model ranks) at ``data`` dp ranks, S
    ``MODEL_S`` (``bucket_bytes`` as :func:`spec_topology`'s)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.models import common as cm
    from repro_torch.models.convert import PARAM_SPECS
    specs = PARAM_SPECS[cfg.family](cfg)
    local = cm.take_slices(specs, cm.placement(cfg, specs, MODEL_M),
                           cm.ModelWorld(MODEL_M, 0))
    return plan_mod.compile_plan(
        spec_topology({"bucket_bytes": bucket_bytes}, data)
        or plan_mod.Topology.flat(("data",), (data,)), local,
        plan_mod.AveragingConfig(group_size=MODEL_S, tau=TRAIN_TAU))


def model_combines(cfg, data: int = MODEL_DATA):
    """A model path's combine operands, one rank's ``(1, n_b)`` buckets
    of its slices."""
    return plan_combines(model_slice_plan(cfg, data), 1)


def model_config():
    """The model phase's training model: tinyllama-1.1b at
    ``MODEL_LAYERS``."""
    from repro_torch.configs import get_config
    return get_config(ARCH).variant(n_layers=MODEL_LAYERS)


def rg_model_config():
    from repro_torch.configs import get_config
    return get_config(RG_ARCH).variant(n_layers=RG_MODEL_LAYERS)


def model_prompts(cfg, spec: dict):
    """The serving prompts, ``spec["rows"]`` a dp rank, from a numpy
    seed."""
    return np.random.default_rng(MODEL_SERVE_SEED).integers(
        0, cfg.vocab, (spec["data"] * spec["rows"], spec["prompt"]))


def greedy_run(model, params, tokens, max_len: int, new: int, feed=None,
               extra=None, pos0: Optional[int] = None,
               times: Optional[list] = None):
    """``build_prefill`` then ``new`` steps of ``build_serve_step``: the
    (gathered) last logits of the prefill and of each step as float32 CPU
    tensors (B, new + 1, V), the greedy token of each (B, new + 1), and
    the launches of the prefill and of each step.  Step i is fed the
    greedy token of the logits before it, or ``feed[:, i]`` where given
    (another run's tokens, so that the two runs' logits stay
    comparable).  ``extra`` joins the prefill's batch (an encoder's
    ``frames`` or ``src``, a VLM's ``patches``); the first decode step is
    at ``pos0`` (the prompt's length by default; a VLM's counts its
    patches).  ``times``, where given, gets the host ms of the prefill and
    of each step, the device synchronised."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import common as cm
    from repro_torch.serve.decode import build_prefill, build_serve_step
    device = tokens.device
    pos0 = tokens.shape[1] if pos0 is None else pos0
    kinds = (K1, K2, K3, K4, K4_TMA, K4_WALK)
    times = [] if times is None else times
    _sync(device)
    before, t0 = ops.launch_counts(), time.perf_counter()
    logits, caches = build_prefill(model, max_len)(
        params, {"tokens": tokens, **(extra or {})})
    _sync(device)
    times.append((time.perf_counter() - t0) * 1e3)
    after = ops.launch_counts()
    launches = [{k: after[k] - before[k] for k in kinds}]
    masked = torch.where(torch.arange(logits.shape[-1], device=device)
                         < model.cfg.vocab, logits, cm.NEG_INF)
    tok = masked[:, -1].argmax(-1)[:, None]
    step = build_serve_step(model)
    all_logits, all_tokens = [logits[:, -1].float().cpu()], [tok[:, 0].cpu()]
    for i in range(new):
        if feed is not None:
            tok = feed[:, i:i + 1].to(device)
        before, t0 = ops.launch_counts(), time.perf_counter()
        tok, logits, caches = step(params, caches, tok, pos0 + i)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        launches.append({k: after[k] - before[k] for k in kinds})
        all_logits.append(logits[:, -1].float().cpu())
        all_tokens.append(tok[:, 0].cpu())
    return torch.stack(all_logits, 1), torch.stack(all_tokens, 1), launches


def plant_layer_fault(trainer):
    """Check (f)'s fault for the trainer's family: the dense family's
    global layer ``MODEL_FAULT_LAYER`` (or its last) without f's backward
    all-reduce in its MLP (:func:`one_layer_without_f`), the hybrid's
    first recurrent layer with ``w_r``'s gradient left partial
    (:func:`first_layer_w_r_unsummed`).  Returns (the layer, the undo)."""
    if trainer.cfg.family == "hybrid":
        return 0, first_layer_w_r_unsummed(trainer)
    layer = min(MODEL_FAULT_LAYER, trainer.cfg.n_layers - 1)
    return layer, one_layer_without_f(trainer, layer)


def first_layer_w_r_unsummed(trainer):
    """The hybrid family's check (f) fault: the gates of the first
    recurrent layer run with ``copy_to_model`` on ``w_r`` as the plain
    identity, so that ``w_r``'s gradient stays partial, on every rank
    alike; returns the undo."""
    from repro_torch.models import common as cm
    from repro_torch.models import rglru
    target = trainer.state.params["blocks"]["rec1"]["w_r"][0, 0].data_ptr()
    gates, copy = rglru._gates, cm.copy_to_model

    def faulty(p, u, mw=None):
        if p["w_r"].data_ptr() != target:
            return gates(p, u, mw)
        cm.copy_to_model = lambda x, mw: (x if x is p["w_r"]
                                          else copy(x, mw))
        try:
            return gates(p, u, mw)
        finally:
            cm.copy_to_model = copy
    rglru._gates = faulty

    def undo():
        rglru._gates = gates
    return undo


def one_layer_without_f(trainer, layer: int):
    """Check (f)'s fault: the MLP of global layer ``layer`` runs with
    ``copy_to_model`` as the plain identity (no all-reduce of its input's
    gradient), on every rank alike; returns the undo."""
    from repro_torch.models import common as cm
    from repro_torch.models import transformer as tfm
    target = trainer.state.params["blocks"]["global"]["mlp"]["w1"][0, layer
                                                                   ].data_ptr()
    mlp, copy = tfm.mlp, cm.copy_to_model

    def faulty(cfg, p, h, mw=None):
        if p["w1"].data_ptr() != target:
            return mlp(cfg, p, h, mw)
        cm.copy_to_model = lambda x, mw: x
        try:
            return mlp(cfg, p, h, mw)
        finally:
            cm.copy_to_model = copy
    tfm.mlp = faulty

    def undo():
        tfm.mlp = mlp
    return undo


def model_digests(world, params, dims) -> Optional[list]:
    """(row digest of the rank's params, digest of its leaves held whole)
    of every torch rank, on rank 0 (``None`` elsewhere)."""
    import hashlib
    from repro_torch.models import common as cm
    whole = hashlib.sha256("".join(digests(
        cm.held_whole(params, dims))).encode()).hexdigest()
    return gather_to_rank0(world, (row_digests(params)[0], whole))


def model_check_b(rows, t: int, sync: bool, offset) -> None:
    """Check (b) on rank 0: at each model coordinate, the dp ranks of a
    group hold equal slices and the groups differ; after a sync all of
    them."""
    from repro_torch.core import grouping
    data = len(rows) // MODEL_M
    for m in range(MODEL_M):
        dig = [rows[d * MODEL_M + m][0] for d in range(data)]
        groups = ((tuple(range(data)),) if sync else
                  grouping.groups_for_offset(data, MODEL_S, offset))
        same = all(dig[r] == dig[g[0]] for g in groups for r in g)
        differ = len({dig[g[0]] for g in groups}) == len(groups)
        if not same or (not sync and not differ):
            raise AssertionError(
                f"step {t}, model coordinate {m}: dp ranks of a group "
                f"bit-identical {same}, groups differ {differ}, groups "
                f"{groups}")


def model_check_c(rows) -> bool:
    """Check (c) on rank 0: every model group's leaves held whole are
    bit-identical."""
    return all(rows[r][1] == rows[r - r % MODEL_M][1]
               for r in range(len(rows)))


def model_worker(spec: dict, out: str) -> int:
    """One rank of the model phase, started by torchrun: the port's
    ``Trainer`` on this rank's slices of its replica for ``spec["steps"]``
    steps with checks (a)-(c), one profiled step, check (f)'s faulty step;
    then a fresh model served through ``build_prefill`` and
    ``build_serve_step`` on this dp rank's prompts; rank 0 serves the
    whole model on every prompt (check (e)'s reference) and writes
    ``out/model.json``."""
    import os
    import torch
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = spec["data"]
    world = mesh.init_rank_world(data, model=MODEL_M,
                                 backend=os.environ["REPRO_TORCH_BACKEND"],
                                 device_type=spec["device"])
    device = world.device
    on_card = device.type == "cuda"
    rank0 = world.torch_rank == 0
    try:
        trainer = model_trainer(spec, world)
        cfg = trainer.cfg
        init_s = time.perf_counter() - t_start
        avg = trainer.averager
        plan = trainer.plan()
        stacked_plan = plan_mod.compile_plan(plan.topology,
                                             plan.storage_struct, plan.cfg)
        n_buckets = plan.class_layout(0).n_buckets
        n_stages = len(plan.runs_for_offset(0)[0].bits)
        dims = cm.placement(cfg, trainer.state.params, MODEL_M)
        split, wire, pending, checked, check_s, own = \
            instrument_rank_trainer(trainer, world, plan)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        log, c_held, check_h = [], [], None
        for t in range(spec["steps"]):
            for k in split:
                split[k] = 0.0
            wire.clear()
            check_s[0] = 0.0
            plan.wire.events = []
            before, tp0 = ops.launch_counts(), cm.tp_stats()
            _sync(device)
            t0 = time.perf_counter()
            loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t0 - check_s[0]
            after, tp1 = ops.launch_counts(), cm.tp_stats()
            sync = avg.sync_due(t)
            offset = None if sync else plan.offsets[avg.phase_for_step(t)]
            g = None if sync else receipt_events(plan.wire, n_buckets,
                                                 n_stages)   # check (g)
            plan.wire.events = None
            t0 = time.perf_counter()
            rows = model_digests(world, trainer.state.params, dims)
            if rank0:
                model_check_b(rows, t, sync, offset)
                c_held.append(model_check_c(rows))
                if not c_held[-1]:
                    raise AssertionError(f"step {t}: check (c): a model "
                                         f"group's leaves held whole differ")
            if offset in pending:        # check (b), once an offset
                pre = pending.pop(offset)
                post = mesh.gather_rows(world, trainer.state.params)
                checked[offset] = None
                faulty = None            # check (h) and its fault, once
                if offset in own:
                    check_h, faulty = overlap_pair(world, plan,
                                                   own.pop(offset), offset)
                if world.rank == 0:      # dp rank 0 of each coordinate
                    want = stacked_plan.average_offset(
                        tr.tree_map(lambda a: a.to(device), pre), offset)
                    checked[offset] = rows_equal(want, post)
                    if faulty is not None:
                        check_h["fault_parts"] = not rows_equal(want,
                                                                faulty)
                    del want
                verdicts = gather_to_rank0(world, checked[offset])
                if rank0:
                    checked[offset] = [v for v in verdicts if v is not None]
                    if not all(checked[offset]):
                        raise AssertionError(
                            f"step {t}: the wire average at offset {offset}"
                            f" differs from the stacked plan's")
                del pre, post, faulty
            log.append({
                "t": t, "loss": loss, "sync": sync, "offset": offset,
                "step_ms": step_s * 1e3,
                **{k + "_ms": v * 1e3 for k, v in split.items()},
                "tp_ms": (tp1["s"] - tp0["s"]) * 1e3,
                "tp_bytes": tp1["bytes"] - tp0["bytes"],
                "tp_ops": tp1["ops"] - tp0["ops"],
                "exchange_ms": {k[:-2]: wire.get(k, 0.0) * 1e3
                                for k in ("d2h_s", "wire_s", "h2d_s")},
                "wire_bytes": wire.get("bytes", 0), "check_g": g,
                "check_ms": (check_s[0] + time.perf_counter() - t0) * 1e3,
                "skipped": trainer.last_metrics["skipped_nonfinite"],
                **{key: after[name] - before[name] for key, name in (
                    ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4),
                    ("k4_tma", K4_TMA))}})
        peak = torch.cuda.max_memory_allocated() if on_card else None
        window = profiled_step(trainer, spec["steps"], device)
        # check (f): a step whose one layer leaves out a backward sum
        fault_layer, undo = plant_layer_fault(trainer)
        try:
            trainer.step_once(spec["steps"] + 1)
        finally:
            undo()
        rows = model_digests(world, trainer.state.params, dims)
        fault_c = model_check_c(rows) if rank0 else None
        train_s = time.perf_counter() - t_start
        del trainer, pending
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        # serving: a fresh model, this dp rank's prompts over the model group
        t0 = time.perf_counter()
        scfg = model_cfg(spec, spec["serve_layers"])
        model = build_model(scfg, device, model_world=world.model_world)
        params = model.init(torch.Generator(device=device).manual_seed(
            MODEL_SERVE_SEED))
        prompts = model_prompts(scfg, spec)
        rows_ = spec["rows"]
        mine = torch.from_numpy(prompts[world.rank * rows_:
                                        (world.rank + 1) * rows_]).to(device)
        max_len = spec["prompt"] + spec["new"]
        t1 = time.perf_counter()
        logits, tokens, launches = greedy_run(model, params, mine, max_len,
                                              spec["new"])
        serve = {"init_s": t1 - t0, "run_s": time.perf_counter() - t1,
                 "launches": launches,
                 "peak": torch.cuda.max_memory_allocated() if on_card
                 else None}
        del params, model
        got = (logits, tokens) if world.model_rank == 0 else None
        everyone = gather_to_rank0(world, {
            "rank": world.torch_rank, "dp": world.rank,
            "model": world.model_rank, "device": str(device), "log": log,
            "peak": peak, "window": window, "init_s": init_s,
            "train_s": train_s, "serve": serve, "served": got,
            "check_h": check_h})
        if rank0:
            # check (e)'s reference: rank 0 serves the whole model on every
            # prompt
            t0 = time.perf_counter()
            if on_card:
                torch.cuda.empty_cache()
            model = build_model(scfg, device)
            params = model.init(torch.Generator(device=device).manual_seed(
                MODEL_SERVE_SEED))
            tp = [r["served"] for r in everyone if r["served"] is not None]
            tp_tokens = torch.cat([x[1] for x in tp])
            ref_logits, ref_tokens, ref_launches = greedy_run(
                model, params, torch.from_numpy(prompts).to(device), max_len,
                spec["new"], feed=tp_tokens)
            del params, model
            result = {
                "world": {"data": data, "model": MODEL_M,
                          "backend": world.backend},
                "n_buckets": n_buckets, "n_stages": n_stages,
                "bucket_sizes": list(plan.class_layout(0).bucket_sizes),
                "bucket_bytes": plan.class_bucket_bytes[0],
                "expected_k1_k2_per_group_step": expected_combine_launches(
                    n_buckets, n_stages),
                "stacked_equals_wire": checked, "check_c": c_held,
                "fault_check_c": fault_c,
                "fault_layer": fault_layer,
                "serve_check": serve_compare(
                    torch.cat([x[0] for x in tp]), tp_tokens, ref_logits,
                    ref_tokens),
                "ref_launches": ref_launches,
                "ref_s": time.perf_counter() - t0,
                "ranks": [{k: v for k, v in r.items() if k != "served"}
                          for r in everyone],
                "worker_s": time.perf_counter() - t_start}
            (Path(out) / "model.json").write_text(json.dumps(result))
        return 0
    finally:
        mesh.shutdown()


def serve_compare(logits, tokens, ref_logits, ref_tokens) -> dict:
    """Check (e): the model world's gathered logits (B, n, V) and greedy
    tokens against the one-rank run's, which was fed the model world's
    tokens (so every step's logits are comparable): the prefill's and the
    first decode step's logits to ``LOGIT_RTOL`` of the largest reference
    logit; at every step whose reference top-2 margin exceeds the two
    runs' largest logit gap there, the same greedy token."""
    import torch
    scale = float(ref_logits[:, :2].abs().max())
    first = [float((logits[:, i] - ref_logits[:, i]).abs().max())
             for i in range(2)]
    gap = (logits - ref_logits).abs().amax(-1)                  # (B, n)
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    above = margin > gap
    same = tokens == ref_tokens
    return {"ok": max(first) <= LOGIT_RTOL * scale
            and bool(same[above].all()),
            "prefill_and_first_step_max_abs_diff": first,
            "largest_logit": scale, "limit": LOGIT_RTOL * scale,
            "max_logit_gap": float(gap.max()),
            "tokens_compared": int(above.sum()),
            "tokens_equal": int((same & above).sum()),
            "near_ties": int((~above).sum()),
            "near_ties_equal": int((same & ~above).sum()),
            "tokens": int(same.numel())}


def model_serve_launches(cfg) -> tuple:
    """The launches a prefill and a decode step of ``cfg`` make on a
    model rank, as dicts of (K1, K2, K3, K4, K4_TMA, K4_WALK): the dense
    family K3 once a layer a prefill; the hybrid K4 once a recurrent
    layer, on the TMA route a prefill and the walk route a decode step,
    and K3 once an attention layer a prefill."""
    from repro_torch.models import rglru
    zero = dict.fromkeys((K1, K2, K3, K4, K4_TMA, K4_WALK), 0)
    if cfg.family != "hybrid":
        return dict(zero, **{K3: cfg.n_layers}), zero
    n_sb, tail = rglru.layout(cfg)
    n_rec = 2 * n_sb + tail
    return (dict(zero, **{K3: n_sb, K4: n_rec, K4_TMA: n_rec}),
            dict(zero, **{K4: n_rec, K4_WALK: n_rec}))


def check_model_launches(stats):
    """Check (a) of a model phase, on every rank: each group step
    launched the K1 and K2 counts of the rank's plan's schedule, syncs
    neither, training no K3, and K4 (all on the TMA route) one replica's
    :func:`rg_train_k4_per_step` (none for the dense family); each
    prefill and decode step :func:`model_serve_launches`."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    spec = stats["spec"]
    tcfg = model_cfg(spec, spec["n_layers"])
    k4 = rg_train_k4_per_step(tcfg, 1) if tcfg.family == "hybrid" else 0
    want_pre, want_step = model_serve_launches(
        model_cfg(spec, spec["serve_layers"]))
    for r in stats["ranks"]:
        for e in r["log"]:
            want = ((0, 0) if e["sync"] else (want_k1, want_k2)) + (0, k4, k4)
            got = (e["k1"], e["k2"], e["k3"], e["k4"], e["k4_tma"])
            if got != want:
                raise AssertionError(f"rank {r['rank']} step {e['t']}: K1, "
                                     f"K2, K3, K4, K4 on TMA launched {got}; "
                                     f"the schedule predicts {want}")
        pre, *steps = r["serve"]["launches"]
        if pre != want_pre or any(s != want_step for s in steps):
            raise AssertionError(f"rank {r['rank']} serving: launches "
                                 f"{r['serve']['launches']}; a prefill "
                                 f"{want_pre}, a decode step {want_step}")


def check_model_held(stats, combines) -> None:
    """Check (a): the ranks' plan is the plan whose combine operands the
    K1/K2 phase held (``model_combines``)."""
    spec = stats["spec"]
    plan_sizes = list(model_slice_plan(
        model_cfg(spec, spec["n_layers"]), spec["data"],
        spec.get("bucket_bytes")).class_layout(0).bucket_sizes)
    if stats["bucket_sizes"] != plan_sizes:
        raise AssertionError(f"the ranks compiled buckets "
                             f"{stats['bucket_sizes']}; the K1/K2 phase held "
                             f"those of {plan_sizes} ({combines})")


def model_summary(stats: dict) -> dict:
    """The phase's numbers: rank 0's median step after the first and its
    split (grads, of which the TP all-reduces; update; the dp exchange and
    combine), each rank's peak memory, and the device's idle share over
    the profiled step (as :func:`ranks_summary` takes it)."""
    r0 = stats["ranks"][0]
    steady = r0["log"][1:]
    group = [e for e in steady if not e["sync"]]
    med = lambda es, f: statistics.median(f(e) for e in es) if es else None
    return {
        "median_step_ms": med(steady, lambda e: e["step_ms"]),
        "median_group_step_ms": med(group, lambda e: e["step_ms"]),
        "group_split_ms": {
            "grads": med(group, lambda e: e["grads_ms"]),
            "tp_all_reduce": med(group, lambda e: e["tp_ms"]),
            "update": med(group, lambda e: e["update_ms"]),
            "exchange": {k: med(group, lambda e: e["exchange_ms"][k])
                         for k in ("d2h", "wire", "h2d")},
            "combine": med(group, lambda e: e["average_ms"] - sum(
                e["exchange_ms"].values())),
            "other": med(group, lambda e: e["step_ms"] - e["grads_ms"]
                         - e["update_ms"] - e["average_ms"])},
        "tp_bytes_a_step": group[0]["tp_bytes"] if group else None,
        "tp_ops_a_step": group[0]["tp_ops"] if group else None,
        "wire_bytes_a_group_step": group[0]["wire_bytes"] if group else None,
        "sync_ms": med([e for e in steady if e["sync"]],
                       lambda e: e["sync_ms"]),
        "peak_bytes_by_rank": [r["peak"] for r in stats["ranks"]],
        "serve_peak_bytes_by_rank": [r["serve"]["peak"]
                                     for r in stats["ranks"]],
        "serve_run_s_by_rank": [r["serve"]["run_s"] for r in stats["ranks"]],
        **device_idle([r["window"] for r in stats["ranks"]]),
    }


def model_phase(spec: dict, out: Path, timeout: int = MODEL_TIMEOUT) -> dict:
    """Start ``spec["data"] x MODEL_M`` ranks through torchrun (gloo, all
    on one card, model minor), then check (d) against the one-process
    stacked ``Trainer`` and (f) on what they report.  A rank that fails
    fails the phase.  ``out`` is the phase's own directory (emptied
    first): the ranks' log and their result."""
    import shutil
    import torch

    t_phase = time.perf_counter()
    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torchrun_s = run_torchrun(spec["data"] * MODEL_M, MODEL_WORKER_FLAG,
                              spec, out, timeout)
    stats = json.loads((out / "model.json").read_text())
    stats["spec"], stats["torchrun_s"] = spec, torchrun_s
    stats["serve_layers"] = model_cfg(spec, spec["serve_layers"]).n_layers
    stats["train_layers"] = model_cfg(spec, spec["n_layers"]).n_layers
    log0 = stats["ranks"][0]["log"]
    bad = [e for r in stats["ranks"] for e in r["log"]
           if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (f)
        raise AssertionError(f"non-finite losses or skipped updates: {bad}")
    if any(e["loss"] != f["loss"] for r in stats["ranks"]
           for e, f in zip(r["log"], log0)):
        raise AssertionError("the ranks report different mean losses")
    if stats["fault_check_c"] is not False:                     # check (f)
        raise AssertionError("check (c) holds on a step that left out a "
                             "backward sum in one layer")
    stats["overlap"] = check_overlap(stats)                     # (g), (h)
    if not stats["serve_check"]["ok"]:                          # check (e)
        raise AssertionError(f"check (e): {stats['serve_check']}")
    # check (d): the one-process stacked twin, whole replicas as rows
    t0 = time.perf_counter()
    trainer = model_trainer(spec)
    losses = [trainer.step_once(t) for t in range(spec["steps"])]
    del trainer
    if torch.device(spec["device"]).type == "cuda":
        torch.cuda.empty_cache()
    rank_losses = [e["loss"] for e in log0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rank_losses, losses))
    stats["check_d"] = {"stacked_losses": losses, "max_loss_rel_diff": rel,
                        "loss_rtol": MODEL_LOSS_RTOL,
                        "stacked_s": time.perf_counter() - t0}
    if rel > MODEL_LOSS_RTOL:
        raise AssertionError(f"check (d): the model ranks' losses part from "
                             f"the stacked trainer's: {stats['check_d']}")
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["summary"] = model_summary(stats)
    return stats


def print_model(stats: dict, card: str, label: str = "model"):
    s, d, e = stats["summary"], stats["check_d"], stats["serve_check"]
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    fault = ("w_r's gradient sum" if stats["spec"]["arch"] == RG_ARCH
             else "f")
    print(f"{label} [{card}]: {stats['spec']['arch']} full width, "
          f"{stats['train_layers']} layers, data "
          f"{stats['world']['data']} x model {MODEL_M} ranks over "
          f"{stats['world']['backend']} on one card, S={MODEL_S} "
          f"tau={TRAIN_TAU}, {stats['n_buckets']} buckets of a rank's slices "
          f"({stats['bucket_bytes'] >> 20} MiB), K1/K2 a group step "
          f"{stats['expected_k1_k2_per_group_step']}; phase "
          f"{stats['phase_s']:.1f} s (torchrun {stats['torchrun_s']:.1f} s, "
          f"stacked twin {d['stacked_s']:.1f} s)", flush=True)
    losses = [round(x["loss"], 5) for x in stats["ranks"][0]["log"]]
    print(f"{label} losses: {losses} (stacked twin "
          f"{[round(x, 5) for x in d['stacked_losses']]})", flush=True)
    print(f"{label} [{card}]: median step {s['median_step_ms']:.1f} ms after "
          f"the first (group {s['median_group_step_ms']}); group step split "
          f"{json.dumps(s['group_split_ms'])} ms; TP all-reduce "
          f"{s['tp_ops_a_step']} ops, {s['tp_bytes_a_step']} bytes a step a "
          f"rank; dp wire {s['wire_bytes_a_group_step']} bytes; sync "
          f"{s['sync_ms']} ms; peak memory by rank training "
          f"{[gib(b) for b in s['peak_bytes_by_rank']]} GiB, serving "
          f"{[gib(b) for b in s['serve_peak_bytes_by_rank']]} GiB; profiled "
          f"step: wall {s['profile_wall_ms']:.1f} ms, device busy "
          f"{s['device_busy_ms']} ms, idle share {s['device_idle_share']}",
          flush=True)
    print(f"{label} checks: (b) wire = stacked by offset "
          f"{stats['stacked_equals_wire']}; (c) leaves held whole equal over "
          f"each model group at every step {all(stats['check_c'])}, and not "
          f"after the step without {fault} in layer {stats['fault_layer']} "
          f"(f); "
          f"(d) max loss rel diff vs the stacked twin "
          f"{d['max_loss_rel_diff']:.3g}"
          f" (tol {d['loss_rtol']}); (e) prefill and first decode logits max "
          f"abs diff {e['prefill_and_first_step_max_abs_diff']} (limit "
          f"{e['limit']:.4g}, largest gap over all steps "
          f"{e['max_logit_gap']:.4g}), tokens equal {e['tokens_equal']} of "
          f"the {e['tokens_compared']} whose margin exceeds the gap "
          f"({e['near_ties_equal']} of the {e['near_ties']} others); serving "
          f"{[round(x, 2) for x in s['serve_run_s_by_rank']]}"
          f" s by rank, the one-rank reference {stats['ref_s']:.1f} s",
          flush=True)
    print_overlap(label, stats["overlap"], card)


# ---------------------------------------------------------------------------
# attn model phase (slice 4c, second part): the audio and vlm families and
# the paged scheduler over model ranks
# ---------------------------------------------------------------------------

def attn_model_spec(device="cuda", smoke: bool = False,
                    new: int = MODEL_NEW, prompts: Optional[dict] = None,
                    src_len: int = WMT_SRC,
                    sched_layers: Optional[int] = None,
                    sched_prompt=SCHED_PROMPT, sched_new: int = SCHED_NEW,
                    block_size: int = BLOCK_SIZE,
                    max_blocks: int = MAX_BLOCKS_PER_REQ) -> dict:
    """What the attn model phase's ranks run (JSON, handed to every rank
    on its command line): the audio and vlm models of
    ``ATTN_MODEL_ARCHS`` served over data ``ATTN_MODEL_DATA`` x model
    ``MODEL_M`` ranks, one prompt of ``prompts[arch]`` tokens a dp rank
    and ``new`` decode steps; then ``SCHED_REQUESTS`` requests of
    distinct lengths in ``sched_prompt`` through the paged scheduler on
    ``ARCH`` (``sched_layers`` None: its own depth), ``sched_new`` tokens
    each."""
    return {"device": device, "smoke": smoke, "data": ATTN_MODEL_DATA,
            "archs": list(ATTN_MODEL_ARCHS), "new": new,
            "prompts": dict(prompts or ATTN_MODEL_PROMPTS),
            "src_len": src_len, "sched_arch": ARCH,
            "sched_layers": sched_layers, "sched_prompt": list(sched_prompt),
            "sched_new": sched_new, "block_size": block_size,
            "max_blocks": max_blocks}


def attn_model_cfg(spec: dict, arch: str, n_layers: Optional[int] = None):
    return model_cfg({"arch": arch, "smoke": spec["smoke"]}, n_layers)


def k3_per_prefill(cfg) -> int:
    """K3's launches a prefill of ``cfg`` on a model rank: one an encoder
    layer and two a decoder layer (self and cross) for the audio family,
    one a layer for the vlm and dense families."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return cfg.n_layers


def cross_attention_without_g():
    """Check (e)'s fault: every cross-attention (prefill and decode) adds
    only this rank's heads' part of its output, ``reduce_from_model`` left
    out, on every rank alike; returns the undo."""
    from repro_torch.models import common as cm
    from repro_torch.models import encdec
    reduce = cm.reduce_from_model
    saved = {n: getattr(encdec, n) for n in ("_cross_attn", "_cross_decode")}

    def without_g(fn):
        def faulty(*args, **kw):
            cm.reduce_from_model = lambda x, mw: x
            try:
                return fn(*args, **kw)
            finally:
                cm.reduce_from_model = reduce
        return faulty
    for n, fn in saved.items():
        setattr(encdec, n, without_g(fn))

    def undo():
        for n, fn in saved.items():
            setattr(encdec, n, fn)
    return undo


def rank_local_pick(model, last):
    """Check (e)'s fault for the paged steps: the greedy token of the
    rank's own masked vocab columns, numbered from its first (the pick a
    model world must not make), beside the gathered logits."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.serve.decode import greedy_pick
    n = last.shape[-1]
    lo = model.model_world.rank * n if model.model_world else 0
    cols = lo + torch.arange(n, device=last.device)
    local = torch.where(cols < model.cfg.vocab, last, cm.NEG_INF)
    return local.argmax(-1), greedy_pick(model, last)[1]


def gather_to_rank0(world, obj):
    """Every torch rank's ``obj`` on rank 0 (a list in rank order; ``None``
    elsewhere)."""
    import torch.distributed as dist
    out = [None] * world.model * world.P if world.torch_rank == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out


def attn_family_serve(spec: dict, world, arch: str) -> Optional[dict]:
    """One family model of the attn model phase on this rank: its slices
    of random weights from ``ATTN_MODEL_SEED``, this dp rank's prompt (and
    its frames, source tokens or patches) through ``greedy_run``, K3 tallied
    by role; transformer-wmt again with check (e)'s cross-attention without
    g.  Rank 0 then serves the whole model on every prompt, fed the model
    world's tokens, for check (b) (and fed the faulty run's, for (e)), and
    returns the checks; the other ranks return ``None``."""
    import torch
    from repro_torch.models.registry import build_model
    device, mw = world.device, world.model_world
    on_card = device.type == "cuda"
    cfg = attn_model_cfg(spec, arch)
    prompt, new = spec["prompts"][arch], spec["new"]
    t0 = time.perf_counter()
    model = build_model(cfg, device, model_world=mw)
    params = model.init(torch.Generator(device=device).manual_seed(
        ATTN_MODEL_SEED))
    prompts = torch.as_tensor(np.random.default_rng(ATTN_MODEL_SEED).integers(
        0, cfg.vocab, (spec["data"], prompt)), dtype=torch.int64,
        device=device)
    extra_all = serve_inputs(cfg, spec["data"], ATTN_MODEL_SEED, device,
                             spec["src_len"])
    mine = slice(world.rank, world.rank + 1)
    extra = {k: v[mine] for k, v in extra_all.items()}
    pos0 = prompt + (cfg.n_patches if cfg.family == "vlm" else 0)
    max_len = prompt + new
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    (logits, tokens, launches), roles, _ = tally_k3_roles(
        lambda: greedy_run(model, params, prompts[mine], max_len, new,
                           extra=extra, pos0=pos0))
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() if on_card else None
    fault = None
    if cfg.family == "audio" and not cfg.encoder_frames:
        undo = cross_attention_without_g()
        try:
            fault = greedy_run(model, params, prompts[mine], max_len, new,
                               extra=extra, pos0=pos0)[:2]
        finally:
            undo()
    del params, model
    everyone = gather_to_rank0(world, {
        "rank": world.torch_rank, "launches": launches, "k3_roles": roles,
        "init_s": t1 - t0, "run_s": run_s, "peak": peak,
        "served": (logits, tokens, fault) if world.model_rank == 0
        else None})
    if world.torch_rank != 0:
        return None
    served = [r.pop("served") for r in everyone]
    served = [x for x in served if x is not None]
    w_logits = torch.cat([x[0] for x in served])
    w_tokens = torch.cat([x[1] for x in served])
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(
        ATTN_MODEL_SEED))
    ref_logits, ref_tokens, ref_launches = greedy_run(
        model, params, prompts, max_len, new, feed=w_tokens,
        extra=extra_all, pos0=pos0)
    v = cfg.vocab                # the padding columns masked or not
    check = serve_compare(w_logits[..., :v], w_tokens, ref_logits[..., :v],
                          ref_tokens)
    fault_check = None
    if fault is not None:
        f_logits = torch.cat([x[2][0] for x in served])
        f_tokens = torch.cat([x[2][1] for x in served])
        fr_logits, fr_tokens, _ = greedy_run(
            model, params, prompts, max_len, new, feed=f_tokens,
            extra=extra_all, pos0=pos0)
        fault_check = serve_compare(f_logits[..., :v], f_tokens,
                                    fr_logits[..., :v], fr_tokens)
    ref_s = time.perf_counter() - t0
    del params, model
    finite = bool(torch.isfinite(w_logits[..., :v]).all())
    in_vocab = bool(((w_tokens >= 0) & (w_tokens < v)).all())
    return {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
            "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
            "prompt": prompt, "input_positions": prompt + sum(
                v.shape[1] for v in extra_all.values()),
            "new": new, "ranks": everyone, "ref_launches": ref_launches,
            "ref_s": ref_s, "serve_check": check,
            "cross_without_g_check": fault_check,
            "finite": finite, "in_vocab": in_vocab,
            "tokens": w_tokens.tolist()}


def sched_prompts(cfg, spec: dict) -> list:
    """``SCHED_REQUESTS`` prompts of the distinct lengths
    :func:`sched_lengths` draws in ``spec["sched_prompt"]``, their tokens
    from a numpy seed."""
    rng = np.random.default_rng(SCHED_SEED + 1)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
            for n in sched_lengths(spec["sched_prompt"])]


def sched_run(model, params, prompts: list, new: int, spec: dict,
              pick=None, sched_cls=None, **sched_kw) -> dict:
    """``prompts`` through the paged ``ServeScheduler`` (or ``sched_cls``
    with ``sched_kw``; ``new`` tokens each) from a pool with no block to
    spare, so that growth preempts; ``pick`` in place of the paged steps'
    greedy pick where given.  Records each request's gathered logits (its
    prefill's and each decode step's, from its last admission), the
    admissions and preemptions (at the decode step count), the decode
    shapes, each prefill's and decode step's launches, and a
    disaggregated scheduler's staging seconds and ``TransferStats``."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Request, ServeScheduler, kv_cache
    from repro_torch.serve.decode import greedy_pick
    device = model.device
    bs = spec["block_size"]
    n_blocks = 1 + sum(-(-(len(p) + 1) // bs) for p in prompts)
    logits, current = {}, [None]
    admissions, preemptions = [], []
    launches = {"prefill": [], "decode": []}
    times = {"prefill": [], "decode": []}          # ms, synchronised
    inner = model.prefill

    def recording_prefill(params, batch, max_len):
        out, caches = inner(params, batch, max_len)
        logits[current[0]] = [greedy_pick(model, out[:, -1])[1][0].float()
                              .cpu()]
        return out, caches
    sched = (sched_cls or ServeScheduler)(
        model._replace(prefill=recording_prefill), params,
        n_blocks=n_blocks, block_size=bs,
        max_blocks_per_req=spec["max_blocks"], max_batch=MAX_BATCH,
        **sched_kw)
    do_prefill, decode, preempt = (sched._do_prefill, sched._decode,
                                   sched._preempt)
    kinds = (K1, K2, K3, K4)

    def counted(key, fn, *args):
        _sync(device)
        before, t0 = ops.launch_counts(), time.perf_counter()
        out = fn(*args)
        _sync(device)
        times[key].append((time.perf_counter() - t0) * 1e3)
        after = ops.launch_counts()
        launches[key].append({k: after[k] - before[k] for k in kinds})
        return out

    def logged_prefill(req, table):
        current[0] = req.rid
        admissions.append((sched.n_decode_steps, req.rid))
        return counted("prefill", do_prefill, req, table)

    def logged_decode(params, pool, tables, tokens, positions):
        batch = list(sched.running)       # rows in the order the step built
        pool, nxt, out = counted("decode", decode, params, pool, tables,
                                 tokens, positions)
        for i, req in enumerate(batch):
            logits[req.rid].append(out[i].float().cpu())
        return pool, nxt, out

    def logged_preempt(victim):
        preemptions.append((sched.n_decode_steps, victim.rid))
        return preempt(victim)
    sched._do_prefill, sched._decode, sched._preempt = (
        logged_prefill, logged_decode, logged_preempt)
    saved = kv_cache.greedy_pick
    if pick is not None:
        kv_cache.greedy_pick = pick
    try:
        for i, p in enumerate(prompts):
            sched.submit(Request(i, p, new))
        _sync(device)
        t0 = time.perf_counter()
        outs = sched.run()
        _sync(device)
        wall_s = time.perf_counter() - t0
    finally:
        kv_cache.greedy_pick = saved
    return {"tokens": {rid: list(t) for rid, t in sorted(outs.items())},
            "logits": logits, "admissions": admissions,
            "preemptions": preemptions, "n_blocks": n_blocks,
            "evictions": sched.blocks.evictions,
            "n_decode_steps": sched.n_decode_steps,
            "shapes": sorted(sched.decode_shapes_compiled),
            "launches": launches, "times_ms": times, "wall_s": wall_s,
            "blocks_free": sched.blocks.n_free,
            "staging": getattr(sched, "staging", None),
            "transfer": (dataclasses.asdict(sched.connector.stats)
                         if hasattr(sched, "connector") else None)}


def first_parting_step(tokens, want, ref_logits, gap) -> Optional[int]:
    """The first step at which ``tokens`` part from ``want`` (the tokens
    the reference was fed), if the reference's greedy token there is not
    ``tokens``' and its top-2 margin exceeds ``gap``: the step at which
    check (c)'s rule fails; ``None`` where it does not."""
    import torch
    for i, (a, b) in enumerate(zip(tokens, want)):
        if a != b:
            top2 = torch.topk(ref_logits[0, i], 2).values
            ok = int(ref_logits[0, i].argmax()) != a and \
                float(top2[0] - top2[1]) > gap
            return i if ok else None
    return None


def attn_sched_serve(spec: dict, world) -> Optional[dict]:
    """Check (c) on this rank: ``SCHED_REQUESTS`` requests of distinct
    prompt lengths through the paged scheduler over the model world, each
    request then again through the dense model-world
    ``build_prefill``/``build_serve_step`` fed its tokens; check (e)'s
    rank-local pick on the first ``SCHED_FAULT_REQUESTS`` requests.  Rank 0
    gathers every rank's tokens, logs and shapes and returns the
    verdicts; the other ranks return ``None``."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model
    from repro_torch.serve import DisaggregatedScheduler, LinkCostedConnector
    device, mw = world.device, world.model_world
    on_card = device.type == "cuda"
    cfg = attn_model_cfg(spec, spec["sched_arch"], spec["sched_layers"])
    model = build_model(cfg, device, model_world=mw)
    params = model.init(torch.Generator(device=device).manual_seed(
        ATTN_MODEL_SEED))
    prompts = sched_prompts(cfg, spec)
    new = spec["sched_new"]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    run = sched_run(model, params, prompts, new, spec)
    t0 = time.perf_counter()
    dense = {}
    for rid, p in enumerate(prompts):
        feed = torch.tensor([run["tokens"][rid]], dtype=torch.int64)
        d_logits, d_tokens, d_launches = greedy_run(
            model, params, torch.as_tensor(p[None], dtype=torch.int64,
                                           device=device),
            len(p) + new, new - 1, feed=feed)
        dense[rid] = (d_logits, d_tokens, d_launches)
    dense_s = time.perf_counter() - t0
    fault_prompts = prompts[:SCHED_FAULT_REQUESTS]
    fault = sched_run(model, params, fault_prompts, new, spec,
                      pick=rank_local_pick)
    # check (g): the same requests through the disaggregated scheduler,
    # each rank shipping its KV heads; then the fault's requests with rank
    # 1's wire flipping the top exponent bit of request 0's first V element
    prefill_params = tr.tree_map(torch.clone, params)
    disagg = sched_run(model, params, prompts, new, spec,
                       sched_cls=DisaggregatedScheduler,
                       prefill_params=prefill_params)
    kh = tfm.kv_heads_held(cfg, mw)
    flip_conn = None
    if world.model_rank == 1:
        n_ship = -(-(len(prompts[0]) + 1) // spec["block_size"])
        at = first_v_element(cfg, n_ship, LinkCostedConnector(),
                             kv_heads=kh, block_size=spec["block_size"])
        flip_conn = LinkCostedConnector(transport=bit_flip_transport(
            at, 8 * tfm.torch_dtype(cfg).itemsize - 2))
    flip = sched_run(model, params, fault_prompts, new, spec,
                     sched_cls=DisaggregatedScheduler,
                     prefill_params=prefill_params, connector=flip_conn)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del params, model, prefill_params
    logs = lambda r: {k: r[k] for k in ("tokens", "admissions",
                                        "preemptions", "shapes")}
    everyone = gather_to_rank0(world, {
        "rank": world.torch_rank, "run": logs(run),
        "fault": logs(fault), "launches": run["launches"],
        "times_ms": run["times_ms"],
        "dense_launches": [d[2] for d in dense.values()],
        "wall_s": run["wall_s"], "dense_s": dense_s, "peak": peak,
        "disagg": logs(disagg), "disagg_launches": disagg["launches"],
        "disagg_wall_s": disagg["wall_s"], "staging": disagg["staging"],
        "transfer": disagg["transfer"], "flip": logs(flip),
        "kv_heads": kh})
    if world.torch_rank != 0:
        return None
    same = all(r["run"] == everyone[0]["run"] for r in everyone)
    v = cfg.vocab
    compares = {rid: serve_compare(
        torch.stack(run["logits"][rid])[None, :, :v], torch.tensor(
            [run["tokens"][rid]]), dense[rid][0][..., :v], dense[rid][1])
        for rid in range(len(prompts))}
    finite = all(bool(torch.isfinite(torch.stack(v)[:, :cfg.vocab]).all())
                 for v in run["logits"].values())
    in_vocab = all(0 <= t < cfg.vocab for toks in run["tokens"].values()
                   for t in toks)
    ok = (same and all(c["ok"] for c in compares.values())
          and run["evictions"] >= 1 and finite and in_vocab
          and run["blocks_free"] == run["n_blocks"] - 1
          and all(len(t) == new for t in run["tokens"].values()))
    # check (e): the rank-local pick must fail (c): the ranks part, or a
    # request parts from the dense run where (c)'s rule holds it
    fault_same = all(r["fault"]["tokens"] == everyone[0]["fault"]["tokens"]
                     for r in everyone)
    fault_parting = {rid: first_parting_step(
        fault["tokens"][rid], run["tokens"][rid], dense[rid][0][..., :v],
        compares[rid]["max_logit_gap"])
        for rid in range(len(fault_prompts))}
    disagg_check = check_disaggregated_ranks(everyone, cfg, prompts, spec)
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "prompt_lens": [len(p) for p in prompts], "new": new,
            "disagg": disagg_check,
            "n_blocks": run["n_blocks"], "evictions": run["evictions"],
            "preemptions": run["preemptions"],
            "admissions": run["admissions"],
            "n_decode_steps": run["n_decode_steps"],
            "decode_shapes": run["shapes"], "ranks_equal": same,
            "checks": {str(k): v for k, v in compares.items()},
            "finite": finite, "in_vocab": in_vocab, "ok": ok,
            "fault_ranks_equal": fault_same,
            "fault_parting_step": {str(k): v
                                   for k, v in fault_parting.items()},
            "fault_fails": (not fault_same) or any(
                v is not None for v in fault_parting.values()),
            "tokens": run["tokens"], "ranks": everyone}


def check_disaggregated_ranks(everyone: list, cfg, prompts: list,
                              spec: dict) -> dict:
    """Check (g) of the attn model phase on rank 0, from every rank's
    logs: on each rank the disaggregated run's tokens, admissions,
    preemptions and decode shapes equal the colocated paged run's, and
    its connector took one insert a prefill (a preempted request ships
    again) of each prefill's ``ceil((prompt + 1) / block_size)`` blocks,
    the rank's KV heads' share of ``kv_payload_bytes`` of a block each;
    the run of ``SCHED_FAULT_REQUESTS`` requests with rank 1's flipped bit
    in request 0 must fail it (its tokens part from the colocated run's).
    Returns the verdicts and each rank's staging ms and bytes."""
    from repro_torch.serve.kv_transfer import kv_payload_bytes
    bs = spec["block_size"]
    out = {"ranks": []}
    ok = True
    for r in everyone:
        d = r["disagg"]
        blocks = sum(-(-(len(prompts[rid]) + 1) // bs)
                     for _, rid in d["admissions"])
        per_block = kv_payload_bytes(cfg, bs) * r["kv_heads"] \
            // cfg.n_kv_heads
        want = {"requests": len(d["admissions"]), "blocks": blocks,
                "payload_bytes": blocks * per_block}
        got = {k: r["transfer"][k] for k in want}
        same = d == r["run"]
        ok = ok and same and got == want
        out["ranks"].append({
            "rank": r["rank"], "equal_to_colocated": same,
            "transfer": r["transfer"], "want": want,
            "bytes_a_block": per_block, "wall_s": r["disagg_wall_s"],
            "staging_ms": {k[:-2]: v * 1e3
                           for k, v in r["staging"].items()}})
    out["ok"] = ok
    colocated = {rid: everyone[0]["run"]["tokens"][rid]
                 for rid in range(SCHED_FAULT_REQUESTS)}
    out["flip_tokens_differ"] = [r["flip"]["tokens"] != colocated
                                 for r in everyone]
    out["flip_fails"] = any(out["flip_tokens_differ"])
    return out


def host_buffers() -> dict:
    """Check (d): the pinned host buffers the model collectives staged
    through (``common._HOST``), their capacities by dtype, and the bound
    item 6 sets: a dtype at most as many as its largest capacity has
    bits (one a power of two up to it)."""
    from repro_torch.models import common as cm
    caps = {}
    for cap, dtype in cm._HOST:
        caps.setdefault(str(dtype), []).append(cap)
    return {"buffers": len(cm._HOST),
            "capacities": {d: sorted(c) for d, c in caps.items()},
            "bound": sum(max(c).bit_length() for c in caps.values()),
            "bytes": sum(b.numel() * b.element_size()
                         for b in cm._HOST.values())}


def attn_model_worker(spec: dict, out: str) -> int:
    """One rank of the attn model phase, started by torchrun: the family
    models (:func:`attn_family_serve`), then the paged scheduler
    (:func:`attn_sched_serve`) and the pinned buffers left
    (:func:`host_buffers`); rank 0 writes ``out/attn_model.json``."""
    import os
    import torch
    from repro_torch.launch import mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = mesh.init_rank_world(spec["data"], model=MODEL_M,
                                 backend=os.environ["REPRO_TORCH_BACKEND"],
                                 device_type=spec["device"])
    try:
        families = {}
        for arch in spec["archs"]:
            t0 = time.perf_counter()
            families[arch] = attn_family_serve(spec, world, arch)
            if families[arch] is not None:
                families[arch]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sched = attn_sched_serve(spec, world)
        host = gather_to_rank0(world, host_buffers())
        if world.torch_rank == 0:
            sched["seconds"] = time.perf_counter() - t0
            (Path(out) / "attn_model.json").write_text(json.dumps({
                "world": {"data": spec["data"], "model": MODEL_M,
                          "backend": world.backend},
                "families": families, "sched": sched, "host": host,
                "worker_s": time.perf_counter() - t_start}))
        return 0
    finally:
        mesh.shutdown()


def attn_model_phase(spec: dict, out: Path,
                     timeout: int = ATTN_MODEL_TIMEOUT) -> dict:
    """Start ``spec["data"] x MODEL_M`` ranks through torchrun (gloo, all
    on one card, model minor) and hold what they report to checks (b)-(f)
    (check (a) is :func:`check_attn_model_launches`).  A rank that fails
    fails the phase.  ``out`` is the phase's own directory (emptied
    first)."""
    import shutil
    t_phase = time.perf_counter()
    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torchrun_s = run_torchrun(spec["data"] * MODEL_M,
                              ATTN_MODEL_WORKER_FLAG, spec, out, timeout)
    stats = json.loads((out / "attn_model.json").read_text())
    stats["spec"], stats["torchrun_s"] = spec, torchrun_s
    for arch, f in stats["families"].items():
        if not f["serve_check"]["ok"]:                          # check (b)
            raise AssertionError(f"check (b), {arch}: {f['serve_check']}")
        if not (f["finite"] and f["in_vocab"]):                 # check (f)
            raise AssertionError(f"check (f), {arch}: non-finite logits or "
                                 f"tokens outside the vocab")
        fault = f["cross_without_g_check"]                      # check (e)
        if fault is not None and fault["ok"]:
            raise AssertionError(f"check (e), {arch}: check (b) holds on a "
                                 f"cross-attention without g: {fault}")
    if not any(f["cross_without_g_check"] is not None
               for f in stats["families"].values()):
        raise AssertionError("check (e): no cross-attention fault was run")
    sched = stats["sched"]
    if not sched["ok"]:                                         # check (c)
        raise AssertionError(f"check (c): {json.dumps(sched)[:4000]}")
    if not sched["fault_fails"]:                                # check (e)
        raise AssertionError("check (e): check (c) holds on paged steps "
                             "that keep the rank-local pick")
    if not sched["disagg"]["ok"]:                               # check (g)
        raise AssertionError(f"check (g): {json.dumps(sched['disagg'])}")
    if not sched["disagg"]["flip_fails"]:                       # check (g)
        raise AssertionError("check (g): a wire that flipped one bit on "
                             "rank 1 passed")
    for h in stats["host"]:                                     # check (d)
        if h["buffers"] > h["bound"]:
            raise AssertionError(f"check (d): {h['buffers']} pinned buffers "
                                 f"> the bound {h['bound']}: {h}")
    stats["phase_s"] = time.perf_counter() - t_phase
    return stats


def check_attn_model_launches(stats) -> None:
    """Check (a) of the attn model phase, on every rank: a family model's
    prefill launches K3 :func:`k3_per_prefill` times (whisper by role:
    one an encoder layer, a decoder layer and a cross-attention), its
    decode steps nothing, K1, K2 and K4 never; the scheduler's prefills K3
    once a layer, its decode steps nothing; the dense model-world runs
    of check (c) alike."""
    spec = stats["spec"]
    zero = dict.fromkeys((K1, K2, K3, K4), 0)
    for arch, f in stats["families"].items():
        cfg = attn_model_cfg(spec, arch)
        want = dict(zero, **{K3: k3_per_prefill(cfg)})
        roles = ({"encoder": cfg.encoder_layers, "decoder": cfg.n_layers,
                  "cross": cfg.n_layers} if cfg.family == "audio"
                 else {"decoder": cfg.n_layers})
        for r in f["ranks"]:
            pre, *steps = [{k: l[k] for k in zero} for l in r["launches"]]
            if pre != want or any(s != zero for s in steps) \
                    or r["k3_roles"] != roles:
                raise AssertionError(
                    f"{arch} rank {r['rank']}: launches {r['launches']}, "
                    f"K3 by role {r['k3_roles']}; a prefill {want} "
                    f"({roles}), a decode step none")
    cfg = attn_model_cfg(spec, spec["sched_arch"], spec["sched_layers"])
    want = dict(zero, **{K3: cfg.n_layers})
    for r in stats["sched"]["ranks"]:
        runs = [r["launches"], r["disagg_launches"]] + [
            {"prefill": d[:1], "decode": d[1:]} for d in r["dense_launches"]]
        for l in runs:
            pre = [{k: x[k] for k in zero} for x in l["prefill"]]
            dec = [{k: x[k] for k in zero} for x in l["decode"]]
            if any(x != want for x in pre) or any(x != zero for x in dec):
                raise AssertionError(
                    f"scheduler rank {r['rank']}: prefills {pre}, decode "
                    f"steps {dec}; a prefill {want}, a decode step none")


def print_attn_model(stats: dict, card: str):
    """The attn model phase's lines: each family model's serving over the
    ranks against the one-rank run, the scheduler's, the pinned
    buffers."""
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    print(f"attn model [{card}]: data {stats['world']['data']} x model "
          f"{MODEL_M} ranks over {stats['world']['backend']} on one card; "
          f"phase {stats['phase_s']:.1f} s (torchrun "
          f"{stats['torchrun_s']:.1f} s)", flush=True)
    for arch, f in stats["families"].items():
        e, g = f["serve_check"], f["cross_without_g_check"]
        layers = (f"{f['encoder_layers']} + {f['n_layers']}"
                  if f["family"] == "audio" else f"{f['n_layers']}")
        print(f"attn model {arch} [{card}]: full width, {layers} layers, "
              f"{f['input_positions']} input positions a dp rank, "
              f"{f['new']} decode steps; serving by rank "
              f"{[round(r['run_s'], 2) for r in f['ranks']]} s, peak "
              f"{[gib(r['peak']) for r in f['ranks']]} GiB, K3 by role "
              f"{f['ranks'][0]['k3_roles']}; one-rank reference "
              f"{f['ref_s']:.1f} s; {f['seconds']:.1f} s in all", flush=True)
        print(f"attn model {arch} checks: (b) prefill and first decode "
              f"logits max abs diff {e['prefill_and_first_step_max_abs_diff']}"
              f" (limit {e['limit']:.4g}, largest gap "
              f"{e['max_logit_gap']:.4g})"
              f", tokens equal {e['tokens_equal']} of the "
              f"{e['tokens_compared']} whose margin exceeds the gap "
              f"({e['near_ties_equal']} of {e['near_ties']} others); (f) "
              f"finite {f['finite']}, in vocab {f['in_vocab']}"
              + (f"; (e) without g in the cross-attention: diffs "
                 f"{g['prefill_and_first_step_max_abs_diff']}, (b) holds "
                 f"{g['ok']}" if g else ""), flush=True)
    s = stats["sched"]
    dec = s["ranks"]
    decode_ms = [round(statistics.median(r["times_ms"]["decode"]), 1)
                 for r in dec]
    checks = s["checks"].values()
    worst = max(max(c["prefill_and_first_step_max_abs_diff"])
                / c["largest_logit"] for c in checks)
    print(f"attn model scheduler [{card}]: {s['arch']} full width, "
          f"{s['n_layers']} layers, {len(s['prompt_lens'])} requests of "
          f"{s['prompt_lens']} tokens, {s['new']} new, pool "
          f"{s['n_blocks']} blocks: {s['evictions']} evictions "
          f"{s['preemptions']}, {s['n_decode_steps']} decode steps, shapes "
          f"{s['decode_shapes']}; run by rank "
          f"{[round(r['wall_s'], 2) for r in dec]} s (decode ms a step, "
          f"median by rank {decode_ms}; prefill ms by rank "
          f"{[[round(x, 1) for x in r['times_ms']['prefill']] for r in dec]})"
          f", dense runs "
          f"{[round(r['dense_s'], 2) for r in dec]} s, peak "
          f"{[gib(r['peak']) for r in dec]} GiB; {s['seconds']:.1f} s in all",
          flush=True)
    print(f"attn model scheduler checks: (c) ranks' tokens, admissions, "
          f"preemptions and shapes equal {s['ranks_equal']}, every request "
          f"within (b)'s rule of its dense model-world run "
          f"{all(c['ok'] for c in checks)} (largest "
          f"prefill/first-step diff {worst:.3g} of the largest logit, "
          f"tokens equal {sum(c['tokens_equal'] for c in checks)} of "
          f"{sum(c['tokens_compared'] for c in checks)} "
          f"compared); (e) the rank-local pick: ranks equal "
          f"{s['fault_ranks_equal']}, first parting step by request "
          f"{s['fault_parting_step']}, (c) fails {s['fault_fails']}; (d) "
          f"pinned buffers by rank "
          f"{[(h['buffers'], h['bound'], h['bytes']) for h in stats['host']]}"
          f" (count, bound, bytes), capacities "
          f"{stats['host'][0]['capacities']}", flush=True)
    g = s["disagg"]
    for r in g["ranks"]:
        print(f"attn model disaggregated rank {r['rank']} [{card}]: tokens, "
              f"admissions, preemptions and shapes == the colocated run's "
              f"{r['equal_to_colocated']}; {r['transfer']['requests']} "
              f"inserts, {r['transfer']['blocks']} blocks, "
              f"{r['transfer']['payload_bytes']} bytes ({r['bytes_a_block']} "
              f"a block: the rank's KV heads; want {r['want']}); staging ms "
              f"{ {k: round(v, 3) for k, v in r['staging_ms'].items()} }; "
              f"run {r['wall_s']:.2f} s", flush=True)
    print(f"attn model disaggregated checks: (g) {g['ok']}; a wire flipping "
          f"one bit of request 0 on rank 1: tokens part by rank "
          f"{g['flip_tokens_differ']}, (g) fails {g['flip_fails']}",
          flush=True)


def ep_model_spec(device="cuda", smoke: bool = False, new: int = MODEL_NEW,
                  prompts: Optional[dict] = None,
                  moe_layers: int = MOE_LAYERS,
                  xlstm_layers: Optional[int] = None) -> dict:
    """What the ep model phase's ranks run (JSON, handed to every rank on
    its command line): the models of ``EP_MODEL_ARCHS`` served over data
    ``EP_MODEL_DATA`` x model ``MODEL_M`` ranks, one prompt of
    ``prompts[arch]`` tokens a dp rank and ``new`` decode steps; the moe
    models at ``moe_layers`` (their capacity factor :func:`ep_model_cfg`'s),
    xlstm at ``xlstm_layers`` (None: its own depth) in
    ``EP_MODEL_DTYPES``'s dtype; the planted faults of
    ``EP_MODEL_FAULTS``."""
    return {"device": device, "smoke": smoke, "data": EP_MODEL_DATA,
            "archs": list(EP_MODEL_ARCHS), "new": new,
            "prompts": dict(prompts or EP_MODEL_PROMPTS),
            "layers": dict(dict.fromkeys(MOE_ARCHS, moe_layers),
                           **{XLSTM_ARCH: xlstm_layers}),
            "faults": dict(EP_MODEL_FAULTS),
            "dtypes": dict(EP_MODEL_DTYPES)}


def ep_model_cfg(spec: dict, arch: str):
    """``arch`` at the spec's depth and dtype; a moe model at capacity
    factor E/k, where the capacity is the tokens and nothing drops."""
    cfg = model_cfg({"arch": arch, "smoke": spec["smoke"]},
                    spec["layers"][arch])
    cfg = cfg.variant(dtype=spec["dtypes"].get(arch, cfg.dtype))
    if cfg.family == "moe":
        cfg = cfg.variant(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def record_routes():
    """Checks (b) and (c)'s recorder: ``moe.router_topk`` wrapped to
    append, at each call, its expert choices (T, k) on the host and the
    count of routed all-reduces so far (``common.tp_stats``); returns (the
    list, the undo)."""
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    calls, inner = [], moe.router_topk

    def recorded(cfg, logits):
        idx, gate, aux = inner(cfg, logits)
        calls.append((idx.cpu(), cm.tp_stats()["routed"]))
        return idx, gate, aux
    moe.router_topk = recorded

    def undo():
        moe.router_topk = inner
    return calls, undo


def routed_by_call(calls) -> list:
    """The routed all-reduces each moe layer's call made: the count from
    its router to the next call's (to now for the last)."""
    from repro_torch.models import common as cm
    marks = [c[1] for c in calls] + [cm.tp_stats()["routed"]]
    return [b - a for a, b in zip(marks, marks[1:])]


def ep_fault(name: str):
    """Check (d)'s planted faults, on every rank alike (so that the
    collectives still pair); returns the undo.  ``rows_of_rank_0``: every
    rank gathers the slot map's rows of experts [0, E/M) (rank 0's) for
    its own experts' weights; ``z_from_next_rank``: every mLSTM reads the
    ``z`` columns of the next model rank's heads."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.models import moe, xlstm
    if name == "rows_of_rank_0":
        offset = moe.expert_offset
        moe.expert_offset = lambda cfg, mw: 0
        return lambda: setattr(moe, "expert_offset", offset)
    if name != "z_from_next_rank":
        raise ValueError(f"unknown fault {name!r}")
    preacts, gather = xlstm._mlstm_preacts, cm.gather_from_model

    def rolled(x, mw):
        inner, z = gather(x, mw).chunk(2, dim=-1)
        return torch.cat([inner, z.roll(-(z.shape[-1] // mw.size), -1)],
                         -1)

    def faulty(cfg, p, x, mw=None):
        cm.gather_from_model = rolled
        try:
            return preacts(cfg, p, x, mw)
        finally:
            cm.gather_from_model = gather
    xlstm._mlstm_preacts = faulty
    return lambda: setattr(xlstm, "_mlstm_preacts", preacts)


def route_parting(got: list, want: list) -> Optional[float]:
    """The share of (token, choice) assignments of one run whose expert is
    not among the token's k experts in the other's recorded routes (two
    near-equal gates may swap places in the order without a change of
    route), over every moe call; None without a moe call."""
    if not want:
        return None
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} moe calls against {len(want)}")
    n = sum(w.numel() for w in want)
    return sum(int((~(g[..., :, None] == w[..., None, :]).any(-1)).sum())
               for g, w in zip(got, want)) / n


def ep_family_serve(spec: dict, world, arch: str) -> Optional[dict]:
    """One model of the ep model phase on this rank: its slices of random
    weights from ``EP_MODEL_SEED`` (drawn by the rank-sliced init), this
    dp rank's prompt through ``greedy_run`` with the routes, the routed
    all-reduces and the dropped shares recorded, then again with the
    arch's planted fault.  Every rank frees its slices before rank 0
    serves the whole model on every prompt, fed the model world's tokens
    (and the faulty run's), and the others wait for it, so that the
    whole model never shares the card with the slices.  Rank 0 returns
    the checks; the other ranks ``None``."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    device, mw = world.device, world.model_world
    on_card = device.type == "cuda"
    cfg = ep_model_cfg(spec, arch)
    prompt, new = spec["prompts"][arch], spec["new"]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device, model_world=mw)
    params = model.init(torch.Generator(device=device).manual_seed(
        EP_MODEL_SEED))
    _sync(device)
    t1 = time.perf_counter()
    param_bytes = tree_bytes(params)
    prompts = torch.as_tensor(np.random.default_rng(EP_MODEL_SEED).integers(
        0, cfg.vocab, (spec["data"], prompt)), dtype=torch.int64,
        device=device)
    mine = slice(world.rank, world.rank + 1)
    max_len = prompt + new
    calls, undo = record_routes()
    tp0, times = cm.tp_stats(), []
    try:
        with moe.recording_dropped() as drops:
            logits, tokens, launches = greedy_run(
                model, params, prompts[mine], max_len, new, times=times)
        routed = routed_by_call(calls)
    finally:
        undo()
    tp1 = cm.tp_stats()
    run_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() if on_card else None
    fault = None
    if arch in spec["faults"]:
        undo = ep_fault(spec["faults"][arch])
        try:
            fault = greedy_run(model, params, prompts[mine], max_len, new)[:2]
        finally:
            undo()
    del params, model
    if on_card:
        torch.cuda.empty_cache()
    everyone = gather_to_rank0(world, {
        "rank": world.torch_rank, "launches": launches, "routed": routed,
        "drops": [float(d) for d in drops], "init_s": t1 - t0,
        "run_s": run_s, "times_ms": times, "peak": peak,
        "param_bytes": param_bytes,
        "tp": {k: tp1[k] - tp0[k] for k in ("s", "bytes", "ops")},
        "routes": [c[0] for c in calls] if world.torch_rank == 0 else None,
        "served": (logits, tokens, fault) if world.model_rank == 0
        else None})
    out = None
    if world.torch_rank == 0:
        out = ep_reference(spec, cfg, everyone, prompts, device)
    dist.barrier()                    # the whole model gone from the card
    return out


def ep_reference(spec: dict, cfg, everyone: list, prompts, device) -> dict:
    """Rank 0's half of :func:`ep_family_serve`: the whole model on every
    prompt, fed the model world's tokens and then the faulty run's, and
    the checks of one model."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    on_card = device.type == "cuda"
    new, max_len = spec["new"], prompts.shape[1] + spec["new"]
    served = [r.pop("served") for r in everyone]
    served = [x for x in served if x is not None]
    w_logits = torch.cat([x[0] for x in served])
    w_tokens = torch.cat([x[1] for x in served])
    routes = [r.pop("routes") for r in everyone][0]
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(
        EP_MODEL_SEED))
    calls, undo = record_routes()
    ref_times = []
    try:
        with moe.recording_dropped() as drops:
            ref_logits, ref_tokens, ref_launches = greedy_run(
                model, params, prompts, max_len, new, feed=w_tokens,
                times=ref_times)
    finally:
        undo()
    v = cfg.vocab
    check = serve_compare(w_logits[..., :v], w_tokens, ref_logits[..., :v],
                          ref_tokens)
    fault_check = None
    if served[0][2] is not None:
        f_logits = torch.cat([x[2][0] for x in served])
        f_tokens = torch.cat([x[2][1] for x in served])
        fr_logits, fr_tokens, _ = greedy_run(model, params, prompts,
                                             max_len, new, feed=f_tokens)
        fault_check = serve_compare(f_logits[..., :v], f_tokens,
                                    fr_logits[..., :v], fr_tokens)
    ref_peak = torch.cuda.max_memory_allocated() if on_card else None
    ref_bytes = tree_bytes(params)
    del params, model
    if on_card:
        torch.cuda.empty_cache()
    return {"arch": cfg.name, "family": cfg.family, "dtype": cfg.dtype,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_experts": cfg.n_experts, "top_k": cfg.top_k,
            "capacity_factor": cfg.capacity_factor,
            "n_chunks": (moe._chunking(cfg, prompts.shape[1], None)[0]
                         if cfg.family == "moe" else None),
            "prompt": int(prompts.shape[1]), "new": new,
            "ranks": everyone, "ref_launches": ref_launches,
            "ref_drops": [float(d) for d in drops],
            "ref_times_ms": ref_times, "ref_peak": ref_peak,
            "ref_param_bytes": ref_bytes,
            "ref_s": time.perf_counter() - t0, "serve_check": check,
            "route_parting": route_parting(routes, [c[0] for c in calls]),
            "fault": spec["faults"].get(cfg.name),
            "fault_check": fault_check,
            "finite": bool(torch.isfinite(w_logits[..., :v]).all()),
            "in_vocab": bool(((w_tokens >= 0) & (w_tokens < v)).all()),
            "tokens": w_tokens.tolist()}


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors."""
    from repro_torch.core import tree as tr
    return sum(a.numel() * a.element_size() for a in tr.tree_leaves(tree))


def ep_model_worker(spec: dict, out: str) -> int:
    """One rank of the ep model phase, started by torchrun: each model of
    ``spec["archs"]`` (:func:`ep_family_serve`); rank 0 writes
    ``out/ep_model.json``."""
    import os
    import torch
    from repro_torch.launch import mesh

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = mesh.init_rank_world(spec["data"], model=MODEL_M,
                                 backend=os.environ["REPRO_TORCH_BACKEND"],
                                 device_type=spec["device"])
    try:
        families = {}
        for arch in spec["archs"]:
            t0 = time.perf_counter()
            families[arch] = ep_family_serve(spec, world, arch)
            if families[arch] is not None:
                families[arch]["seconds"] = time.perf_counter() - t0
        if world.torch_rank == 0:
            (Path(out) / "ep_model.json").write_text(json.dumps({
                "world": {"data": spec["data"], "model": MODEL_M,
                          "backend": world.backend},
                "families": families,
                "card_bytes": (torch.cuda.get_device_properties(
                    world.device).total_memory
                    if world.device.type == "cuda" else None),
                "worker_s": time.perf_counter() - t_start}))
        return 0
    finally:
        mesh.shutdown()


def ep_model_phase(spec: dict, out: Path,
                   timeout: int = EP_MODEL_TIMEOUT) -> dict:
    """Start ``spec["data"] x MODEL_M`` ranks through torchrun (gloo, all
    on one card, model minor) and hold what they report to checks (b)-(e)
    (check (a) is :func:`check_ep_model_launches`).  A rank that fails
    fails the phase.  ``out`` is the phase's own directory (emptied
    first)."""
    import shutil
    t_phase = time.perf_counter()
    out = Path(out)
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torchrun_s = run_torchrun(spec["data"] * MODEL_M, EP_MODEL_WORKER_FLAG,
                              spec, out, timeout)
    stats = json.loads((out / "ep_model.json").read_text())
    stats["spec"], stats["torchrun_s"] = spec, torchrun_s
    for arch, f in stats["families"].items():
        if f["family"] == "moe":              # (b) drop-free, both runs
            drops = [d for r in f["ranks"] for d in r["drops"]] \
                + f["ref_drops"]
            if any(d > 0 for d in drops):
                raise AssertionError(f"check (b), {arch}: a run dropped at "
                                     f"capacity factor "
                                     f"{f['capacity_factor']}: {drops}")
        if not f["serve_check"]["ok"]:                          # check (b)
            raise AssertionError(f"check (b), {arch}: {f['serve_check']}")
        check_ep_collectives(stats, arch, f)                    # check (c)
        fault = f["fault_check"]                                # check (d)
        if arch in spec["faults"] and (fault is None or fault["ok"]):
            raise AssertionError(f"check (d), {arch}: check (b) holds with "
                                 f"{spec['faults'][arch]}: {fault}")
        if not (f["finite"] and f["in_vocab"]):                 # check (e)
            raise AssertionError(f"check (e), {arch}: non-finite logits or "
                                 f"tokens outside the vocab")
    stats["phase_s"] = time.perf_counter() - t_phase
    return stats


def check_ep_collectives(stats: dict, arch: str, f: dict) -> None:
    """Check (c) of one model: on every rank each moe layer's prefill made
    ``n_chunks`` routed all-reduces and each decode step's one (one
    chunk), xlstm none; each rank's peak memory under half the card."""
    new = f["new"]
    for r in f["ranks"]:
        if f["family"] == "moe":
            n_moe = len(r["routed"]) // (new + 1)
            want = [f["n_chunks"]] * n_moe + [1] * (n_moe * new)
        else:
            want = []
        if r["routed"] != want:
            raise AssertionError(f"check (c), {arch} rank {r['rank']}: "
                                 f"routed all-reduces by moe call "
                                 f"{r['routed']}, want {want}")
        card = stats["card_bytes"]
        if card is not None and not r["peak"] < card / 2:
            raise AssertionError(f"check (c), {arch} rank {r['rank']}: peak "
                                 f"{r['peak']} bytes, not under half the "
                                 f"card's {card}")


def check_ep_model_launches(stats) -> None:
    """Check (a) of the ep model phase, on every rank: a moe model's
    prefill launches K3 once a layer, xlstm's none, a decode step nothing,
    K1, K2 and K4 never."""
    spec = stats["spec"]
    zero = dict.fromkeys((K1, K2, K3, K4), 0)
    for arch, f in stats["families"].items():
        cfg = ep_model_cfg(spec, arch)
        want = dict(zero, **{K3: cfg.n_layers if cfg.family == "moe"
                             else 0})
        for r in f["ranks"]:
            pre, *steps = [{k: l[k] for k in zero} for l in r["launches"]]
            if pre != want or any(s != zero for s in steps):
                raise AssertionError(
                    f"{arch} rank {r['rank']}: launches {r['launches']}; a "
                    f"prefill {want}, a decode step none")


def print_ep_model(stats: dict, card: str):
    """The ep model phase's lines: each model's serving over the ranks
    against the one-rank run."""
    gib = lambda b: round(b / 2 ** 30, 2) if b is not None else None
    print(f"ep model [{card}]: data {stats['world']['data']} x model "
          f"{MODEL_M} ranks over {stats['world']['backend']} on one card; "
          f"phase {stats['phase_s']:.1f} s (torchrun "
          f"{stats['torchrun_s']:.1f} s)", flush=True)
    for arch, f in stats["families"].items():
        e, g, rs = f["serve_check"], f["fault_check"], f["ranks"]
        decode = [round(statistics.median(r["times_ms"][1:]), 1) for r in rs]
        moe_part = (f", {f['n_experts']} experts top-{f['top_k']} (each "
                    f"rank {f['n_experts'] // MODEL_M}), capacity factor "
                    f"{f['capacity_factor']}, {f['n_chunks']} chunks a "
                    f"prefill" if f["family"] == "moe" else "")
        print(f"ep model {arch} [{card}]: full width, {f['n_layers']} "
              f"layers, {f['dtype']}{moe_part}; one prompt of "
              f"{f['prompt']} tokens a dp rank, {f['new']} decode steps; "
              f"init by rank "
              f"{[round(r['init_s'], 2) for r in rs]} s ("
              f"{[gib(r['param_bytes']) for r in rs]} GiB of slices; whole "
              f"{gib(f['ref_param_bytes'])}), serving by rank "
              f"{[round(r['run_s'], 2) for r in rs]} s (prefill ms "
              f"{[round(r['times_ms'][0], 1) for r in rs]}, decode ms a step "
              f"{decode}; one rank whole "
              f"{round(f['ref_times_ms'][0], 1)} / "
              f"{round(statistics.median(f['ref_times_ms'][1:]), 1)}), "
              f"collectives a run by rank "
              f"{[(r['tp']['ops'], round(r['tp']['s'], 2)) for r in rs]} "
              f"(count, s), peak by rank {[gib(r['peak']) for r in rs]} GiB "
              f"(one rank whole {gib(f['ref_peak'])}); one-rank reference "
              f"{f['ref_s']:.1f} s after the ranks freed their slices; "
              f"{f['seconds']:.1f} s in all", flush=True)
        print(f"ep model {arch} checks: (b) prefill and first decode "
              f"logits max abs diff {e['prefill_and_first_step_max_abs_diff']}"
              f" (limit {e['limit']:.4g}, largest gap "
              f"{e['max_logit_gap']:.4g}), tokens equal {e['tokens_equal']} "
              f"of the {e['tokens_compared']} whose margin exceeds the gap "
              f"({e['near_ties_equal']} of {e['near_ties']} others)"
              + (f", assignments routed to another expert than one rank's "
                 f"{f['route_parting']:.4g}, drops none"
                 if f["family"] == "moe" else "")
              + f"; (c) routed all-reduces by moe call on rank 0 "
              f"{rs[0]['routed'][:4]}...; (d) "
              + (f"{f['fault']}: diffs "
                 f"{g['prefill_and_first_step_max_abs_diff']}, (b) holds "
                 f"{g['ok']}" if g else "none planted")
              + f"; (e) finite {f['finite']}, in vocab {f['in_vocab']}",
              flush=True)


def rg_train_config():
    from repro_torch.configs import get_config
    return get_config(RG_ARCH).variant(n_layers=RG_TRAIN_LAYERS)


def rg_train_k4_per_step(cfg, replicas: int) -> int:
    """K4 launches of one training step: each superblock recurrent layer
    scans forward, again when its superblock is recomputed, and backward (3
    a replica); each trailing recurrent layer forward and backward (2)."""
    from repro_torch.models import rglru
    n_sb, tail = rglru.layout(cfg)
    return replicas * (3 * 2 * n_sb + 2 * tail)


def check_rg_train_launches(stats, k4_per_step: int):
    """Check (b) of the recurrentgemma training phase: every step launched
    K4 ``k4_per_step`` times, all on the TMA route, and K3 never."""
    for e in stats["steps"]:
        got = (e["k4"], e["k4_tma"], e["k4_walk"], e["k3"])
        if got != (k4_per_step, k4_per_step, 0, 0):
            raise AssertionError(f"step {e['t']}: K4 / TMA / walk / K3 "
                                 f"launched {got}; expected K4 "
                                 f"{k4_per_step}, all TMA, and no K3")


def scan_train_phase(device="cuda", shape=SCAN_TRAIN_SHAPE):
    """Check (e): ``rglru_scan_train`` at one training layer's shape, f32
    with h0: its output and its gradients for a, x and h0 bit-identical
    between K4 and the plain scan on the same CUDA tensors; then the times
    of the forward K4 launch, of the whole backward (autograd), of the
    backward's K4 launch and of its flips, and the plain version's forward
    and backward, against the scan's byte bound."""
    import torch
    from repro_torch.kernels import rglru_scan as rg

    b, s, w = shape
    gen = torch.Generator(device=device).manual_seed(3)
    a, x, h0 = k4_inputs(gen, b, s, w, True, "float32", device)
    dh = torch.randn((b, s, w), generator=gen, device=device)

    def graph(scan):
        ins = [t.clone().requires_grad_(True) for t in (a, x, h0)]
        return ins, rg.rglru_scan_train(*ins, scan=scan)

    def run(scan):
        ins, h = graph(scan)
        return [h.detach()] + list(torch.autograd.grad(h, ins, dh))

    got, want = run(rg.rglru_scan_cuda), run(rg.rglru_scan_plain)
    torch.cuda.synchronize()
    names = ("h", "da", "dx", "dh0")
    equal = {n: bool(torch.equal(g, v)) for n, g, v in zip(names, got, want)}
    err = max(float((g - v).abs().max()) for g, v in zip(got, want))
    if not all(equal.values()):
        raise AssertionError(f"rglru_scan_train through K4 differs from the "
                             f"plain scan at {shape}: {equal}, max abs err "
                             f"{err}")
    del got, want
    a_rev, dh_rev = rg.reverse_inputs(a, dh)
    g_rev = rg.rglru_scan_cuda(a_rev, dh_rev)
    ins, h = graph(rg.rglru_scan_cuda)
    plain_ins, plain_h = graph(rg.rglru_scan_plain)
    out = {
        "shape": [b, s, w], "dtype": "float32", "h0": True, "equal": equal,
        "max_abs_err": err,
        "forward_ms": time_ms(lambda: rg.rglru_scan_cuda(a, x, h0)),
        "backward_ms": time_ms(lambda: torch.autograd.grad(
            h, ins, dh, retain_graph=True)),
        "backward_scan_ms": time_ms(lambda: rg.rglru_scan_cuda(a_rev,
                                                               dh_rev)),
        # the reversed inputs (a shifted and flipped, dh flipped) and the
        # flip of the reversed scan's result
        "flips_ms": time_ms(lambda: (rg.reverse_inputs(a, dh),
                                     g_rev.flip(1))),
        "plain_forward_ms": time_ms(lambda: rg.rglru_scan_plain(a, x, h0),
                                    iters=5, warmup=1),
        "plain_backward_ms": time_ms(lambda: torch.autograd.grad(
            plain_h, plain_ins, dh, retain_graph=True), iters=5, warmup=1),
        "bound_ms": scan_bound_ms(b, s, w, 4, 4, True), "bound_by": "bytes",
    }
    del a, x, h0, dh, a_rev, dh_rev, g_rev, ins, h, plain_ins, plain_h
    torch.cuda.empty_cache()
    return out


def paper_steps(averager: str, n_phases: int) -> int:
    """The steps a paper-phase run takes: ``PAPER_STEPS`` for WAGMA and
    local SGD, else what the baseline's check (b) needs (one step a phase
    and one more where ``PAPER_BASELINE_STEPS`` names none)."""
    if averager in ("wagma", "local_sgd"):
        return PAPER_STEPS
    return PAPER_BASELINE_STEPS.get(averager, n_phases + 1)


def paper_train_run(cfg, averager: str, device="cuda",
                    steps: Optional[int] = None, replicas: int = PAPER_P,
                    group_size: int = PAPER_S, tau: int = PAPER_TAU,
                    seq_len: int = PAPER_SEQ, global_batch: int = PAPER_GB,
                    profile: bool = False, checks=None):
    """``steps`` Trainer steps under ``averager`` (by default
    :func:`paper_steps`) with checks (b) and (c); returns the run's numbers
    and each step's launches for check (a).

    Check (b): WAGMA's groups bit-identical after each group step, its
    fused K1/K2 average bit-identical to the plan's plain per-leaf average
    of the same rows on the first step of each phase offset, and every row
    identical after a sync; Allreduce-SGD's and Eager-SGD's rows
    bit-identical after every step; local SGD's rows apart before its first
    sync and identical after it; the gossip baselines' mix of the pre-mix
    rows on ``device``, on the first step of each phase, bit-identical to
    the same averager's mix of those rows copied to the CPU (IEEE adds and
    one product).  Every other step passes only if its phase's check did.
    The checks' time is kept out of the step's.  With ``checks`` (a
    :class:`GossipChecks`) the CPU mixes run on its thread behind the
    steps that follow: ``phase_checks`` then holds a gossip run's futures,
    and :meth:`GossipChecks.settle` holds its steps to them."""
    import torch
    from repro_torch.core import grouping
    from repro_torch.core import tree as tr
    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.sgd import Optimizer
    from repro_torch.train import train_step

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, replicas, device=device, averager=averager,
                      group_size=group_size, tau=tau, learning_rate=PAPER_LR,
                      seq_len=seq_len, global_batch=global_batch, seed=0)
    avg = trainer.averager
    if steps is None:
        steps = paper_steps(averager, avg.n_phases)
    split = {"grads": 0.0, "update": 0.0, "average": 0.0}
    timed = split_timer(split, device)
    trainer.opt = Optimizer(trainer.opt.init,
                            timed("update", trainer.opt.update))
    plan = trainer.plan() if averager == "wagma" else None
    ref_plan = per_leaf_plan(plan) if plan is not None else None
    checked = {}                     # phase -> that phase's check passed
    check_s = [0.0]
    comm, raw_comm = timed("average", avg.comm), avg.comm

    def comm_checked(tree, phase):
        if phase in checked or (plan is None and averager not in GOSSIP):
            return comm(tree, phase)
        t0 = time.perf_counter()
        host = None if plan is not None else tr.tree_map(
            lambda a: a.to("cpu", copy=True), tree)
        check_s[0] += time.perf_counter() - t0
        out = comm(tree, phase)
        t0 = time.perf_counter()
        if plan is not None:
            checked[phase] = fused_equals_per_leaf(ref_plan, out, tree,
                                                   plan.offsets[phase])
        elif checks is not None:
            checked[phase] = checks.submit(raw_comm, host, phase, out)
            del host
        else:
            want = raw_comm(host, phase)
            checked[phase] = all(torch.equal(a.cpu(), b) for a, b in zip(
                tr.tree_leaves(out), tr.tree_leaves(want)))
            del host, want
        check_s[0] += time.perf_counter() - t0
        return out

    avg.comm = comm_checked
    avg.sync = timed("average", avg.sync)
    value_and_grad = train_step.value_and_grad
    train_step.value_and_grad = timed("grads", value_and_grad)
    n_buckets = n_stages = None
    if plan is not None:
        n_buckets = plan.class_layout(0).n_buckets
        n_stages = len(plan.runs_for_offset(0)[0].bits)
    log = []
    try:
        ops.reset_launch_counts()
        for t in range(steps):
            split.update(grads=0.0, update=0.0, average=0.0)
            check_s[0] = 0.0
            before = ops.launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            loss = trainer.step_once(t)
            _sync(device)
            step_s = time.perf_counter() - t0 - check_s[0]
            after = ops.launch_counts()
            sync = avg.sync_due(t)
            phase = avg.phase_for_step(t)
            params = trainer.state.params
            if averager == "wagma" and not sync:
                groups = grouping.groups_for_offset(replicas, group_size,
                                                    plan.offsets[phase])
                same, differ = group_rows_agree(params, groups)
                ok = same and differ and checked.get(phase, False)
            elif averager in ("allreduce", "eager_sgd") or sync:
                ok = group_rows_agree(params, (tuple(range(replicas)),))[0]
            elif averager == "local_sgd":
                ok = not group_rows_agree(params,
                                          (tuple(range(replicas)),))[0]
            elif checks is not None:     # its verdict: GossipChecks.settle
                ok = phase in checked
            else:
                ok = checked.get(phase, False)
            if not ok:                                          # check (b)
                raise AssertionError(f"{averager} step {t} (sync {sync}): "
                                     f"the replica rows fail check (b)")
            log.append({"t": t, "loss": loss, "sync": sync,
                        "phase": None if sync else phase,
                        "step_ms": step_s * 1e3,
                        "check_ms": check_s[0] * 1e3,
                        **{k + "_ms": v * 1e3 for k, v in split.items()},
                        "other_ms": (step_s - sum(split.values())) * 1e3,
                        "skipped": trainer.last_metrics["skipped_nonfinite"],
                        **{key: after[name] - before[name] for key, name in (
                            ("k1", K1), ("k2", K2), ("k3", K3), ("k4", K4))}})
    finally:
        train_step.value_and_grad = value_and_grad
    window = train_profile(trainer, steps, device) if profile else None
    bad = [e for e in log if not math.isfinite(e["loss"]) or e["skipped"]]
    if bad:                                                     # check (c)
        raise AssertionError(f"{averager}: non-finite losses or skipped "
                             f"updates: {bad}")
    steady = log[1:] or log
    med = lambda key: statistics.median(e[key] for e in steady)
    out = {
        "averager": averager, "replicas": replicas, "n_buckets": n_buckets,
        "n_phases": avg.n_phases, "n_steps": steps,
        "expected_k1_k2_per_group_step": (expected_combine_launches(
            n_buckets, n_stages) if averager == "wagma" else (0, 0)),
        "losses": [e["loss"] for e in log], "steps": log,
        "median_step_ms": med("step_ms"),
        "tokens_per_s": global_batch * seq_len / (med("step_ms") / 1e3),
        "median_split_ms": {k: med(k + "_ms") for k in
                            ("grads", "update", "average", "other")},
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if on_card else None),
        # phase -> WAGMA's fused average equal to the per-leaf one, or a
        # gossip mix on the card equal to the CPU's
        "phase_checks": dict(sorted(checked.items())),
        "profile": window,
    }
    del trainer
    if on_card:
        torch.cuda.empty_cache()
    return out


class GossipChecks:
    """The paper phase's gossip checks (b) on a thread: each submitted
    check copies the card's mix to the host, then computes the CPU mix of
    the pre-mix rows on the thread and compares them there, while the
    steps that follow run on the card.  At most ``depth`` checks are
    pending at once (each holds two host copies of the 16 replicas).
    The CPU mixes read the plan caches the main thread reads too; they
    add entries to none (the card run compiled the plan already)."""

    def __init__(self, depth: int = 2):
        import threading
        from concurrent.futures import ThreadPoolExecutor
        self.pool = ThreadPoolExecutor(1)
        self.room = threading.BoundedSemaphore(depth)

    def submit(self, mix, host, phase, out):
        """Check that ``mix(host, phase)`` equals ``out`` (the card's)
        bit for bit, on the thread; returns the future."""
        from repro_torch.core import tree as tr
        self.room.acquire()
        try:
            got = tr.tree_map(lambda a: a.to("cpu", copy=True), out)
        except BaseException:
            self.room.release()
            raise

        def check():
            import torch
            try:
                want = mix(host, phase)
                return all(torch.equal(a, b) for a, b in zip(
                    tr.tree_leaves(got), tr.tree_leaves(want)))
            finally:
                self.room.release()
        return self.pool.submit(check)

    def settle(self, paper: dict) -> float:
        """Wait for every gossip run's checks, put their verdicts in its
        ``phase_checks`` and fail check (b) where one is false; returns
        the seconds waited."""
        t0 = time.perf_counter()
        try:
            for name, run in paper.items():
                if name not in GOSSIP:
                    continue
                run["phase_checks"] = {p: f.result() for p, f in
                                       run["phase_checks"].items()}
                if not all(run["phase_checks"].values()):  # check (b)
                    raise AssertionError(
                        f"{name}: the card's mix differs from the CPU's by "
                        f"phase {run['phase_checks']}")
        finally:
            self.pool.shutdown(wait=True)
        return time.perf_counter() - t0


def check_paper_launches(stats):
    """Check (a) of the paper phase: WAGMA's group steps launch the K1 and
    K2 counts the wavefront schedule predicts; every sync, and every step
    of a baseline, launches neither; no training step launches K3 or K4."""
    want_k1, want_k2 = stats["expected_k1_k2_per_group_step"]
    for e in stats["steps"]:
        group = stats["averager"] == "wagma" and not e["sync"]
        want = (want_k1, want_k2, 0, 0) if group else (0, 0, 0, 0)
        got = (e["k1"], e["k2"], e["k3"], e["k4"])
        if got != want:
            raise AssertionError(f"{stats['averager']} step {e['t']}: K1, "
                                 f"K2, K3, K4 launched {got}; expected "
                                 f"{want}")


def fig5_phase(cfg, device="cuda", **kw) -> dict:
    """Fig. 5's two runs (``repro_torch.train.stragglers.run``, at the paper
    phase's settings unless ``kw`` overrides them) and their final losses:
    the means of the last ``FIG5_TAIL`` iterations and WAGMA's over
    Allreduce-SGD's."""
    from repro_torch.train import stragglers
    kw = {"replicas": PAPER_P, "group_size": PAPER_S, "tau": PAPER_TAU,
          "steps": FIG5_STEPS, "seq_len": PAPER_SEQ,
          "rows": PAPER_GB // PAPER_P, "learning_rate": PAPER_LR, **kw}
    runs = {mode: stragglers.run(cfg, mode, device=device, **kw)
            for mode in stragglers.MODES}
    tail = {mode: statistics.fmean(r["losses"][-FIG5_TAIL:])
            for mode, r in runs.items()}
    return {"runs": runs, "tail_mean": tail,
            "ratio": tail["wagma"] / tail["allreduce"]}


def tally_k3_roles(run):
    """``run()`` with ``ops.flash_attention`` wrapped to tally each call's
    role in an encoder-decoder (decoder: causal; encoder: non-causal over
    as many keys as queries; cross: non-causal over the source's keys);
    returns (``run()``'s result, the tally, K3's launches meanwhile)."""
    from repro_torch.kernels import ops
    roles = Counter()
    inner = ops.flash_attention

    def tallied(q, k, v, *, causal=True, **kw):
        roles["decoder" if causal else "encoder" if q.shape[1] == k.shape[1]
              else "cross"] += 1
        return inner(q, k, v, causal=causal, **kw)

    before = ops.launch_counts()[K3]
    ops.flash_attention = tallied
    try:
        out = run()
    finally:
        ops.flash_attention = inner
    return out, dict(roles), ops.launch_counts()[K3] - before


def make_requests(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=N_REQUESTS)
    return [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
            for n in lens]


def load_model(cfg, device="cuda", seed: int = 0):
    """The port's model with random weights from a seeded torch generator
    on ``device``; returns (model, params, seconds)."""
    import torch
    from repro_torch.models.registry import build_model

    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    return model, params, time.perf_counter() - t0


def serve_phase(model, params, device="cuda", seed: int = 0,
                n_requests: int = N_REQUESTS, sched_cls=None, **sched_kw):
    """Serve the first ``n_requests`` of the ragged request set through
    ``sched_cls`` (``ServeScheduler``, or ``DisaggregatedScheduler`` with
    ``sched_kw``) and check it against the dense path; returns the run's
    numbers, with its tokens and, for a disaggregated run, its transfer
    numbers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import (DisaggregatedScheduler, Request,
                                   ServeScheduler, build_prefill,
                                   build_serve_step)

    cfg = model.cfg
    prompts = make_requests(cfg, seed)[:n_requests]
    n_blocks = 1 + SPARE_BLOCKS + sum(
        -(-(len(p) + 1) // BLOCK_SIZE) for p in prompts)
    sched = (sched_cls or ServeScheduler)(
        model, params, n_blocks=n_blocks, block_size=BLOCK_SIZE,
        max_blocks_per_req=MAX_BLOCKS_PER_REQ, max_batch=MAX_BATCH,
        **sched_kw)

    prefill_log, decode_log, first_step = [], [], {}
    inner_prefill, inner_decode = sched._do_prefill, sched._decode

    def timed_prefill(req, table):
        _sync(device)
        t = time.perf_counter()
        first = inner_prefill(req, table)
        _sync(device)
        done = time.perf_counter()
        prefill_log.append((req.rid, req.prompt_len, done - t,
                            done - run_start))
        return first

    def timed_decode(params, pool, tables, tokens, positions):
        batch = list(sched.running)         # rows in the order the step built
        _sync(device)
        t = time.perf_counter()
        pool, nxt, logits = inner_decode(params, pool, tables, tokens,
                                         positions)
        _sync(device)
        decode_log.append((int(tables.shape[0]), time.perf_counter() - t))
        for i, req in enumerate(batch):
            if (req.rid in CHECKED_REQUESTS and req.rid not in first_step
                    and int(positions[i]) == req.prompt_len):
                first_step[req.rid] = (int(tokens[i]), logits[i].float().cpu())
        return pool, nxt, logits

    sched._do_prefill, sched._decode = timed_prefill, timed_decode
    for i, p in enumerate(prompts):
        sched.submit(Request(i, p, MAX_NEW))
    ops.reset_launch_counts()
    run_start = time.perf_counter()
    outs = sched.run()
    _sync(device)
    wall_s = time.perf_counter() - run_start
    launches = ops.launch_counts()

    if sorted(outs) != list(range(n_requests)):
        raise AssertionError(f"unfinished requests: {sorted(outs)}")
    for rid, toks in outs.items():
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    if sched.blocks.evictions < 1:
        raise AssertionError("the pool never preempted a request")
    if sched.blocks.n_free != n_blocks - 1:
        raise AssertionError("blocks leaked")

    # dense, uncontended reference for the checked requests
    s_view = MAX_BLOCKS_PER_REQ * BLOCK_SIZE
    dense_prefill = build_prefill(model, s_view)
    dense_step = build_serve_step(model)
    checks = []
    for rid in CHECKED_REQUESTS:
        p = prompts[rid]
        tokens = torch.as_tensor(p[None], dtype=torch.int64, device=device)
        logits, caches = dense_prefill(params, {"tokens": tokens})
        cols = torch.arange(logits.shape[-1], device=device)
        first = int(torch.where(cols < cfg.vocab, logits[0, -1],
                                -1e30).argmax())
        if first != outs[rid][0]:
            raise AssertionError(f"request {rid}: paged first token "
                                 f"{outs[rid][0]} != dense {first}")
        tok, paged_logits = first_step[rid]
        if tok != first:
            raise AssertionError(f"request {rid}: first decode fed {tok}")
        _, dense_logits, _ = dense_step(
            params, caches, torch.tensor([[first]], device=device), len(p))
        ref = dense_logits[0, -1, :cfg.vocab].float().cpu()
        got = paged_logits[:cfg.vocab]
        diff = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not math.isfinite(diff) or diff > LOGIT_RTOL * scale:
            raise AssertionError(f"request {rid}: paged vs dense logits "
                                 f"differ by {diff} > {LOGIT_RTOL} * {scale}")
        checks.append({"rid": rid, "prompt_len": len(p), "first_token": first,
                       "logits_max_abs_diff": diff, "logits_max_abs": scale})

    prefill_tokens = sum(n for _, n, _, _ in prefill_log)
    prefill_s = sum(t for _, _, t, _ in prefill_log)
    ttft = {}                  # run start (all arrive at 0) to first token
    for rid, _, _, at in prefill_log:
        ttft.setdefault(rid, at)
    by_bucket = {}
    for n_pad, t in decode_log:
        by_bucket.setdefault(n_pad, []).append(t * 1e3)
    transfer = None
    if isinstance(sched, DisaggregatedScheduler):
        conn = sched.connector
        transfer = dict(dataclasses.asdict(conn.stats), **sched.staging,
                        link=dataclasses.asdict(conn.link),
                        bytes_sent=conn.transport.bytes_sent,
                        messages_sent=conn.transport.messages_sent)
    return {
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "wall_s": wall_s,
        "prompt_lens": [len(p) for p in prompts], "n_blocks": n_blocks,
        "n_prefills": sched.n_prefills, "evictions": sched.blocks.evictions,
        "preempted": sorted(r.rid for r in sched.finished.values()
                            if r.preemptions),
        "n_decode_steps": sched.n_decode_steps,
        "decode_shapes": sorted(sched.decode_shapes_compiled),
        "launches": launches,
        "prefill_tokens": prefill_tokens,
        "prefill_tok_per_s": prefill_tokens / prefill_s,
        "prefill_ms": [(rid, n, t * 1e3) for rid, n, t, _ in prefill_log],
        "ttft_s": [ttft[rid] for rid in range(n_requests)],
        "decode_ms_per_step": {str(k): float(np.mean(v))
                               for k, v in sorted(by_bucket.items())},
        "decode_steps_per_bucket": {str(k): len(v)
                                    for k, v in sorted(by_bucket.items())},
        "checks": checks,
        "tokens": [outs[rid] for rid in range(n_requests)],
        "transfer": transfer,
    }


def profile_phase(model, params, device="cuda", seed: int = 0,
                  decode_steps: int = 4):
    """Kernel time by name and the device's busy share over two windows of
    a fresh scheduler on the same requests: the first step (every prefill
    plus one decode step at batch 8) and the next ``decode_steps`` decode
    steps.  Device numbers are None where the profiler saw no CUDA kernel."""
    from torch.profiler import profile
    from repro_torch.serve import Request, ServeScheduler

    prompts = make_requests(model.cfg, seed)
    sched = ServeScheduler(model, params, n_blocks=1 + MAX_BATCH
                           * MAX_BLOCKS_PER_REQ, block_size=BLOCK_SIZE,
                           max_blocks_per_req=MAX_BLOCKS_PER_REQ,
                           max_batch=MAX_BATCH)
    for i, p in enumerate(prompts):
        sched.submit(Request(i, p, MAX_NEW))
    windows = {}
    for name, n_steps in (("admit_all_prefills_plus_1_decode", 1),
                          (f"{decode_steps}_decode_steps_batch_8",
                           decode_steps)):
        _sync(device)
        with profile(activities=_activities(device)) as prof:
            t = time.perf_counter()
            for _ in range(n_steps):
                sched.step()
            _sync(device)
            wall_ms = (time.perf_counter() - t) * 1e3
        windows[name] = _window(prof, wall_ms)
    return windows


def check_serving_launches(stats, n_layers: int):
    """Check (a) of a paged serving run: K3 once a layer a prefill, K1,
    K2 and K4 never."""
    served = stats["launches"]
    want = n_layers * stats["n_prefills"]
    if served[K3] != want or served[K1] or served[K2] or served[K4]:
        raise AssertionError(f"kernels launched on the serving path "
                             f"{served}; expected K3 {n_layers} layers x "
                             f"{stats['n_prefills']} prefills = {want}")


def check_disaggregated(want_tokens, got_tokens, transfer, prefill_lens,
                        cfg):
    """Handoff check (a): the disaggregated run's tokens equal the
    colocated run's for every request; the connector took one insert a
    prefill (a preempted request ships again) and shipped each prefill's
    ``ceil((prompt_len + 1) / BLOCK_SIZE)`` blocks, ``kv_payload_bytes``
    of one block each."""
    from repro_torch.serve.kv_transfer import kv_payload_bytes
    differ = [rid for rid, (a, b) in enumerate(zip(want_tokens, got_tokens))
              if a != b]
    if differ or len(want_tokens) != len(got_tokens):
        raise AssertionError(f"check (a): disaggregated tokens differ from "
                             f"the colocated ones for requests {differ}")
    blocks = sum(-(-(n + 1) // BLOCK_SIZE) for n in prefill_lens)
    want = {"requests": len(prefill_lens), "blocks": blocks,
            "payload_bytes": blocks * kv_payload_bytes(cfg, BLOCK_SIZE)}
    got = {k: transfer[k] for k in want}
    if got != want:
        raise AssertionError(f"check (a): the connector counted {got}, "
                             f"the prefills need {want}")


def bit_flip_transport(at: int, bit: int):
    """The in-process wire with one planted fault (check (d)): bit ``bit``
    of element ``at`` of the payload, counted across the messages in
    order, flipped in the first send."""
    import torch
    from repro_torch.serve import InProcessTransport

    class BitFlip(InProcessTransport):
        def send(self, rid, messages):
            out = super().send(rid, messages)
            if self.messages_sent == len(out):          # the first send
                i = at
                for m in out:
                    if i < m.numel():
                        ints = m.view({2: torch.int16,
                                       4: torch.int32}[m.element_size()])
                        ints[i] ^= 1 << bit
                        break
                    i -= m.numel()
            return out

    return BitFlip()


def first_v_element(cfg, n_ship: int, connector,
                    kv_heads: Optional[int] = None,
                    block_size: int = BLOCK_SIZE) -> int:
    """Where the connector packs the first V element (layer 0, block 0,
    position 0, KV head 0, dim 0) of a request's ``n_ship`` blocks of
    ``kv_heads`` heads (a model rank's; by default all): its index in the
    payload, counted across the messages in order.  Every later decode
    step of every layer-0 query attends to it."""
    from repro_torch.core import bucketing
    from repro_torch.core import tree as tr
    from repro_torch.models.transformer import torch_dtype
    spec = tr.Spec((cfg.n_layers, n_ship, block_size,
                    kv_heads or cfg.n_kv_heads, cfg.hd), torch_dtype(cfg))
    tree = {"global": {"k": spec, "v": spec}}
    layout = bucketing.layout_for(tree, max_bucket_bytes=connector.budget_for(
        bucketing.tree_payload_bytes(tree)))
    slot = layout.slots[1]
    return sum(layout.bucket_sizes[:slot.bucket]) + slot.offset


def serve_tokens(model, params, prompts, sched_cls=None, **sched_kw):
    """Tokens of ``prompts`` served alone through ``sched_cls`` (a pool
    that holds them all at full length: no preemption)."""
    from repro_torch.serve import Request, ServeScheduler
    sched = (sched_cls or ServeScheduler)(
        model, params, n_blocks=1 + len(prompts) * MAX_BLOCKS_PER_REQ,
        block_size=BLOCK_SIZE, max_blocks_per_req=MAX_BLOCKS_PER_REQ,
        max_batch=MAX_BATCH, **sched_kw)
    for i, p in enumerate(prompts):
        sched.submit(Request(i, p, MAX_NEW))
    outs = sched.run()
    return [outs[i] for i in range(len(prompts))], sched


def planted_fault(model, params, prefill_params, seed: int = 0):
    """Check (d): one request served colocated and disaggregated with a
    wire that flips the top exponent bit of its first V element must fail
    check (a).  Returns what (a) said."""
    from repro_torch.serve import DisaggregatedScheduler, LinkCostedConnector
    from repro_torch.models.transformer import torch_dtype
    cfg = model.cfg
    prompt = make_requests(cfg, seed)[0]
    want, _ = serve_tokens(model, params, [prompt])
    probe = LinkCostedConnector()
    at = first_v_element(cfg, -(-(len(prompt) + 1) // BLOCK_SIZE), probe)
    bit = 8 * torch_dtype(cfg).itemsize - 2
    conn = LinkCostedConnector(transport=bit_flip_transport(at, bit))
    got, sched = serve_tokens(model, params, [prompt],
                              DisaggregatedScheduler,
                              prefill_params=prefill_params, connector=conn)
    try:
        check_disaggregated(want, got, dataclasses.asdict(conn.stats),
                            [len(prompt)], cfg)
    except AssertionError as e:
        return {"prompt_len": len(prompt), "element": at, "bit": bit,
                "error": str(e), "tokens_differ_from": next(
                    (i for i, (a, b) in enumerate(zip(want[0], got[0]))
                     if a != b), None)}
    raise AssertionError("check (d): a wire that flipped one bit passed "
                         "check (a)")


def handoff_phase(model, params, colocated, device="cuda", seed: int = 0):
    """Checks (a) and (d) of the handoff phase on the serving phase's model
    and requests: ``DisaggregatedScheduler`` with the prefill worker's own
    weight copy against the colocated run ``colocated`` (``serve_phase``'s
    numbers), then the colocated run again (its TTFT is (b)'s yardstick:
    the first run also pays the card's warm-up).  Returns the
    disaggregated run's numbers (with (b)'s transfer numbers), the second
    colocated run's and (d)'s."""
    from repro_torch.core import tree as tr
    from repro_torch.serve import DisaggregatedScheduler
    import torch
    prefill_params = tr.tree_map(torch.clone, params)
    run = serve_phase(model, params, device, seed,
                      sched_cls=DisaggregatedScheduler,
                      prefill_params=prefill_params)
    again = serve_phase(model, params, device, seed)
    for want in (colocated, again):
        check_disaggregated(want["tokens"], run["tokens"], run["transfer"],
                            [n for _, n, _ in run["prefill_ms"]], model.cfg)
    fault = planted_fault(model, params, prefill_params, seed)
    return run, again, fault


def print_handoff(colo, colo_again, run, fault, card):
    """Checks (a) and (d) and the staging numbers (b) of the handoff
    phase; TTFT against the colocated runs before and after the
    disaggregated one."""
    t = run["transfer"]
    n = t["requests"]
    rate = lambda s: t["payload_bytes"] / s / 1e9 if s else float("nan")
    link = t["link"]
    print(f"handoff (a) [{card}]: {run['arch']} {run['n_layers']} layers "
          f"{run['dtype']}: disaggregated tokens == colocated for all "
          f"{len(run['tokens'])} requests; {run['n_prefills']} prefills "
          f"({run['evictions']} evictions), K3 {run['launches'][K3]} "
          f"launches; {t['blocks']} blocks, {t['payload_bytes']} bytes in "
          f"{t['messages']} messages ({t['bytes_sent']} bytes on the wire)",
          flush=True)
    print(f"handoff (b) [{card}]: {t['payload_bytes'] / n:.0f} bytes a "
          f"prefill; host clock with synchronize over the {n} prefills: "
          f"device to host {t['d2h_s'] * 1e3:.3f} ms "
          f"({rate(t['d2h_s']):.2f} GB/s), connector (pack, transport "
          f"copy, unpack) {t['connector_s'] * 1e3:.3f} ms "
          f"({rate(t['connector_s']):.2f} GB/s), host to device "
          f"{t['h2d_s'] * 1e3:.3f} ms ({rate(t['h2d_s']):.2f} GB/s)",
          flush=True)
    for name, r in (("colocated (first)", colo), ("disaggregated", run),
                    ("colocated (after)", colo_again)):
        print(f"handoff (b) [{card}]: {name}: TTFT max "
              f"{max(r['ttft_s']):.4f} s mean "
              f"{statistics.mean(r['ttft_s']):.4f} s, prefill "
              f"{r['prefill_tok_per_s']:.0f} tok/s, wall {r['wall_s']:.3f} "
              f"s", flush=True)
    print(f"handoff (b): modeled on the {link['name']} class (alpha "
          f"{link['alpha']:.1e} s a message, {1 / link['beta'] / 1e9:.0f} "
          f"GB/s: the JAX package's model constants, not a time of this "
          f"machine): {t['modeled_seconds'] * 1e3:.3f} ms for the {n} "
          f"transfers", flush=True)
    print(f"handoff (d) [{card}]: bit {fault['bit']} of payload element "
          f"{fault['element']} (request 0's first V element, prompt "
          f"{fault['prompt_len']} tokens) flipped on the wire: check (a) "
          f"failed as it must (tokens apart from position "
          f"{fault['tokens_differ_from']}): {fault['error']}", flush=True)


def check_post_sync_consolidation(trainer, t: int) -> dict:
    """Check (c), first half: right after the tau-sync of step ``t`` every
    replica row is the same, and ``Trainer.consolidated()`` must be row 0
    of every leaf bit for bit."""
    import torch
    from repro_torch.core import tree as tr
    if not trainer.averager.sync_due(t):
        raise AssertionError(f"step {t} is not a sync step")
    t0 = time.perf_counter()
    cons = trainer.consolidated()
    _sync(trainer.device)
    seconds = time.perf_counter() - t0
    rows = tr.tree_leaves(trainer.state.params)
    bad = [i for i, (c, a) in enumerate(zip(tr.tree_leaves(cons), rows))
           if c.dtype != a.dtype or not torch.equal(c, a[0])]
    if bad:
        raise AssertionError(f"check (c): the consolidation after the sync "
                             f"at step {t} differs from row 0 in leaves "
                             f"{bad}")
    return {"step": t, "leaves": len(rows), "consolidate_s": seconds,
            "elements": sum(c.numel() for c in tr.tree_leaves(cons))}


def trained_serving(trainer, device="cuda", seed: int = 0,
                    n_requests: int = HANDOFF_REQUESTS) -> dict:
    """Check (c), second half: the trainer's consolidated weights, where
    the replica rows differ by group, served at the trained depth through
    both schedulers on ``n_requests`` requests (each run's first decode
    step held to the dense path within ``LOGIT_RTOL``, ``serve_phase``):
    the same tokens, the disaggregated run's transfer as check (a)."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.serve import DisaggregatedScheduler
    rows = tr.tree_leaves(trainer.state.params)
    if all(torch.equal(a[0], a[-1]) for a in rows):
        raise AssertionError("check (c): the replica rows do not differ")
    weights = trainer.consolidated()
    colo = serve_phase(trainer.model, weights, device, seed,
                       n_requests=n_requests)
    disagg = serve_phase(trainer.model, weights, device, seed,
                         n_requests=n_requests,
                         sched_cls=DisaggregatedScheduler,
                         prefill_params=tr.tree_map(torch.clone, weights))
    check_disaggregated(colo["tokens"], disagg["tokens"], disagg["transfer"],
                        [n for _, n, _ in disagg["prefill_ms"]],
                        trainer.model.cfg)
    return {"colocated": colo, "disaggregated": disagg}


def _masked_argmax(logits, vocab: int):
    """Greedy pick over (..., V) logits, vocab-padding columns excluded."""
    return logits[..., :vocab].argmax(-1)


def check_fresh_prefill(name: str, diff: float, scale: float):
    """Check (b): the last decode step's logits within ``LOGIT_RTOL`` of
    the largest logit of a fresh prefill."""
    if not math.isfinite(diff) or diff > LOGIT_RTOL * scale:
        raise AssertionError(f"{name} decode vs fresh prefill logits "
                             f"differ by {diff} > {LOGIT_RTOL} * {scale}")


def rg_serve_phase(model, params, device="cuda", batch: int = RG_BATCH,
                   prompt_len: int = RG_PROMPT, new: int = RG_NEW,
                   seed: int = 0, extra=None, pos_offset: int = 0,
                   fresh_check: bool = True):
    """Prefill ``batch`` equal prompts and decode ``new`` greedy tokens
    through ``build_prefill``/``build_serve_step`` with checks (b) and (d);
    returns the run's numbers with each prefill's and decode step's kernel
    launches for check (a).  ``extra`` joins every prefill's batch (an
    encoder-decoder's ``src`` or ``frames``, a VLM's ``patches``);
    ``pos_offset`` is the positions before the prompt (a VLM's patches),
    so the first decode step is at ``pos_offset + prompt_len``.  Without
    ``fresh_check`` check (b)'s difference and scale are returned but
    judged by the caller (a moe model, whose capacity may drop)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import build_prefill, build_serve_step

    cfg = model.cfg
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len))
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device=device)
    extra = extra or {}
    max_len = prompt_len + new
    prefill = build_prefill(model, max_len)
    step = build_serve_step(model)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    _sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens, **extra})
    fed = [_masked_argmax(logits[:, -1], cfg.vocab)[:, None]]
    _sync(device)
    ttft_s = time.perf_counter() - t0
    prefill_launches = ops.launch_counts()
    finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    step_ms, step_launches = [], []
    for j in range(new - 1):
        _sync(device)
        ops.reset_launch_counts()
        t = time.perf_counter()
        nxt, logits, caches = step(params, caches, fed[-1],
                                   pos_offset + prompt_len + j)
        _sync(device)
        step_ms.append((time.perf_counter() - t) * 1e3)
        step_launches.append(ops.launch_counts())
        finite &= bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        fed.append(nxt)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else None)
    generated = torch.cat(fed, dim=1)                        # (B, new)
    if not finite:                                           # check (d)
        raise AssertionError(f"non-finite logits on the {cfg.name} path")
    if not bool(((generated >= 0) & (generated < cfg.vocab)).all()):
        raise AssertionError(f"tokens outside the vocab: {generated}")

    # check (b): the last decode step against a fresh prefill over the
    # prompt and every token the steps were fed
    last = logits[:, -1, :cfg.vocab].float()
    del caches
    ref_logits, _ = prefill(params, {"tokens": torch.cat(
        [tokens, generated[:, :-1]], dim=1), **extra})
    ref = ref_logits[:, -1, :cfg.vocab].float()
    diff = float((last - ref).abs().max())
    scale = float(ref.abs().max())
    if fresh_check:
        check_fresh_prefill(cfg.name, diff, scale)
    steady = step_ms[1:] or step_ms
    return {
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "batch": batch, "prompt_len": prompt_len,
        "new_tokens": new, "ttft_s": ttft_s,
        "prefill_tok_per_s": batch * prompt_len / ttft_s,
        "decode_ms_per_step": statistics.median(steady),
        "decode_ms": step_ms, "max_memory_allocated": peak,
        "prefill_launches": prefill_launches, "step_launches": step_launches,
        "logits_max_abs_diff": diff, "logits_max_abs": scale,
        "tokens": generated.cpu().tolist(),
    }


def serve_inputs(cfg, batch: int, seed: int = 0, device="cuda",
                 src_len: int = WMT_SRC) -> dict:
    """What a family's prefill takes beside the tokens, from numpy seeded by
    ``seed + 1``: whisper's frame embeddings and a VLM's patch embeddings
    (standard normal x 0.02, float32), transformer-wmt's ``src_len``
    source tokens; nothing for a decoder-only LM."""
    import torch
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "audio" and not cfg.encoder_frames:
        return {"src": torch.as_tensor(rng.integers(
            0, cfg.vocab, (batch, src_len)), dtype=torch.int64,
            device=device)}
    n = {"audio": cfg.encoder_frames, "vlm": cfg.n_patches}.get(cfg.family)
    if n is None:
        return {}
    emb = rng.standard_normal((batch, n, cfg.d_model)) * 0.02
    return {"frames" if cfg.family == "audio" else "patches":
            torch.as_tensor(emb.astype(np.float32), device=device)}


def family_serve_phase(cfg, device="cuda", batch: int = FAMILY_BATCH,
                       prompt_len: int = WHISPER_PROMPT,
                       new: int = FAMILY_NEW,
                       f32_prompt: Optional[int] = None,
                       f32_steps: int = WHISPER_F32_STEPS, seed: int = 0,
                       src_len: int = WMT_SRC,
                       profile_prompt: Optional[int] = None):
    """Serve ``cfg`` at full size with random weights: ``batch`` prompts of
    ``prompt_len`` tokens (after :func:`serve_inputs`), ``new`` greedy
    tokens through ``build_prefill``/``build_serve_step``
    (``rg_serve_phase``: checks (b) and (d), each prefill's and step's
    launches for check (a)); for an encoder-decoder one more prefill with
    K3's calls tallied by role; two profiler windows (``rg_profile``,
    over ``profile_prompt`` tokens, ``prompt_len`` by default); check (c)
    on a float32 copy at batch 1 over ``f32_prompt`` tokens (``prompt_len``
    by default) and ``f32_steps`` decode steps."""
    import torch
    from repro_torch.serve import build_prefill

    model, params, init_s = load_model(cfg, device, seed)
    extra = serve_inputs(cfg, batch, seed, device, src_len)
    offset = cfg.n_patches if cfg.family == "vlm" else 0
    stats = rg_serve_phase(model, params, device, batch=batch,
                           prompt_len=prompt_len, new=new, seed=seed,
                           extra=extra, pos_offset=offset)
    roles = launched = None
    if cfg.family == "audio":
        tokens = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (batch, prompt_len)), dtype=torch.int64,
            device=device)
        _, roles, launched = tally_k3_roles(lambda: build_prefill(
            model, prompt_len + 1)(params, {"tokens": tokens, **extra}))
    windows = rg_profile(model, params, device, batch=batch,
                         prompt_len=profile_prompt or prompt_len, seed=seed,
                         extra=extra, pos_offset=offset)
    f32 = rg_f32_check(cfg, params, device, prompt_len=f32_prompt or
                       prompt_len, steps=f32_steps,
                       extra={k: v[:1] for k, v in extra.items()},
                       pos_offset=offset)
    del model, params
    # the positions a prefill runs: the encoder's input or the patches,
    # and the prompt
    inputs = sum(v.shape[1] for v in extra.values()) + prompt_len
    return {**stats, "init_s": init_s, "input_positions": inputs,
            "prefill_positions_per_s": batch * inputs / stats["ttft_s"],
            "k3_roles": roles, "k3_role_launches": launched,
            "profile": windows, "float32_check": f32}


def moe_dropfree_check(cfg, params, device="cuda", batch: int = FAMILY_BATCH,
                       prompt_len: int = MOE_PROMPT, new: int = FAMILY_NEW,
                       seed: int = 0,
                       capacity_factor: float = MOE_DROPFREE_FACTOR):
    """Check (b) of a moe model: ``rg_serve_phase`` on the same weights at
    ``capacity_factor``, where its two prefills and every decode step must
    drop nothing (a capacity that drops may legally route a prefill of
    another length otherwise); its last decode step must then match the
    fresh prefill to 5% of the largest logit.  Check (d) holds in any
    case."""
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    model = build_model(cfg.variant(capacity_factor=capacity_factor),
                        device=device)
    with moe.recording_dropped() as calls:
        stats = rg_serve_phase(model, params, device, batch=batch,
                               prompt_len=prompt_len, new=new, seed=seed,
                               fresh_check=False)
    drops = [float(d) for d in calls]
    n_moe = moe.layout(cfg)[0]
    if len(drops) != n_moe * (new + 1):
        raise AssertionError(f"{cfg.name}: {len(drops)} moe calls recorded,"
                             f" expected {n_moe} a prefill and decode step")
    if any(d > 0 for d in drops):
        raise AssertionError(f"{cfg.name} at capacity factor "
                             f"{capacity_factor}: a prefill or decode step "
                             f"dropped (largest share {max(drops)}); check "
                             f"(b) needs a drop-free capacity")
    check_fresh_prefill(cfg.name, stats["logits_max_abs_diff"],
                        stats["logits_max_abs"])
    return {"capacity_factor": capacity_factor,
            "capacity": moe._chunking(model.cfg, batch * prompt_len,
                                      None)[1],
            "logits_max_abs_diff": stats["logits_max_abs_diff"],
            "logits_max_abs": stats["logits_max_abs"]}


def moe_f32_check(cfg, params, device="cuda", n_experts: int = MOE_F32_EXPERTS,
                  prompt_len: int = MOE_F32_PROMPT,
                  steps: int = MOE_F32_STEPS):
    """Check (c) of a moe model (``rg_f32_check``) on the first
    ``n_experts`` experts of every moe layer (router columns and expert
    weights; top-k unchanged) at capacity factor 2E/k, so that the
    capacity is at least the tokens and nothing drops (asserted)."""
    from repro_torch.models import moe
    cut = cfg.variant(n_experts=n_experts,
                      capacity_factor=2.0 * n_experts / cfg.top_k)
    pm = params["blocks"]["moe"]["moe"]
    pm = dict(pm, router=pm["router"][..., :n_experts],
              **{k: pm[k][:, :n_experts] for k in ("we1", "we3", "we2")})
    blocks = dict(params["blocks"], moe=dict(params["blocks"]["moe"], moe=pm))
    with moe.recording_dropped() as calls:
        f32 = rg_f32_check(cut, dict(params, blocks=blocks), device,
                           prompt_len=prompt_len, steps=steps)
    drops = [float(d) for d in calls]
    if any(d > 0 for d in drops):
        raise AssertionError(f"float32 {cfg.name}: drops {drops} at a "
                             f"capacity of at least the tokens")
    return dict(f32, n_experts=n_experts)


def moe_serve_phase(cfg, device="cuda", batch: int = FAMILY_BATCH,
                    prompt_len: int = MOE_PROMPT, new: int = FAMILY_NEW,
                    seed: int = 0,
                    dropfree_factor: float = MOE_DROPFREE_FACTOR,
                    f32_experts: int = MOE_F32_EXPERTS,
                    f32_prompt: int = MOE_F32_PROMPT,
                    f32_steps: int = MOE_F32_STEPS):
    """Serve a moe ``cfg`` with random weights: ``batch`` prompts of
    ``prompt_len`` tokens, ``new`` greedy tokens through ``build_prefill``/
    ``build_serve_step`` at the config's capacity (checks (a) and (d), the
    timed prefill's dropped share); two profiler windows; check (b) at
    the drop-free ``dropfree_factor`` (:func:`moe_dropfree_check`); check (c) on a float32 copy of
    ``f32_experts`` experts (:func:`moe_f32_check`).  Returns the numbers
    with the keys :func:`print_family_serving` reads."""
    from repro_torch.core import tree as tr
    from repro_torch.models import moe

    model, params, init_s = load_model(cfg, device, seed)
    n_params = sum(a.numel() for a in tr.tree_leaves(params))
    param_bytes = sum(a.numel() * a.element_size()
                      for a in tr.tree_leaves(params))
    with moe.recording_dropped() as calls:
        stats = rg_serve_phase(model, params, device, batch=batch,
                               prompt_len=prompt_len, new=new, seed=seed,
                               fresh_check=False)
    n_moe = moe.layout(cfg)[0]
    # the timed prefill's moe layers, then each decode step's (the fresh
    # prefill's come last)
    drops = [float(d) for d in calls]
    windows = rg_profile(model, params, device, batch=batch,
                         prompt_len=prompt_len, seed=seed)
    dropfree = moe_dropfree_check(cfg, params, device, batch=batch,
                                  prompt_len=prompt_len, new=new, seed=seed,
                                  capacity_factor=dropfree_factor)
    f32 = moe_f32_check(cfg, params, device, n_experts=f32_experts,
                        prompt_len=f32_prompt, steps=f32_steps)
    del model, params
    return {**stats, "init_s": init_s, "n_params": n_params,
            "param_bytes": param_bytes, "n_experts": cfg.n_experts,
            "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
            "capacity": moe._chunking(cfg, batch * prompt_len, None)[1],
            "prefill_dropped": statistics.mean(drops[:n_moe]),
            "decode_dropped_max": max(drops[n_moe:n_moe * new]),
            "logits_max_abs_diff": dropfree["logits_max_abs_diff"],
            "logits_max_abs": dropfree["logits_max_abs"],
            "dropfree": dropfree, "input_positions": prompt_len,
            "prefill_positions_per_s": batch * prompt_len / stats["ttft_s"],
            "k3_roles": None, "k3_role_launches": None, "profile": windows,
            "float32_check": f32}


def moe_config(arch: str):
    """``arch`` at published width, experts, top-k and vocab, depth cut to
    ``MOE_LAYERS``."""
    from repro_torch.configs import get_config
    return get_config(arch).variant(n_layers=MOE_LAYERS)


def print_moe_serving(label, r, card):
    """The moe-specific numbers of a moe phase, after
    :func:`print_family_serving`'s."""
    b = r["dropfree"]
    print(f"{label} [{card}]: {r['n_params']} params "
          f"({r['param_bytes'] / 1e9:.2f} GB), {r['n_experts']} experts "
          f"top-{r['top_k']}, initialised in {r['init_s']:.2f} s; capacity "
          f"factor {r['capacity_factor']} (C {r['capacity']} at the prompt):"
          f" timed prefill dropped {r['prefill_dropped']:.4f} of its "
          f"assignments, decode steps at most {r['decode_dropped_max']}; "
          f"check (b) at capacity factor {b['capacity_factor']} (C "
          f"{b['capacity']}, drop-free); check (c) on "
          f"{r['float32_check']['n_experts']} experts", flush=True)


def check_encdec_roles(stats, cfg):
    """Check (a), by role: one prefill called K3 once for each encoder
    layer, and once for each decoder layer's self- and cross-attention,
    and launched it that many times."""
    want = {"encoder": cfg.encoder_layers, "decoder": cfg.n_layers,
            "cross": cfg.n_layers}
    if stats["k3_roles"] != want or \
            stats["k3_role_launches"] != sum(want.values()):
        raise AssertionError(f"K3 by role {stats['k3_roles']}, "
                             f"{stats['k3_role_launches']} launches; "
                             f"expected {want}")


def check_rg_launches(stats, n_rec: int, n_attn: int):
    """Check (a): each prefill ran K4 once per recurrent layer, all on the
    TMA route, and K3 once per attention layer; each decode step K4 once
    per recurrent layer, all on the walk route, and K3 never; K1/K2
    never."""
    runs = [("prefill", stats["prefill_launches"], n_attn, K4_TMA)] + [
        (f"decode step {i}", got, 0, K4_WALK)
        for i, got in enumerate(stats["step_launches"])]
    for name, got, k3, route in runs:
        if (got[K4], got[route], got[K3], got[K1], got[K2]) != (
                n_rec, n_rec, k3, 0, 0):
            raise AssertionError(f"{name}: launched {got}; expected K4 "
                                 f"{n_rec}, all {route}, K3 {k3}")


def rg_f32_check(cfg, params, device="cuda", prompt_len: int = RG_F32_PROMPT,
                 steps: int = RG_F32_STEPS, seed: int = 1, extra=None,
                 pos_offset: int = 0):
    """Check (c): a float32 copy of the model, batch 1: prefill, ``steps``
    greedy decode steps, each step's logits against the model's own
    ``forward`` over prompt + fed tokens at that position, to RG_F32_TOL
    (rtol and atol).  ``extra`` (batch 1) joins the prefill's and the
    forward's batch; ``pos_offset`` positions (a VLM's patches) come
    before the prompt, in the decode positions and in the forward's
    logits.  Returns the largest difference."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.models.registry import build_model
    from repro_torch.serve import build_prefill, build_serve_step

    cfg32 = cfg.variant(dtype="float32")
    model = build_model(cfg32, device=device)
    p32 = tr.tree_map(lambda a: a.float(), params)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, prompt_len)), dtype=torch.int64, device=device)
    extra = extra or {}
    logits, caches = build_prefill(model, prompt_len + steps)(
        p32, {"tokens": toks, **extra})
    got = [logits[0, -1, :cfg.vocab]]
    fed = [_masked_argmax(logits[:, -1], cfg.vocab)[:, None]]
    step = build_serve_step(model)
    for j in range(steps):
        nxt, logits, caches = step(p32, caches, fed[-1],
                                   pos_offset + prompt_len + j)
        got.append(logits[0, -1, :cfg.vocab])
        fed.append(nxt)
    del caches
    full, _ = model.forward(p32, {"tokens": torch.cat([toks] + fed[:-1],
                                                      dim=1), **extra})
    worst = 0.0
    for j, g in enumerate(got):
        ref = full[0, pos_offset + prompt_len - 1 + j, :cfg.vocab]
        excess = float(((g - ref).abs() - RG_F32_TOL * ref.abs()).max())
        worst = max(worst, float((g - ref).abs().max()))
        if not math.isfinite(excess) or excess > RG_F32_TOL:
            raise AssertionError(f"float32 {cfg.name}: decode step {j} "
                                 f"logits differ from forward by more than "
                                 f"{RG_F32_TOL} (rtol and atol)")
    return {"prompt_len": prompt_len, "steps": steps,
            "logits_max_abs_diff": worst, "tol": RG_F32_TOL}


def rg_profile(model, params, device="cuda", batch: int = RG_BATCH,
               prompt_len: int = RG_PROMPT, seed: int = 0, extra=None,
               pos_offset: int = 0):
    """Two profiler windows: one prefill of the phase's prompts (with
    ``extra`` in its batch) and one decode step after it (at position
    ``pos_offset + prompt_len``), each with K4's and K3's share of device
    time."""
    import torch
    from torch.profiler import profile
    from repro_torch.serve import build_prefill, build_serve_step

    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (batch, prompt_len)), dtype=torch.int64,
        device=device)
    prefill = build_prefill(model, prompt_len + 1)
    step = build_serve_step(model)
    shares = {"K4": "rglru_scan", "K3": "attn_fwd"}
    windows = {}
    _sync(device)
    with profile(activities=_activities(device)) as prof:
        t = time.perf_counter()
        logits, caches = prefill(params, {"tokens": tokens, **(extra or {})})
        _sync(device)
        wall_ms = (time.perf_counter() - t) * 1e3
    windows["prefill"] = _window(prof, wall_ms, shares=shares)
    token = _masked_argmax(logits[:, -1], model.cfg.vocab)[:, None]
    _sync(device)
    with profile(activities=_activities(device)) as prof:
        t = time.perf_counter()
        step(params, caches, token, pos_offset + prompt_len)
        _sync(device)
        wall_ms = (time.perf_counter() - t) * 1e3
    windows["decode_step"] = _window(prof, wall_ms, shares=shares)
    return windows


def _activities(device):
    """What a profiler window records: the device's kernels on the card
    (all that a window reads: recording the host's ops too slowed a
    host-bound step about 2.5 times and its read-back by up to a minute),
    the host's ops on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity
    if torch.device(device).type == "cuda":
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def _window(prof, wall_ms: float, top_n: int = 8, shares=None) -> dict:
    """Device busy time and idle share of a profiled window, and its
    largest kernels; with ``shares`` ({label: substring of a kernel name}),
    each label's share of the busy time.  Device numbers are None where no
    CUDA kernel ran."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    extra = {}
    if shares:
        extra["shares"] = {
            label: (sum(e.self_device_time_total for e in kernels
                        if key in e.key) / 1e3 / busy_ms if kernels else None)
            for label, key in shares.items()}
    return {**extra,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else None,
        "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "ms": e.self_device_time_total / 1e3}
                        for e in top],
    }


def _print_window(name, w, card):
    print(f"profile {name} [{card}]: wall {w['wall_ms']:.2f} ms, device "
          f"busy {w['device_busy_ms']} ms, idle share "
          f"{w['device_idle_share']}"
          + (f", shares {w['shares']}" if "shares" in w else ""), flush=True)
    for k in w["top_kernels"]:
        print(f"    {k['ms']:9.3f} ms {k['calls']:6d}x {k['name']}")


def check_family_launches(stats, cfg):
    """Check (a) of a family's serving phase: K3 once a prefill for every
    attention layer (for an encoder-decoder, by role too) and never a
    decode step; K1, K2 and K4 never (``check_rg_launches``)."""
    n_attn = {"audio": cfg.encoder_layers + 2 * cfg.n_layers,
              "vlm": cfg.n_layers, "moe": cfg.n_layers,
              "ssm": 0}[cfg.family]
    check_rg_launches(stats, 0, n_attn)
    if cfg.family == "audio":
        check_encdec_roles(stats, cfg)


def print_family_serving(label, r, card, seconds=None):
    """A serving phase's numbers, checks and profile windows."""
    print(json.dumps({label.replace(" ", "_"): r, "card": card}), flush=True)
    print(f"{label} [{card}]: {r['arch']} full width, {r['n_layers']} "
          f"layers, {r['dtype']}, batch {r['batch']} x {r['input_positions']}"
          f" positions ({r['prompt_len']} prompt tokens), {r['new_tokens']} "
          f"new: TTFT {r['ttft_s']:.4f} s, prefill "
          f"{r['prefill_positions_per_s']:.0f} positions/s, decode "
          f"{r['decode_ms_per_step']:.2f} ms/step (median of "
          f"{r['new_tokens'] - 2} after the first), peak memory "
          f"{r['max_memory_allocated'] / 2**30:.2f} GiB; launches per "
          f"prefill {r['prefill_launches']}"
          + (f", K3 by role {r['k3_roles']}" if r["k3_roles"] else "")
          + f", per decode step {r['step_launches'][0]}"
          + (f"; phase {seconds:.1f} s" if seconds is not None else ""),
          flush=True)
    f32 = r["float32_check"]
    print(f"{label} checks: decode vs fresh prefill max abs diff "
          f"{r['logits_max_abs_diff']:.4g} (limit {LOGIT_RTOL} x "
          f"{r['logits_max_abs']:.4g}); float32 decode vs forward over "
          f"{f32['prompt_len']} + {f32['steps']} tokens max abs diff "
          f"{f32['logits_max_abs_diff']:.3g} (tol {RG_F32_TOL})", flush=True)
    for name, w in r["profile"].items():
        _print_window(f"{label} {name}", w, card)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_identity()
    print(f"card: {card}", flush=True)
    seconds, since = {}, [time.perf_counter()]

    def phase_done(label: str):
        """:func:`free_memory` after a phase, and its seconds (from the
        end of the one before) into ``seconds``."""
        free_memory(label)
        now = time.perf_counter()
        seconds[label] = round(now - since[0], 1)
        since[0] = now

    t = time.perf_counter()
    reports = _build.build(_build.sources())
    build_s = time.perf_counter() - t
    print(f"build: {_build.sources()} in {build_s:.1f} s", flush=True)
    for name, report in reports.items():
        print(f"--- nvcc {name}.cu ---\n{report}", file=sys.stderr)
    k3_report = _build.report("flash_attention")
    for line in k3_report.splitlines():
        if "warning" in line.lower():
            print(f"nvcc flash_attention.cu: {line.strip()}", flush=True)
    k3_build = check_k3_build(k3_report)
    for name, r in sorted(k3_build.items()):
        print(f"ptxas {name}: {r}", flush=True)
    print(f"ptxas: {len(k3_build)} bf16 K3 kernels, 0 spill bytes",
          flush=True)
    k4_build = check_k4_build(_build.report("rglru_scan"))
    for name, r in sorted(k4_build.items()):
        print(f"ptxas {name}: {r}", flush=True)
    print(f"ptxas: {len(k4_build)} K4 TMA-route kernels, 0 spill bytes",
          flush=True)
    phase_done("build")

    # -- kernel phase: K3 ---------------------------------------------------
    rows = kernel_phase()
    for r in rows:
        print(f"K3 {r['shape']} causal={r['causal']} window={r['window']} "
              f"{r['dtype']}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"bf16 excess {r['bf16_excess']} faults {r['fault_excess']} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"sdpa {r['library_ms']} ms"
              + (f" sdpa causal, no window {r['library_causal_ms']} ms"
                 if r["library_causal_ms"] is not None else "")
              + f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]",
              flush=True)
        print(f"K3 host {r['shape']} {r['dtype']}: wrapper "
              f"{r['host_us']:.1f} us per call", flush=True)
    print(json.dumps({"k3_shapes": rows, "card": card}), flush=True)
    phase_done("K3 kernel phase")

    # -- kernel phase: K1/K2 ------------------------------------------------
    ga_rows, ga_line = combine_kernel_phase()
    for r in ga_rows:
        if "ms" in r:
            n = r["n"] if len(r["n"]) < 3 else f"{len(r['n'])} pairs"
            print(f"{r['kernel']} {r.get('case', '')} {r['dtype']} scale "
                  f"{r['scale']} n={n} aligned={r.get('aligned', '')}: "
                  f"equal {r['equal']} kernel {r['ms']:.4f} ms plain "
                  f"{r['plain_ms']:.4f} ms library {r['library_ms']} ms "
                  f"bound {r['bound_ms']:.4f} ms [{card}]", flush=True)
            print(f"{r['kernel']} host n={n}: wrapper {r['host_us']:.1f} us "
                  f"per call", flush=True)
    print(f"K1/K2: {len(ga_rows)} cases bit-identical to the plain versions, "
          f"out of place and in place", flush=True)
    vs_add = ga_line["K1_vs_add"]
    for mode in ("", " in place"):
        k1, add = vs_add[f"K1{mode}"], vs_add[f"torch.add{mode}"]
        print(f"K1 vs torch.add{mode} in turns at n={ga_line['K1']['n']} "
              f"f32: K1 {k1['ms']} ms, torch.add {add['ms']} ms; means "
              f"{k1['mean_ms']:.4f} / {add['mean_ms']:.4f} ms [{card}]",
              flush=True)
    print(json.dumps({"k1_k2_cases": ga_rows, "k1_vs_add": vs_add,
                      "card": card}), flush=True)
    phase_done("K1/K2 kernel phase")

    # -- kernel phase: K4 ---------------------------------------------------
    k4_rows, k4_edges, k4_pair = rglru_kernel_phase()
    for r in k4_rows:
        print(f"K4 {r['shape']} h0={r['h0']} {r['dtype']} route {r['route']}: "
              f"equal {r['equal']} kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]", flush=True)
        print(f"K4 host {r['shape']} {r['dtype']}: wrapper "
              f"{r['host_us']:.1f} us per call", flush=True)
    for r in k4_edges:
        print(f"K4 edge {r['shape']} h0={r['h0']} {r['dtype']}: route "
              f"{r['route']} equal {r['equal']}, walk route equal "
              f"{r['walk_equal']}"
              + (f", TMA request refused {r['tma_refused']}"
                 if r["tma_refused"] is not None else ""), flush=True)
    print(f"K4: {len(k4_edges)} TMA-route edge cases bit-identical on both "
          f"routes ({Counter(r['route'] for r in k4_edges)})", flush=True)
    print(f"K4 routes in turns (walk, tma, tma, walk) at "
          f"{list(RG_SCAN_SHAPE[:3])} f32: walk {k4_pair['walk']['ms']} ms, "
          f"tma {k4_pair['tma']['ms']} ms; means "
          f"{k4_pair['walk']['mean_ms']:.4f} / {k4_pair['tma']['mean_ms']:.4f}"
          f" ms [{card}]", flush=True)
    print(json.dumps({"k4_cases": k4_rows, "k4_edges": k4_edges,
                      "k4_routes": k4_pair, "card": card}), flush=True)
    phase_done("K4 kernel phase")

    # -- serving phase (K3) -------------------------------------------------
    cfg = get_config(ARCH)
    model, params, init_s = load_model(cfg)
    print(f"weights: {cfg.name} initialised on the card in {init_s:.2f} s",
          flush=True)
    stats = serve_phase(model, params)
    check_serving_launches(stats, cfg.n_layers)
    served = stats["launches"]
    print(json.dumps({"slice": stats, "card": card}), flush=True)
    print(f"slice [{card}]: {cfg.name} full width bf16, "
          f"{stats['n_prefills']} prefills ({stats['evictions']} evictions), "
          f"prefill {stats['prefill_tok_per_s']:.0f} tok/s, "
          f"TTFT max {max(stats['ttft_s']):.3f} s, decode ms/step by bucket "
          f"{stats['decode_ms_per_step']}", flush=True)
    windows = profile_phase(model, params)
    for name, w in windows.items():
        _print_window(name, w, card)
    print(json.dumps({"profile": windows, "card": card}), flush=True)
    phase_done("tinyllama serving")

    # -- handoff phase (a), (b), (d): the same model and requests served
    # disaggregated, the KV blocks through the host (K3) ------------------
    t_handoff = time.perf_counter()
    disagg, colo_again, fault = handoff_phase(model, params, stats)
    check_serving_launches(disagg, cfg.n_layers)                # check (a)
    handoff_s = time.perf_counter() - t_handoff
    print(json.dumps({"handoff": disagg, "colocated_again": colo_again,
                      "planted_fault": fault, "card": card}), flush=True)
    print_handoff(stats, colo_again, disagg, fault, card)
    del model, params
    phase_done("handoff (a), (b), (d)")

    # -- training phase (K1, K2); handoff check (c) on its state ----------
    tcfg = train_config()
    post_sync = {}

    def consolidate_after_sync(t, trainer):
        if t == HANDOFF_SYNC_STEP:
            t0 = time.perf_counter()
            post_sync.update(check_post_sync_consolidation(trainer, t))
            post_sync["check_s"] = time.perf_counter() - t0

    train, trainer = train_phase(tcfg, on_step=consolidate_after_sync)
    check_train_launches(train)
    window = train_profile(trainer, TRAIN_STEPS)
    t_trained = time.perf_counter()
    trained = trained_serving(trainer)
    for run in trained.values():
        check_serving_launches(run, tcfg.n_layers)            # check (c)
    handoff_s += post_sync["check_s"] + time.perf_counter() - t_trained
    del trainer
    print(json.dumps({"handoff_post_sync": post_sync,
                      "handoff_trained": trained, "card": card}), flush=True)
    dense = [(c["logits_max_abs_diff"], c["logits_max_abs"])
             for run in trained.values() for c in run["checks"]]
    print(f"handoff (c) [{card}]: consolidated right after the sync at step "
          f"{post_sync['step']}: {post_sync['leaves']} leaves, "
          f"{post_sync['elements']} elements, row 0 bit for bit, in "
          f"{post_sync['consolidate_s'] * 1e3:.1f} ms; after step "
          f"{TRAIN_STEPS} (rows apart by group) {tcfg.n_layers}-layer "
          f"weights served on {HANDOFF_REQUESTS} requests: tokens equal "
          f"through both schedulers; first decode logits vs dense (max abs "
          f"diff, largest logit) {dense}, limit {LOGIT_RTOL} of the largest",
          flush=True)
    print(f"handoff phase {handoff_s:.1f} s: the disaggregated run, a "
          f"second colocated run, (d)'s two runs, (c)'s consolidation "
          f"and its two {tcfg.n_layers}-layer runs (the serving and "
          f"training phases it reads not included)", flush=True)
    print(json.dumps({"train": train, "train_profile": window,
                      "card": card}), flush=True)
    print(f"train [{card}]: {tcfg.name} full width, {tcfg.n_layers} layers, "
          f"{TRAIN_P} replicas S={TRAIN_S} tau={TRAIN_TAU}, "
          f"{train['params_per_replica']} params/replica, "
          f"{train['n_buckets']} buckets of "
          f"{train['bucket_bytes'] >> 20} MiB", flush=True)
    print(f"train losses: {[round(x, 4) for x in train['losses']]}",
          flush=True)
    print(f"train: median step {train['median_step_ms']:.1f} ms after the "
          f"first, {train['tokens_per_s']:.0f} tokens/s, host split "
          f"{ {k: round(v, 1) for k, v in train['median_split_ms'].items()} }"
          f" ms, peak memory {train['max_memory_allocated'] / 2**30:.2f} GiB,"
          f" launches {train['launches']}", flush=True)
    _print_window(f"train group step {TRAIN_STEPS}", window, card)
    phase_done("tinyllama training")

    # -- elastic phase: the training model through ElasticTrainer, worlds
    # of 8, 4 and 2 rows (K1, K2) ------------------------------------------
    elastic = elastic_phase(tcfg)
    check_elastic_launches(elastic)                             # check (a)
    check_elastic_held(elastic, ga_line["elastic"])             # check (a)
    check_elastic_memory(elastic)                               # check (g)
    print(json.dumps({"elastic": elastic,
                      "elastic_summary": elastic_summary(elastic),
                      "card": card}), flush=True)
    print_elastic(elastic, card)
    phase_done("elastic phase")

    # -- FSDP phase: 4 pods of 2 at 22 layers, the pods' shard buffers
    # averaged pod to pod (K1, K2), the consolidated model served (K3) ----
    kept = {}
    fsdp = fsdp_phase(fsdp_config(), keep=kept)
    check_fsdp_launches(fsdp)                                   # check (a)
    check_fsdp_held(fsdp, ga_line["fsdp"])                      # check (a)
    check_fsdp_memory(fsdp)                                     # check (f)
    print(json.dumps({"fsdp": fsdp, "card": card}), flush=True)
    print_fsdp(fsdp, card)
    phase_done("FSDP phase")

    # -- streamed phase: the same run through the layer-streamed engine,
    # 22 spans, 24 grouped shard buckets averaged pod to pod (K1, K2) ----
    streamed = streamed_phase(fsdp_config(), fsdp, kept)
    del kept
    check_streamed_launches(streamed)                           # check (a)
    check_streamed_held(streamed, ga_line["streamed"])          # check (a)
    check_streamed_memory(streamed)                             # check (e)
    print(json.dumps({"streamed": streamed, "card": card}), flush=True)
    print_streamed(streamed, card)
    phase_done("streamed phase")

    # -- ranks phase: the same model, one replica a rank over gloo (K1, K2)
    ranks = ranks_phase(ranks_spec(), ROOT / "build" / "ranks")
    check_ranks_launches(ranks)                                 # check (a)
    print(json.dumps({"ranks": ranks, "card": card}), flush=True)
    print_ranks(ranks, card)
    phase_done("ranks phase")

    # -- fsdp ranks phase: the same model, gather-all FSDP over data 2 x
    # pod 4 gloo ranks, one member a rank (K1, K2 on a rank's slices)
    fsdp_ranks = fsdp_ranks_phase(fsdp_ranks_spec(),
                                  ROOT / "build" / "fsdp_ranks")
    streamed_ranks = fsdp_ranks.pop("streamed")
    check_fsdp_ranks_launches(fsdp_ranks, ga_line["fsdp ranks"])  # (a)
    print(json.dumps({"fsdp_ranks": fsdp_ranks, "card": card}), flush=True)
    print_fsdp_ranks(fsdp_ranks, card)
    # -- its streamed ranks part: the same ranks and run through the
    # layer-streamed engine (K1, K2 on a rank's grouped slices)
    check_fsdp_ranks_launches(streamed_ranks,                  # (a)
                              ga_line["streamed ranks"])
    print(json.dumps({"streamed_ranks": streamed_ranks, "card": card}),
          flush=True)
    print_streamed_ranks(streamed_ranks, fsdp_ranks["summary"], card)
    seconds["streamed ranks part (in the fsdp ranks phase)"] = round(
        streamed_ranks["seconds"], 1)
    phase_done("fsdp ranks phase")

    # -- fsdp model phase: the same model, FSDP under a model axis over pod
    # 2 x data 2 x model 2 gloo ranks, gather-all then streamed (K1, K2 on
    # a rank's slices of its model coordinate's buckets)
    fsdp_model = fsdp_model_phase(fsdp_model_spec(),
                                  ROOT / "build" / "fsdp_model")
    streamed_model = fsdp_model.pop("streamed")
    check_fsdp_ranks_launches(fsdp_model, ga_line["fsdp model"])  # (a)
    check_fsdp_ranks_launches(streamed_model,                  # (a)
                              ga_line["streamed model"])
    print(json.dumps({"fsdp_model": fsdp_model,
                      "streamed_model": streamed_model, "card": card}),
          flush=True)
    print_fsdp_model(dict(fsdp_model, streamed=streamed_model), card)
    phase_done("fsdp model phase")

    # -- model phase: the same model, each replica split over 2 model ranks,
    # 4 x 2 gloo ranks (K1, K2 on a rank's slices; K3 at its local heads)
    tp = model_phase(model_spec(serve_layers=MODEL_SERVE_LAYERS),
                     ROOT / "build" / "model")
    check_model_launches(tp)                                    # check (a)
    check_model_held(tp, ga_line["K1 model"])                   # check (a)
    print(json.dumps({"model": tp, "card": card}), flush=True)
    print_model(tp, card)
    phase_done("model phase")

    # -- rg model phase: recurrentgemma-2b, each replica split over 2 model
    # ranks, 2 x 2 gloo ranks (K1/K2 on a rank's slices, K4 on its 1,280
    # channels, K3 at its 5 heads)
    rg_tp = model_phase(rg_model_spec(serve_layers=RG_MODEL_SERVE_LAYERS),
                        ROOT / "build" / "rg_model")
    check_model_launches(rg_tp)                                 # check (a)
    check_model_held(rg_tp, ga_line["K1 rg model"])             # check (a)
    print(json.dumps({"rg_model": rg_tp, "card": card}), flush=True)
    print_model(rg_tp, card, label="rg model")
    phase_done("rg model phase")

    # -- attn model phase: whisper-medium, internvl2-2b and transformer-wmt
    # served over data 1 x model 2 gloo ranks, then the paged scheduler on
    # tinyllama-1.1b over them (K3 at a rank's heads)
    attn = attn_model_phase(attn_model_spec(sched_layers=SCHED_LAYERS),
                            ROOT / "build" / "attn_model")
    check_attn_model_launches(attn)                             # check (a)
    print(json.dumps({"attn_model": attn, "card": card}), flush=True)
    print_attn_model(attn, card)
    phase_done("attn model phase")

    # -- ep model phase: xlstm-350m by heads and the expert-parallel moe
    # family served over data 1 x model 2 gloo ranks (K3 at a rank's heads)
    ep = ep_model_phase(ep_model_spec(), ROOT / "build" / "ep_model")
    check_ep_model_launches(ep)                                 # check (a)
    print(json.dumps({"ep_model": ep, "card": card}), flush=True)
    print_ep_model(ep, card)
    phase_done("ep model phase")

    # -- recurrentgemma phase (K4, K3 at head dim 256) ---------------------
    from repro_torch.models import rglru
    rcfg = get_config(RG_ARCH)
    model, params, init_s = load_model(rcfg)
    print(f"weights: {rcfg.name} ({rcfg.n_layers} layers) initialised on the "
          f"card in {init_s:.2f} s", flush=True)
    rg = rg_serve_phase(model, params)
    n_sb, tail = rglru.layout(rcfg)
    check_rg_launches(rg, 2 * n_sb + tail, n_sb)
    rg_windows = rg_profile(model, params)
    f32 = rg_f32_check(rcfg, params)
    del model, params
    phase_done("recurrentgemma serving")
    print(json.dumps({"recurrentgemma": rg, "profile": rg_windows,
                      "float32_check": f32, "card": card}), flush=True)
    print(f"recurrentgemma [{card}]: {rcfg.name} full width, "
          f"{rcfg.n_layers} layers, bf16, batch {RG_BATCH} x {RG_PROMPT} "
          f"tokens: prefill {rg['prefill_tok_per_s']:.0f} tok/s, TTFT "
          f"{rg['ttft_s']:.3f} s, decode {rg['decode_ms_per_step']:.2f} "
          f"ms/step (median of {RG_NEW - 2} after the first), peak memory "
          f"{rg['max_memory_allocated'] / 2**30:.2f} GiB; launches per "
          f"prefill {rg['prefill_launches']}, per decode step "
          f"{rg['step_launches'][0]}", flush=True)
    print(f"recurrentgemma checks: decode vs fresh prefill max abs diff "
          f"{rg['logits_max_abs_diff']:.4g} (limit {LOGIT_RTOL} x "
          f"{rg['logits_max_abs']:.4g}); float32 decode vs forward max abs "
          f"diff {f32['logits_max_abs_diff']:.3g} (tol {RG_F32_TOL})",
          flush=True)
    for name, w in rg_windows.items():
        _print_window(f"recurrentgemma {name}", w, card)

    # -- recurrentgemma training phase (K4 forward and backward, K1, K2) ---
    scan_train = scan_train_phase()
    print(json.dumps({"scan_train": scan_train, "card": card}), flush=True)
    print(f"K4 training scan {scan_train['shape']} f32 + h0 [{card}]: "
          f"output and grads bit-identical to the plain scan "
          f"{scan_train['equal']}; forward {scan_train['forward_ms']:.4f} ms, "
          f"backward {scan_train['backward_ms']:.4f} ms (its K4 launch "
          f"{scan_train['backward_scan_ms']:.4f} ms, flips "
          f"{scan_train['flips_ms']:.4f} ms), bound "
          f"{scan_train['bound_ms']:.4f} ms a scan (bytes); plain forward "
          f"{scan_train['plain_forward_ms']:.3f} ms, backward "
          f"{scan_train['plain_backward_ms']:.3f} ms", flush=True)
    phase_done("K4 training scan")
    rtcfg = rg_train_config()
    rg_train, trainer = train_phase(rtcfg, replicas=RG_TRAIN_P,
                                    group_size=RG_TRAIN_S,
                                    global_batch=RG_TRAIN_GB)
    check_train_launches(rg_train)                              # check (a)
    k4_per_step = rg_train_k4_per_step(rtcfg, RG_TRAIN_P)
    check_rg_train_launches(rg_train, k4_per_step)              # check (b)
    rg_train_window = train_profile(trainer, TRAIN_STEPS, shares={
        "K4": "rglru_scan", "K1/K2": "group_average_combine"})
    del trainer
    torch.cuda.empty_cache()
    print(json.dumps({"rg_train": rg_train, "rg_train_profile":
                      rg_train_window, "card": card}), flush=True)
    print(f"rg train [{card}]: {rtcfg.name} full width, vocab "
          f"{rtcfg.vocab}, {rtcfg.n_layers} layers, {RG_TRAIN_P} replicas "
          f"S={RG_TRAIN_S} tau={TRAIN_TAU}, "
          f"{rg_train['params_per_replica']} params/replica, "
          f"{rg_train['n_buckets']} buckets of "
          f"{rg_train['bucket_bytes'] >> 20} MiB; K4 {k4_per_step} launches "
          f"a step, all TMA", flush=True)
    print(f"rg train losses: {[round(x, 4) for x in rg_train['losses']]}",
          flush=True)
    print(f"rg train [{card}]: median step {rg_train['median_step_ms']:.1f} "
          f"ms after the first, {rg_train['tokens_per_s']:.0f} tokens/s, host "
          f"split { {k: round(v, 1) for k, v in rg_train['median_split_ms'].items()} }"
          f" ms, peak memory {rg_train['max_memory_allocated'] / 2**30:.2f} "
          f"GiB (after the first step "
          f"{rg_train['max_memory_allocated_after_first'] / 2**30:.2f} GiB), "
          f"launches {rg_train['launches']}", flush=True)
    _print_window(f"rg train group step {TRAIN_STEPS}", rg_train_window, card)
    phase_done("recurrentgemma training")

    # -- paper phase: transformer-wmt under the seven averagers (K1, K2),
    # Fig. 5, and translation serving (K3) --------------------------------
    pcfg = get_config(PAPER_ARCH)
    ptcfg = pcfg.variant(n_layers=PAPER_TRAIN_LAYERS,
                         encoder_layers=PAPER_TRAIN_LAYERS)
    t_paper = time.perf_counter()
    paper, gossip = {}, GossipChecks()
    for name in PAPER_AVERAGERS:
        run = paper_train_run(ptcfg, name, profile=name in PAPER_PROFILED,
                              checks=gossip)
        phase_done(f"paper training {name}")
        check_paper_launches(run)                               # check (a)
        paper[name] = run
        print(json.dumps({"paper_train": run, "card": card}, default=str),
              flush=True)
        print(f"paper train {name} [{card}]: {pcfg.name} full width, "
              f"{PAPER_TRAIN_LAYERS} + {PAPER_TRAIN_LAYERS} layers, bf16, "
              f"{PAPER_P} replicas, seq {PAPER_SEQ}, batch "
              f"{PAPER_GB}: median step {run['median_step_ms']:.1f} ms after "
              f"the first, {run['tokens_per_s']:.0f} tokens/s, host split "
              f"{ {k: round(v, 1) for k, v in run['median_split_ms'].items()} }"
              f" ms (one card: 'average' is HBM traffic and arithmetic, no "
              f"network), peak memory "
              f"{run['max_memory_allocated'] / 2**30:.2f} GiB, K1/K2 a group "
              f"step {run['expected_k1_k2_per_group_step']}"
              + (f", fused average equals the per-leaf one by phase "
                 f"{run['phase_checks']}" if name == "wagma" else "")
              + (f", gossip mix against the CPU's on a thread (below)"
                 if name in GOSSIP else ""), flush=True)
        print(f"paper train {name} losses: "
              f"{[round(x, 4) for x in run['losses']]}", flush=True)
        if run["profile"]:
            _print_window(f"paper train {name} step {run['n_steps']}",
                          run["profile"], card)
    fig5 = fig5_phase(pcfg)
    print(json.dumps({"fig5": fig5, "card": card}), flush=True)
    for mode, r in fig5["runs"].items():
        print(f"fig5 {mode} losses: {[round(x, 4) for x in r['losses']]}",
              flush=True)
    print(f"fig5 [{card}]: {pcfg.name} full width, P={PAPER_P} S={PAPER_S} "
          f"tau={PAPER_TAU}, 2 stragglers an iteration (p_stall 0.25, "
          f"{fig5['runs']['wagma']['stalled']} stalled draws): mean of the "
          f"last {FIG5_TAIL} losses wagma {fig5['tail_mean']['wagma']:.4f}, "
          f"allreduce {fig5['tail_mean']['allreduce']:.4f}, ratio "
          f"{fig5['ratio']:.4f}; median iteration ms wagma "
          f"{statistics.median(fig5['runs']['wagma']['step_ms']):.1f}, "
          f"allreduce "
          f"{statistics.median(fig5['runs']['allreduce']['step_ms']):.1f}",
          flush=True)
    phase_done("Fig. 5")
    wmt = family_serve_phase(pcfg, batch=WMT_BATCH, prompt_len=WMT_PROMPT,
                             new=WMT_NEW, f32_steps=WMT_F32_STEPS)
    check_family_launches(wmt, pcfg)                           # check (a)
    phase_done("transformer-wmt serving")
    waited = gossip.settle(paper)                               # check (b)
    print(f"paper gossip checks: the card's mix equals the CPU's by phase "
          f"{ {n: paper[n]['phase_checks'] for n in GOSSIP} } (waited "
          f"{waited:.1f} s at the end of the phase)", flush=True)
    paper_s = time.perf_counter() - t_paper
    print_family_serving("wmt serving", wmt, card)
    print(f"paper phase {paper_s:.1f} s", flush=True)

    # -- the other families served at full width: whisper-medium (K3 at its
    # encoder, decoder and cross shapes), internvl2-2b (K3 at head dim
    # 128), xlstm-350m (no kernel) ----------------------------------------
    family = {}
    for arch, kw in ((WHISPER_ARCH, {}),
                     (VLM_ARCH, dict(prompt_len=VLM_PROMPT,
                                     f32_steps=VLM_F32_STEPS)),
                     (XLSTM_ARCH, dict(prompt_len=XLSTM_PROMPT,
                                       f32_prompt=XLSTM_F32_PROMPT,
                                       f32_steps=XLSTM_F32_STEPS,
                                       profile_prompt=XLSTM_PROFILE_PROMPT))):
        fcfg = get_config(arch)
        t0 = time.perf_counter()
        run = family_serve_phase(fcfg, **kw)
        check_family_launches(run, fcfg)                       # check (a)
        phase_done(f"{arch} serving")
        family[arch] = run
        print_family_serving(f"{arch} serving", run, card,
                             seconds=time.perf_counter() - t0)

    # -- the moe family at published width and expert count (K3 at head
    # dims 128 and 112) -------------------------------------------------
    for arch in MOE_ARCHS:
        mcfg = moe_config(arch)
        t0 = time.perf_counter()
        run = moe_serve_phase(mcfg)
        check_family_launches(run, mcfg)                       # check (a)
        phase_done(f"{arch} serving")
        family[arch] = run
        print_family_serving(f"{arch} serving", run, card,
                             seconds=time.perf_counter() - t0)
        print_moe_serving(f"{arch} moe", run, card)

    main_row = next(r for r in rows if r["shape"] == list(TL_ATTN_SHAPE[:6])
                    and r["dtype"] == TL_ATTN_SHAPE[8])
    rg_row = next(r for r in rows if r["shape"] == list(RG_ATTN_SHAPE[:6])
                  and r["dtype"] == RG_ATTN_SHAPE[8])
    k4_row, k4_decode_row = (
        next(r for r in k4_rows if r["shape"] == list(shape[:3])
             and r["h0"] == shape[3] and r["dtype"] == shape[4])
        for shape in (RG_SCAN_SHAPE, RG_DECODE_SCAN_SHAPE))
    k4_err = max(r["max_abs_err"] for r in k4_rows + k4_edges)
    rg_launches = [rg["prefill_launches"]] + rg["step_launches"]
    ga_err = {k: max(r["max_abs_err"] for r in ga_rows if r["kernel"] == k)
              for k in ("K1", "K2")}
    # the paper phase's K1/K2 launches, all WAGMA's (check (a): no baseline
    # launches either)
    paper_launches = {name: sum(e[key] for run in paper.values()
                                for e in run["steps"])
                      for name, key in ((K1, "k1"), (K2, "k2"), (K4, "k4"))}
    (ranks_launches, fsdp_ranks_launches, streamed_ranks_launches,
     fsdp_model_launches, streamed_model_launches) = (
        {name: sum(e[key] for r in run["ranks"] for e in r["log"])
         for name, key in ((K1, "k1"), (K2, "k2"), (K4, "k4"))}
        for run in (ranks, fsdp_ranks, streamed_ranks, fsdp_model,
                    streamed_model))
    model_launches, rg_model_launches = (
        {name: sum(e[key] for r in run["ranks"] for e in r["log"])
         for name, key in ((K1, "k1"), (K2, "k2"), (K4, "k4"),
                           (K4_TMA, "k4_tma"))}
        for run in (tp, rg_tp))
    model_path = f"{ARCH} training, data {MODEL_DATA} x model {MODEL_M} ranks"
    rg_model_path = (f"{RG_ARCH} training, data {RG_MODEL_DATA} x model "
                     f"{MODEL_M} ranks")
    # the rg model phase's serving launches over every rank, by kind
    rg_model_served = {k: sum(l[k] for r in rg_tp["ranks"]
                              for l in r["serve"]["launches"])
                       for k in (K3, K4, K4_TMA, K4_WALK)}
    tl_k3 = {f"{ARCH} serving": served[K3],
             f"{ARCH} disaggregated": disagg["launches"][K3],
             f"{ARCH} handoff of the trained state, {tcfg.n_layers} layers":
             sum(r["launches"][K3] for r in trained.values()),
             f"{FSDP_PATH}, consolidated and pod 0 served":
             sum(r["launches"][K3] for r in fsdp["serving"].values())}
    by_path = lambda name, serving=0: {
        f"{ARCH} training": train["launches"][name],
        f"{ARCH} elastic, pool {ELASTIC_POOL}": sum(
            run["launches"][name] for run in elastic["runs"].values()),
        f"{ARCH} training, {RANKS_P} ranks": ranks_launches[name],
        FSDP_RANKS_PATH: fsdp_ranks_launches[name],
        STREAMED_RANKS_PATH: streamed_ranks_launches[name],
        FSDP_MODEL_PATH: fsdp_model_launches[name],
        STREAMED_MODEL_PATH: streamed_model_launches[name],
        model_path: model_launches[name],
        rg_model_path: rg_model_launches[name],
        FSDP_PATH: fsdp["launches"][name],
        STREAMED_PATH: streamed["launches"][name],
        f"{RG_ARCH} serving": serving,
        f"{RG_ARCH} training": rg_train["launches"][name],
        f"{PAPER_ARCH} training": paper_launches[name]}
    bf16_row = lambda c: next(r for r in rows if r["shape"] == list(c[:6])
                              and r["causal"] == c[6]
                              and r["dtype"] == "bfloat16")
    wmt_rows = {role: bf16_row(c) for role, c in WMT_ATTN_ROLES.items()}
    k3_on = lambda run: sum(c[K3] for c in [run["prefill_launches"]]
                            + run["step_launches"])
    whisper_rows = {role: bf16_row(c)
                    for role, c in WHISPER_ATTN_ROLES.items()}
    vlm_row = bf16_row(VLM_ATTN)
    model_row = bf16_row(MODEL_ATTN)
    rg_model_row = next(r for r in rows
                        if r["shape"] == list(RG_MODEL_ATTN[:6])
                        and r["dtype"] == RG_MODEL_ATTN[8])
    rg_model_k4 = {name: next(r for r in k4_rows if r["shape"] == list(c[:3])
                              and r["h0"] == c[3] and r["dtype"] == c[4])
                   for name, c in RG_MODEL_SCAN_SHAPES.items()}
    by_role = lambda role_rows: {role: {k: r[k] for k in (
        "shape", "causal", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err", "host_us")}
        for role, r in role_rows.items()}
    entry = lambda name, source, replaces, launches, row, err, **kw: {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": kw.pop("bound_by", "bytes"),
        "library_ms": row["library_ms"], "host_us": row["host_us"], **kw}
    sched_row = bf16_row(SCHED_RANK_ATTN)
    sched_k3_by = {
        "paged": sum(x[K3] for r in attn["sched"]["ranks"]
                     for key in ("prefill", "decode")
                     for x in r["launches"][key]),
        "disaggregated": sum(x[K3] for r in attn["sched"]["ranks"]
                             for key in ("prefill", "decode")
                             for x in r["disagg_launches"][key]),
        "dense": sum(x[K3] for r in attn["sched"]["ranks"]
                     for d in r["dense_launches"] for x in d)}
    sched_k3 = sum(sched_k3_by.values())
    ranks_row = lambda r: {k: r[k] for k in (
        "n", "scale", "ms", "plain_ms", "library_ms", "bound_ms",
        "max_abs_err", "host_us")}
    # each elastic world's largest K1 operand and its K2 batch
    elastic_row = lambda k: {f"world {w}": ranks_row(held[k])
                             for w, held in ga_line["elastic"].items()}
    fsdp_row = lambda k: dict(ranks_row(ga_line["fsdp"][k]),
                              n_layers=fsdp["n_layers"], pods=fsdp["pods"])
    streamed_row = lambda k: dict(ranks_row(ga_line["streamed"][k]),
                                  n_layers=streamed["n_layers"],
                                  pods=streamed["pods"])
    # a rank's largest slice operand (K1) and its K2 batch, where it has one
    fsdp_ranks_row = lambda k: (dict(
        ranks_row(ga_line["fsdp ranks"][k]),
        add_ms=ga_line["fsdp ranks"][k].get("add_ms"),
        n_layers=fsdp_ranks["spec"]["n_layers"], pods=fsdp_ranks["pods"],
        pod_size=fsdp_ranks["pod_size"])
        if k in ga_line["fsdp ranks"] else None)
    streamed_ranks_row = lambda k: (dict(
        ranks_row(ga_line["streamed ranks"][k]),
        n_layers=streamed_ranks["spec"]["n_layers"],
        pods=streamed_ranks["pods"], pod_size=streamed_ranks["pod_size"])
        if k in ga_line["streamed ranks"] else None)
    # a rank's largest slice of its model coordinate's buckets (K1), its
    # K2 batch, gather-all and streamed
    fsdp_model_row = lambda key, k: (dict(
        ranks_row(ga_line[key][k]), add_ms=ga_line[key][k].get("add_ms"),
        n_layers=fsdp_model["spec"]["n_layers"], pods=fsdp_model["pods"],
        pod_size=fsdp_model["pod_size"], model=MODEL_M)
        if k in ga_line[key] else None)
    kernels = [
        entry(K1, "src/repro_torch/kernels/csrc/group_average.cu",
              "src/repro/kernels/group_average.py:68",
              sum(by_path(K1).values()), ga_line["K1"], ga_err["K1"],
              n=ga_line["K1"]["n"], dtype="float32", scale=1.0,
              launches_by_path=by_path(K1),
              elastic_row=elastic_row("K1"), fsdp_row=fsdp_row("K1"),
              streamed_row=streamed_row("K1"),
              fsdp_ranks_row=fsdp_ranks_row("K1"),
              streamed_ranks_row=streamed_ranks_row("K1"),
              fsdp_model_row=fsdp_model_row("fsdp model", "K1"),
              streamed_model_row=fsdp_model_row("streamed model", "K1"),
              ranks_row=ranks_row(ga_line["K1 ranks"]),
              model_row=ranks_row(ga_line["K1 model"]),
              rg_model_row=ranks_row(ga_line["K1 rg model"])),
        entry(K2, "src/repro_torch/kernels/csrc/group_average.cu",
              "src/repro/kernels/group_average.py:80",
              sum(by_path(K2).values()), ga_line["K2"], ga_err["K2"],
              n=ga_line["K2"]["n"], dtype="float32", scale=1.0,
              launches_by_path=by_path(K2),
              elastic_row=elastic_row("K2"), fsdp_row=fsdp_row("K2"),
              streamed_row=streamed_row("K2"),
              fsdp_ranks_row=fsdp_ranks_row("K2"),
              streamed_ranks_row=streamed_ranks_row("K2"),
              fsdp_model_row=fsdp_model_row("fsdp model", "K2"),
              streamed_model_row=fsdp_model_row("streamed model", "K2"),
              ranks_row=ranks_row(ga_line["K2 ranks"]),
              model_row=ranks_row(ga_line["K2 model"]),
              rg_model_row=ranks_row(ga_line["K2 rg model"])),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              sum(tl_k3.values()), main_row,
              max(r["max_abs_err"] for r in rows),
              bound_by=main_row["bound_by"], shape=main_row["shape"],
              dtype=main_row["dtype"], launches_by_path=tl_k3,
              path=f"{ARCH} serving, colocated and disaggregated"),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              k3_on(rg), rg_row,
              max(r["max_abs_err"] for r in rows),
              bound_by=rg_row["bound_by"], shape=rg_row["shape"],
              dtype=rg_row["dtype"], window=rg_row["window"],
              library_causal_ms=rg_row["library_causal_ms"],
              path=f"{RG_ARCH} serving"),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              k3_on(wmt), wmt_rows["encoder"],
              max(r["max_abs_err"] for r in rows),
              bound_by=wmt_rows["encoder"]["bound_by"],
              shape=wmt_rows["encoder"]["shape"], dtype="bfloat16",
              causal=False, launches_by_role=wmt["k3_roles"],
              rows_by_role=by_role(wmt_rows), path=f"{PAPER_ARCH} serving"),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              k3_on(family[WHISPER_ARCH]), whisper_rows["encoder"],
              max(r["max_abs_err"] for r in rows),
              bound_by=whisper_rows["encoder"]["bound_by"],
              shape=whisper_rows["encoder"]["shape"], dtype="bfloat16",
              causal=False,
              launches_by_role=family[WHISPER_ARCH]["k3_roles"],
              rows_by_role=by_role(whisper_rows),
              path=f"{WHISPER_ARCH} serving"),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              k3_on(family[VLM_ARCH]), vlm_row,
              max(r["max_abs_err"] for r in rows),
              bound_by=vlm_row["bound_by"], shape=vlm_row["shape"],
              dtype="bfloat16", path=f"{VLM_ARCH} serving"),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              sum(l[K3] for r in tp["ranks"]
                  for l in r["serve"]["launches"]), model_row,
              max(r["max_abs_err"] for r in rows),
              bound_by=model_row["bound_by"], shape=model_row["shape"],
              dtype="bfloat16",
              path=f"{ARCH} serving, data {MODEL_DATA} x model {MODEL_M} "
                   f"ranks (a rank's heads)"),
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              rg_model_served[K3], rg_model_row,
              max(r["max_abs_err"] for r in rows),
              bound_by=rg_model_row["bound_by"],
              shape=rg_model_row["shape"], dtype="bfloat16",
              window=rg_model_row["window"],
              path=f"{RG_ARCH} serving, data {RG_MODEL_DATA} x model "
                   f"{MODEL_M} ranks (a rank's heads)"),
    ] + [
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              sum(l[K3] for r in attn["families"][arch]["ranks"]
                  for l in r["launches"]), role_rows[role_key],
              max(r["max_abs_err"] for r in rows),
              bound_by=role_rows[role_key]["bound_by"],
              shape=role_rows[role_key]["shape"], dtype="bfloat16",
              causal=role_rows[role_key]["causal"],
              launches_by_role=dict(Counter(
                  k for r in attn["families"][arch]["ranks"]
                  for k, n in r["k3_roles"].items() for _ in range(n))),
              rows_by_role=by_role(role_rows),
              path=f"{arch} serving, data {ATTN_MODEL_DATA} x model "
                   f"{MODEL_M} ranks (a rank's heads)")
        for arch, role_rows, role_key in (
            (WHISPER_ARCH, {role: bf16_row(c) for role, c in
                            WHISPER_RANK_ROLES.items()}, "encoder"),
            (VLM_ARCH, {"decoder": bf16_row(VLM_RANK_ATTN)}, "decoder"),
            (PAPER_ARCH, {role: bf16_row(c) for role, c in
                          WMT_RANK_ROLES.items()}, "encoder"))
    ] + [
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              sum(l[K3] for r in ep["families"][arch]["ranks"]
                  for l in r["launches"]), bf16_row(shape),
              max(r["max_abs_err"] for r in rows),
              bound_by=bf16_row(shape)["bound_by"],
              shape=bf16_row(shape)["shape"], dtype="bfloat16",
              path=f"{arch} serving, data {EP_MODEL_DATA} x model "
                   f"{MODEL_M} ranks (a rank's heads; its experts)")
        for arch, shape in ((MOE_ARCHS[0], LLAMA4_RANK_ATTN),
                            (MOE_ARCHS[1], KIMI_RANK_ATTN))
    ] + [
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              sched_k3, sched_row, max(r["max_abs_err"] for r in rows),
              bound_by=sched_row["bound_by"], shape=sched_row["shape"],
              dtype="bfloat16",
              launches_by_path={"paged scheduler": sched_k3_by["paged"],
                                "disaggregated scheduler":
                                sched_k3_by["disaggregated"],
                                "dense model-world runs of check (c)":
                                sched_k3_by["dense"]},
              path=f"{ARCH} paged and disaggregated schedulers, data "
                   f"{ATTN_MODEL_DATA} x model {MODEL_M} ranks (a rank's "
                   f"heads; the longest prompt)"),
    ] + [
        entry(K3, "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:70",
              k3_on(family[arch]), row, max(r["max_abs_err"] for r in rows),
              bound_by=row["bound_by"], shape=row["shape"], dtype="bfloat16",
              path=f"{arch} serving")
        for arch, row in ((MOE_ARCHS[0], bf16_row(LLAMA4_ATTN)),
                          (MOE_ARCHS[1], bf16_row(KIMI_ATTN)))
    ] + [
        entry(K4, "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:48",
              sum(c[K4] for c in rg_launches) + rg_train["launches"][K4],
              k4_row, max(k4_err, scan_train["max_abs_err"]),
              shape=k4_row["shape"], dtype=k4_row["dtype"],
              k4_route=k4_row["route"], launches_by_route={
                  route: sum(c[key] for c in rg_launches)
                  + rg_train["launches"][key]
                  for route, key in (("tma", K4_TMA), ("walk", K4_WALK))},
              launches_by_path=by_path(K4, sum(c[K4] for c in rg_launches)),
              train_scan={k: scan_train[k] for k in (
                  "shape", "forward_ms", "backward_ms", "backward_scan_ms",
                  "flips_ms", "plain_forward_ms", "plain_backward_ms",
                  "bound_ms")},
              path=f"{RG_ARCH} serving and training"),
        entry(f"{K4}_decode", "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:48",
              sum(c[K4_WALK] for c in rg_launches), k4_decode_row, k4_err,
              shape=k4_decode_row["shape"], dtype=k4_decode_row["dtype"],
              h0=True, k4_route=k4_decode_row["route"],
              path=f"{RG_ARCH} decode"),
        entry(K4, "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:48",
              rg_model_served[K4], rg_model_k4["prefill"], k4_err,
              shape=rg_model_k4["prefill"]["shape"], dtype="float32",
              k4_route=rg_model_k4["prefill"]["route"],
              launches_by_route={"tma": rg_model_served[K4_TMA],
                                 "walk": rg_model_served[K4_WALK]},
              decode_row={k: rg_model_k4["decode"][k] for k in (
                  "shape", "route", "ms", "plain_ms", "bound_ms",
                  "host_us")},
              path=f"{RG_ARCH} serving, data {RG_MODEL_DATA} x model "
                   f"{MODEL_M} ranks (a rank's channels)"),
        entry(K4, "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan.py:48",
              rg_model_launches[K4], rg_model_k4["train"], k4_err,
              shape=rg_model_k4["train"]["shape"], dtype="float32", h0=True,
              k4_route=rg_model_k4["train"]["route"],
              launches_by_route={
                  "tma": rg_model_launches[K4_TMA],
                  "walk": rg_model_launches[K4] - rg_model_launches[K4_TMA]},
              path=f"{rg_model_path} (a rank's channels)"),
    ]
    print(f"phase seconds (each from the end of the one before): "
          f"{json.dumps(seconds)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [RANKS_WORKER_FLAG]:
        sys.exit(ranks_worker(json.loads(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == [FSDP_RANKS_WORKER_FLAG]:
        sys.exit(fsdp_ranks_worker(json.loads(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == [FSDP_MODEL_WORKER_FLAG]:
        sys.exit(fsdp_model_worker(json.loads(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == [MODEL_WORKER_FLAG]:
        sys.exit(model_worker(json.loads(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == [ATTN_MODEL_WORKER_FLAG]:
        sys.exit(attn_model_worker(json.loads(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == [EP_MODEL_WORKER_FLAG]:
        sys.exit(ep_model_worker(json.loads(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
