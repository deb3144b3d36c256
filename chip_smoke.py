#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``blendjax_torch``) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. card     — ``nvidia-smi``'s name and power limit.
2. kernels  — the hand-written kernels the port has; their library is
              built from ``blendjax_torch/ops/csrc`` into ``build/``, one
              ``nvcc`` per source in parallel, while ``g++`` builds the
              native shared-memory ring from ``blendjax_torch/native``
              (``build`` line; a failed build prints the compiler's output).
3. kernel   — the decode kernel against its plain PyTorch version on the
              card (``decode_cases``: the main shape, the densityopt
              path's (8|32, 128, 128, 3), unaligned bases 1-15, sizes
              around the plan's chunk; f32 and bf16, with and without
              ``linearize``), with its max abs error, and bit-equal to it
              wherever ``linearize`` is off; its time at the main path's
              shape in bf16 and f32, and at (8, 128, 128, 3) in f32, beside
              the bytes it moves and the card's bandwidth bound, the timing
              window's own floor, and the kernel's own duration from
              torch.profiler (``kernel_us``).
4. train    — a full-width TinyDetector (channels 32/64/128, hidden 256,
              K=8) takes 8 Adam steps on seeded 8x480x640x3 uint8 batches
              decoded by the kernel inside the loss, in turns with the step
              eager and captured as a CUDA graph (eager, captured, captured,
              eager: ``FORMS``), each turn from the same seeded state; the
              captured losses and parameters must equal the eager ones bit
              for bit, and 3 more steps of each form under torch.profiler
              give the device's busy time and must show the decode kernel
              inside the replays.  The model path is also held against the
              CPU on a small input.
5. stream   — the datagen path through its entry points: 2 producers
              started by ``BlenderLauncher`` (with
              ``tests/helpers/fake_blender.py`` as the Blender executable)
              -> ``RemoteIterableDataset`` (the example's per-item
              transform) -> ``TorchStream`` -> decode kernel -> train steps.
5b. stream_ab — the same producers with no per-item transform and a
              batch-level one, so batches assemble from the wire frames:
              ``TorchStream(arena=False)`` and ``arena='auto'`` (recycled
              arenas, staged through the feed's pinned ring) in turns of
              ``AB_ITEMS`` items, each batch held on the card to what its
              producers published, the arena checked engaged.
5c. transport — the same-host transports.  The datagen stream of 5b
              (arena engaged) with the producers launched by
              ``BlenderLauncher(proto=...)`` over tcp, shm, shm, tcp, then
              ipc, 512 items a turn: items/s and the p50s of ``recv``,
              ``scatter``, ``arena_wait``, ``device_put`` and ``wait``;
              every batch held to its producers' frames, the shm turns
              checked to have read the rings, nothing left under each
              launch's ``/dev/shm`` prefix.  Then the flagship served (as
              14, float) to 8 ``ServeClient`` threads in one child process,
              ``shm=False`` and ``shm="auto"`` in turns (3 s windows, 2
              rounds): ``serve_qps``, p50/p99, ``serve_shm_bytes`` and
              ``serve_wire_bytes`` per arm; every client's wire checked
              (``tcp``, ``shm`` with no demotion), one seeded episode's
              predictions bit-equal between the arms.
5d. obs     — the measurement plane (``OBS``).  ``obs_feed``: the datagen
              stream of 5b (2 producers, arena, full width) through
              ``TorchStream(timer=StageTimer(trace=True))`` into the
              captured detector step (K1 in the loss), each loss folded
              into a ``fence_chain``; the feed's chrome trace exported and
              read back: every event complete and inside the timer's wall
              time, ``recv``/``scatter``/``device_put``/``recycle``/``step``
              all there with their counts, nothing dropped, at least 3
              thread rows, ``duty_cycle("step")`` the step events over the
              wall time, K1 launched once a step; ``steady`` reads the
              trace over the replayed steps alone (no boot, no capture).
              ``obs_fence``: ``fences_valid`` true at the card's
              bf16 peak and false at 1 FLOP/s (the implied TFLOP/s beside
              the peak); ``fold`` returning before a 50 ms spin ends and
              ``sync`` after it; 32 captured detector steps billed by a
              ``fence_chain`` and by ``torch.cuda.synchronize`` in turns,
              the medians within 5%, every window at least its CUDA-event
              time; ``value_fence`` of the parameters on the card equal to
              the CPU's (1e-6).  ``obs_spans``: ``launch_env_pool(trace=True,
              pipeline_depth=2)`` over 2 cartpole producers, the MLP policy
              sampling on the card, 24 steps lockstep and async in turns;
              the pool's spans merged with a second recorder's file by
              ``export_chrome_trace`` and read back by ``load_chrome_trace``
              (equal to the snapshots sorted by ``(ts, pid)``): at least 3
              pids, at least 20 correlation ids with both sides, each
              producer span inside its client span within 2 ms; ``drain``
              empties the recorder.
6. flash    — the flash-attention forward, dQ and dK/dV kernels against
              their plain passes on the card, case by case (the flagship
              shape in bf16, f32 causal and not, f32 at head dim 128 and
              T=512, GQA, a window, ragged lengths, a q offset, and a bf16
              twin of every f32 case), each with its max abs error, limit
              and route: bf16 takes the tensor-core kernels ("tc"), f32
              the CUDA-core ones ("f32").
7. flash_time — each flash kernel, its plain pass and the library call
              (``scaled_dot_product_attention`` on the fastest of its
              backends, timed as a CUDA graph's replay, for comparison
              only) at the flagship shape, beside its FLOPs, bytes and
              bound; each also on the CUDA-core route (``previous_ms``).
              nvidia-smi samples the SM clock, power and temperature
              beside this window and the decode timing.
7b. layer_norm — K5, the layer norm's forward and backward kernels,
              against their plain passes (``LN_CASES``: the benchmark's
              (131,072, 1,024) bf16 rows, a decode step's 16, (4,096, 128)
              f32 and one case of each other kind of instance), the
              backward's outputs bit-equal over two runs; each pass's time
              beside its byte bound, its plain pass and ``F.layer_norm``
              (``layer_norm_time``, for comparison only); and one capture of
              a seqformer_big train step counted by the kernels' launch
              counters: 13 of each a replay (``layer_norm_engaged``).
              ``probes/layer_norm.py`` runs this phase alone.
7c. mla_kernels — K2-K4 at latent attention's head dims (q/k 192, v
              128) against their plain passes (``MLA_FLASH_CASES``: causal,
              ragged T, a window, and non-causal; and one head of the
              Moonlight step's (8, 8192, 16) at T 8192), and K5's RMS mode
              against its plain passes (``RMS_CASES``: the Moonlight step's
              block rows (65,536, 2,048) and latent rows (65,536, 512) in
              bf16, and small f32 and bf16 ones), its backward bit-equal
              over two runs; the held experts' grouped products (torch's,
              forward, input and weight gradients) against a bf16 product
              an expert at unbalanced counts (``grouped``); each kernel's
              time (CUDA events after a clean flush, and the profiler's
              device time) beside its bound at the step's shapes, and the
              grouped products' at balanced routing (``mla_kernels_time``).
7d. moonlight_step — Moonlight-16B-A3B's block as one card of its
              8-card expert-parallel deployment trains it (``MOONLIGHT``:
              MLA, 1 dense and 4 DeepSeekMoE layers, experts 0-7 of 64, batch
              4 x T 8192 of pendulum episodes): the first forward's loss
              against the float32 reference's (``portbench/reference/
              mla_moe.py``) on one sequence; then ``MOONLIGHT['steps']``
              steps of the captured train step with the bias step, launch
              counters read around them (K2-K4 and K5's RMS mode, every
              launch on the tensor cores, the counts a step as the model
              has them); the routing counters, the step's time and the peak
              memory, and one replay's device time by kernel class.
              ``probes/mla_kernels.py`` runs 7c and 7d alone.
8. seqformer — the flagship SeqFormer (8 layers, d_model 1024, 8 heads,
              T=512, batch 8) takes 8 Adam(1e-4) steps through the flash
              kernels on seeded float16 episodes on the card, eager and
              captured in turns as the train phase, every forward, dQ and
              dK/dV launch on the tensor-core route (counted per replay),
              then 3 more of each form under ``torch.profiler`` for the
              device's busy time and idle share per step; a small f32 model
              is held between card (kernels) and CPU (plain passes).
9. worldmodel — the world-model path through its entry points: 2
              ``btb/episodes.blend.py`` producers -> ``RemoteIterableDataset``
              -> ``TorchStream(transform=episode_transform)`` on the arena
              -> ``worldmodel.train_on_episodes`` (captured) at the flagship
              sizing.
10. rl      — RL through its entry points: 4 ``btb/cartpole.blend.py``
              producers (``BLENDJAX_FAKE_BPY=1``) -> ``launch_env_pool``;
              random forces stepped lockstep and pipelined (4 requests in
              flight per env) in turns, env-steps/s per turn and the ratio;
              then ``control.train_reinforce`` and ``control.train_ppo`` for
              a few iterations each at the examples' defaults, the policy
              sampling on the card at every step, printing rollout and
              update ms, the policy's per-step round trip (p50) and the
              mean return per iteration.  On a fresh rollout of each trained
              policy the logits, log-probs, returns or GAE, the loss and its
              gradients must equal the CPU's within 1e-5, and the update
              captured must equal it eager bit for bit (as the train
              phase).  No kernel is on this path.
11. al      — the actor-learner through its entry points: the RL phase's
              fleet settings -> ``ActorLearner`` (rollout 32, queue 4, a
              200,000-row prioritized ``ReplayBuffer`` at replay ratio 2,
              batch 64): 3 untimed updates (each step's warm-ups and
              capture), then ``run(seconds=3)`` turns lockstep and
              pipelined (``al_turn``: env-steps/s with learning, updates/s,
              the actor's policy and env-step p50, the learner's wait for
              segments, the replay stages), then ``run_offline`` for 200
              updates (``al_offline``: updates/s, the feed's stages).  On a
              live segment and a sampled replay batch the losses and
              gradients must equal the CPU's within 1e-5, and the on-policy
              and replay steps alternated over one Adam must be bit-equal
              captured and eager.  No kernel is on this path.
12. densityopt — the densityopt example through its entry points: 4
              ``btb/supershape.blend.py`` producers (``BLENDJAX_FAKE_BPY=1``)
              started by ``BlenderLauncher`` with ``DATA`` and ``CTRL``
              sockets -> ``RemoteIterableDataset`` and one
              ``btt.DuplexChannel`` each -> ``make_blender_renderer``: the
              32 real frames at the target (5, 5), then
              ``densityopt.optimize`` for 20 iterations (the example runs
              100) at its settings (batch 8, widths 32/64/128 in bf16, Adam
              2e-4 and 5e-2), each decoding its frames with the decode
              kernel and replaying the captured discriminator step, scores
              and ProbModel step.  Per iteration the stages' p50, the stale
              frames, iterations/s and renders/s; the loop again over the
              recorded frames and samples eager and captured in turns
              (bit-equal, and equal to the live run); one step of each on
              the card against the CPU at f32 within ``DO_ATOL``.

13. quant   — the int8 products (``ops/quant.py``: ``torch._int_mm``) on the
              card equal the CPU's int64 products exactly at the flagship's
              projection shapes (k = 1,024 and 4,096; 1, 8 and 16 rows) and
              the detector's three convs on (8, 480, 640, 3), each timed
              beside its f32 counterpart.
14. serve   — the flagship SeqFormer (rope) served by ``PolicyServer`` from
              16 slots with a 512-step ring to 8 ``ServeClient`` threads
              (32-step episodes, each client's first admitted with a 16-step
              prefix): float batched, serial and int8 windows in turns, with
              the serve benchmark's metrics (``serve_qps``, ``serve_p50_ms``,
              ``serve_p99_ms``, ``serve_batch_x``, ``serve_int8_x``), the
              ``SERVE_STAGES`` p50s, each captured bucket's device time
              beside its bound, and a profile of the 8-row tick (float and
              int8: busy time, kernels, the ten costliest).  Checked: captured ticks bit-equal to eager
              ones, every bucket; batched per-row decode against each episode
              alone (1e-5); the card against the CPU on a small model (1e-5).
              ``serve_small`` repeats the windows at the serve benchmark's
              own width (d_model 64, 4 heads, 2 layers, a 64-step ring).
              These clients stay on ZMQ (``shm=False``); 5c measures ShmRPC.
15. dream   — ``worldmodel.dream`` on the world-model phase's flash-trained
              model: batch 8, a 64-step prefix, 448 dreamed steps, float and
              int8 in turns (steps/s); the rollout against the CPU on a small
              model (1e-5).
16. infer_int8 — ``generate.py --infer-int8``'s path: 2 producers, the first
              batch held back, the detector trained on the rest, then K1's
              decode to f32 and the int8 detector; against the CPU on the
              same frames (``INFER_INT8_ATOL``).
17. ha      — state and checkpoints.  ``ha_resume``: the train phase's
              full-width detector (K1) and the flagship SeqFormer (K2-K4)
              each take 4 captured steps from a seeded state, are saved
              (the barrier's host copy, ``ha_snapshot``, timed on its first
              cut, which allocates the pinned buffers, and again into the
              same buffers; then ``CheckpointManager.save``,
              ``ha_serialize``) and take 4 more;
              a differently seeded state whose step is captured gets the
              cut restored in place (``ha_restore``) and takes the same 4:
              losses, parameters and Adam's tensors bit-equal, the same
              graph (no new capture), 3P + 2 leaves in the file.
              ``ha_al``: the al phase's fleet and settings with a
              ``TrainCheckpointer`` cutting every 2 updates; a forced cut
              restored into a fresh learner on the card draws the no-crash
              replay stream, parameters and Adam bit-equal; then
              ``ckpt_overhead_x`` (``benchmarks/ha_benchmark.py``'s
              interleaved ``run_offline`` windows, on/off median ratio).
              ``ha_drill``: two cartpole producers feed a
              ``python -m blendjax_torch.ha.learner`` child on the card under
              a ``LearnerSupervisor``; SIGKILL after its first cut; one
              death, one respawn, resumed from a real cut, past the
              pre-kill count, the postmortem naming the learner;
              ``learner_recovery_s`` (the kill to the mirror showing the
              respawn past the pre-kill count) split by the child's boot
              times (import, CUDA init, build, restore, the first update).
18. replay_service — the sharded replay service at the reference replay
              benchmark's shape ((120, 160, 3) uint8 frames, 4,096 rows,
              batch 32): 2 shard processes (``ShardFleet``), one
              ``ShardedReplay`` over ShmRPC and one over tcp, and an
              in-process ``ReplayBuffer``, each sampling onto the card
              through pinned staging buffers; the first batches of all three
              bit-equal on the card; interleaved windows give
              ``replay_shard_x`` (service over in-process batches/s) and
              ``replay_degraded_x`` (a shard quarantined over healthy) per
              wire; then a ``FleetSupervisor`` over the fleet, shard 0
              SIGKILLed after 512 more appends: quarantined, respawned, restored from its
              checkpoint and spill tail with its rows' digest unchanged,
              re-admitted; nothing left under the fleet's ``/dev/shm``
              prefixes.  No kernel is on this path.
19. flywheel — (a) the al phase's cartpole fleet -> ``ActorLearner`` over a
              ``ShardedReplay`` on 2 shard processes (replay ratio 1) with a
              ``TelemetryHub`` and a ``WeightPublisher`` (every 2 updates);
              a ``PolicyServer`` on the card subscribed to the bus serves 2
              ``ServeClient``s in a child process throughout: turns with the
              bus on and off (env-steps/s beside the al phase's,
              ``weight_publish``), each client's weight versions strictly
              increasing to the last publish with no error, the hub's scrape
              holding the learner's, the replay's (shards as remotes) and the
              server's telemetry, its Prometheus text parsing.  (b) the
              flagship served (as 14) with clients stepping while a second
              parameter set is published, float and then int8
              (``quantize="seqformer"`` into an int8 server): snapshot MB,
              publish ms, ``weight_swap_ms`` (publish's return to the first
              reply at the new version), ``weight_swap_qps_dip_x``
              (``benchmarks/weight_benchmark.py``'s 100 ms buckets); held:
              no tick recaptured, every served tensor the published one in
              its layout, and the first captured tick after a further swap
              bit-equal to an eager ``decode_step`` with the new params on
              the same cache.  No kernel is on this path.
20. scenario — the scenario plane at the reference's configuration
              (``benchmarks/scenario_benchmark.py``: ``lite`` at 200 us of
              physics a frame, ``rich`` at 4,000 us): a ``FleetSet(ctrl=
              True)`` of 3 fleets x 2 echo producers
              (``tests/blender/torch_env.blend.py``) launched lite, lite,
              rich -> ``ActorLearner(scenarios=DomainRandomizer, curriculum=
              CurriculumScheduler, fanin_min_ready=1, device="cuda")`` over a
              200,000-row ``ReplayBuffer`` at ratio 2.  ``scenario_run``: the
              uniform curriculum's bootstrap and run, then a
              ``pin({"rich": 1.0})`` shift: every fleet rich, every push seen
              applied, both scenarios in the replay strata.
              ``scenario_fanin``: env-steps/s with learning at
              ``fanin_min_ready=1`` against the all-live barrier in turns,
              and the pool's ready-first/lockstep ratio over 2 lite and 2
              rich producers.  ``scenario_strata``: a replay update on a
              batch drawn under ``{"lite": 0.25, "rich": 0.75}`` on the card
              against the CPU (1e-5), captured = eager; ``sample``'s p50 at
              200,000 rows, strata and plain.  ``scenario_ha``: a cut
              mid-curriculum resumed in place into a new learner over the
              same fleets (curriculum equal, assignment re-pushed, no
              recapture).  ``scenario_chaos``: a producer SIGKILLed and
              pushed into 12 times within 6 s, respawned by its fleet's
              supervisor, its scenario following it back; then a quiet kill
              with nothing pushed in the outage: the respawn holds its
              launch scene until ``reassign``'s push alone turns it.  No
              kernel is on this path.
21. serve_fleet — the flagship (``SERVE``'s widths) in 3 replica processes
              on the card (``ServerFleet(device="cuda")``, one seed, each
              subscribed to one ``WeightPublisher``) behind the gateway, 16
              client threads of 32-step episodes in a child process.
              ``fleet_boot``: spawn-to-ready per replica, the card's memory
              before and after, every bucket captured before serving
              (the server warms a captured model), one seeded episode
              bit-equal on all three.
              ``gateway_scale``: 1-replica (r1, r2 drained) and 3-replica
              windows in turns and a direct-dial arm to r0, the 16 client
              threads spread over 4 processes that start together
              (``gateway_scale_x``, p50/p99, each arm's ``bound_by`` from
              the clients' and the gateway loop's CPU shares, the
              gateway counters; no error, every step on its lease's replica,
              no capture in a window, a seeded episode through the gateway
              bit-equal to it dialled straight).  ``gateway_sharded``:
              ``start_sharded_gateway_thread(workers=2)`` with 2 active
              workers and 1 in turns (``gateway_shard_x``; relays after the
              rendezvous at most resets plus retries; no ``/dev/shm`` left).
              ``gateway_chaos``: r1 SIGKILLed under ``FleetWatchdog``; at
              most one stale-lease error per client, the kill to the first
              answered scrape, every acknowledged prediction against the
              episode replayed on one in-process flagship
              (``FLEET_REPLAY_ATOL``) beside a double-applied step's gap.
              ``canary``: ``WeightBusController`` promotes v2 under traffic;
              v3, on a canary replica of its own (a canary bus) admitted
              drained and so given no traffic, is rolled back by its verdict
              timeout and the stable weights republished to every replica;
              each swap's first captured tick bit-equal to eager, no
              recapture.
              ``autoscale``: ``AutoscaleController`` (always up) grows a
              fourth replica on the card and commits it after its healthy
              window; the always-down controller then chooses a replica
              (its least-loaded), drains it and retires it
              (``resize_settle_s``, the card's memory; no client error).
              ``reshard``: ``reshard_replay`` 2 -> 3 shards under appends,
              the draws on the card bit-identical to an unresharded twin's,
              then the new shard SIGKILLed mid-handoff: aborted whole, the
              map unchanged.  No kernel is on this path.
22. moe     — the flagship SeqFormer (``SEQ``'s widths) with 8 experts,
              top-2, capacity factor 1.25 and a 0.01 load-balance weight
              (``MOE``; ``benchmarks/suite_device.py``'s ``phase_moe_compare``):
              the routed layer with sort dispatch, the dense mixture and the
              routed layer with scatter dispatch, each 8 Adam(1e-4) steps on
              seeded float16 episodes through K2-K4, eager and captured in
              turns as the seqformer phase (captured bit-equal to eager, every
              flash launch on the tensor-core route, 3 profiled steps of each
              form), with ``moe_stats``'s measured dispatch fraction and
              ``topk_over_dense``.  Sort and scatter dispatch on the card agree
              within ``MOE_DISPATCH_ATOL`` on an f32 case; a small f32 MoE
              model's loss, gradients and rollout on the card (flash, f32
              route) against the CPU within ``MOE_ATOL``, the routing compared
              token by token (a differing choice passes only as a tie, its
              k-th and (k+1)-th probabilities within ``MOE_TIE``).
23. dp      — 2 rank processes on ``cuda:0`` in a gloo process group (NCCL
              refuses two ranks on one device), each ``python3 chip_smoke.py
              --dp-rank '<json>'``: a ``data_mesh()`` on the card; 2 producers
              per rank through ``BatchLoader(shard=(rank, 2))`` and
              ``TorchStream(sharding=data_sharding(mesh))`` into
              ``datagen.train_on_stream(mesh=)`` (the full-width TinyDetector,
              K1 decoding each rank's shard inside the loss); then 4
              data-parallel f32 steps on a seeded global (8, 480, 640, 3)
              batch against one process's eager steps (``DP``'s limits), and
              the same for a ``{"model": 2}`` tensor-parallel step with
              ``detector_rules()``, K1 in every held step's loss; the DP
              step's ms beside one process's, for the record.  The sharded
              steps run eager: gloo's collectives cannot be captured.
24. ring    — 2 rank processes on ``cuda:0`` over gloo, mesh ``{"seq": 2}``
              (``--ring-rank``), each holding (8, 256, 8, 128) of the
              flagship attention shape (8, 512, 8, 128) bf16: ``ring_flash``
              causal and not, ``zigzag_flash`` causal, ``ulysses_flash``
              causal and ``ring_flash`` with a 128 window, each output and
              q/k/v gradient against one process's K2-K4 on the whole
              sequence (``RING``'s limits), every K2-K4 launch counted and on
              the ``tc`` route, the rotations and all-to-alls counted
              (``parallel/p2p.py``; the rotation staged through the host),
              ms per call beside one process's; the f32 plain ``ring``
              against the plain full attention (2e-5, 5e-4); then the
              flagship SeqFormer (``SEQ``'s widths) takes 4 Adam(1e-4)
              ``ring_flash`` steps through ``make_seqformer_train_step``,
              each rank on its T/2 shard, against one process's eager steps
              (:func:`ring_flagship`; every layer norm of the sharded steps
              counted through K5).  A flagship outside ``RING``'s limits
              fails the run after the last phase, so that the phases after
              this one still run and report; ``probes/ring_norm.py`` runs
              the flagship check on several seeds with K5 and with the
              plain norm.
25. rl_dp   — 2 rank processes on ``cuda:0``, mesh ``{"data": 2}``
              (``--rl-dp-rank``): one seeded rollout split 4/2 (rank 1's rows
              padded) through one sharded ``ActorLearner`` update against
              one process's (``RL_DP``'s limits); then each rank's
              ``FleetSet`` of 2 cartpole producers through
              ``ActorLearner(mesh=)`` and ``control.train_reinforce(mesh=)``,
              env-steps/s and updates/s beside one process's.  No kernel.
              The dp phase also gathers its TP state through
              ``convert.train_state_arrays`` (c10d's all-gather): the arrays
              must be the ranks' local shards put together, bit for bit.
26. pipe    — pipeline parallelism (``PIPE``, ``MPMD``).  SPMD: 2 rank
              processes on ``cuda:0`` over gloo, mesh ``{"pipe": 2}``
              (``--pipe-rank``): ``tests/test_pipeline.py``'s residual stage
              ``x + gelu(dense(x))`` at the flagship width, f32, 8
              microbatches of 64 rows; ``make_pipeline``'s forward, then
              ``make_pipeline_train`` with ``"gpipe"`` and ``"1f1b"``
              (``in_proj`` 32 -> 1024, ``out_proj`` 1024 -> 8, MSE), each held
              to one process's sequential autograd on the card, the
              rotations counted (all host-staged) and ms per step beside the
              sequential step's.  MPMD: ``StageFleet`` stage processes
              on the card at ``benchmarks/pipeline_benchmark.py``'s setting
              (3 stages, 6 layers, wire 64, d_in 32, d_out 8, batch 64, 8
              microbatches, work_us 0): 4 updates each in the ``mse`` and
              ``pg`` families held to full-model plain SGD on the card;
              updates/s beside a 1-stage fleet's; the kill drill (the middle
              stage SIGKILLed mid-update under ``FleetWatchdog(restart=True)``,
              6 updates equal to the uninterrupted plain SGD run, no
              ``/dev/shm`` object left); and ``ActorLearner(pipeline_stages=)``
              over a 2-stage ``pg`` fleet at cartpole's dims, 3 offline
              updates from a prioritized buffer, its state equal to the
              fleet's parameters, its losses and the fleet's parameters held
              to plain SGD on the batches it drew.  No kernel.

Every kernel's launch count is zeroed just before the path that runs it
(the datagen stream, each shm turn of the transport phase, the obs phase's
traced feed (``obs_feed``), the densityopt loop and the int8 inference for the
decode kernel, the world-model stream for the flash kernels, and the ha
phase's resumed steps for all four; the moe arms' turns for the flash
kernels and each dp rank's stream and held steps for the decode kernel, and each ring
rank's cases and flagship steps for the flash kernels) and read just after; a kernel a path
never launched fails the run.  K5's two counters are read around each phase that runs
the SeqFormer in this process (transport's server, seqformer, worldmodel, serve,
serve_small, dream, ha, flywheel, serve_fleet's replays, moe) and in the ring ranks'
sharded steps, each printed as a ``layer_norm_launches`` line and listed by path in the
kernels line; a path with no forward launch, or a training path with no backward one,
fails the run.  The pipe phase launches none of them: its ``launches_by_path``
entries, checked 0, count this process (``pipe``) and both SPMD ranks
(``pipe_ranks``); its stage processes enroll no kernel wrapper, and their
counts are not read.  The line before the last holds every kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.  Any failed check exits nonzero
without printing it, as does a host without CUDA or a directory without
the ``blendjax_torch`` package beside this file.

Kernel times are medians of CUDA-event windows with the L2 flushed before
each (``ms``: the flush buffer zeroed, so up to the L2's 50 MB of dirty
lines are written back inside the window; ``ms_clean_l2``: the buffer then
read once, so the L2 holds clean lines and the window only the kernel's
own traffic).
"""

from __future__ import annotations

import contextlib
import faulthandler
import glob
import json
import logging
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: Published HBM bandwidth, bytes/s, by the card name nvidia-smi prints:
#: H100 SXM5 80GB, 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet).  A
#: card not listed here stops the run until its rate is added.
HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
#: Published dense bf16 tensor-core rate, FLOP/s, by the same names: H100
#: SXM5 80GB, 989.4 TFLOP/s (NVIDIA H100 Tensor Core GPU data sheet).
BF16_PEAK = {
    "NVIDIA H100 80GB HBM3": 989.4e12,
}

MAIN_SHAPE = (8, 480, 640, 3)  # examples/datagen: batch 8 of 480x640 RGB
# examples/densityopt: the simulated batch of 8 and the 32 real frames, 128x128 RGB
DENSITYOPT_SHAPES = ((8, 128, 128, 3), (32, 128, 128, 3))
# benchmarks/suite_device.py's flagship SeqFormer: batch 8, 513-step
# episodes (T = 512) of 32 channels, d_model 1024, 8 heads, 8 layers
SEQ = dict(batch=8, seq_len=512, obs_dim=32, d_model=1024, n_heads=8, n_layers=8, lr=1e-4)
FLASH_SHAPE = (SEQ["batch"], SEQ["seq_len"], SEQ["n_heads"],
               SEQ["d_model"] // SEQ["n_heads"])  # (B, T, H, Dh)
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")  # each counted by route too
LN_KERNELS = ("layer_norm_fwd", "layer_norm_bwd")
#: the card's name and power limit as nvidia-smi prints them, and its HBM
#: rate (set by main)
CARD = None
HBM_RATE = None


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def peak_rate(table, name):
    if name not in table:
        raise SystemExit(f"chip_smoke: no peak rate on record for {name!r}")
    return table[name]


#: device cycles (about 0.5 ms) the stream spins before each timed window,
#: so the host has enqueued the timed work before the window opens
HOST_LEAD_CYCLES = 1_000_000


def time_ms(torch, fn, reps=50, flush=None, clean=False):
    """Median CUDA-event time of ``fn`` in ms after warm-up.  ``flush``
    (a large tensor) is rewritten before each launch so the 50 MB L2
    holds none of the inputs, as for a batch just copied in.  The rewrite
    leaves the L2 full of dirty lines, which ``fn`` then writes back inside
    its window; with ``clean`` the buffer is also read once after it is
    zeroed, so the L2 holds clean lines and the window only ``fn``'s own
    traffic.  A device-side spin of :data:`HOST_LEAD_CYCLES` precedes each
    start event, so the window holds the device's time for ``fn`` and not
    the host's path to its launches, up to about 0.5 ms of host work."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            if clean:
                flush.sum()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def profiled_us(torch, fn, flush, reps=20):
    """Median device duration in us of the kernels ``fn`` launches, from
    torch.profiler (CUDA activity), with the L2 flushed clean before each
    call as for ``time_ms(clean=True)``: the kernel's own time,
    without the event window's floor.  The flush's own kernels (fill and
    reduce) are left out by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            flush.sum()
            fn()
            torch.cuda.synchronize()
    flush_names = {"zero", "fill", "reduce", "sum"}
    times = sorted(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not any(k in e.name.lower() for k in flush_names))
    return times[len(times) // 2] if times else float("nan")


def graph_replay(torch, fn, stream):
    """``fn`` captured in a CUDA graph on ``stream`` after a warm-up there;
    returns the graph's replay: the same device work, with no host dispatch
    between its kernels."""
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    stream.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    return graph.replay


SMI_FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")


@contextlib.contextmanager
def smi_window(label):
    """Samples the card's SM clock, power and temperature with nvidia-smi
    about every 0.25 s in a thread while the block runs, then emits each
    field's range over the window."""
    samples, stop = [], threading.Event()
    cmd = ["nvidia-smi", "--query-gpu=" + ",".join(SMI_FIELDS),
           "--format=csv,noheader,nounits"]

    def sample():
        while not stop.is_set():
            out = subprocess.run(cmd, capture_output=True, text=True)
            row = out.stdout.strip().splitlines()[:1]
            if out.returncode == 0 and row:
                samples.append([v.strip() for v in row[0].split(",")])
            stop.wait(0.25)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()
    ranges = {}
    for i, field in enumerate(SMI_FIELDS):
        vals = [float(s[i]) for s in samples
                if len(s) > i and s[i].replace(".", "", 1).isdigit()]
        ranges[field] = [min(vals), max(vals)] if vals else None
    emit({"phase": "smi", "window": label, "samples": len(samples), "ranges": ranges})


def bf16_ulp(torch, ref):
    """One bf16 ulp of each value (8 significant bits)."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def decode_cases(torch, image, g):
    """The decode kernel's checked inputs as ``(label, uint8 tensor)``: the
    main shape, the densityopt path's two and a small odd one, the main
    shape's flat buffer from each base offset 1-15 (unaligned input; the
    small one's from 1), and flat sizes around the plan's chunk
    (``image.DECODE_CHUNK``)."""
    chunk = image.DECODE_CHUNK
    cases = []
    for shape in DENSITYOPT_SHAPES:
        cases.append((str(shape), torch.randint(0, 256, shape, dtype=torch.uint8,
                                                device="cuda", generator=g)))
    for shape in (MAIN_SHAPE, (2, 13, 17, 3)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
        cases.append((str(shape), x))
        for k in range(1, 16) if shape == MAIN_SHAPE else (1,):
            cases.append((f"{shape}[{k}:]", x.reshape(-1)[k:]))
    flat = torch.randint(0, 256, (132 * chunk + 7,), dtype=torch.uint8, device="cuda",
                         generator=g)
    for size in (1, 17, chunk - 1, chunk + 1, 132 * chunk + 7):
        cases.append((f"n={size}", flat[:size]))
    return cases


def kernel_phase(torch, image, peak):
    g = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for label, inp in decode_cases(torch, image, g):
        results = []
        for dtype in (torch.float32, torch.bfloat16):
            for linearize in (False, True):
                out = image.decode_frames_cuda(inp, dtype, linearize)
                ref = image.decode_frames_plain(inp, dtype, linearize)
                torch.cuda.synchronize()
                check(out.shape == ref.shape and out.dtype == dtype,
                      f"decode {label} shape/dtype")
                err = (out.float() - ref.float()).abs()
                max_err = err.max().item()
                if dtype == torch.float32:
                    limit = 1e-6 if linearize else 1e-7
                    ok = max_err <= limit
                else:
                    limit = "1 bf16 ulp"
                    ok = bool((err <= bf16_ulp(torch, ref)).all())
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                results.append({"dtype": str(dtype), "linearize": linearize,
                                "max_abs_err": max_err, "limit": limit, "ok": ok,
                                "bit_equal": torch.equal(out.view(bits), ref.view(bits))})
                check(ok, f"decode_u8 {label} {dtype} linearize={linearize}")
                # without linearize every step is exact or correctly rounded
                check(linearize or results[-1]["bit_equal"],
                      f"decode_u8 {label} {dtype} bit-equal to the plain decode")
                if label == str(MAIN_SHAPE) and dtype == torch.bfloat16 and not linearize:
                    main_err = max_err
        emit({"phase": "kernel", "kernel": "decode_u8", "case": label,
              "numel": inp.numel(), "results": results})

    x = torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda", generator=g)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def decode():
        return image.decode_frames_cuda(x, torch.bfloat16)

    ms = time_ms(torch, decode, flush=flush)
    ms_clean = time_ms(torch, decode, flush=flush, clean=True)
    plain_ms = time_ms(torch, lambda: image.decode_frames_plain(x, torch.bfloat16),
                       flush=flush)
    # the window's own floor: no work between the events, the same flush
    window_floor_ms = time_ms(torch, lambda: None, flush=flush, clean=True)
    kernel_us = profiled_us(torch, decode, flush)

    # The one library call that computes the same function: uint8 promoted
    # to f32, times f32(1/255), rounded to nearest-even bf16 on the store.
    # Timed for comparison only; the port never calls it.
    def library():
        return torch.mul(x, 1.0 / 255.0,
                         out=torch.empty(x.shape, dtype=torch.bfloat16, device="cuda"))

    check(torch.equal(library().view(torch.int16),
                      image.decode_frames_plain(x, torch.bfloat16).view(torch.int16)),
          "torch.mul library call bit-equal to the plain decode")
    library_ms = time_ms(torch, library, flush=flush)
    library_ms_clean = time_ms(torch, library, flush=flush, clean=True)
    f32_ms = time_ms(torch, lambda: image.decode_frames_cuda(x, torch.float32), flush=flush)
    f32_ms_clean = time_ms(torch, lambda: image.decode_frames_cuda(x, torch.float32),
                           flush=flush, clean=True)
    f32_kernel_us = profiled_us(torch, lambda: image.decode_frames_cuda(x, torch.float32),
                                flush)
    small = densityopt_decode_time(torch, image, peak, g, flush, window_floor_ms)
    del flush
    nbytes = x.numel() * (1 + 2)  # uint8 read once, bf16 written once
    bound_ms = nbytes / peak * 1e3
    f32_bound_ms = x.numel() * (1 + 4) / peak * 1e3
    rec = {"phase": "kernel_time", "kernel": "decode_u8", "shape": list(MAIN_SHAPE),
           "out": "bfloat16", "bytes_in": x.numel(), "bytes_out": 2 * x.numel(),
           "ms": ms, "ms_clean_l2": ms_clean, "window_floor_ms": window_floor_ms,
           "kernel_us": kernel_us, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_ms_clean_l2": library_ms_clean,
           "library_call": "torch.mul(x, 1/255, out=bf16)",
           "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
           "bound_ms": bound_ms, "hbm_peak_share": bound_ms / ms,
           "hbm_peak_share_clean_l2": bound_ms / ms_clean}
    emit(rec)
    emit({"phase": "kernel_time", "kernel": "decode_u8", "shape": list(MAIN_SHAPE),
          "out": "float32", "ms": f32_ms, "ms_clean_l2": f32_ms_clean,
          "window_floor_ms": window_floor_ms, "kernel_us": f32_kernel_us,
          "bound_ms": f32_bound_ms,
          "hbm_peak_share": f32_bound_ms / f32_ms,
          "hbm_peak_share_clean_l2": f32_bound_ms / f32_ms_clean})
    return {"max_abs_err": main_err, "ms": ms, "ms_clean_l2": ms_clean, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "library_ms": library_ms, "densityopt": small}


def densityopt_decode_time(torch, image, peak, g, flush, window_floor_ms):
    """The decode at the densityopt path's simulated batch, (8, 128, 128, 3)
    uint8 -> f32 as ``densityopt.optimize`` calls it: 1.97 MB, about 0.6 us
    at the card's bandwidth, under the event window's ~3 us floor, so the
    kernel's own duration comes from the profiler (``kernel_us``).  Beside
    it the plain decode (two kernels: the cast and the multiply) and the
    library call (``torch.mul`` into f32, checked bit-equal first, one
    kernel, so the profiler times it too)."""
    shape = DENSITYOPT_SHAPES[0]
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)

    def decode():
        return image.decode_frames_cuda(x, torch.float32)

    def plain():
        return image.decode_frames_plain(x, torch.float32)

    def library():
        return torch.mul(x, 1.0 / 255.0,
                         out=torch.empty(x.shape, dtype=torch.float32, device="cuda"))

    check(torch.equal(library().view(torch.int32), plain().view(torch.int32)),
          "torch.mul into f32 bit-equal to the plain decode at the densityopt shape")
    rec = {"phase": "kernel_time", "kernel": "decode_u8", "shape": list(shape),
           "out": "float32", "bytes_in": x.numel(), "bytes_out": 4 * x.numel(),
           "ms": time_ms(torch, decode, flush=flush),
           "ms_clean_l2": time_ms(torch, decode, flush=flush, clean=True),
           "window_floor_ms": window_floor_ms,
           "kernel_us": profiled_us(torch, decode, flush),
           "plain_ms": time_ms(torch, plain, flush=flush),
           "library_ms": time_ms(torch, library, flush=flush),
           "library_kernel_us": profiled_us(torch, library, flush),
           "library_call": "torch.mul(x, 1/255, out=f32)",
           "bound_ms": x.numel() * (1 + 4) / peak * 1e3}
    rec["hbm_peak_share_kernel_us"] = rec["bound_ms"] * 1e3 / rec["kernel_us"]
    emit(rec)
    return rec


#: the train step's two forms, run in turns, each turn from the same seeded
#: state over the same batches: eager, captured, captured, eager
FORMS = ("eager", "captured", "captured", "eager")
#: how the captured step is held to the eager one (losses and parameters
#: after every turn's steps): "exact" is bit-equality
CAPTURED_MATCH = "exact"


def _timed_steps(torch, step, state, batches):
    """``step`` over ``batches``, each timed to its completion (the loss
    read back, as the trainers do); returns (state, losses, step ms)."""
    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))  # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
    return state, losses, times


def _max_param_diff(torch, params, ref):
    return max((params[k].float() - ref[k].float()).abs().max().item() for k in ref)


def _forms(torch, phase, make_state, loss, batches, counts, profile_kernels):
    """The train step in both forms, in :data:`FORMS` turns, each from
    ``make_state()`` over ``batches``: step times, losses, launch counts
    (``counts()``, zeroed by ``counts(zero=True)`` before each turn), peak
    memory, and the losses' and parameters' largest difference from the
    first eager turn.  The first turn of each form is followed by 3 more
    steps under torch.profiler (:func:`_device_profile`).  For every kernel
    in ``profile_kernels`` (its name in the profiler -> its wrapper), the
    profiler's count of its runs on the card in those steps must equal what
    its wrapper's launch counter added for them; in the captured form,
    both must equal 3 times the launches the graph recorded per replay.
    Emits one line per turn; returns the turns."""
    from blendjax_torch.models.train import WARMUP_STEPS, make_train_step

    turns, ref, profiled = [], None, set()
    for turn, form in enumerate(FORMS):
        state = make_state()
        step = make_train_step(loss, capture=form == "captured")
        counts(zero=True)
        torch.cuda.reset_peak_memory_stats()
        state, losses, times = _timed_steps(torch, step, state, batches)
        launched = counts()
        params = {k: v.detach().clone() for k, v in state.params.items()}
        if ref is None:
            ref = (losses, params)
        # the captured form's first WARMUP_STEPS are eager and the next one
        # captures: its replays are the steps after those
        replays = times[WARMUP_STEPS + 1:] if form == "captured" else times
        rec = {"phase": phase + "_turn", "turn": turn, "form": form, "losses": losses,
               "step_ms": times, "median_step_ms": statistics.median(times),
               "median_replay_ms": statistics.median(replays) if form == "captured" else None,
               "launches": launched, "graphs": len(step.graphs),
               "params": sum(v.numel() for v in state.params.values()),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "loss_max_abs_diff": max(abs(a - b) for a, b in zip(losses, ref[0])),
               "param_max_abs_diff": _max_param_diff(torch, params, ref[1])}
        del params
        if form not in profiled:
            profiled.add(form)
            more = iter(batches)
            counted = {}

            def profiled_step():
                nonlocal state
                state, loss = step(state, next(more))
                float(loss)  # waits for the step, as in the timed steps

            def recording():  # the counters' baseline, after the guard step
                counted.update({name: fn.launches for name, fn in profile_kernels.items()})

            prof = _device_profile(torch, profiled_step, PROFILED_STEPS,
                                   rec["median_step_ms"], phase + "_profile", form,
                                   on_active=recording)
            rec["profile"] = {k: prof[k] for k in ("busy_ms_per_step", "idle_share",
                                                   "idle_share_of_median_step")}
            per_replay = {fn: n for g in step.graphs.values() for fn, n, _ in g.launches}
            rec["profiled_launches"] = {}
            for name, fn in profile_kernels.items():
                ran = sum(n for k, n in prof["runs"].items() if name in k)
                added = fn.launches - counted[name]
                rec["profiled_launches"][name] = {
                    "profiler": ran, "counter": added,
                    "per_replay": per_replay.get(fn) if form == "captured" else None}
                check(ran > 0, f"{phase} {form}: the profiler found {name} in the steps")
                check(ran == added, f"{phase} {form}: the profiler's {ran} runs of {name} "
                      f"match the {added} launches its counter added")
                if form == "captured":
                    check(ran == PROFILED_STEPS * per_replay.get(fn, 0),
                          f"{phase} captured: {name} ran {PROFILED_STEPS} x the launches "
                          "the graph recorded per replay")
        emit(rec)
        turns.append(rec)
        del state, step
    torch.cuda.empty_cache()
    return turns


#: steps of each form under torch.profiler
PROFILED_STEPS = 3
#: steps the profiler traces and discards before the profiled ones
#: (:func:`_device_profile`)
PROFILE_WARMUP_STEPS = 1
#: the spin that opens a profiled window (about 10 ms at 1.98 GHz), and
#: the marker spins around its recorded steps (about 5 us)
#: (:func:`_device_profile`)
PROFILE_ABSORB_CYCLES = 20_000_000
PROFILE_MARK_CYCLES = 10_000


def _check_forms(phase, turns):
    for rec in turns:
        check(all(math.isfinite(v) for v in rec["losses"]), f"{phase} losses finite")
        check(rec["losses"][-1] < rec["losses"][0], f"{phase} loss fell")
        check(rec["graphs"] == (1 if rec["form"] == "captured" else 0),
              f"{phase} {rec['form']}: one captured graph for one batch signature")
        check(rec["loss_max_abs_diff"] == 0 and rec["param_max_abs_diff"] == 0,
              f"{phase} {rec['form']} turn {rec['turn']}: losses and parameters "
              f"{CAPTURED_MATCH} to the first eager turn")


def _form_summary(turns):
    """Per form: the median of its turns' step times (and replay times)."""
    out = {}
    for form in ("eager", "captured"):
        recs = [r for r in turns if r["form"] == form]
        out[form] = {
            "median_step_ms": statistics.median(t for r in recs for t in r["step_ms"]),
            "turn_medians_ms": [r["median_step_ms"] for r in recs],
            "peak_memory_gb": max(r["peak_memory_gb"] for r in recs),
            "profile": recs[0]["profile"]}
        if form == "captured":
            out[form]["median_replay_ms"] = statistics.median(r["median_replay_ms"]
                                                               for r in recs)
    return out


def train_phase(torch, datagen, detector, image):
    # the model path on the card against the CPU on a small input (float32
    # compute; TF32 is off for this, see main)
    cfg = dict(num_keypoints=2, channels=(8, 16), hidden=32)
    params = detector.init(torch.Generator().manual_seed(0), device="cpu", **cfg)
    xg = torch.Generator().manual_seed(1)
    u8 = torch.randint(0, 256, (2, 33, 48, 3), dtype=torch.uint8, generator=xg)
    xy = torch.rand((2, 2, 2), generator=xg)
    loss = datagen.make_loss(torch.float32)
    cpu_loss = loss(params, {"image": u8, "xy": xy}).item()
    gpu_loss = loss({k: v.cuda() for k, v in params.items()},
                    {"image": u8.cuda(), "xy": xy.cuda()}).item()
    emit({"phase": "reference", "cpu_loss": cpu_loss, "cuda_loss": gpu_loss,
          "rtol": 1e-4})
    check(math.isclose(cpu_loss, gpu_loss, rel_tol=1e-4), "small-input loss vs CPU")

    dg = torch.Generator(device="cuda").manual_seed(1)
    # fixed targets: the loss must fall within 8 steps
    target = torch.rand((MAIN_SHAPE[0], 8, 2), generator=dg, device="cuda")
    batches = [{"image": torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8,
                                       device="cuda", generator=dg),
                "xy": target} for _ in range(8)]

    def counts(zero=False):
        if zero:
            image.decode_frames_cuda.launches = 0
        return {"decode_u8": image.decode_frames_cuda.launches}

    turns = _forms(torch, "train",
                   lambda: datagen.make_state(torch.Generator(device="cuda").manual_seed(0)),
                   datagen.make_loss(), batches, counts,
                   {"decode_u8_kernel": image.decode_frames_cuda})
    forms = _form_summary(turns)
    med = forms["captured"]["median_step_ms"]
    emit({"phase": "train", "steps": len(batches), "first_loss": turns[1]["losses"][0],
          "last_loss": turns[1]["losses"][-1], "median_step_ms": med, "forms": forms,
          "captured_match": CAPTURED_MATCH,
          "model_tflop_per_s": detector.train_flops(*MAIN_SHAPE[:3]) / (med * 1e-3) / 1e12})
    _check_forms("train", turns)
    for rec in turns:
        check(rec["launches"]["decode_u8"] == len(batches),
              f"train {rec['form']}: one decode_u8 launch per step")


def _port_block(n=2):
    """The first of ``n`` consecutive free ports."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            for k in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", port + k))
            return port
        except OSError:
            continue
    raise SystemExit(f"chip_smoke: no {n} free consecutive ports")


def _fake_blender():
    os.environ["BLENDJAX_BLENDER"] = os.path.join(REPO, "tests", "helpers",
                                                  "fake_blender.py")


def _stamped(stream, arrivals, check_batch):
    """Pass the stream's batches through, checking each ("check") and
    recording its arrival, the time the train loop spent on it ("step") and
    the time the loop then waited for the next batch ("wait": the feed's
    share)."""
    done = None
    for batch in stream:
        t0 = time.perf_counter()
        if done is not None:
            stream.timer.add("wait", t0 - done)
        check_batch(batch)
        arrivals.append(time.perf_counter())
        stream.timer.add("check", arrivals[-1] - t0)
        t0 = time.perf_counter()
        yield batch  # the train step runs while this generator waits
        done = time.perf_counter()
        stream.timer.add("step", done - t0)


def stream_phase(torch, btt, datagen, image):
    _fake_blender()
    max_items, batch_size = 64, 8
    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    arrivals = []

    def check_batch(batch):
        check(batch["image"].is_cuda and batch["image"].dtype == torch.uint8
              and tuple(batch["image"].shape) == MAIN_SHAPE, "stream batch")

    with btt.BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=2,
                             named_sockets=["DATA"], start_port=_port_block(),
                             background=True, seed=0) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=max_items,
                                       item_transform=datagen.item_transform)
        with btt.TorchStream(ds, batch_size=batch_size, num_workers=2,
                             device="cuda") as stream:
            image.decode_frames_cuda.launches = 0
            _, losses = datagen.train_on_stream(
                _stamped(stream, arrivals, check_batch), state=state, log_every=0)
            torch.cuda.synchronize()
            end = time.perf_counter()
            launches = image.decode_frames_cuda.launches
    items_after_first = (len(arrivals) - 1) * batch_size
    rec = {"phase": "stream", "batches": len(losses), "items": len(losses) * batch_size,
           "items_per_s": items_after_first / (end - arrivals[0]),
           "median_step_ms": stream.timer.percentiles("step")["p50_ms"],
           "first_loss": losses[0], "last_loss": losses[-1],
           "launches": {"decode_u8": launches}, "timer": stream.timer.summary()}
    emit(rec)
    check(len(losses) == max_items // batch_size, "stream delivered every batch")
    check(all(math.isfinite(v) for v in losses), "stream losses finite")
    check(launches >= 1, "the main path launched decode_u8")
    return launches


#: items per turn of the stream A/B, and its arms in turns (the collate
#: path's fresh buffers, then the arena), two turns of each
AB_ITEMS = 512
AB_ARMS = (False, "auto", "auto", False)
#: per-stage p50s reported for each turn
AB_STAGES = ("recv", "scatter", "collate", "arena_wait", "device_put", "recycle", "check",
             "step", "wait")


def stream_ab_phase(torch, btt, datagen, image):
    """The datagen stream with the arena off and on (:data:`AB_ARMS`: values
    of ``TorchStream(arena=)``), in turns, through its entry points: 2
    ``frames.blend.py`` producers -> ``RemoteIterableDataset``
    with no per-item transform -> ``TorchStream(transform=<batch-level>,
    arena=...)`` -> the captured train step.  Every batch is held on the card
    to what its producers published (each producer publishes a pool of 8
    seeded frames, rebuilt here from ``make_frame``), so an arena recycled
    before its copy landed would show.  An untimed turn first runs the
    step's warm-up and capture."""
    import runpy

    import numpy as np

    from blendjax_torch.models.train import make_train_step

    _fake_blender()
    batch_size, producers = 8, 2
    script = runpy.run_path(str(datagen.FRAMES_SCRIPT), run_name="frames")
    frames = [script["make_frame"](seed, i, MAIN_SHAPE[1], MAIN_SHAPE[2], 8)
              for seed in range(producers) for i in range(script["POOL"])]
    ref_image = torch.from_numpy(np.stack([f[0] for f in frames])).cuda()
    ref_xy = torch.from_numpy(np.stack([
        datagen.item_transform({"image": f[0], "xy": f[1]})["xy"] for f in frames])).cuda()

    def transform(batch):  # batch-level: the dataset keeps no per-item transform
        return {**datagen.item_transform(batch), "btid": batch["btid"],
                "frameid": batch["frameid"]}

    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(datagen.make_loss())
    with btt.BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=producers,
                             named_sockets=["DATA"], start_port=_port_block(),
                             background=True, seed=0) as bl:
        addresses = bl.launch_info.addresses["DATA"]

        def turn(arena, items):
            ds = btt.RemoteIterableDataset(addresses, max_items=items)
            check(ds.supports_batched_stream(), "the A/B stream takes the batched path")
            arrivals = []
            wrong = torch.zeros((), dtype=torch.int64, device="cuda")

            def check_batch(batch):
                nonlocal wrong
                check(batch["image"].is_cuda and batch["image"].dtype == torch.uint8
                      and tuple(batch["image"].shape) == MAIN_SHAPE, "A/B stream batch")
                idx = batch["btid"].long() * script["POOL"] + batch["frameid"].long() % \
                    script["POOL"]
                wrong = wrong + (batch["image"] != ref_image[idx]).sum() + \
                    (batch["xy"] != ref_xy[idx]).sum()

            with btt.TorchStream(ds, batch_size=batch_size, num_workers=producers,
                                 device="cuda", transform=transform, arena=arena) as stream:
                image.decode_frames_cuda.launches = 0
                losses = []  # the trainer's loop, over one step kept across turns
                for batch in _stamped(stream, arrivals, check_batch):
                    _, loss = step(state, batch)
                    losses.append(float(loss))
                torch.cuda.synchronize()
                end = time.perf_counter()
                launches = image.decode_frames_cuda.launches
            pool = stream.arena_pool
            summary = stream.timer.summary()
            rec = {"phase": "stream_ab", "arena": arena, "batches": len(losses),
                   "items": len(losses) * batch_size,
                   "items_per_s": (len(arrivals) - 1) * batch_size / (end - arrivals[0]),
                   "p50_ms": {k: stream.timer.percentiles(k)["p50_ms"] for k in AB_STAGES},
                   "mean_ms": {k: summary[k]["mean_ms"] for k in AB_STAGES if k in summary},
                   "counts": {k: stream.timer.count(k) for k in AB_STAGES},
                   "median_step_ms": stream.timer.percentiles("step")["p50_ms"],
                   "wrong_elements": int(wrong), "launches": {"decode_u8": launches},
                   "arena_engaged": pool is not None, "first_loss": losses[0],
                   "last_loss": losses[-1]}
            check(len(losses) == items // batch_size, "A/B stream delivered every batch")
            check(rec["wrong_elements"] == 0,
                  "every A/B batch reached the card as its producers published it")
            check(all(math.isfinite(v) for v in losses), "A/B stream losses finite")
            check(launches == len(losses), "one decode_u8 launch per A/B step")
            if arena is False:
                check(pool is None, "arena=False keeps the arena off")
                return rec
            check(pool is not None and pool.in_use == 0, "the arena pool drained")
            check(stream.timer.count("recycle") == len(losses), "every arena recycled")
            arenas = list(pool._free)  # every arena is back after the close
            rec["arenas"] = len(arenas)
            check(arenas and all(a.buffers[("image",)].shape == MAIN_SHAPE for a in arenas),
                  "the A/B batches were built in the arenas")
            return rec

        emit({**turn("auto", 8 * batch_size), "phase": "stream_ab_warmup"})
        turns = [turn(arena, AB_ITEMS) for arena in AB_ARMS]
    for rec in turns:
        emit(rec)
    summary = {}
    for rec in turns:
        arm = summary.setdefault(rec["arena"], {"items_per_s": [], "median_step_ms": []})
        arm["items_per_s"].append(rec["items_per_s"])
        arm["median_step_ms"].append(rec["median_step_ms"])
    emit({"phase": "stream_ab_summary", "items_per_turn": AB_ITEMS, "arms": summary})


# -- the measurement plane ------------------------------------------------------------

#: the obs phase (:func:`obs_phase`): items through the traced feed, captured
#: steps per billed window and the arms in turns, the traced pool's steps,
#: the spin ``fold`` must not wait for, and the limits
OBS = dict(items=256, producers=2, batch=8, window_steps=32,
           window_arms=("synchronize", "fence", "fence", "synchronize"),
           pool_envs=2, pool_steps=24, spin_cycles=120_000_000, spin_ms=50.0,
           fold_limit_ms=5.0, window_rtol=0.05, value_rtol=1e-6, nest_us=2000,
           min_tids=3, min_pids=3, min_pairs=20)
#: the feed stages the traced feed must show, each on the thread that ran it
OBS_STAGES = ("recv", "scatter", "device_put", "recycle", "step")


def _obs_feed(torch, btt, datagen, image, tmp):
    """The traced feed at full width: 2 ``frames.blend.py`` producers ->
    ``RemoteIterableDataset`` (no per-item transform) ->
    ``TorchStream(transform=<batch-level>, arena='auto',
    timer=StageTimer(trace=True))`` -> the captured detector step (K1 in the
    loss), each step's loss folded into a ``fence_chain`` and the chain
    synced at the end.  The exported trace is read back and held to the
    timer.  The timer's own duty cycles and percentiles span the whole run,
    the producers' boot and the step's warm-ups and capture included; the
    record's ``steady`` block reads the trace over the replayed steps only
    (:func:`_steady_state`).  Returns (K1 launches, the record)."""
    from blendjax_torch.models.train import WARMUP_STEPS, make_train_step
    from blendjax_torch.utils.fence import fence_chain
    from blendjax_torch.utils.timing import StageTimer

    _fake_blender()
    timer = StageTimer(trace=True)
    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(datagen.make_loss())
    chain = fence_chain()
    with btt.BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT),
                             num_instances=OBS["producers"], named_sockets=["DATA"],
                             start_port=_port_block(OBS["producers"]), background=True,
                             seed=0) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=OBS["items"])
        with btt.TorchStream(ds, batch_size=OBS["batch"], num_workers=OBS["producers"],
                             device="cuda", transform=datagen.item_transform,
                             timer=timer) as stream:
            check(stream.arena_pool is not None, "obs: the traced feed takes the arena")
            batches = len(stream)
            image.decode_frames_cuda.launches = 0
            steps = 0
            for batch in stream:
                with timer.stage("step"):
                    check(tuple(batch["image"].shape) == MAIN_SHAPE, "obs feed batch")
                    _, loss = step(state, batch)
                    chain.fold(loss)
                steps += 1
                if steps == WARMUP_STEPS + 1:  # the eager warm-ups and the capture
                    steady_from = timer.wall_s
            loss_sum = chain.sync()
            steady_to = timer.wall_s
            launches = image.decode_frames_cuda.launches
            w0 = timer.wall_s
            duty = stream.duty_cycle("step")
            w1 = timer.wall_s
    path = os.path.join(tmp, "feed_trace.json")
    n = timer.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    check(n == len(events) > 0, "obs: the feed trace holds every exported event")
    check(all(e["ph"] == "X" and e["dur"] > 0 and 0 <= e["ts"] <= w1 * 1e6 for e in events),
          "obs: every feed event complete, with a duration, inside the timer's wall time")
    names = {e["name"] for e in events}
    counts = {k: sum(e["name"] == k for e in events) for k in sorted(names)}
    check(set(OBS_STAGES) <= names, f"obs: the feed trace shows {OBS_STAGES} ({sorted(names)})")
    check(all(counts[k] == timer.count(k) for k in counts),
          "obs: each stage's events equal its count")
    check(timer.trace_dropped == 0, "obs: no feed event dropped")
    tids = {e["tid"] for e in events}
    check(len(tids) >= OBS["min_tids"], f"obs: {len(tids)} thread rows in the feed trace")
    step_s = sum(e["dur"] for e in events if e["name"] == "step") * 1e-6
    check(math.isclose(step_s, timer.total_s("step"), rel_tol=1e-6),
          "obs: the step events sum to the step stage's total")
    check(0 < duty <= 1 and step_s / w1 - 1e-6 <= duty <= step_s / w0 + 1e-6,
          "obs: duty_cycle('step') is the step events over the wall time")
    check(steps == batches == OBS["items"] // OBS["batch"], "obs: the feed delivered every batch")
    check(math.isfinite(loss_sum), "obs: the folded losses are finite")
    check(launches == steps, f"obs: the traced feed decoded once a step ({launches} for {steps})")
    summary = timer.summary()
    return launches, {
        "batches": steps, "events": n, "tids": len(tids), "event_counts": counts,
        "p50_ms": {k: summary[k]["p50_ms"] for k in sorted(summary)},
        "duty_cycle": {k: timer.duty_cycle(k) for k in sorted(summary)},
        "wall_s": w1, "trace_dropped": timer.trace_dropped, "loss_sum": loss_sum,
        "steady": _steady_state(events, steady_from, steady_to),
        "launches": {"decode_u8": launches}}


def _steady_state(events, t0, t1):
    """The feed trace over ``[t0, t1]`` seconds of the timer's clock (the
    replayed steps): the window's length, and per stage the events that
    start in it, their exact median duration and the stage's time inside
    the window over its length (a stage on two threads can exceed 1)."""
    lo, hi = t0 * 1e6, t1 * 1e6
    out = {"window_s": t1 - t0, "stages": {}}
    for name in sorted({e["name"] for e in events}):
        own = [e for e in events if e["name"] == name]
        inside = [e["dur"] for e in own if lo <= e["ts"] < hi]
        busy = sum(max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) for e in own)
        out["stages"][name] = {"count": len(inside),
                               "p50_ms": statistics.median(inside) / 1e3 if inside else None,
                               "duty_cycle": busy / (hi - lo)}
    return out


def _obs_fences(torch, datagen, flops_peak):
    """``fences_valid`` at the card's bf16 peak and at 1 FLOP/s; ``fold``
    against an enqueued spin; captured detector steps on batches on the
    card billed by a ``fence_chain`` and by ``torch.cuda.synchronize`` in
    turns (:data:`OBS`'s ``window_arms``), each window beside the steps'
    CUDA-event time; ``value_fence`` of the parameters on the card against
    the CPU's."""
    from blendjax_torch.models.train import WARMUP_STEPS, make_train_step
    from blendjax_torch.utils.fence import fence_chain, fences_valid, value_fence

    ok, valid = fences_valid(flops_peak)
    bad, invalid = fences_valid(1.0)
    check(ok, f"obs: synchronize is a real fence at the card's bf16 peak ({valid})")
    check(not bad, "obs: fences_valid refuses a 1 FLOP/s peak")

    x = torch.ones(1024, device="cuda")
    warm = fence_chain()  # loads the fold's kernels before the spin
    warm.fold(x * 2)
    warm.sync()
    chain = fence_chain()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t_start = time.perf_counter()
    ev0.record()
    torch.cuda._sleep(OBS["spin_cycles"])
    ev1.record()
    y = x * 2  # ordered after the spin
    t0 = time.perf_counter()
    chain.fold(y)
    fold_ms = (time.perf_counter() - t0) * 1e3
    got = chain.sync()
    sync_ms = (time.perf_counter() - t_start) * 1e3
    spin_ms = ev0.elapsed_time(ev1)
    check(spin_ms >= OBS["spin_ms"], f"obs: the spin ran {spin_ms:.1f} ms")
    check(fold_ms < OBS["fold_limit_ms"], f"obs: fold returned in {fold_ms:.3f} ms, not waiting")
    check(sync_ms >= spin_ms and got == 2.0, "obs: sync returned after the spin's end")

    dg = torch.Generator(device="cuda").manual_seed(1)
    target = torch.rand((MAIN_SHAPE[0], 8, 2), generator=dg, device="cuda")
    batches = [{"image": torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda",
                                       generator=dg), "xy": target} for _ in range(8)]
    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(datagen.make_loss())
    for i in range(WARMUP_STEPS + 1):  # the eager warm-ups and the capture
        state, _ = step(state, batches[i % len(batches)])
    windows = []
    for arm in OBS["window_arms"]:
        chain = fence_chain()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for i in range(OBS["window_steps"]):
            state, loss = step(state, batches[i % len(batches)])
            if arm == "fence":
                chain.fold(loss)
        end.record()
        if arm == "fence":
            chain.sync()
        else:
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        windows.append({"arm": arm, "window_ms": host_ms, "event_ms": start.elapsed_time(end)})
    check(len(step.graphs) == 1, "obs: one captured graph over the windows")
    medians = {arm: statistics.median(w["window_ms"] for w in windows if w["arm"] == arm)
               for arm in ("fence", "synchronize")}
    gap = abs(medians["fence"] / medians["synchronize"] - 1)
    check(gap <= OBS["window_rtol"], f"obs: fenced and synchronized windows within "
          f"{OBS['window_rtol']:.0%} ({medians})")
    check(all(w["window_ms"] >= w["event_ms"] for w in windows),
          "obs: every window at least its steps' CUDA-event time")
    card = value_fence(state.params)
    cpu = value_fence({k: v.detach().cpu() for k, v in state.params.items()})
    check(math.isclose(card, cpu, rel_tol=OBS["value_rtol"]),
          f"obs: value_fence on the card {card!r} and on the CPU {cpu!r}")
    return {
        "fences_valid": {"ok": ok, "min_s": valid["min_s"],
                         "implied_tflop_per_s": valid["implied_flops_per_sec"] / 1e12,
                         "peak_tflop_per_s": flops_peak / 1e12,
                         "at_1_flop_per_s_ok": bad},
        "fold": {"spin_ms": spin_ms, "fold_ms": fold_ms, "sync_ms": sync_ms},
        "windows": windows, "window_medians_ms": medians, "window_gap": gap,
        "steps_per_window": OBS["window_steps"],
        "value_fence": {"card": card, "cpu": cpu}}


def _obs_pool(torch, btt, control, policy, tmp):
    """The traced RL pool: ``launch_env_pool(trace=True, pipeline_depth=2)``
    over 2 cartpole producers, the MLP policy sampling on the card; lockstep
    ``step`` and ``step_async``/``step_wait_full`` alternated, each step's
    sampling recorded in a second recorder.  The pool's spans and the
    second recorder's file are merged by ``export_chrome_trace`` and read
    back by ``load_chrome_trace``."""
    import numpy as np

    from blendjax_torch.obs import SpanRecorder, export_chrome_trace, load_chrome_trace
    from blendjax_torch.obs.spans import span_trace

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    params = policy.init(torch.Generator(device="cuda").manual_seed(1), 3, 2, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    learner = SpanRecorder()
    with btt.launch_env_pool(scene="", script=str(control.SCRIPT),
                             num_instances=OBS["pool_envs"], background=True,
                             start_port=_port_block(OBS["pool_envs"]), seed=0,
                             real_time=False, pipeline_depth=2, trace=True) as pool:
        obs, _ = pool.reset()
        for i in range(OBS["pool_steps"]):
            with learner.span("policy", trace=f"step{i}", cat="learner"):
                obs_t = torch.as_tensor(np.asarray(obs, np.float32), device="cuda")
                with torch.no_grad():
                    actions, _ = policy.sample_action(params, gen, obs_t)
                forces = control._forces(actions)
            if i % 2 == 0:
                obs, rew, *_ = pool.step(forces)
            else:
                pool.step_async(forces)
                obs, rew, *_ = pool.step_wait_full()
            check(_finite_transitions(obs, rew), "obs: pool transitions finite")
        second = os.path.join(tmp, "learner_spans.json")
        learner.export_chrome_trace(second)
        merged = os.path.join(tmp, "merged_spans.json")
        n = export_chrome_trace(merged, pool.spans, second)
        want = sorted(pool.spans.snapshot() + learner.snapshot(),
                      key=lambda e: (e.get("ts", 0), e.get("pid", 0)))
        spans = pool.spans.drain()
        check(len(pool.spans) == 0, "obs: drain() left the pool's recorder empty")
    loaded = load_chrome_trace(merged)
    check(n == len(loaded) and loaded == want,
          "obs: the merged file reads back as the snapshots sorted by (ts, pid)")
    pids = {e["pid"] for e in loaded}
    check(len(pids) >= OBS["min_pids"], f"obs: {len(pids)} pids in the merged span trace")
    by_trace = {}
    for s in spans:
        if span_trace(s) is not None:
            by_trace.setdefault(span_trace(s), []).append(s)
    pairs, worst_us = 0, 0
    for group in by_trace.values():
        client = [s for s in group if s.get("cat") == "envpool"]
        producer = [s for s in group if s.get("cat") == "producer"]
        if not (client and producer):
            continue
        pairs += 1
        c, p = client[0], producer[0]
        out_us = max(c["ts"] - p["ts"], p["ts"] + p["dur"] - c["ts"] - c["dur"], 0)
        worst_us = max(worst_us, out_us)
        check(p["pid"] != c["pid"] and out_us <= OBS["nest_us"],
              f"obs: producer span {out_us} us outside its client span")
    check(pairs >= OBS["min_pairs"], f"obs: {pairs} correlation ids carry both sides")
    return {"spans": n, "pids": len(pids), "pairs": pairs, "worst_outside_us": worst_us,
            "steps": OBS["pool_steps"]}


def obs_phase(torch, btt, datagen, image, control, policy, flops_peak):
    """The measurement plane on the card: the traced feed at full width
    (:func:`_obs_feed`), the fences (:func:`_obs_fences`) and the traced RL
    pool (:func:`_obs_pool`).  The feed's ``StageTimer`` trace (perf_counter
    from its reset) and the pool's spans (epoch microseconds) are two
    files, as the reference keeps them.  Returns the feed's K1 launches."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="bjx-obs-") as tmp:
        launches, feed = _obs_feed(torch, btt, datagen, image, tmp)
        emit({"phase": "obs_feed", "card": CARD, **feed})
        fences = _obs_fences(torch, datagen, flops_peak)
        emit({"phase": "obs_fence", "card": CARD, **fences})
        pool = _obs_pool(torch, btt, control, policy, tmp)
        emit({"phase": "obs_spans", "card": CARD, **pool})
    emit({"phase": "obs", "card": CARD, "seconds": time.perf_counter() - t0})
    return launches


# -- the same-host transports ------------------------------------------------------

#: datagen turns of the transport phase, by ``BlenderLauncher(proto=)``: tcp and
#: shm in turns, then one ipc turn as a check
TRANSPORT_TURNS = ("tcp", "shm", "shm", "tcp", "ipc")
TRANSPORT_ITEMS = 512
TRANSPORT_STAGES = ("recv", "scatter", "arena_wait", "device_put", "wait")
#: the served flagship's arms (``ServeClient(shm=)``) and their rounds
SERVE_SHM_ARMS = (False, "auto")


def _frames_reference(torch, datagen, producers):
    """The frames each ``frames.blend.py`` producer publishes (a pool of
    seeded frames per producer), on the card, with the keypoints the
    batch-level transform gives them."""
    import runpy

    import numpy as np

    script = runpy.run_path(str(datagen.FRAMES_SCRIPT), run_name="frames")
    frames = [script["make_frame"](seed, i, MAIN_SHAPE[1], MAIN_SHAPE[2], 8)
              for seed in range(producers) for i in range(script["POOL"])]
    ref_image = torch.from_numpy(np.stack([f[0] for f in frames])).cuda()
    ref_xy = torch.from_numpy(np.stack([
        datagen.item_transform({"image": f[0], "xy": f[1]})["xy"] for f in frames])).cuda()
    return script["POOL"], ref_image, ref_xy


def _transport_datagen(torch, btt, datagen, image):
    """The datagen stream over each transport of :data:`TRANSPORT_TURNS`,
    through its entry points: 2 ``frames.blend.py`` producers started by
    ``BlenderLauncher(proto=...)`` -> ``RemoteIterableDataset`` ->
    ``TorchStream`` (arena engaged, a batch-level transform) -> K1 -> the
    captured detector step.  Every batch is held on the card to the frames
    its producers published; the shm turns must have read the rings
    (``stream_shm_rings``), and no launch may leave objects under its
    ``/dev/shm`` prefix.  Returns K1's launches in the shm turns."""
    from blendjax_torch.btt import shm_rpc
    from blendjax_torch.models.train import make_train_step
    from blendjax_torch.utils.timing import EventCounters

    _fake_blender()
    batch_size, producers = 8, 2
    pool_size, ref_image, ref_xy = _frames_reference(torch, datagen, producers)

    def transform(batch):
        return {**datagen.item_transform(batch), "btid": batch["btid"],
                "frameid": batch["frameid"]}

    state = datagen.make_state(torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(datagen.make_loss())

    def turn(proto, items):
        counters = EventCounters()
        wrong = torch.zeros((), dtype=torch.int64, device="cuda")
        arrivals, losses = [], []

        def check_batch(batch):
            nonlocal wrong
            check(batch["image"].is_cuda and batch["image"].dtype == torch.uint8
                  and tuple(batch["image"].shape) == MAIN_SHAPE, f"{proto} stream batch")
            idx = batch["btid"].long() * pool_size + batch["frameid"].long() % pool_size
            wrong = wrong + (batch["image"] != ref_image[idx]).sum() + \
                (batch["xy"] != ref_xy[idx]).sum()

        with btt.BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT),
                                 num_instances=producers, named_sockets=["DATA"],
                                 start_port=_port_block(), background=True, seed=0,
                                 proto=proto) as bl:
            base = bl._shm_base
            addresses = bl.launch_info.addresses["DATA"]
            ds = btt.RemoteIterableDataset(addresses, max_items=items, counters=counters)
            with btt.TorchStream(ds, batch_size=batch_size, num_workers=producers,
                                 device="cuda", transform=transform, arena="auto") as stream:
                image.decode_frames_cuda.launches = 0
                for batch in _stamped(stream, arrivals, check_batch):
                    _, loss = step(state, batch)
                    losses.append(float(loss))
                torch.cuda.synchronize()
                end = time.perf_counter()
                launches = image.decode_frames_cuda.launches
            engaged = stream.arena_pool is not None
        leaked = shm_rpc.leaked_objects(base)
        summary = stream.timer.summary()
        rec = {"phase": "transport_datagen", "proto": proto, "addresses": addresses,
               "batches": len(losses), "items": len(losses) * batch_size,
               "items_per_s": (len(arrivals) - 1) * batch_size / (end - arrivals[0]),
               "p50_ms": {k: stream.timer.percentiles(k)["p50_ms"] for k in TRANSPORT_STAGES},
               "ms_per_batch": {k: summary[k]["total_s"] * 1e3 / max(1, len(losses))
                                for k in TRANSPORT_STAGES if k in summary},
               "counts": {k: stream.timer.count(k) for k in TRANSPORT_STAGES},
               "median_step_ms": stream.timer.percentiles("step")["p50_ms"],
               "shm_rings_read": counters.get("stream_shm_rings"),
               "wrong_elements": int(wrong), "launches": {"decode_u8": launches},
               "arena_engaged": engaged, "leaked": leaked, "last_loss": losses[-1]}
        check(len(losses) == items // batch_size, f"{proto}: the stream delivered every batch")
        check(rec["wrong_elements"] == 0,
              f"{proto}: every batch reached the card as its producers published it")
        check(all(math.isfinite(v) for v in losses), f"{proto}: losses finite")
        check(launches == len(losses), f"{proto}: one decode_u8 launch per step")
        check(engaged, f"{proto}: the arena was engaged")
        check(all(a.startswith(f"{proto}://") for a in addresses),
              f"{proto}: the launcher allocated {proto} addresses")
        check(rec["shm_rings_read"] == (producers if proto == "shm" else 0),
              f"{proto}: the stream read the rings iff shm ({rec['shm_rings_read']})")
        check(not leaked, f"{proto}: nothing left under /dev/shm/{base}*: {leaked}")
        return rec

    emit({**turn("shm", 8 * batch_size), "phase": "transport_datagen_warmup"})
    turns = [turn(proto, TRANSPORT_ITEMS) for proto in TRANSPORT_TURNS]
    for rec in turns:
        emit(_stamp(rec))
    arms = {}
    for rec in turns:
        arms.setdefault(rec["proto"], []).append(rec["items_per_s"])
    emit(_stamp({"phase": "transport_datagen_summary", "items_per_turn": TRANSPORT_ITEMS,
                 "items_per_s": arms}))
    return sum(r["launches"]["decode_u8"] for r in turns if r["proto"] == "shm")


def serve_clients_main(spec):
    """The serving arm's clients, in a process of their own (``python3
    chip_smoke.py --serve-clients '<json>'``): first one seeded check
    episode alone (unless ``check`` is false), then ``clients`` threads
    stepping episodes for ``seconds`` (from the wall-clock ``start_at``
    where given) or until ``stop_file`` exists (a ``prefix`` of 0 admits
    episodes without one); prints one JSON line (the
    check episode's predictions, per-thread steps and latencies, the
    process's CPU seconds over the window, each
    client's wire and channel generations and demotions, each client's
    weight versions in the order they arrived, errors; behind a gateway
    also the resets, the retries, the steps each replica stamped and the
    steps stamped by another replica than the one that admitted their
    episode)."""
    import numpy as np

    sys.path.insert(0, REPO)
    from blendjax_torch.serve.client import ServeClient
    from blendjax_torch.utils.timing import fleet_counters

    cfg = json.loads(spec)
    shm = cfg["shm"]

    def episode(seed):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((cfg["episode_len"], cfg["obs_dim"])).astype(np.float32)

    check_preds = []
    if cfg.get("check", True):
        check_client = ServeClient(cfg["address"], timeoutms=30000, shm=shm)
        ep = episode(7)
        check_preds = [check_client.reset(prefix=ep[:cfg["prefix"]])["pred"].tolist()]
        check_preds += [check_client.step(o)["pred"].tolist() for o in ep[cfg["prefix"]:]]
        check_client.close_episode()
        check_client.close()

    stop_file = cfg.get("stop_file")
    n = cfg["clients"]
    lat, steps, versions = [[] for _ in range(n)], [0] * n, [[] for _ in range(n)]
    wires, errors = [None] * n, []
    resets, breaks, stamped = [0] * n, [0] * n, [{} for _ in range(n)]
    ready, go = threading.Barrier(n + 1), threading.Barrier(n + 1)
    deadline = [None]

    def run(i):
        client = ServeClient(cfg["address"], timeoutms=30000, shm=shm)
        e = episode(cfg["seed"] + i)
        try:
            if cfg["prefix"]:
                client.reset(prefix=e[:cfg["prefix"]])
            else:
                client.reset()
            resets[i] += 1
            owner = client.replica
            t = cfg["prefix"]
            ready.wait(timeout=120)
            go.wait(timeout=60)
            while time.perf_counter() < deadline[0] and not (
                    stop_file and os.path.exists(stop_file)):
                t0 = time.perf_counter()
                reply = client.step(e[t])
                lat[i].append(time.perf_counter() - t0)
                steps[i] += 1
                v, rep = reply.get("weight_version"), reply.get("replica")
                if v is not None and (not versions[i] or versions[i][-1] != v):
                    versions[i].append(v)
                if rep is not None:
                    stamped[i][rep] = stamped[i].get(rep, 0) + 1
                    breaks[i] += rep != owner
                t += 1
                if t == cfg["episode_len"]:
                    client.close_episode()
                    client.reset()
                    resets[i] += 1
                    owner = client.replica
                    t = 0
            client.close_episode()
            chan = client._chan
            wires[i] = {"transport": client.transport, "generations": chan.generations,
                        "demotions": chan.demotions}
        except Exception as exc:  # noqa: BLE001 - reported to the parent
            errors.append(f"client {i}: {type(exc).__name__}: {exc}")
            ready.abort()
            go.abort()
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    try:
        ready.wait(timeout=120)
        if cfg.get("start_at"):  # the wall-clock start shared with sibling processes
            time.sleep(max(0.0, cfg["start_at"] - time.time()))
        deadline[0] = time.perf_counter() + cfg["seconds"]
        go.wait(timeout=60)
    except threading.BrokenBarrierError:
        pass
    t0, cpu0 = time.perf_counter(), time.process_time()
    for t in threads:
        t.join(timeout=cfg["seconds"] + 60)
    elapsed = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    replica_steps = {}
    for per in stamped:
        for rep, k in per.items():
            replica_steps[rep] = replica_steps.get(rep, 0) + k
    print(json.dumps({"check_preds": check_preds, "steps": steps, "elapsed": elapsed,
                      "cpu_s": cpu_s,
                      "latencies": [x for per in lat for x in per], "wires": wires,
                      "versions": versions, "errors": errors, "resets": sum(resets),
                      "retries": fleet_counters.get("retries"),
                      "affinity_breaks": sum(breaks), "replica_steps": replica_steps}),
          flush=True)
    return 0


def chaos_clients_main(spec):
    """The gateway chaos drill's clients, in a process of their own
    (``python3 chip_smoke.py --chaos-clients '<json>'``): ``clients``
    threads step seeded episodes through the gateway until ``stop_file``
    exists.  A transport timeout re-sends the same observation; the
    actionable stale-lease error (``reset() and resume``) ends the episode
    and the client resets.  Prints one JSON line: per episode its seed, the
    predictions acknowledged in order and how it ended, and the errors that
    were neither."""
    import numpy as np

    sys.path.insert(0, REPO)
    from blendjax_torch.btt.faults import FaultPolicy
    from blendjax_torch.serve.client import ServeClient

    cfg = json.loads(spec)
    n, stop_file = cfg["clients"], cfg["stop_file"]
    episodes, errors = [[] for _ in range(n)], []

    def run(i):
        client = ServeClient(cfg["address"], timeoutms=cfg["timeout_ms"],
                             fault_policy=FaultPolicy(max_retries=2, backoff_base=0.05,
                                                      backoff_max=0.2, circuit_threshold=0,
                                                      seed=i))
        k = 0
        try:
            while not os.path.exists(stop_file):
                seed = cfg["seed"] + 1000 * i + k
                k += 1
                obs = np.random.default_rng(seed).standard_normal(
                    (cfg["episode_len"], cfg["obs_dim"])).astype(np.float32)
                rec = {"seed": seed, "preds": [], "end": "closed", "timeouts": 0}
                episodes[i].append(rec)
                while True:
                    try:
                        client.reset(timeout_ms=cfg["timeout_ms"])
                        rec["replica"] = client.replica
                        break
                    except (TimeoutError, RuntimeError):
                        time.sleep(0.1)
                t = 0
                while t < len(obs) and not os.path.exists(stop_file):
                    try:
                        rec["preds"].append(client.step(obs[t])["pred"].tolist())
                        t += 1
                    except TimeoutError:
                        rec["timeouts"] += 1
                    except RuntimeError as exc:
                        if "reset() and resume" not in str(exc):
                            raise
                        rec["end"] = "stale"
                        break
                if rec["end"] == "closed":
                    try:
                        client.close_episode()
                    except (TimeoutError, RuntimeError):
                        rec["end"] = "open"
        except Exception as exc:  # noqa: BLE001 - reported to the parent
            errors.append(f"client {i}: {type(exc).__name__}: {exc}")
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    print(json.dumps({"episodes": episodes, "errors": errors}), flush=True)
    return 0


def _serve_clients(address, cfg, shm, seconds, seed):
    """One window of the child-process clients; returns its JSON record."""
    spec = json.dumps({"address": address, "shm": shm, "seconds": seconds, "seed": seed,
                       **{k: cfg[k] for k in ("clients", "episode_len", "prefix", "obs_dim",
                                              "check", "stop_file", "start_at")
                          if k in cfg}})
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-clients", spec],
                          capture_output=True, text=True, timeout=seconds + 240, cwd=REPO)
    check(proc.returncode == 0,
          f"serve clients exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not out["errors"], f"serve clients: {out['errors']}")
    return out


def _transport_serve(torch, seqformer, serve, cfg):
    """The flagship served to 8 ``ServeClient`` threads in one child process,
    each arm of :data:`SERVE_SHM_ARMS` in turns (``cfg["rounds"]`` rounds of
    ``cfg["window_s"]``): ``serve_qps`` and p50/p99 per arm, the bytes each
    wire moved, every client's wire checked, and one seeded episode's
    predictions bit-equal between the arms."""
    import numpy as np

    from blendjax_torch.btt import shm_rpc
    from blendjax_torch.utils.timing import EventCounters, StageTimer

    params = _serve_params(torch, seqformer, cfg)
    model = serve.SeqFormerModel(params, cfg["slots"], cfg["length"])
    counters = EventCounters()
    handle = serve.start_server_thread(model, tick_ms=1.0, max_batch=cfg["slots"],
                                       counters=counters, timer=StageTimer())
    base = handle.server._shm.base if handle.server._shm is not None else None
    check(base is not None, "the policy server built its ShmRPC transport")
    arms = {str(a): {"qps": [], "lat": [], "shm_bytes": 0, "wire_bytes": 0, "wires": []}
            for a in SERVE_SHM_ARMS}
    checks = {}
    try:
        for b in handle.server.buckets:  # every bucket a window can hit: warm-ups, capture
            for _ in range(3):
                model.step_rows(np.full(b, model.pad_slot, np.int64),
                                np.zeros((b, cfg["obs_dim"]), np.float32))
            if b >= cfg["clients"]:
                break
        for r in range(cfg["rounds"]):
            order = SERVE_SHM_ARMS if r % 2 == 0 else SERVE_SHM_ARMS[::-1]
            for arm in order:
                before = counters.snapshot()
                out = _serve_clients(handle.address, cfg, arm, cfg["window_s"], 1000 * (r + 1))
                after = counters.snapshot()
                rec = arms[str(arm)]
                rec["qps"].append(sum(out["steps"]) / out["elapsed"])
                rec["lat"].extend(out["latencies"])
                for key, name in (("shm_bytes", "serve_shm_bytes"),
                                  ("wire_bytes", "serve_wire_bytes")):
                    rec[key] += after.get(name, 0) - before.get(name, 0)
                rec["wires"].extend(out["wires"])
                checks.setdefault(str(arm), out["check_preds"])
                want = "shm" if arm else "tcp"
                check(all(w["transport"] == want for w in out["wires"]),
                      f"serve shm={arm}: every client rode {want}: {out['wires']}")
                if arm:
                    check(all(w["demotions"] == 0 and w["generations"] == 1
                              for w in out["wires"]),
                          f"serve shm={arm}: no channel demoted: {out['wires']}")
        errors = counters.get("serve_errors")
    finally:
        handle.close()
    leaked = shm_rpc.leaked_objects(base)
    results = {}
    for arm, rec in arms.items():
        results[arm] = {
            "serve_qps": float(np.median(rec["qps"])), "qps_turns": rec["qps"],
            "serve_p50_ms": float(np.percentile(rec["lat"], 50)) * 1e3,
            "serve_p99_ms": float(np.percentile(rec["lat"], 99)) * 1e3,
            "serve_shm_bytes": rec["shm_bytes"], "serve_wire_bytes": rec["wire_bytes"],
            "clients": len(rec["wires"])}
    a, b = (np.asarray(checks[str(x)], np.float32) for x in SERVE_SHM_ARMS)
    emit(_stamp({"phase": "transport_serve", "config": cfg, "arms": results,
                 "check_episode_bit_equal": bool(np.array_equal(a, b)),
                 "check_episode_max_abs_diff": float(np.abs(a - b).max()),
                 "shm_endpoint": f"shm://{base}", "leaked": leaked, "errors": errors}))
    check(np.array_equal(a, b), "serve: one seeded episode's predictions bit-equal "
          "between the arms")
    check(results["False"]["serve_shm_bytes"] == 0, "serve shm=False: no byte rode shm")
    check(results["auto"]["serve_shm_bytes"] > results["auto"]["serve_wire_bytes"],
          "serve shm=auto: the requests rode the rings")
    check(errors == 0, "serve: no request errored")
    check(not leaked, f"serve: nothing left under /dev/shm/{base}*: {leaked}")


def transport_phase(torch, btt, datagen, image, seqformer, serve):
    """The same-host transports on the card: the native ring must have
    built, the datagen stream over tcp, shm and ipc, then the flagship
    served over ZMQ and over ShmRPC.  Returns K1's launches in the shm
    datagen turns."""
    from blendjax_torch.btt import shm_rpc
    from blendjax_torch.native import ring

    check(ring.native_available(), f"the native ring loaded: {ring.load_error()}")
    check(shm_rpc.enabled(), "ShmRPC is enabled (Linux, /dev/shm, the ring, no kill switch)")
    emit({"phase": "transport", "ring": ring.LIBRARY, "host_token": shm_rpc.host_token()})
    launches = _transport_datagen(torch, btt, datagen, image)
    _transport_serve(torch, seqformer, serve, SERVE)
    return launches


# -- flash attention -----------------------------------------------------------

# (label, (B, Tq, H, Dh), h_kv, Tk, dtype, causal, window, q_offset)
FLASH_CASES = [
    ("flagship", FLASH_SHAPE, FLASH_SHAPE[2], FLASH_SHAPE[1], "bfloat16", True, None, 0),
    ("f32 causal", (2, 128, 4, 32), 4, 128, "float32", True, None, 0),
    ("f32 non-causal", (2, 128, 4, 32), 4, 128, "float32", False, None, 0),
    ("gqa 8q/2kv", (2, 128, 8, 32), 2, 128, "float32", True, None, 0),
    ("gqa 8q/2kv bf16 dh128", (2, 128, 8, 128), 2, 128, "bfloat16", True, None, 0),
    ("f32 dh128 T 512", (2, 512, 8, 128), 8, 512, "float32", True, None, 0),
    ("gqa 8q/2kv f32 dh128 T 512", (2, 512, 8, 128), 2, 512, "float32", True, None, 0),
    ("window 48", (2, 128, 4, 32), 4, 128, "float32", True, 48, 0),
    ("T 96", (2, 96, 4, 32), 4, 96, "float32", True, None, 0),
    ("T 17", (2, 17, 4, 32), 4, 17, "float32", True, None, 0),
    ("T 17 non-causal dh16", (2, 17, 4, 16), 4, 17, "float32", False, None, 0),
    ("dh64 bf16 non-causal", (2, 128, 4, 64), 4, 128, "bfloat16", False, None, 0),
    ("q_offset 64, Tk 128", (2, 64, 4, 32), 4, 128, "float32", True, None, 64),
    ("q_offset 128, window 160", (2, 128, 4, 32), 4, 128, "float32", True, 160, 128),
    ("q_offset 256, window 48: no row sees a column", (1, 128, 2, 32), 2, 128,
     "float32", True, 48, 256),
]
# a bf16 twin of every f32 case: the backward's tensor-core route ("tc")
# takes bf16 inputs, its CUDA-core route ("f32") float32 ones
FLASH_CASES += [("bf16 " + c[0].replace("f32 ", ""), *c[1:4], "bfloat16", *c[5:])
                for c in FLASH_CASES if c[4] == "float32"]


#: absolute slack of a bf16 output beside its two ulps (below)
BF16_ATOL = 1e-4


def _compare(torch, got, want, grad, gqa):
    """Max abs error of a kernel output against its plain pass, whether it
    is within its limit, and the limit.  Kernel and plain pass share f32
    arithmetic and differ only in the order of their f32 sums, so an f32
    output (including lse, and dK/dV partials under GQA, from bf16 inputs
    too) is held to tests/test_flash_attention.py's f32 limits (atol =
    rtol: forward 2e-5, gradients 5e-5, GQA gradients 1e-4), and a bf16
    output to BF16_ATOL plus two bf16 ulps of the plain value: one for a
    rounding that falls the other way, one for a binade crossed."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        allowed, limit = BF16_ATOL + 2 * bf16_ulp(torch, want), f"{BF16_ATOL} + 2 bf16 ulps"
    else:
        tol = (1e-4 if gqa else 5e-5) if grad else 2e-5
        allowed, limit = tol + tol * want.float().abs(), f"atol=rtol={tol}"
    ok = bool((err <= allowed).all()) and bool(torch.isfinite(got).all())
    return err.max().item(), ok, limit


def _flash_inputs(torch, g, shape, h_kv, tk, dtype):
    b, t, h, d = shape
    dt = getattr(torch, dtype)

    def rnd(rows, length):
        return torch.randn((rows, length, d), generator=g, device="cuda").to(dt)

    return rnd(b * h, t), rnd(b * h_kv, tk), rnd(b * h_kv, tk), rnd(b * h, t)


def flash_phase(torch, flash):
    """Each kernel against its plain pass on the same card inputs."""
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for label, shape, h_kv, tk, dtype, causal, window, q_offset in FLASH_CASES:
        b, t, h, d = shape
        qf, kf, vf, dof = _flash_inputs(torch, g, shape, h_kv, tk, dtype)
        heads = (h, h_kv) if h != h_kv else None
        kw = dict(window=window, q_offset=q_offset, heads=heads)
        scale = 1.0 / math.sqrt(d)
        of, lse = flash.flash_fwd_plain(qf, kf, vf, causal, scale, **kw)
        delta = (dof.float() * of.float()).sum(-1, keepdim=True)
        gkw = dict(kw, out_dtype=torch.float32 if heads else None)
        bwd = (qf, kf, vf, dof, lse, delta, causal, scale)
        pairs = {  # kernel outputs, plain outputs, gradient?
            "flash_fwd": (flash.flash_fwd_cuda(qf, kf, vf, causal, scale, **kw), (of, lse),
                          False),
            "flash_dq": ((flash.flash_dq_cuda(*bwd, **kw),),
                         (flash.flash_dq_plain(*bwd, **kw),), True),
            "flash_dkv": (flash.flash_dkv_cuda(*bwd, **gkw),
                          flash.flash_dkv_plain(*bwd, **gkw), True),
        }
        torch.cuda.synchronize()
        route = flash.kernel_route(qf.dtype, d)
        for name, (got, want, grad) in pairs.items():
            results = [_compare(torch, a, w, grad, heads is not None)
                       for a, w in zip(got, want)]
            max_err = max(r[0] for r in results)
            ok = all(r[1] for r in results)
            emit({"phase": "flash", "kernel": name, "case": label, "shape": list(shape),
                  "h_kv": h_kv, "tk": tk, "dtype": dtype, "causal": causal,
                  "window": window, "q_offset": q_offset,
                  "route": route, "max_abs_err": max_err,
                  "limit": " / ".join(r[2] for r in results), "ok": ok})
            check(ok, f"{name} {label}")
            if label == "flagship":
                errs[name] = max_err
    _misaligned_check(torch, flash, g)
    return errs


def _misaligned_check(torch, flash, g):
    """bf16 views whose bases sit off TMA's 16-byte alignment give the
    tensor-core kernels' answer (forward, dQ, dK/dV) for aligned copies of
    the same values."""
    qf, kf, vf, dof = _flash_inputs(torch, g, (2, 128, 4, 32), 4, 128, "bfloat16")
    of, lse = flash.flash_fwd_plain(qf, kf, vf, True, 0.25)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)

    def shifted(x):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device="cuda")
        return buf[1:x.numel() + 1].view(x.shape).copy_(x)

    rest = (lse, delta, True, 0.25)
    views = [shifted(x) for x in (qf, kf, vf, dof)]
    check(all(x.data_ptr() % 16 for x in views), "misaligned views")
    got = [*flash.flash_fwd_cuda(*views[:3], True, 0.25), flash.flash_dq_cuda(*views, *rest),
           *flash.flash_dkv_cuda(*views, *rest)]
    want = [*flash.flash_fwd_cuda(qf, kf, vf, True, 0.25),
            flash.flash_dq_cuda(qf, kf, vf, dof, *rest),
            *flash.flash_dkv_cuda(qf, kf, vf, dof, *rest)]
    torch.cuda.synchronize()
    ok = all(torch.equal(a, w) for a, w in zip(got, want))
    emit({"phase": "flash", "kernel": "flash_fwd, flash_dq, flash_dkv",
          "case": "bf16 misaligned bases", "route": "tc",
          "limit": "bit-equal to the aligned inputs", "ok": ok})
    check(ok, "tensor-core forward and backward on misaligned bases")


def _flash_work(b, t, h, d, elt):
    """FLOPs over the causal pairs and the least bytes of each flash kernel
    at (B, T, H, Dh) causal, no window, elt-byte inputs and outputs."""
    pairs = b * h * t * (t + 1) // 2
    tile = b * h * t * d * elt  # one q, k, v, O or dO tensor
    rows = b * h * t * 4  # one f32 lse or delta vector
    return {
        "flash_fwd": (2 * 2 * pairs * d, 3 * tile + tile + rows),  # QK^T, PV
        "flash_dq": (3 * 2 * pairs * d, 4 * tile + 2 * rows + tile),  # QK^T, dOV^T, dSK
        "flash_dkv": (4 * 2 * pairs * d, 4 * tile + 2 * rows + 2 * tile),  # + P^T dO, dS^T Q
    }


LIBRARY_CALLS = {
    "fwd": "F.scaled_dot_product_attention(q, k, v, is_causal=True)",
    "bwd": "torch.autograd.grad of that call (dQ, dK and dV together)",
}
#: SDPA's backends tried for the library call; the fastest one's time is kept
LIBRARY_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION")


def _library_times(torch, qf, kf, vf, dof, flush):
    """The library calls of :data:`LIBRARY_CALLS` on (B, H, T, Dh) views of
    the flat flagship inputs, on each of :data:`LIBRARY_BACKENDS` in turn:
    ``{backend: {"fwd": {"ms", "eager_ms"}, "bwd": {...}}}``, or
    ``{backend: {"error": ...}}`` where it has no kernel for these inputs.
    ``ms`` is a CUDA graph's replay, so host dispatch (autograd's above
    all) falls outside the window, and ``ms_clean_l2`` the same after a
    clean flush (:func:`time_ms`); ``eager_ms`` times the call itself.
    Timed for comparison only: the port never calls them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, t, h, d = FLASH_SHAPE
    q4, k4, v4, do4 = (x.view(b, h, t, d) for x in (qf, kf, vf, dof))
    times = {}
    for name in LIBRARY_BACKENDS:
        qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q4, k4, v4))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                with torch.cuda.stream(side):  # the backward runs on its forward's stream
                    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
                calls = {
                    "fwd": lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
                    "bwd": lambda: torch.autograd.grad(out, (qg, kg, vg), do4,
                                                       retain_graph=True),
                }
                eager = {k: time_ms(torch, fn, reps=20, flush=flush) for k, fn in calls.items()}
                replays = {k: graph_replay(torch, fn, side) for k, fn in calls.items()}
        except RuntimeError as exc:  # no kernel of this backend for these inputs
            times[name] = {"error": (str(exc) or type(exc).__name__).splitlines()[0][:200]}
            continue
        torch.cuda.current_stream().wait_stream(side)
        times[name] = {k: {"ms": time_ms(torch, replays[k], reps=20, flush=flush),
                           "ms_clean_l2": time_ms(torch, replays[k], reps=20, flush=flush,
                                                  clean=True),
                           "eager_ms": eager[k]} for k in calls}
    return times


def flash_time_phase(torch, flash, hbm, flops_peak):
    b, t, h, d = FLASH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(1)
    qf, kf, vf, dof = _flash_inputs(torch, g, FLASH_SHAPE, h, t, "bfloat16")
    scale = 1.0 / math.sqrt(d)
    of, lse = flash.flash_fwd_cuda(qf, kf, vf, True, scale)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    bwd_args = (qf, kf, vf, dof, lse, delta, True, scale)
    runs = {
        "flash_fwd": (lambda: flash.flash_fwd_cuda(qf, kf, vf, True, scale),
                      lambda: flash.flash_fwd_plain(qf, kf, vf, True, scale)),
        "flash_dq": (lambda: flash.flash_dq_cuda(*bwd_args),
                     lambda: flash.flash_dq_plain(*bwd_args)),
        "flash_dkv": (lambda: flash.flash_dkv_cuda(*bwd_args),
                      lambda: flash.flash_dkv_plain(*bwd_args)),
    }
    library = _library_times(torch, qf, kf, vf, dof, flush)
    ran = {n: r for n, r in library.items() if "error" not in r}
    check(ran, "scaled_dot_product_attention ran on some backend")
    # the earlier kernels, the CUDA-core route, on the same bf16 inputs: the
    # tensor-core kernels' baseline on this card in this run
    previous = {"flash_fwd": lambda: flash.flash_fwd_cuda(qf, kf, vf, True, scale, route="f32"),
                "flash_dq": lambda: flash.flash_dq_cuda(*bwd_args, route="f32"),
                "flash_dkv": lambda: flash.flash_dkv_cuda(*bwd_args, route="f32")}
    work = _flash_work(b, t, h, d, 2)
    timing = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(torch, kernel, reps=20, flush=flush)
        ms_clean = time_ms(torch, kernel, reps=20, flush=flush, clean=True)
        plain_ms = time_ms(torch, plain, reps=10, flush=flush)
        previous_ms = time_ms(torch, previous[name], reps=10, flush=flush)
        flops, nbytes = work[name]
        by_ops, by_bytes = flops / flops_peak * 1e3, nbytes / hbm * 1e3
        lib = "fwd" if name == "flash_fwd" else "bwd"
        best = min(ran, key=lambda n: ran[n][lib]["ms"])
        rec = {"phase": "flash_time", "kernel": name, "shape": list(FLASH_SHAPE),
               "dtype": "bfloat16", "causal": True, "flops": flops, "bytes": nbytes,
               "route": flash.kernel_route(qf.dtype, d),
               "ms": ms, "ms_clean_l2": ms_clean, "previous_ms": previous_ms,
               "previous_route": "f32",
               "plain_ms": plain_ms, "library_ms": ran[best][lib]["ms"],
               "library_ms_clean_l2": ran[best][lib]["ms_clean_l2"],
               "library_call": LIBRARY_CALLS[lib], "library_backend": best,
               "library_backends": {n: r.get(lib, r) for n, r in library.items()},
               "tflop_per_s": flops / (ms * 1e-3) / 1e12,
               "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops > by_bytes else "bytes"}
        rec["bound_share"] = rec["bound_ms"] / ms
        emit(rec)
        timing[name] = rec
    del flush
    return timing


def _zero_flash_counts(flash):
    for name in FLASH_KERNELS:
        fn = getattr(flash, name + "_cuda")
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def _route_counts(flash):
    """The flash kernels' launches by route ("tc", "f32")."""
    return {n: dict(getattr(flash, n + "_cuda").launches_by_route) for n in FLASH_KERNELS}


# -- K5: the layer norm kernels ------------------------------------------------

#: (label, (rows, d), dtype): the benchmark cells' rows at d_model 1024, a
#: serving decode step's, a small model's in f32, then one case of each
#: other kind of kernel instance (one element a lane and padded chunk slots
#: at d 96, the widest rows at d 4096 and 4064; the other widths the port's
#: models use, 32 and 64)
LN_CASES = [
    ("train", (131072, 1024), "bfloat16"),
    ("decode", (16, 1024), "bfloat16"),
    ("small f32", (4096, 128), "float32"),
    ("d 32 f32", (300, 32), "float32"),
    ("d 64 bf16", (7, 64), "bfloat16"),
    ("d 96 bf16", (301, 96), "bfloat16"),
    ("d 4096 bf16", (33, 4096), "bfloat16"),
    ("d 4064 f32", (9, 4064), "float32"),
]
#: the cases timed (:func:`layer_norm_time_phase`)
LN_TIME_CASES = LN_CASES[:3]
#: absolute floor of the bf16 limits (:func:`_ln_err`)
LN_ATOL = 1e-5
#: relative limits of f32 outputs: the forward's mean and variance and the
#: backward's two row means are f32 sums taken in another order than the
#: plain pass's, a few ulps of each row's terms
LN_RTOL = {"y": 1e-5, "mean": 1e-5, "rstd": 1e-5, "dx": 5e-5}
#: the column sums' limit, a share of the sum of the terms' magnitudes (f32
#: sums of the same terms in another order): the largest share read on an
#: H100 is 2.4e-7 (d 4064, 9 rows); one row left out of the train case's
#: 131,072 reads about 8e-6, one block's partial row far more
LN_SUM_RTOL = 1e-6
#: the seqformer_big train step whose capture the norm kernels' counters
#: read (the benchmark's widths and T, batch 4)
LN_STEP = dict(batch=4, obs_dim=32, d_model=1024, n_heads=16, n_layers=6, d_ff=4096)


def _ln_inputs(torch, g, shape, dtype):
    """x (mean 0.5, std 2), dy, and scale and bias near 1 and 0, on the card."""
    rows, d = shape
    dt = getattr(torch, dtype)
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dt)
    dy = torch.randn(shape, generator=g, device="cuda").to(dt)
    scale = 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
    bias = 0.1 * torch.randn(d, generator=g, device="cuda")
    return x, dy, scale, bias


def _ln_err(torch, got, want, rtol):
    """Max abs error of a kernel output against the plain pass's, and
    whether it is within its limit: rtol * (1 + |want|) for f32, and for
    bf16 LN_ATOL plus two bf16 ulps of the plain value (one for a rounding
    that falls the other way after the f32 sums' reordering, one for a
    binade crossed)."""
    err = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        allowed = LN_ATOL + 2 * bf16_ulp(torch, want)
        limit = f"{LN_ATOL} + 2 bf16 ulps"
    else:
        allowed, limit = rtol * (1 + want.float().abs()), f"rtol={rtol}"
    ok = bool((err <= allowed).all()) and bool(torch.isfinite(got).all())
    return {"max_abs_err": err.max().item(), "limit": limit, "ok": ok}


def _ln_sum_err(got, want, magnitude):
    """A column sum against the plain pass's, within LN_SUM_RTOL of the sum
    of its terms' magnitudes."""
    err = (got - want).abs()
    ok = bool((err <= LN_SUM_RTOL * magnitude + 1e-6).all())
    return {"max_abs_err": err.max().item(),
            "max_share": (err / magnitude.clamp_min(1e-30)).max().item(),
            "limit": f"{LN_SUM_RTOL} x sum |terms|", "ok": ok}


def layer_norm_phase(torch, ln):
    """K5 against its plain passes on the same card inputs, the backward of
    each from the kernel's statistics; the backward's outputs bit-equal
    over two runs.  Returns the train case's largest errors."""
    g = torch.Generator(device="cuda").manual_seed(2)
    errs = {}
    for label, shape, dtype in LN_CASES:
        x, dy, scale, bias = _ln_inputs(torch, g, shape, dtype)
        y, mean, rstd = ln.layer_norm_fwd_cuda(x, scale, bias)
        want = ln.layer_norm_fwd_plain(x, scale, bias)
        grads = ln.layer_norm_bwd_cuda(dy, x, mean, rstd, scale)
        again = ln.layer_norm_bwd_cuda(dy, x, mean, rstd, scale)
        dx_p, ds_p, db_p = ln.layer_norm_bwd_plain(dy, x, mean, rstd, scale)
        torch.cuda.synchronize()
        xhat = (x.float() - mean[:, None]) * rstd[:, None]
        res = {name: _ln_err(torch, a, w, LN_RTOL[name])
               for name, a, w in zip(("y", "mean", "rstd"), (y, mean, rstd), want)}
        # rounding flips y's last bit either way; a bias would move the mean
        gap = y.float() - want[0].float()
        res["y"].update(differ_share=(gap != 0).float().mean().item(),
                        mean_signed_err=gap.double().mean().item(),
                        mean_abs=want[0].float().abs().double().mean().item())
        res["dx"] = _ln_err(torch, grads[0], dx_p, LN_RTOL["dx"])
        res["dscale"] = _ln_sum_err(grads[1], ds_p, (dy.float() * xhat).abs().sum(0))
        res["dbias"] = _ln_sum_err(grads[2], db_p, dy.float().abs().sum(0))
        repeat = all(torch.equal(a, b) for a, b in zip(grads, again))
        ok = all(r["ok"] for r in res.values()) and repeat
        emit({"phase": "layer_norm", "case": label, "shape": list(shape), "dtype": dtype,
              "errors": res, "backward_bit_equal_over_two_runs": repeat, "ok": ok})
        check(ok, f"layer norm {label}")
        if label == "train":
            errs = {"fwd": max(res[k]["max_abs_err"] for k in ("y", "mean", "rstd")),
                    "bwd": max(res[k]["max_abs_err"] for k in ("dx", "dscale", "dbias"))}
        del x, dy, y, mean, rstd, want, grads, again, dx_p, xhat, gap
    torch.cuda.empty_cache()
    return errs


LN_LIBRARY_CALLS = {
    "fwd": "F.layer_norm(x, (d,), scale, bias, eps)",
    "bwd": "torch.autograd.grad of that call (dx, dscale and dbias together)",
}


def _ln_library_times(torch, ln, x, dy, scale, bias, flush):
    """:data:`LN_LIBRARY_CALLS` as CUDA graph replays (autograd's host work
    outside the window), ms: ``{"fwd", "bwd", "mixed"}``, where ``mixed``
    says whether the call took the f32 scale and bias with the narrower x
    (else they are cast to x's dtype).  Timed for comparison only: the port
    never calls it."""
    import torch.nn.functional as F

    d = x.shape[-1]
    try:
        F.layer_norm(x, (d,), scale, bias, ln.EPS)
        w, b, mixed = scale, bias, True
    except RuntimeError:  # no mixed-dtype kernel for these inputs
        w, b, mixed = scale.to(x.dtype), bias.to(x.dtype), False
    xg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the backward runs on its forward's stream
        out = F.layer_norm(xg, (d,), wg, bg, ln.EPS)
    calls = {"fwd": lambda: F.layer_norm(x, (d,), w, b, ln.EPS),
             "bwd": lambda: torch.autograd.grad(out, (xg, wg, bg), dy, retain_graph=True)}
    replays = {k: graph_replay(torch, fn, side) for k, fn in calls.items()}
    torch.cuda.current_stream().wait_stream(side)
    times = {k: time_ms(torch, replays[k], reps=20, flush=flush) for k in calls}
    return {**times, "mixed": mixed}


def layer_norm_time_phase(torch, ln, hbm):
    """Each pass of K5 at :data:`LN_TIME_CASES` beside its bound (the least
    bytes over the card's bandwidth: x and y, or x, dy and dx, once each,
    the statistics, scale, bias and their gradients), its plain pass and
    the library call.  Returns the records by (case, pass)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timing = {}
    for label, shape, dtype in LN_TIME_CASES:
        rows, d = shape
        x, dy, scale, bias = _ln_inputs(torch, g, shape, dtype)
        _, mean, rstd = ln.layer_norm_fwd_cuda(x, scale, bias)
        elt = x.element_size()
        nbytes = {"fwd": 2 * rows * d * elt + 2 * rows * 4 + 2 * d * 4,
                  "bwd": 3 * rows * d * elt + 2 * rows * 4 + 3 * d * 4}
        runs = {
            "fwd": (lambda: ln.layer_norm_fwd_cuda(x, scale, bias),
                    lambda: ln.layer_norm_fwd_plain(x, scale, bias)),
            "bwd": (lambda: ln.layer_norm_bwd_cuda(dy, x, mean, rstd, scale),
                    lambda: ln.layer_norm_bwd_plain(dy, x, mean, rstd, scale)),
        }
        library = _ln_library_times(torch, ln, x, dy, scale, bias, flush)
        for name, (kernel, plain) in runs.items():
            ms = time_ms(torch, kernel, reps=20, flush=flush)
            rec = {"phase": "layer_norm_time", "kernel": f"layer_norm_{name}", "case": label,
                   "shape": list(shape), "dtype": dtype, "bytes": nbytes[name],
                   "ms": ms, "ms_clean_l2": time_ms(torch, kernel, reps=20, flush=flush,
                                                    clean=True),
                   "plain_ms": time_ms(torch, plain, reps=10, flush=flush),
                   "library_ms": library[name], "library_call": LN_LIBRARY_CALLS[name],
                   "library_mixed_dtypes": library["mixed"],
                   "bound_ms": nbytes[name] / hbm * 1e3, "bound_by": "bytes"}
            rec["bound_share"] = rec["bound_ms"] / ms
            rec["gb_per_s"] = nbytes[name] / (ms * 1e-3) / 1e9
            emit(rec)
            timing[(label, name)] = rec
        del x, dy, mean, rstd
    del flush
    torch.cuda.empty_cache()
    return timing


# -- MLA's K2-K4 instance and K5's RMS mode ------------------------------------

#: (label, (B, T, H), causal, window): K2-K4 at q/k 192, v 128 against the
#: plain passes (which hold a full f32 score matrix, hence the sizes)
MLA_FLASH_CASES = [
    ("mla causal", (2, 1024, 4), True, None),
    ("mla T 1000", (1, 1000, 2), True, None),
    ("mla window 300", (1, 1024, 2), True, 300),
    ("mla non-causal T 200", (1, 200, 2), False, None),
]
#: q/k and v head dims of latent attention (Moonlight-16B-A3B)
MLA_DIMS = (192, 128)
#: the Moonlight cell's attention: (B, T, H) causal, timed
MLA_TIME_SHAPE = (8, 8192, 16)
#: (label, (rows, d), dtype): K5's RMS mode against its plain passes; the
#: first two are the Moonlight cell's block and latent norms
RMS_CASES = [
    ("block", (65536, 2048), "bfloat16"),
    ("latent", (65536, 512), "bfloat16"),
    ("small f32", (4096, 128), "float32"),
    ("d 96 bf16", (301, 96), "bfloat16"),
]
#: the RMS eps of the cases (Moonlight's rms_norm_eps)
RMS_EPS = 1e-5


def _device_us_per_call(torch, fn, flush, reps=10):
    """The device time in us of all the kernels one call of ``fn`` launches
    (a backward and its partial sums together), from torch.profiler over
    ``reps`` calls, each after a clean flush: each kernel named in a
    profile of three calls of ``fn`` alone (so not the flush's fill, cast
    and reduction) counts at its median duration, as many times as it runs
    a call.  Medians, because the profiler now and then loses a prefix of a
    window's device records; NaN when it recorded none of ``fn``'s."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    def device(prof):
        return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as alone:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    per_call = {name: max(1, round(n / 3))
                for name, n in collections.Counter(e.name for e in device(alone)).items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            flush.sum()
            fn()
            torch.cuda.synchronize()
    times = collections.defaultdict(list)
    for e in device(prof):
        if e.name in per_call:
            times[e.name].append(e.time_range.elapsed_us())
    if not times or set(times) != set(per_call):
        return float("nan")
    return sum(statistics.median(t) * per_call[name] for name, t in times.items())


def _mla_flash_work(b, t, h, elt):
    """FLOPs over the causal pairs and least bytes of each flash kernel at
    latent attention's head dims (q/k 192, v 128), every tensor at its
    own width."""
    dq, dv = MLA_DIMS
    pairs = b * h * t * (t + 1) // 2
    wq, wv, rows = b * h * t * dq * elt, b * h * t * dv * elt, b * h * t * 4
    return {"flash_fwd": (2 * pairs * (dq + dv), 2 * wq + 2 * wv + rows),
            "flash_dq": (2 * pairs * (2 * dq + dv), 3 * wq + 2 * wv + 2 * rows),
            "flash_dkv": (2 * pairs * (2 * dq + 2 * dv), 3 * wq + 3 * wv + 2 * rows)}


def _mla_flash_inputs(torch, g, b, t, h):
    dq, dv = MLA_DIMS

    def rnd(d):
        return torch.randn((b * h, t, d), generator=g, device="cuda").to(torch.bfloat16)

    return rnd(dq), rnd(dq), rnd(dv), rnd(dv)


def _mla_flash_check(torch, flash, label, inputs, shape, causal, window, scale):
    """K2-K4 on card inputs (B*H, T, D) against their plain passes, held to
    :func:`_compare`'s limits: the largest error by kernel."""
    qf, kf, vf, dof = inputs
    of, lse = flash.flash_fwd_plain(qf, kf, vf, causal, scale, window=window)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)
    bwd = (qf, kf, vf, dof, lse, delta, causal, scale)
    pairs = {
        "flash_fwd": (flash.flash_fwd_cuda(qf, kf, vf, causal, scale, window=window),
                      (of, lse), False),
        "flash_dq": ((flash.flash_dq_cuda(*bwd, window=window),),
                     (flash.flash_dq_plain(*bwd, window=window),), True),
        "flash_dkv": (flash.flash_dkv_cuda(*bwd, window=window),
                      flash.flash_dkv_plain(*bwd, window=window), True),
    }
    torch.cuda.synchronize()
    errs = {}
    for name, (got, want, grad) in pairs.items():
        shapes_ok = all(a.shape == w.shape for a, w in zip(got, want))
        results = [_compare(torch, a, w, grad, False) for a, w in zip(got, want)]
        ok = shapes_ok and all(r[1] for r in results)
        errs[name] = max(r[0] for r in results)
        emit({"phase": "mla_flash", "kernel": name, "case": label, "shape": list(shape),
              "head_dims": list(MLA_DIMS), "causal": causal, "window": window,
              "max_abs_err": errs[name], "limit": " / ".join(r[2] for r in results),
              "ok": ok})
        check(ok, f"{name} {label}")
    return errs


def mla_flash_phase(torch, flash):
    """K2-K4 at (192, 128) against their plain passes on the same card
    inputs (:data:`MLA_FLASH_CASES`), held to :func:`_compare`'s limits.
    Returns the largest error by kernel."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for label, (b, t, h), causal, window in MLA_FLASH_CASES:
        inputs = _mla_flash_inputs(torch, g, b, t, h)
        errs = _mla_flash_check(torch, flash, label, inputs, (b, t, h), causal, window,
                                1.0 / math.sqrt(MLA_DIMS[0]))
        worst = {k: max(worst.get(k, 0.0), v) for k, v in errs.items()}
        del inputs
    torch.cuda.empty_cache()
    return worst


def _mla_head_check(torch, flash, inputs, scale):
    """K2-K4 on one head of the timed inputs at T 8192, causal, against
    their plain passes (whose f32 score matrix is 256 MiB at this T)."""
    _mla_flash_check(torch, flash, "T 8192 head", inputs, (1, inputs[0].shape[1], 1), True,
                     None, scale)
    torch.cuda.empty_cache()


def rms_norm_phase(torch, ln):
    """K5's RMS mode against its plain passes on the same card inputs
    (:data:`RMS_CASES`), the backward from the kernel's rstd, its outputs
    bit-equal over two runs; the limits of :func:`layer_norm_phase`.
    Returns the largest error of each pass over the cases."""
    g = torch.Generator(device="cuda").manual_seed(6)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for label, shape, dtype in RMS_CASES:
        x, dy, scale, _ = _ln_inputs(torch, g, shape, dtype)
        y, rstd = ln.rms_norm_fwd_cuda(x, scale, RMS_EPS)
        want = ln.rms_norm_fwd_plain(x, scale, RMS_EPS)
        grads = ln.rms_norm_bwd_cuda(dy, x, rstd, scale)
        again = ln.rms_norm_bwd_cuda(dy, x, rstd, scale)
        dx_p, ds_p = ln.rms_norm_bwd_plain(dy, x, rstd, scale)
        torch.cuda.synchronize()
        xhat = x.float() * rstd[:, None]
        res = {name: _ln_err(torch, a, w, LN_RTOL[name])
               for name, a, w in zip(("y", "rstd"), (y, rstd), want)}
        res["dx"] = _ln_err(torch, grads[0], dx_p, LN_RTOL["dx"])
        res["dscale"] = _ln_sum_err(grads[1], ds_p, (dy.float() * xhat).abs().sum(0))
        repeat = all(torch.equal(a, b) for a, b in zip(grads, again))
        ok = all(r["ok"] for r in res.values()) and repeat
        emit({"phase": "rms_norm", "case": label, "shape": list(shape), "dtype": dtype,
              "errors": res, "backward_bit_equal_over_two_runs": repeat, "ok": ok})
        check(ok, f"rms norm {label}")
        worst = {"fwd": max(worst["fwd"], res["y"]["max_abs_err"], res["rstd"]["max_abs_err"]),
                 "bwd": max(worst["bwd"], res["dx"]["max_abs_err"],
                            res["dscale"]["max_abs_err"])}
        del x, dy, y, rstd, want, grads, again, dx_p, xhat
    torch.cuda.empty_cache()
    return worst


#: the Moonlight step's held experts under balanced routing: rows an
#: expert, experts held, d_model, expert width
GROUPED_SHAPE = (6144, 8, 2048, 1408)
#: rows an expert of the grouped products' check: unbalanced, one empty
GROUPED_COUNTS = (700, 0, 1, 5000, 129, 128, 64, 3000)


def grouped_phase(torch, moe):
    """The held experts' grouped products (``moe.grouped_mm``: forward, and
    through autograd the input and weight gradients) against a bf16
    product an expert at :data:`GROUPED_COUNTS` rows, both projections'
    widths, within 2e-2 of each output's largest magnitude (a few bf16
    ulps of its largest term).  Returns the largest error by product."""
    g = torch.Generator(device="cuda").manual_seed(8)
    _, e, d, f = GROUPED_SHAPE
    worst = {"grouped_fwd": 0.0, "grouped_dx": 0.0, "grouped_dw": 0.0}
    ends = torch.cumsum(torch.tensor(GROUPED_COUNTS, device="cuda"), 0).to(torch.int32)
    used = int(ends[-1])
    for k, n in ((d, f), (f, d)):
        # 300 arena rows past the routed ones, never read
        x = torch.randn(used + 300, k, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(e, k, n, generator=g, device="cuda") / math.sqrt(k)
        dy = torch.randn(used, n, generator=g, device="cuda").to(torch.bfloat16)
        x.requires_grad_(True)
        w.requires_grad_(True)
        y = moe.grouped_mm(x, w, ends)[:used]
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        wb, xd = w.detach().to(torch.bfloat16), x.detach()
        errs = {name: 0.0 for name in worst}
        at = 0
        for i, end in enumerate(ends.tolist()):
            if end > at:
                for name, got, want in (("grouped_fwd", y[at:end], xd[at:end] @ wb[i]),
                                        ("grouped_dx", dx[at:end], dy[at:end] @ wb[i].T),
                                        ("grouped_dw", dw[i], xd[at:end].T @ dy[at:end])):
                    err = float((got.float() - want.float()).abs().max()
                                / want.float().abs().max())
                    errs[name] = max(errs[name], err if math.isfinite(err) else math.inf)
            at = end
        empty = float(dw[1].abs().max())
        ok = all(v <= 2e-2 for v in errs.values()) and empty == 0
        emit({"phase": "grouped", "k": k, "n": n, "counts": list(GROUPED_COUNTS),
              "rel_err": errs, "empty_expert_dw": empty, "limit": 2e-2, "ok": ok})
        check(ok, f"grouped products at ({k}, {n})")
        worst = {name: max(worst[name], errs[name]) for name in worst}
        del x, w, dy, y, dx, dw, wb, xd
    torch.cuda.empty_cache()
    return worst


def _grouped_time(torch, moe, flush, hbm, flops_peak):
    """The grouped products at :data:`GROUPED_SHAPE` (forward x W1, the
    input gradient through W1^T, the weight gradient, each a call of
    ``torch._grouped_mm`` over the row ends as ``moe.grouped_mm`` makes
    it), each beside its bound and a bf16 product an expert (``plain_ms``),
    in an arena of 6 rows a token (the drop-free bound at 65,536 tokens),
    8x the rows routed: the work follows the routed rows.  Returns the
    records by product."""
    rows, e, d, f = GROUPED_SHAPE
    g = torch.Generator(device="cuda").manual_seed(8)
    n = rows * e
    ends = (torch.arange(1, e + 1, device="cuda") * rows).to(torch.int32)
    x = torch.randn(8 * n, d, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(e, d, f, generator=g, device="cuda") / math.sqrt(d)).to(torch.bfloat16)
    dy = torch.randn(8 * n, f, generator=g, device="cuda").to(torch.bfloat16)
    wt = w.transpose(-2, -1)
    runs = {
        "grouped_fwd": (lambda: torch._grouped_mm(x, w, offs=ends),
                        lambda: [x[i * rows:(i + 1) * rows] @ w[i] for i in range(e)],
                        (n * d + e * d * f + n * f) * 2),
        "grouped_dx": (lambda: torch._grouped_mm(dy, wt, offs=ends),
                       lambda: [dy[i * rows:(i + 1) * rows] @ wt[i] for i in range(e)],
                       (n * f + e * d * f + n * d) * 2),
        "grouped_dw": (lambda: torch._grouped_mm(x.t(), dy, offs=ends),
                       lambda: [x[i * rows:(i + 1) * rows].t() @ dy[i * rows:(i + 1) * rows]
                                for i in range(e)], (n * d + n * f + e * d * f) * 2),
    }
    out = {}
    for name, (fn, plain, nbytes) in runs.items():
        flops = 2 * n * d * f
        by_ops, by_bytes = flops / flops_peak * 1e3, nbytes / hbm * 1e3
        rec = {"phase": "mla_kernels_time", "kernel": name, "shape": list(GROUPED_SHAPE),
               "arena_rows": 8 * n, "flops": flops, "bytes": nbytes,
               "ms_clean_l2": time_ms(torch, fn, reps=20, flush=flush, clean=True),
               "profiled_us": _device_us_per_call(torch, fn, flush, reps=20),
               "plain_ms": time_ms(torch, plain, reps=10, flush=flush, clean=True),
               "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops > by_bytes else "bytes"}
        rec["bound_share"] = rec["bound_ms"] / rec["ms_clean_l2"]
        rec["bound_share_profiled"] = rec["bound_ms"] / (rec["profiled_us"] * 1e-3)
        emit(rec)
        out[name] = rec
    del x, w, dy, wt
    return out


def mla_kernels_time_phase(torch, flash, ln, moe, hbm, flops_peak):
    """K2-K4 at :data:`MLA_TIME_SHAPE`, K5's RMS mode at the first two
    :data:`RMS_CASES` and the grouped products at :data:`GROUPED_SHAPE`:
    each kernel's median CUDA-event time after a clean flush and its device
    time in the profiler, beside its bound (the larger of FLOPs over the
    bf16 peak and bytes over HBM's rate); the plain pass's time where it
    fits (flash at one row of the batch).  Before the times, K2-K4 on one
    head of :data:`MLA_TIME_SHAPE`'s inputs at T 8192 against their plain
    passes (``mla_flash``, case ``T 8192 head``).  Returns the records by
    kernel name."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    b, t, h = MLA_TIME_SHAPE
    qf, kf, vf, dof = _mla_flash_inputs(torch, g, b, t, h)
    scale = 1.0 / math.sqrt(MLA_DIMS[0])
    of, lse = flash.flash_fwd_cuda(qf, kf, vf, True, scale)
    delta = (dof.float() * of.float()).sum(-1, keepdim=True)
    bwd = (qf, kf, vf, dof, lse, delta, True, scale)
    _mla_head_check(torch, flash, [x[:1] for x in (qf, kf, vf, dof)], scale)
    # the plain passes at one row of the batch and 2,048 steps
    small = [x[:h, :2048].contiguous() for x in (qf, kf, vf, dof)]
    s_of, s_lse = flash.flash_fwd_plain(*small[:3], True, scale)
    s_bwd = (*small, s_lse, (small[3].float() * s_of.float()).sum(-1, keepdim=True), True, scale)
    runs = {"flash_fwd": (lambda: flash.flash_fwd_cuda(qf, kf, vf, True, scale),
                          lambda: flash.flash_fwd_plain(*small[:3], True, scale)),
            "flash_dq": (lambda: flash.flash_dq_cuda(*bwd), lambda: flash.flash_dq_plain(*s_bwd)),
            "flash_dkv": (lambda: flash.flash_dkv_cuda(*bwd),
                          lambda: flash.flash_dkv_plain(*s_bwd))}
    work = _mla_flash_work(b, t, h, 2)
    out = {}
    for name, (kernel, plain) in runs.items():
        flops, nbytes = work[name]
        by_ops, by_bytes = flops / flops_peak * 1e3, nbytes / hbm * 1e3
        rec = {"phase": "mla_kernels_time", "kernel": name, "shape": [b, t, h],
               "head_dims": list(MLA_DIMS), "causal": True, "flops": flops, "bytes": nbytes,
               "ms": time_ms(torch, kernel, reps=10, flush=flush),
               "ms_clean_l2": time_ms(torch, kernel, reps=10, flush=flush, clean=True),
               "profiled_us": _device_us_per_call(torch, kernel, flush),
               "plain_ms": time_ms(torch, plain, reps=5, flush=flush),
               "plain_shape": [1, 2048, h], "bound_ms": max(by_ops, by_bytes),
               "bound_by": "operations" if by_ops > by_bytes else "bytes"}
        rec["bound_share"] = rec["bound_ms"] / rec["ms_clean_l2"]
        rec["bound_share_profiled"] = rec["bound_ms"] / (rec["profiled_us"] * 1e-3)
        emit(rec)
        out[name] = rec
    del qf, kf, vf, dof, of, lse, delta, bwd, small, s_of, s_lse, s_bwd
    torch.cuda.empty_cache()
    for label, shape, dtype in RMS_CASES[:2]:
        rows, d = shape
        x, dy, scale, _ = _ln_inputs(torch, g, shape, dtype)
        _, rstd = ln.rms_norm_fwd_cuda(x, scale, RMS_EPS)
        elt = x.element_size()
        nbytes = {"fwd": 2 * rows * d * elt + rows * 4 + d * 4,
                  "bwd": 3 * rows * d * elt + rows * 4 + 2 * d * 4}
        runs = {"fwd": (lambda: ln.rms_norm_fwd_cuda(x, scale, RMS_EPS),
                        lambda: ln.rms_norm_fwd_plain(x, scale, RMS_EPS)),
                "bwd": (lambda: ln.rms_norm_bwd_cuda(dy, x, rstd, scale),
                        lambda: ln.rms_norm_bwd_plain(dy, x, rstd, scale))}
        for name, (kernel, plain) in runs.items():
            rec = {"phase": "mla_kernels_time", "kernel": f"rms_norm_{name}", "case": label,
                   "shape": list(shape), "dtype": dtype, "bytes": nbytes[name],
                   "ms": time_ms(torch, kernel, reps=20, flush=flush),
                   "ms_clean_l2": time_ms(torch, kernel, reps=20, flush=flush, clean=True),
                   "profiled_us": _device_us_per_call(torch, kernel, flush, reps=20),
                   "plain_ms": time_ms(torch, plain, reps=10, flush=flush),
                   "bound_ms": nbytes[name] / hbm * 1e3, "bound_by": "bytes"}
            rec["bound_share"] = rec["bound_ms"] / rec["ms_clean_l2"]
            rec["bound_share_profiled"] = rec["bound_ms"] / (rec["profiled_us"] * 1e-3)
            emit(rec)
            out.setdefault(f"rms_norm_{name}", rec)  # the block norm's rows
        del x, dy, rstd
    out.update(_grouped_time(torch, moe, flush, hbm, flops_peak))
    del flush
    torch.cuda.empty_cache()
    return out


#: Moonlight-16B-A3B (huggingface.co/moonshotai/Moonlight-16B-A3B,
#: config.json) as one card of an 8-card expert-parallel deployment trains
#: it: every width as published, 5 of its 27 layers (the dense one and four
#: DeepSeekMoE ones), experts 0-7 of the router's 64 held, 8,192-step
#: sequences; batch 4, so that each held expert sees half its load under
#: the deployment (batch 8 does not fit the drop-free arena's activations)
MOONLIGHT = {
    "obs_dim": 32, "d_model": 2048, "n_heads": 16, "n_layers": 5, "held": 8, "batch": 4,
    "seq_len": 8192, "steps": 6, "lr": 1e-4, "gamma": 1e-3,
    "mla": {"kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
            "v_head_dim": 128, "n_dense": 1, "dense_ff": 11264, "moe_ff": 1408,
            "n_routed": 64, "n_shared": 2},
    "arch": {"norm_eps": 1e-5, "kv_norm_eps": 1e-6, "rope_theta": 50000, "moe_k": 6,
             "moe_scale": 2.446, "moe_experts": 64, "moe_first": 0, "balance_alpha": 1e-4},
}
#: the first forward's loss on one sequence against the float32
#: reference's, relative: bf16 products over five layers (a few 1e-3)
MOONLIGHT_LOSS_RTOL = 1e-2
#: substrings of the device kernels' names by class, first match wins
#: (portbench/harness/kernel_classes.json's, with the norms and the grouped
#: products apart; torch's grouped product is a CUTLASS kernel)
STEP_CLASSES = (("flash", ("flash_",)), ("norm", ("layer_norm_",)),
                ("grouped", ("Group", "group")),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "gemv", "sm90_",
                          "splitKreduce")))


def _moonlight_reference_cfg(m):
    """The Moonlight step's settings under the reference's keys."""
    mla, arch = m["mla"], m["arch"]
    return {"qk_nope_head_dim": mla["qk_nope_head_dim"],
            "qk_rope_head_dim": mla["qk_rope_head_dim"], "kv_lora_rank": mla["kv_lora_rank"],
            "kv_norm_eps": arch["kv_norm_eps"], "rope_theta": arch["rope_theta"],
            "rms_norm_eps": arch["norm_eps"], "num_hidden_layers": m["n_layers"],
            "first_k_dense_replace": mla["n_dense"], "router_experts": arch["moe_experts"],
            "n_routed_experts": m["held"], "first_held_expert": arch["moe_first"],
            "num_experts_per_tok": arch["moe_k"], "routed_scaling_factor": arch["moe_scale"],
            "balance_alpha": arch["balance_alpha"]}


def _replay_by_class(torch, replay):
    """One call of ``replay`` under torch.profiler: the device time and
    kernel count by :data:`STEP_CLASSES` class, the busy time, and the ten
    kernels of most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    classes = {}
    for name, (us, n) in by_name.items():
        cls = next((c for c, keys in STEP_CLASSES if any(k in name for k in keys)), "other")
        ms0, n0 = classes.get(cls, (0.0, 0))
        classes[cls] = (ms0 + us / 1e3, n0 + n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_ms": sum(us for us, _ in by_name.values()) / 1e3,
            "by_class": {c: {"ms": ms, "kernels": n} for c, (ms, n) in classes.items()},
            "top": [{"name": name[:160], "ms": us / 1e3, "kernels": n}
                    for name, (us, n) in top]}


def moonlight_step_phase(torch, seqformer, flash, ln, pendulum, TrainState):
    """Phase 7d (module docstring).  Returns the launches of K2-K4 and K5's
    RMS mode by kernel over the steps."""
    import numpy as np

    from blendjax_torch.models import moe
    from blendjax_torch.models.train import make_train_step
    from portbench.reference import mla_moe as ref

    t0 = time.perf_counter()
    m, mla = MOONLIGHT, MOONLIGHT["mla"]
    layers = [f"blocks.{i}" for i in range(mla["n_dense"], m["n_layers"])]
    params = seqformer.init(torch.Generator(device="cuda").manual_seed(0),
                            obs_dim=m["obs_dim"], d_model=m["d_model"], n_heads=m["n_heads"],
                            n_layers=m["n_layers"], device="cuda", mla=mla)
    for key in [k for k in params if k.rsplit(".", 1)[-1] in ("w1", "w3", "w2")
                and ".moe." in k and ".shared." not in k]:
        params[key] = params[key][:m["held"]].clone()  # this card's experts
    torch.cuda.empty_cache()
    ep = pendulum.simulate_episode(np.random.default_rng(0), m["batch"], m["seq_len"],
                                   m["obs_dim"])
    batch = {"episode": torch.from_numpy(ep).to(torch.float16).cuda()}
    attn = flash.make_flash_attention(causal=True, block_q="auto", block_kv="auto")

    def loss_fn(p, b, arch):
        return seqformer.episode_loss_fn(p, b, compute_dtype=torch.bfloat16, attn_fn=attn,
                                         arch=arch)

    # the first forward on one sequence against the float32 reference
    one = {"episode": batch["episode"][:1]}
    with torch.no_grad():
        got = float(loss_fn(params, one, dict(m["arch"], balance=None)))
        want = float(ref.episode_loss(params, one["episode"], _moonlight_reference_cfg(m),
                                      {k: torch.zeros(mla["n_routed"], device="cuda")
                                       for k in layers})[0])
    gap = abs(got - want) / abs(want)
    emit({"phase": "moonlight_reference", "loss": got, "reference_loss": want,
          "rel_gap": gap, "limit": MOONLIGHT_LOSS_RTOL, "ok": gap <= MOONLIGHT_LOSS_RTOL})

    balance = moe.Balance(layers, mla["n_routed"], m["held"], m["gamma"], "cuda")
    arch = dict(m["arch"], balance=balance)
    step = make_train_step(lambda p, b: loss_fn(p, b, arch), balance=balance)
    state = TrainState.create(params, lr=m["lr"])
    fns = {"flash_fwd": flash.flash_fwd_cuda, "flash_dq": flash.flash_dq_cuda,
           "flash_dkv": flash.flash_dkv_cuda, "rms_norm_fwd": ln.rms_norm_fwd_cuda,
           "rms_norm_bwd": ln.rms_norm_bwd_cuda, "layer_norm_fwd": ln.layer_norm_fwd_cuda,
           "layer_norm_bwd": ln.layer_norm_bwd_cuda}
    routes = {k: dict(fns[k].launches_by_route) for k in FLASH_KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: fn.launches for k, fn in fns.items()}
    losses, step_ms = [], []
    for _ in range(m["steps"]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, loss = step(state, batch)
        end.record()
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
    launched = {k: fn.launches - before[k] for k, fn in fns.items()}
    by_route = {k: {r: n - routes[k][r] for r, n in fns[k].launches_by_route.items()}
                for k in FLASH_KERNELS}
    per_replay = {k: sum(n for gr in step.graphs.values() for f, n, _ in gr.launches
                         if f is fn) for k, fn in fns.items()}
    # a step: K2-K4 once a layer; the RMS norms two a block, the latent's
    # and ln_f, forward and backward
    want_step = {"flash_fwd": m["n_layers"], "flash_dq": m["n_layers"],
                 "flash_dkv": m["n_layers"], "rms_norm_fwd": 3 * m["n_layers"] + 1,
                 "rms_norm_bwd": 3 * m["n_layers"] + 1, "layer_norm_fwd": 0,
                 "layer_norm_bwd": 0}
    counters = balance.read()
    n_tok = m["batch"] * m["seq_len"]
    expected_rows = n_tok * m["arch"]["moe_k"] * m["held"] / mla["n_routed"]
    rec = {"phase": "moonlight_step", "config": {k: v for k, v in m.items() if k != "arch"},
           "losses": losses, "step_ms": step_ms, "replay_ms": sorted(step_ms[3:]),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launched, "launches_by_route": by_route, "per_replay": per_replay,
           "per_step": want_step, "arena_rows": moe.arena_rows(n_tok, m["arch"]["moe_k"],
                                                                m["held"]),
           "held_rows_a_forward": {layer: sum(c["rows"]) / m["steps"]
                                   for layer, c in counters["layers"].items()},
           "expected_held_rows": expected_rows, "counters": counters,
           "seconds": time.perf_counter() - t0}
    rec["replay"] = _replay_by_class(torch, lambda: step(state, batch))
    emit(rec)
    check(gap <= MOONLIGHT_LOSS_RTOL, "the Moonlight step's first loss against the reference")
    check(all(math.isfinite(x) for x in losses), "the Moonlight step's losses are finite")
    check(launched == {k: n * m["steps"] for k, n in want_step.items()},
          f"the Moonlight step launched {launched}, {want_step} a step")
    check(per_replay == want_step, f"the Moonlight capture launches {want_step} a replay")
    check(all(r["f32"] == 0 for r in by_route.values()),
          "every Moonlight flash launch on the tensor cores")
    check(counters["updates"] == m["steps"], "one bias step a train step")
    del state, step, batch, params, balance
    torch.cuda.empty_cache()
    return launched


def layer_norm_engagement(torch, ln, seqformer, worldmodel, pendulum, TrainState):
    """A seqformer_big train step (:data:`LN_STEP`) through its eager
    warm-ups, its capture and replays: every call adds 2 x n_layers + 1
    launches to each norm kernel's counter, and the capture recorded that
    many a replay.  Returns the counts a replay."""
    import functools

    import numpy as np

    from blendjax_torch.models.train import make_train_step

    cfg = {k: v for k, v in LN_STEP.items() if k != "batch"}
    state = TrainState.create(seqformer.init(
        torch.Generator(device="cuda").manual_seed(0), max_len=SEQ["seq_len"], device="cuda",
        **cfg), lr=SEQ["lr"])
    step = make_train_step(functools.partial(
        seqformer.episode_loss_fn, attn_fn=worldmodel.make_attn("flash", SEQ["seq_len"])))
    batch = _episodes(torch, pendulum, np.random.default_rng(0), LN_STEP["batch"])
    fns = {"layer_norm_fwd": ln.layer_norm_fwd_cuda, "layer_norm_bwd": ln.layer_norm_bwd_cuda}
    per_call = []
    for _ in range(5):
        before = {k: fn.launches for k, fn in fns.items()}
        state, loss = step(state, batch)
        float(loss)
        per_call.append({k: fn.launches - before[k] for k, fn in fns.items()})
    per_replay = {k: sum(n for gr in step.graphs.values() for f, n, _ in gr.launches if f is fn)
                  for k, fn in fns.items()}
    norms = 2 * LN_STEP["n_layers"] + 1
    emit({"phase": "layer_norm_engaged", "config": LN_STEP, "per_call": per_call,
          "per_replay": per_replay, "norms": norms})
    check(per_replay == {k: norms for k in fns},
          f"layer norm: one capture launches {norms} of each norm kernel a replay")
    check(all(c == {k: norms for k in fns} for c in per_call),
          f"layer norm: every train call adds {norms} launches of each norm kernel")
    del state, step, batch
    torch.cuda.empty_cache()
    return per_replay


def _device_profile(torch, run_step, steps, median_ms, phase, form, on_active=None):
    """``PROFILE_WARMUP_STEPS`` train steps as the profiler's warm-up (traced
    and discarded), then ``steps`` recorded ones under torch.profiler (CUDA
    activity): the device's busy time per step (the sum of its kernel, copy
    and set durations), its idle share of the profiled step and of the
    median unprofiled step, and the flash kernels' share.  ``on_active()``
    runs just before the recorded steps.  Emits the record and returns it,
    with every device event's name under ``kernels`` and the number of its
    events under ``runs``.

    The recorded window opens with a long device spin and one guard step
    and then a short marker spin, and closes with another marker; only
    the device events between the markers (on the card's own clock) are
    the recorded steps'.  The profiler now and then loses a prefix of a
    window's device records, warm-up or not (seen three times on an H100:
    the first decode of the detector's eager step, the first 45 events of
    the MoE flagship's eager step, the first 312 of the flagship's captured
    step), so the counted steps must not be the window's first."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=PROFILE_WARMUP_STEPS, active=1,
                                   repeat=1)) as prof:
        for _ in range(PROFILE_WARMUP_STEPS):
            run_step()
            torch.cuda.synchronize()
            prof.step()
        torch.cuda._sleep(PROFILE_ABSORB_CYCLES)
        run_step()
        torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        if on_active is not None:
            on_active()
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
            torch.cuda.synchronize()  # every recorded kernel done inside the window
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        torch.cuda._sleep(PROFILE_MARK_CYCLES)
        torch.cuda.synchronize()
        prof.step()  # collects the trace
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = sorted((e.time_range.start, e.time_range.end) for e in device
                   if "spin_kernel" in e.name and e.time_range.elapsed_us() < 1e3)
    check(len(marks) == 2, f"{phase} {form}: the profiler kept the recorded steps' two "
          f"marker spins ({len(marks)} found; it lost records past the guard step)")
    (_, lead), (trail, _) = marks
    by_name, runs, events = {}, {}, 0
    for e in device:
        if e.time_range.start >= lead and e.time_range.end <= trail:
            events += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            runs[e.name] = runs.get(e.name, 0) + 1
    busy = sum(by_name.values())
    flash_ms = sum(v for n, v in by_name.items() if "bjx_flash" in n)  # K2-K4
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    rec = {"phase": phase, "form": form, "steps": steps, "device_events": events,
           "warmup_steps": PROFILE_WARMUP_STEPS, "window_events": len(device),
           "wall_ms_per_step": wall_ms, "median_step_ms": median_ms,
           "busy_ms_per_step": busy if events else "not measured",
           "idle_share": 1 - busy / wall_ms if events else None,
           "idle_share_of_median_step": 1 - busy / median_ms if events else None,
           "flash_ms_per_step": flash_ms,
           "flash_share_of_busy": flash_ms / busy if events else None,
           "flash_share_of_step": flash_ms / wall_ms,
           "top_ms_per_step": [[k[:120], v] for k, v in top]}
    emit(rec)
    return {**rec, "kernels": sorted(by_name), "runs": runs}


def _episodes(torch, pendulum, rng, batch):
    """Seeded float16 pendulum episodes on the card, (batch, T+1, obs_dim)."""
    ep = pendulum.simulate_episode(rng, batch, SEQ["seq_len"], SEQ["obs_dim"])
    return {"episode": torch.from_numpy(ep).to(torch.float16).cuda()}


def seqformer_phase(torch, seqformer, flash, worldmodel, pendulum, TrainState):
    import functools

    import numpy as np

    # the model path on the card (kernels) against the CPU (plain passes),
    # float32 compute, on a small model: head dim 32, T = 128
    attn = flash.make_flash_attention(causal=True, block_q="auto", block_kv="auto")
    params = seqformer.init(torch.Generator().manual_seed(0), obs_dim=8, d_model=64,
                            n_heads=2, n_layers=2, max_len=128, device="cpu")
    ep = {"episode": torch.from_numpy(pendulum.simulate_episode(
        np.random.default_rng(0), 2, 128)).to(torch.float16)}
    losses = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        losses[dev] = seqformer.episode_loss_fn(
            p, {"episode": ep["episode"].to(dev)}, attn_fn=attn,
            compute_dtype=torch.float32).item()
    emit({"phase": "seqformer_reference", "cpu_loss": losses["cpu"],
          "cuda_loss": losses["cuda"], "rtol": 2e-4})
    check(math.isclose(losses["cpu"], losses["cuda"], rel_tol=2e-4),
          "small SeqFormer loss: card vs CPU")

    cfg = {k: SEQ[k] for k in ("obs_dim", "d_model", "n_heads", "n_layers")}

    def make_state():
        return TrainState.create(seqformer.init(
            torch.Generator(device="cuda").manual_seed(0), max_len=SEQ["seq_len"],
            device="cuda", **cfg), lr=SEQ["lr"])

    rng = np.random.default_rng(0)
    batches = [_episodes(torch, pendulum, rng, SEQ["batch"]) for _ in range(8)]

    def counts(zero=False):
        if zero:
            _zero_flash_counts(flash)
        return {"launches_per_step": {n: getattr(flash, n + "_cuda").launches / len(batches)
                                      for n in FLASH_KERNELS},
                "launches_by_route": _route_counts(flash)}

    loss = functools.partial(seqformer.episode_loss_fn,
                             attn_fn=worldmodel.make_attn("flash", SEQ["seq_len"]))
    turns = _forms(torch, "seqformer", make_state, loss, batches, counts,
                   {f"{n}_tc_kernel": getattr(flash, n + "_cuda") for n in FLASH_KERNELS})
    forms = _form_summary(turns)
    med = forms["captured"]["median_step_ms"]
    flops = seqformer.train_flops(SEQ["batch"], SEQ["seq_len"], **cfg)
    captured = turns[1]
    emit({"phase": "seqformer", "config": SEQ,
          "params": turns[0]["params"],
          "steps": len(batches), "first_loss": captured["losses"][0],
          "last_loss": captured["losses"][-1], "losses": captured["losses"],
          "median_step_ms": med, "forms": forms, "captured_match": CAPTURED_MATCH,
          "train_flops": flops,
          "model_tflop_per_s": flops / (med * 1e-3) / 1e12,
          "model_tflop_per_s_note": "train_flops counts attention over the full T^2",
          "launches_per_step": captured["launches"]["launches_per_step"],
          "launches_by_route": captured["launches"]["launches_by_route"],
          "peak_memory_gb": forms["captured"]["peak_memory_gb"]})
    _check_forms("seqformer", turns)
    for rec in turns:
        check(all(n == SEQ["n_layers"] for n in rec["launches"]["launches_per_step"].values()),
              f"seqformer {rec['form']}: one launch of each flash kernel per layer and step")
        check(all(r == {"tc": SEQ["n_layers"] * len(batches), "f32": 0}
                  for r in rec["launches"]["launches_by_route"].values()),
              f"seqformer {rec['form']}: every flagship forward, dQ and dK/dV launch took "
              "the tensor-core route")


def worldmodel_phase(torch, btt, worldmodel, flash):
    _fake_blender()
    batches, batch_size = 16, SEQ["batch"]
    args = ["--seq-len", str(SEQ["seq_len"] + 1), "--obs-dim", str(SEQ["obs_dim"])]
    shape = (batch_size, SEQ["seq_len"] + 1, SEQ["obs_dim"])
    arrivals = []

    def check_batch(batch):
        check(batch["episode"].is_cuda and batch["episode"].dtype == torch.float16
              and tuple(batch["episode"].shape) == shape, "episode batch")

    attn = worldmodel.make_attn("flash", SEQ["seq_len"])
    sizing = {k: SEQ[k] for k in ("d_model", "n_heads", "n_layers", "obs_dim", "seq_len",
                                  "lr")}
    with btt.BlenderLauncher(scene="", script=str(worldmodel.SCRIPT), num_instances=2,
                             named_sockets=["DATA"], start_port=_port_block(),
                             background=True, seed=0, instance_args=[args, args]) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                       max_items=batches * batch_size)
        # arena='auto' (the default): the episode stream has no per-item
        # transform, so its batches assemble in arenas
        with btt.TorchStream(ds, batch_size=batch_size, num_workers=2, device="cuda",
                             transform=worldmodel.episode_transform, arena="auto") as stream:
            _zero_flash_counts(flash)
            state, losses = worldmodel.train_on_episodes(
                _stamped(stream, arrivals, check_batch), attn=attn, log_every=0,
                **sizing)
            torch.cuda.synchronize()
            end = time.perf_counter()
            launches = {n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS}
            routes = _route_counts(flash)
    items_after_first = (len(arrivals) - 1) * batch_size
    emit({"phase": "worldmodel", "batches": len(losses), "items": len(losses) * batch_size,
          "items_per_s": items_after_first / (end - arrivals[0]),
          "median_step_ms": stream.timer.percentiles("step")["p50_ms"],
          "first_loss": losses[0], "last_loss": losses[-1],
          "launches": launches, "launches_by_route": routes,
          "arena_engaged": stream.arena_pool is not None,
          "timer": stream.timer.summary()})
    check(len(losses) == batches, "worldmodel stream delivered every batch")
    check(stream.arena_pool is not None and stream.timer.count("recycle") == batches
          and stream.arena_pool.in_use == 0,
          "the world-model stream ran on the arena and recycled every batch's arena")
    check(all(math.isfinite(v) for v in losses), "worldmodel losses finite")
    for name, n in launches.items():
        check(n >= 1, f"the world-model path launched {name}")
    for name, r in routes.items():
        check(r == {"tc": launches[name], "f32": 0},
              f"every world-model {name} launch took the tensor-core route")
    return launches, routes, state


# -- RL: the env layer, the policy and the control twins -----------------------

#: the control examples' fleet (``--instances 4``) and the pipelined arm's
#: depth, as the reference's ``make rlbench`` comparison
RL_INSTANCES = 4
RL_DEPTH = 4
#: env steps per turn of the lockstep/pipelined A/B, and its arms in turns
RL_AB_STEPS = 4000
RL_AB_ARMS = ("lockstep", "pipelined", "pipelined", "lockstep")
#: iterations of each twin at the examples' defaults (REINFORCE: horizon 64;
#: PPO: horizon 128, 4 epochs)
RL_ITERATIONS = {"reinforce": 4, "ppo": 3}
#: the card against the CPU on the same params and rollout (f32, TF32 off)
RL_ATOL = 1e-5


def _finite_transitions(obs, rewards):
    import numpy as np

    return bool(np.isfinite(np.asarray(obs)).all() and np.isfinite(rewards).all())


def _rl_turn(pool, arm, steps, rng):
    """``steps`` env steps with random forces, lockstep (``pool.step``) or
    pipelined (``step_async``/``step_wait`` at :data:`RL_DEPTH` requests in
    flight per env, collected ready-first and resubmitted to the envs that
    answered, topped up for the frames dropped behind an episode's end).
    Returns env steps per second and whether every transition was finite."""
    n = pool.num_envs

    def forces(k):
        return list(rng.choice([-20.0, 20.0], size=k))

    finite, done = True, 0
    t0 = time.perf_counter()
    if arm == "lockstep":
        while done < steps:
            obs, rew, _, _ = pool.step(forces(n))
            finite &= _finite_transitions(obs, rew)
            done += n
    else:
        for _ in range(RL_DEPTH):
            pool.step_async(forces(n))
        owed = n * RL_DEPTH  # transitions the pool owes
        while owed:
            idx, obs, rew, _, infos = pool.step_wait(min_ready=1)
            finite &= _finite_transitions(obs, rew)
            done += len(idx)
            again = [int(i) for i in idx]
            for i, info in zip(idx, infos):
                # frames queued behind an episode's end are dropped unseen
                dropped = info.get("inflight_discarded", 0)
                owed -= dropped
                again += [int(i)] * dropped
            owed -= len(idx)
            again = again[:max(0, steps - done - owed)]
            if again:
                pool.step_async(forces(len(again)), indices=again)
                owed += len(again)
        pool.step_wait()  # waits out the dropped frames: the pool quiesced
    return done / (time.perf_counter() - t0), finite


def _max_diff(torch, a, b):
    return (a.detach().float().cpu() - b.detach().float().cpu()).abs().max().item()


def _grads(torch, loss_fn, params):
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(params)
    return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _rl_vs_cpu(torch, policy, control, algo, params, rollout, last_obs, masks):
    """The card against the CPU on the same params and rollout: logits,
    log-probs, returns (REINFORCE) or values and GAE (PPO), the loss and
    its gradients.  Returns {quantity: max abs difference}."""
    cpu = {k: v.detach().cpu() for k, v in params.items()}
    ro_cpu = control.Rollout("cpu")
    for name in ("obs", "actions", "logp"):
        setattr(ro_cpu, name, [t.cpu() for t in getattr(rollout, name)])
    ro_cpu.rewards, ro_cpu.dones = rollout.rewards, rollout.dones
    diffs = {}
    if algo == "reinforce":
        sides = []
        for p, ro in ((params, rollout), (cpu, ro_cpu)):
            obs, actions = torch.cat(ro.obs), torch.cat(ro.actions)
            returns = policy.discounted_returns(*ro.tensors()).reshape(-1)
            loss, grads = _grads(torch, lambda q: policy.reinforce_loss(
                q, obs, actions, returns), p)
            sides.append({"logits": policy.logits(p, obs),
                          "log_prob": policy.categorical_log_prob(p, obs, actions),
                          "returns": returns, "loss": loss, **grads})
    else:
        sides = []
        for p, ro in ((params, rollout), (cpu, ro_cpu)):
            actor, critic = control.actor_critic(p)
            batch = control.ppo_batch(critic, ro, last_obs, masks)
            loss, grads = _grads(torch, lambda q: control.make_ppo_loss()(q, batch), p)
            sides.append({"logits": policy.logits(actor, batch["obs"]),
                          "log_prob": policy.categorical_log_prob(actor, batch["obs"],
                                                                  batch["actions"]),
                          "values": policy.value_apply(critic, batch["obs"]),
                          "gae": batch["advantages"], "targets": batch["targets"],
                          "loss": loss, **grads})
    for k in sides[0]:
        diffs[k] = _max_diff(torch, sides[0][k], sides[1][k])
    return diffs


def rl_phase(torch, btt, control, policy):
    """RL on the card through its entry points: :data:`RL_INSTANCES`
    ``btb/cartpole.blend.py`` producers under the fake Blender
    (``BLENDJAX_FAKE_BPY=1``) -> ``launch_env_pool`` -> lockstep against
    pipelined stepping in turns, then the REINFORCE and PPO twins
    (``control.train_reinforce``, ``control.train_ppo``) for a few
    iterations each at the examples' defaults, their updates captured.
    Then, on a fresh rollout of each trained policy: the card against the
    CPU on the same params and rollout, and the update eager against
    captured (:func:`_forms`) from the same seeded state over that rollout."""
    import numpy as np

    from blendjax_torch.models.train import WARMUP_STEPS, TrainState
    from blendjax_torch.utils.timing import EventCounters

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    t_phase = time.perf_counter()
    counters = EventCounters()
    rng = np.random.default_rng(0)
    with btt.launch_env_pool(scene="", script=str(control.SCRIPT),
                             num_instances=RL_INSTANCES, background=True,
                             start_port=_port_block(RL_INSTANCES), seed=0, real_time=False,
                             pipeline_depth=RL_DEPTH, counters=counters) as pool:
        pool.reset()
        _rl_turn(pool, "lockstep", 200, rng)  # untimed: the producers' first frames
        rates = {arm: [] for arm in RL_AB_ARMS}
        for turn, arm in enumerate(RL_AB_ARMS):
            rate, finite = _rl_turn(pool, arm, RL_AB_STEPS, rng)
            rates[arm].append(rate)
            emit({"phase": "rl_ab", "turn": turn, "arm": arm, "env_steps": RL_AB_STEPS,
                  "env_steps_per_s": rate, "pipeline_depth": RL_DEPTH if arm != "lockstep"
                  else None, "instances": RL_INSTANCES})
            check(finite, f"rl_ab {arm}: every transition finite")
        lock, pipe = statistics.mean(rates["lockstep"]), statistics.mean(rates["pipelined"])
        emit({"phase": "rl_ab_summary", "arms": rates, "lockstep_mean": lock,
              "pipelined_mean": pipe, "pipelined_x": pipe / lock})

        trained, twin_rates = {}, {}
        for algo, train in (("reinforce", control.train_reinforce),
                            ("ppo", control.train_ppo)):
            iters = []

            def on_iteration(rec, algo=algo):
                iters.append(rec)
                emit({"phase": "rl_train", "algo": algo, **rec})

            state, returns = train(pool, iterations=RL_ITERATIONS[algo], device="cuda",
                                   on_iteration=on_iteration, log_every=0)
            torch.cuda.synchronize()
            trained[algo] = state
            check(len(returns) == RL_ITERATIONS[algo]
                  and all(math.isfinite(r) for r in returns)
                  and all(math.isfinite(r["loss"]) for r in iters),
                  f"rl {algo}: returns and losses finite")
            check(all(torch.isfinite(v).all() for v in state.params.values()),
                  f"rl {algo}: parameters finite")
            # env steps per second with learning (rollouts and updates in
            # series) over the iterations after the update's capture
            horizon, epochs = (64, 1) if algo == "reinforce" else (128, 4)
            after = iters[math.ceil((WARMUP_STEPS + 1) / epochs):]
            twin_rates[algo] = (len(after) * horizon * RL_INSTANCES * 1e3
                                / sum(r["rollout_ms"] + r["update_ms"] for r in after))

        # one fresh rollout of each trained policy, for the checks
        gen = torch.Generator(device="cuda").manual_seed(5)
        batches = {}
        for algo, state in trained.items():
            params = state.params if algo == "reinforce" else control.actor_critic(
                state.params)[0]
            horizon = 64 if algo == "reinforce" else 128
            ro, masks = control.Rollout(torch.device("cuda")), []
            obs, _ = pool.reset()
            prev = np.zeros(RL_INSTANCES, bool)
            for _ in range(horizon):
                obs, dones = ro.step(pool, params, gen, obs)
                masks.append(1.0 - prev.astype(np.float32))
                prev = np.asarray(dones, bool)
            batches[algo] = (ro, obs, masks)
        healthy = bool(pool.healthy.all())
        faults = counters.snapshot()
    emit({"phase": "rl_pool", "healthy": healthy, "counters": faults})
    check(healthy and not faults.get("quarantines"), "the RL pool stayed all healthy")

    for algo, state in trained.items():
        ro, last_obs, masks = batches[algo]
        check(all(bool(torch.isfinite(o).all()) for o in ro.obs)
              and _finite_transitions(last_obs, np.stack(ro.rewards)),
              f"rl {algo}: rollout finite")
        diffs = _rl_vs_cpu(torch, policy, control, algo, state.params, ro, last_obs, masks)
        emit({"phase": "rl_reference", "algo": algo, "atol": RL_ATOL, "max_abs_diff": diffs})
        check(all(d <= RL_ATOL for d in diffs.values()),
              f"rl {algo}: the card equals the CPU within {RL_ATOL}")

        if algo == "reinforce":
            batch = {"obs": torch.cat(ro.obs), "actions": torch.cat(ro.actions),
                     "returns": policy.discounted_returns(*ro.tensors()).reshape(-1)}

            def make_state():
                return TrainState.create(policy.init(
                    torch.Generator(device="cuda").manual_seed(1), 3, 2, device="cuda"),
                    lr=3e-3)

            def loss(p, b):
                return policy.reinforce_loss(p, b["obs"], b["actions"], b["returns"])
        else:
            batch = control.ppo_batch(control.actor_critic(state.params)[1], ro, last_obs,
                                      masks)

            def make_state():
                return TrainState.create(control.joint_params(
                    policy.init(torch.Generator(device="cuda").manual_seed(1), 3, 2,
                                device="cuda"),
                    policy.value_init(torch.Generator(device="cuda").manual_seed(2), 3,
                                      device="cuda")), lr=3e-3)

            loss = control.make_ppo_loss()
        turns = _forms(torch, f"rl_{algo}", make_state, loss, [batch] * 8,
                       lambda zero=False: {}, {})
        forms = _form_summary(turns)
        emit({"phase": f"rl_{algo}_update", "forms": forms, "captured_match": CAPTURED_MATCH})
        _check_forms(f"rl_{algo}", turns)
    emit({"phase": "rl_seconds", "seconds": time.perf_counter() - t_phase})
    return {"rl_ab_lockstep": lock, **{f"{a}_twin": r for a, r in twin_rates.items()}}


# -- the actor-learner: overlapped actors and learner, replay, run_offline -----

#: the actor-learner at ``benchmarks/rl_benchmark.py``'s rollout length
#: (:239-241) with ``docs/replay.md``'s replay settings (:110-112)
AL_ROLLOUT = 32
AL_QUEUE = 4
AL_REPLAY = dict(capacity=200_000, ratio=2, batch=64)
#: seconds per timed turn, and the turns' arms
AL_TURN_S = 3.0
AL_ARMS = ("lockstep", "pipelined", "pipelined", "lockstep")
#: updates of the offline run over the buffer the live turns filled
AL_OFFLINE = 200
#: rounds of (on-policy step, replay step) in the captured-vs-eager check
AL_ROUNDS = 8


def _stage_p50(stages, name):
    return stages[name]["p50_ms"] if name in stages else None


def _al_segment(torch, buf, device):
    """The live run's last :data:`AL_ROLLOUT` env steps, read back from the
    buffer (appended step by step, env by env), as a time-major segment."""
    import numpy as np

    n = len(buf)
    rows = [buf.get(i) for i in range(n - AL_ROLLOUT * RL_INSTANCES, n)]

    def col(key):
        arr = np.stack([r[key] for r in rows])
        return torch.as_tensor(arr.reshape((AL_ROLLOUT, RL_INSTANCES) + arr.shape[1:]),
                               device=device)

    return {"obs": col("obs"), "actions": col("action"), "rewards": col("reward"),
            "dones": col("done")}


def actor_learner_phase(torch, btt, control, rl_rates):
    """The actor-learner on the card through its entry points:
    :data:`RL_INSTANCES` cartpole producers (the RL phase's settings) ->
    ``ActorLearner`` (one actor thread sampling on its own stream, the
    learner's on-policy and replay updates captured over one Adam, the
    replay tail at ratio 2) -> ``run`` for 3 untimed updates (each step's 2
    warm-ups and its capture), then timed turns lockstep against pipelined,
    then ``run_offline`` over the buffer the turns filled.  Checks: exact
    update counts, finite losses and params, the actor ran ahead, every env
    step appended once and none excluded, the pool healthy, the snapshot a
    separate copy, the card against the CPU on a live segment and a sampled
    replay batch, and the two steps alternated captured = eager bit for bit."""
    import numpy as np

    from blendjax_torch.models import policy
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.models.train import TrainState, make_train_step
    from blendjax_torch.replay import ReplayBuffer
    from blendjax_torch.utils.timing import EventCounters, StageTimer

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    t_phase = time.perf_counter()
    counters = EventCounters()
    buf = ReplayBuffer(AL_REPLAY["capacity"], seed=0, counters=EventCounters())

    def forces(a):
        return list((np.asarray(a) * 2 - 1) * control.FORCE_MAG)

    def run_checks(label, st, appended, updates=None):
        if updates is not None:
            check(st["updates"] == updates, f"al {label}: exactly {updates} updates")
        check(all(math.isfinite(v) for v in st["losses"] + st["replay_losses"]),
              f"al {label}: losses finite")
        check(st["env_steps"] > st["updates"] * AL_ROLLOUT * RL_INSTANCES,
              f"al {label}: the actor ran ahead of the learner")
        check(appended == st["env_steps"] and st["replay"]["excluded"] == 0,
              f"al {label}: every env step appended once, none excluded")

    with btt.launch_env_pool(scene="", script=str(control.SCRIPT),
                             num_instances=RL_INSTANCES, background=True,
                             start_port=_port_block(RL_INSTANCES), seed=0, real_time=False,
                             pipeline_depth=RL_DEPTH, counters=counters) as pool:
        al = ActorLearner(pool, 3, 2, rollout_len=AL_ROLLOUT, queue_size=AL_QUEUE,
                          action_map=forces, replay=buf, replay_ratio=AL_REPLAY["ratio"],
                          replay_batch=AL_REPLAY["batch"], device="cuda")
        steps = 0
        st = al.run(num_updates=3)
        steps += st["updates"] + st["replay_updates"]
        emit({"phase": "al_warmup", "updates": st["updates"],
              "replay_updates": st["replay_updates"], "env_steps": st["env_steps"],
              "elapsed_s": st["elapsed_s"], "graphs": [len(al._step.graphs),
                                                       len(al._replay_step.graphs)]})
        run_checks("warm-up", st, st["replay"]["appends"], updates=3)
        check(len(al._step.graphs) == 1 and len(al._replay_step.graphs) == 1,
              "al: each step captured one graph in the warm-up run")
        rates = {arm: [] for arm in AL_ARMS}
        for turn, arm in enumerate(AL_ARMS):
            al.pipeline = arm == "pipelined"
            buf.timer = StageTimer()
            appends = buf.stats()["appends"]
            st = al.run(seconds=AL_TURN_S)
            steps += st["updates"] + st["replay_updates"]
            stages, rstages = st["stages"], buf.timer.summary()
            rates[arm].append(st["env_steps_per_sec"])
            emit({"phase": "al_turn", "turn": turn, "arm": arm,
                  "env_steps_per_s": st["env_steps_per_sec"],
                  "updates_per_s": st["updates_per_sec"], "updates": st["updates"],
                  "replay_updates": st["replay_updates"], "env_steps": st["env_steps"],
                  "elapsed_s": st["elapsed_s"],
                  "policy_p50_ms": _stage_p50(stages, "policy"),
                  "env_step_p50_ms": _stage_p50(stages, "env_step"),
                  "segment_wait_s": stages["segment_wait"]["total_s"],
                  "segment_wait_p50_ms": _stage_p50(stages, "segment_wait"),
                  "update_p50_ms": _stage_p50(stages, "update"),
                  "replay_update_p50_ms": _stage_p50(stages, "replay_update"),
                  "replay_stages": {k: rstages[k] for k in
                                    ("replay_append", "sample_gather", "priority_update")
                                    if k in rstages}})
            run_checks(f"turn {turn}", st, buf.stats()["appends"] - appends)
        emit({"phase": "al_summary", "arms": rates,
              "lockstep_mean": statistics.mean(rates["lockstep"]),
              "pipelined_mean": statistics.mean(rates["pipelined"]),
              "pipelined_x": statistics.mean(rates["pipelined"])
              / statistics.mean(rates["lockstep"]),
              "without_learner": rl_rates})
        healthy = bool(pool.healthy.all())
        faults = counters.snapshot()
    check(healthy and not faults.get("quarantines"), "the actor-learner's pool stayed healthy")
    check(al.state.step == steps, "al: every on-policy and replay update stepped the state")
    check(all(bool(torch.isfinite(v).all()) for v in al.state.params.values()),
          "al: parameters finite")
    snap, _ = al._actor_params
    check(all(snap[k].data_ptr() != v.data_ptr() for k, v in al.state.params.items()),
          "al: the actors' snapshot shares no storage with the learner's params")

    # the card against the CPU on a live segment and a sampled replay batch
    seg = _al_segment(torch, buf, "cuda")
    data, _, w = buf.sample(AL_REPLAY["batch"], keys=("obs", "action", "reward"))
    rep = {k: torch.as_tensor(v, device="cuda") for k, v in
           (("obs", data["obs"]), ("action", data["action"]), ("reward", data["reward"]),
            ("is_weight", w))}
    diffs = {}
    for name, loss_fn, batch in (("segment", al.loss_fn, seg),
                                 ("replay", al.replay_loss_fn, rep)):
        sides = []
        for dev in ("cuda", "cpu"):
            params = {k: v.detach().to(dev) for k, v in al.state.params.items()}
            b = {k: v.to(dev) for k, v in batch.items()}
            sides.append(_grads(torch, lambda q, b=b, f=loss_fn: f(q, b), params))
        diffs[f"{name}_loss"] = _max_diff(torch, sides[0][0], sides[1][0])
        for k in sides[0][1]:
            diffs[f"{name}_grad.{k}"] = _max_diff(torch, sides[0][1][k], sides[1][1][k])
    emit({"phase": "al_reference", "atol": RL_ATOL, "max_abs_diff": diffs})
    check(all(d <= RL_ATOL for d in diffs.values()),
          f"al: the card equals the CPU within {RL_ATOL}")

    # the two steps alternated over one Adam, captured against eager
    turns, ref = [], None
    for turn, form in enumerate(FORMS):
        state = TrainState.create(policy.init(torch.Generator(device="cuda").manual_seed(1),
                                              3, 2, device="cuda"), lr=3e-3)
        on = make_train_step(al.loss_fn, capture=form == "captured")
        off = make_train_step(al.replay_loss_fn, capture=form == "captured")
        losses, times = [], {"on": [], "replay": []}
        for _ in range(AL_ROUNDS):
            for name, step, batch in (("on", on, seg), ("replay", off, rep)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, loss = step(state, batch)
                losses.append(float(loss))
                times[name].append((time.perf_counter() - t0) * 1e3)
        params = {k: v.detach().clone() for k, v in state.params.items()}
        if ref is None:
            ref = (losses, params)
        rec = {"phase": "al_update_turn", "turn": turn, "form": form, "losses": losses,
               "on_policy_ms": statistics.median(times["on"][3:]),
               "replay_ms": statistics.median(times["replay"][3:]),
               "graphs": [len(on.graphs), len(off.graphs)],
               "loss_max_abs_diff": max(abs(a - b) for a, b in zip(losses, ref[0])),
               "param_max_abs_diff": _max_param_diff(torch, params, ref[1])}
        emit(rec)
        turns.append(rec)
        check(all(math.isfinite(v) for v in losses), f"al {form} turn {turn}: losses finite")
        check(rec["graphs"] == ([1, 1] if form == "captured" else [0, 0]),
              f"al {form}: one graph for each step")
        check(rec["loss_max_abs_diff"] == 0 and rec["param_max_abs_diff"] == 0,
              f"al {form} turn {turn}: the alternated steps {CAPTURED_MATCH} to the first "
              "eager turn")

    buf.timer = StageTimer()
    off = al.run_offline(num_updates=AL_OFFLINE, batch_size=AL_REPLAY["batch"])
    stages = buf.timer.summary()
    emit({"phase": "al_offline", "updates": off["updates"],
          "updates_per_s": off["updates_per_sec"], "elapsed_s": off["elapsed_s"],
          "stages": {k: stages[k] for k in ("device_put", "recycle", "sample_gather",
                                             "priority_update", "arena_wait") if k in stages}})
    check(off["updates"] == AL_OFFLINE and all(math.isfinite(v) for v in off["losses"]),
          f"al: run_offline took exactly {AL_OFFLINE} finite updates")
    check(all(bool(torch.isfinite(v).all()) for v in al.state.params.values()),
          "al: parameters finite after run_offline")
    emit({"phase": "al_seconds", "seconds": time.perf_counter() - t_phase})
    return {arm: statistics.mean(v) for arm, v in rates.items()}

# -- ha: state and checkpoints on the card ----------------------------------------

#: resumed steps of each model: 4 before the cut, 4 after it on both timelines
HA_STEPS = 4
#: the cut cadence of the actor-learner's checkpointer, in completed updates
HA_EVERY = 2
#: ``benchmarks/ha_benchmark.py``'s ``measure_ckpt_overhead`` defaults:
#: interleaved run_offline windows (on, off / off, on), a wall-clock cadence
HA_OVERHEAD = dict(window_s=1.5, rounds=4, ckpt_every_s=1.0, batch=32, capacity=4096,
                   chunk=50)
#: the reference's targets for its CPU runs (``scripts/bench_compare.py``):
#: quoted beside the card's numbers, not held against them
HA_REFERENCE_TARGETS = {"ckpt_overhead_x_floor": 0.90, "learner_recovery_s_ceiling": 1.50}


def _adam_tensors(state):
    """Every parameter's Adam tensors, by name."""
    out = {}
    for name, p in state.params.items():
        for key, t in state.optimizer.state[p].items():
            out[f"{name}.{key}"] = t
    return out


def _resume_model(torch, label, make_state, loss, batches, counts, tmp):
    """One model's resume on the card: timeline A takes HA_STEPS captured
    steps, is saved (the barrier's host copy, timed with and without the
    pinned buffers' allocation, then ``CheckpointManager.save``) and takes
    HA_STEPS more; B, seeded differently, takes HA_STEPS + 1 steps
    (its graph captured), gets the cut restored in place, and takes the
    same HA_STEPS steps as A's second half.  Losses, parameters and Adam's
    tensors must be bit-equal, B's graph the one it captured before the
    restore, the file 3P + 2 leaves.  ``counts(zero=True)`` is zeroed just
    before B's resumed steps and read just after."""
    import numpy as np

    from blendjax_torch.models import convert
    from blendjax_torch.models.train import make_train_step
    from blendjax_torch.utils.checkpoint import CheckpointManager

    first, second = batches[:HA_STEPS], batches[HA_STEPS:2 * HA_STEPS]
    a, step_a = make_state(0), make_train_step(loss)
    for batch in first:
        a, _ = step_a(a, batch)
    mgr = CheckpointManager(os.path.join(tmp, label), max_to_keep=1)
    staging = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = convert.train_state_arrays(a, staging)  # waits for the copy
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    # a TrainCheckpointer's later cuts reuse its host buffers: the copy alone
    t0 = time.perf_counter()
    host = convert.train_state_arrays(a, staging)
    snapshot_reuse_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    path = mgr.save(HA_STEPS, host)
    serialize_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    with np.load(path) as data:
        leaves = len(data.files)
    del host, staging
    losses_a = []
    for batch in second:
        a, loss_a = step_a(a, batch)
        losses_a.append(float(loss_a))

    b, step_b = make_state(1), make_train_step(loss)
    for batch in batches[:HA_STEPS + 1]:
        b, _ = step_b(b, batch)
    graphs_before = list(step_b.graphs.values())
    ptrs = {k: v.data_ptr() for k, v in b.params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.restore(b, step=HA_STEPS)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    counts(zero=True)
    losses_b = []
    for batch in second:
        b, loss_b = step_b(b, batch)
        losses_b.append(float(loss_b))
    launched = counts()
    params = len(b.params)
    diffs = {"loss": max(abs(x - y) for x, y in zip(losses_a, losses_b)),
             "params": _max_param_diff(torch, b.params, a.params),
             "adam": _max_param_diff(torch, _adam_tensors(b), _adam_tensors(a))}
    rec = {"phase": "ha_resume", "card": CARD, "model": label, "params": params,
           "param_elements": sum(v.numel() for v in b.params.values()),
           "leaves": leaves, "bytes": nbytes, "ha_snapshot_ms": snapshot_ms,
           "ha_snapshot_reuse_ms": snapshot_reuse_ms,
           "ha_serialize_s": serialize_s, "ha_restore_s": restore_s,
           "losses_uninterrupted": losses_a, "losses_resumed": losses_b,
           "max_abs_diff": diffs, "graphs": len(step_b.graphs),
           "same_graph": len(step_b.graphs) == 1
           and next(iter(step_b.graphs.values())) is graphs_before[0],
           "launches": launched}
    emit(rec)
    shutil.rmtree(os.path.join(tmp, label), ignore_errors=True)
    check(all(math.isfinite(v) for v in losses_b), f"ha_resume {label}: losses finite")
    check(leaves == 3 * params + 2, f"ha_resume {label}: the file holds 3P + 2 leaves")
    check(diffs == {"loss": 0, "params": 0, "adam": 0},
          f"ha_resume {label}: the resumed steps' losses, parameters and Adam tensors "
          "are bit-equal to the uninterrupted timeline")
    check(rec["same_graph"] and len(graphs_before) == 1,
          f"ha_resume {label}: the restore kept the captured graph (no new capture)")
    check({k: v.data_ptr() for k, v in b.params.items()} == ptrs,
          f"ha_resume {label}: the restore wrote into the parameters in place")
    del a, b, step_a, step_b
    torch.cuda.empty_cache()
    return rec


def _ckpt_overhead(torch, tmp):
    """``benchmarks/ha_benchmark.py::measure_ckpt_overhead`` on the card:
    twin fleet-less learners, one with a TrainCheckpointer on a wall-clock
    cadence, ``run_offline`` windows interleaved (order rotated each
    round), the median of the rounds' on/off ratios."""
    import numpy as np

    from blendjax_torch.ha import TrainCheckpointer
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.replay import ReplayBuffer
    from blendjax_torch.utils.timing import EventCounters

    o = HA_OVERHEAD
    counters = EventCounters()
    ck = TrainCheckpointer(os.path.join(tmp, "overhead"), every_updates=10 ** 9,
                           every_seconds=o["ckpt_every_s"], counters=counters, stats_path=None)
    learners = {}
    for arm, c in (("on", ck), ("off", None)):
        buf = ReplayBuffer(o["capacity"], seed=0, counters=EventCounters())
        rng = np.random.default_rng(0)
        for _ in range(min(o["capacity"], 2048)):
            buf.append({"obs": rng.standard_normal(4).astype(np.float32),
                        "action": np.int32(rng.integers(0, 3)),
                        "reward": np.float32(rng.standard_normal()),
                        "next_obs": rng.standard_normal(4).astype(np.float32),
                        "done": np.bool_(False)})
        learners[arm] = ActorLearner(None, 4, 3, replay=buf, seed=0, checkpointer=c,
                                     device="cuda")
    for al in learners.values():  # warm-ups and captures
        al.run_offline(num_updates=8, batch_size=o["batch"])

    def window(arm):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < o["window_s"]:
            learners[arm].run_offline(num_updates=o["chunk"], batch_size=o["batch"])
            n += o["chunk"]
        return n / (time.perf_counter() - t0)

    rates, ratios = {"on": [], "off": []}, []
    for r in range(o["rounds"]):
        pair = {}
        for arm in (("on", "off") if r % 2 == 0 else ("off", "on")):
            pair[arm] = window(arm)
            rates[arm].append(pair[arm])
        ratios.append(pair["on"] / pair["off"])
    ck.join(timeout=30)
    stages = ck.timer.summary()
    return {"ckpt_overhead_x": statistics.median(ratios), "pair_ratios": ratios,
            "ckpt_on_updates_per_sec": statistics.median(rates["on"]),
            "ckpt_off_updates_per_sec": statistics.median(rates["off"]),
            "ckpt_saves": counters.get("ha_ckpt_saves"),
            "ckpt_skipped": counters.get("ha_ckpt_skipped"),
            "ha_snapshot_p50_ms": _stage_p50(stages, "ha_snapshot"),
            "ha_serialize_p50_ms": _stage_p50(stages, "ha_serialize")}


def _ha_al(torch, btt, control, tmp):
    """The actor-learner with its checkpointer on the card: the al phase's
    fleet and settings, a cut every HA_EVERY updates; then a forced cut, and
    the cut's replay and train state restored into a fresh learner on the
    card: the same 4 draws as the no-crash buffer, parameters and Adam's
    tensors bit-equal; then ``ckpt_overhead_x``."""
    import numpy as np

    from blendjax_torch.ha import TrainCheckpointer, latest_manifest, restore_replay
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.replay import ReplayBuffer
    from blendjax_torch.utils.timing import EventCounters

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    directory = os.path.join(tmp, "al")
    counters = EventCounters()
    ck = TrainCheckpointer(directory, every_updates=HA_EVERY, counters=counters)
    buf = ReplayBuffer(AL_REPLAY["capacity"], seed=0, counters=EventCounters())

    def forces(a):
        return list((np.asarray(a) * 2 - 1) * control.FORCE_MAG)

    with btt.launch_env_pool(scene="", script=str(control.SCRIPT),
                             num_instances=RL_INSTANCES, background=True,
                             start_port=_port_block(RL_INSTANCES), seed=0, real_time=False,
                             pipeline_depth=RL_DEPTH, counters=EventCounters()) as pool:
        al = ActorLearner(pool, 3, 2, rollout_len=AL_ROLLOUT, queue_size=AL_QUEUE,
                          action_map=forces, replay=buf, replay_ratio=AL_REPLAY["ratio"],
                          replay_batch=AL_REPLAY["batch"], checkpointer=ck, device="cuda")
        st = al.run(num_updates=8)
    ck.join(timeout=60)
    saves = counters.get("ha_ckpt_saves")
    cut = ck.checkpoint(al, block=True)
    man = latest_manifest(directory)
    seq_no_crash = [buf.sample(AL_REPLAY["batch"])[1].tolist() for _ in range(4)]

    t0 = time.perf_counter()
    buf2 = restore_replay(man, counters=EventCounters())
    fresh = ActorLearner(None, 3, 2, replay=buf2, replay_ratio=0,
                         replay_batch=AL_REPLAY["batch"], seed=7, device="cuda")
    TrainCheckpointer(directory, counters=EventCounters()).restore(fresh, man)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    seq_restored = [buf2.sample(AL_REPLAY["batch"])[1].tolist() for _ in range(4)]
    diffs = {"params": _max_param_diff(torch, fresh.state.params, al.state.params),
             "adam": _max_param_diff(torch, _adam_tensors(fresh.state),
                                     _adam_tensors(al.state))}
    stages = ck.timer.summary()
    over = _ckpt_overhead(torch, tmp)
    rec = {"phase": "ha_al", "card": CARD, "updates": st["updates"],
           "replay_updates": st["replay_updates"], "updates_done": al._updates_done,
           "ckpt_saves_in_run": saves, "ckpt_skipped": counters.get("ha_ckpt_skipped"),
           "forced_cut": cut, "manifest_update": man["update"],
           "replay_rows": len(buf), "ckpt_bytes": counters.get("ha_ckpt_bytes"),
           "ha_snapshot_p50_ms": _stage_p50(stages, "ha_snapshot"),
           "ha_snapshot_max_ms": stages["ha_snapshot"]["max_ms"],
           "ha_serialize_p50_ms": _stage_p50(stages, "ha_serialize"),
           "ha_restore_s": restore_s, "draws_equal": seq_restored == seq_no_crash,
           "max_abs_diff": diffs, **over,
           "reference_targets": HA_REFERENCE_TARGETS,
           "reference_targets_note": "the reference's targets come from CPU runs"}
    emit(rec)
    check(st["updates"] == 8 and saves >= 1, "ha_al: the run's cuts were committed")
    check(cut == al._updates_done == man["update"], "ha_al: the forced cut committed")
    check(rec["draws_equal"], "ha_al: the restored replay draws the no-crash stream")
    check(diffs == {"params": 0, "adam": 0},
          "ha_al: the restored learner's parameters and Adam tensors are bit-equal")
    check(fresh._updates_done == cut, "ha_al: the update counter resumed from the cut")
    check(over["ckpt_saves"] >= 1 and math.isfinite(over["ckpt_overhead_x"]),
          "ha_al: the overhead windows checkpointed")
    return rec


def _ha_drill(torch, control, tmp):
    """The kill/respawn drill on the card: two cartpole producers under the
    fake Blender feed a ``LearnerProcess`` (child on the card) under a
    ``LearnerSupervisor``; SIGKILL the child after its first cut; the
    respawn resumes.  ``learner_recovery_s`` as ``ha_benchmark.py``'s
    ``measure_recovery`` defines it (the kill to the first mirror showing a
    new pid past the pre-kill update count), split by the child's own boot
    times."""
    import signal

    from blendjax_torch.btt.env import kwargs_to_cli
    from blendjax_torch.btt.launcher import BlenderLauncher
    from blendjax_torch.ha import LearnerProcess, LearnerSupervisor
    from blendjax_torch.utils.timing import EventCounters

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    counters = EventCounters()

    def await_stats(lp, cond, timeout, what):
        deadline = time.monotonic() + timeout
        while True:
            s = lp.read_stats() or {}
            if cond(s):
                return s, time.time()
            check(time.monotonic() < deadline, f"ha_drill: {what} within {timeout} s ({s})")
            time.sleep(0.02)

    with BlenderLauncher(scene="", script=str(control.SCRIPT), num_instances=2,
                         named_sockets=["GYM"], background=True, start_port=_port_block(2),
                         seed=0, instance_args=[kwargs_to_cli({"real_time": False})] * 2) as bl:
        with LearnerProcess(ckpt_dir=os.path.join(tmp, "drill"),
                            env_addresses=bl.launch_info.addresses["GYM"], obs_dim=3,
                            num_actions=2, rollout_len=8, seed=1, ckpt_every=2,
                            chunk_updates=2, device="cuda", ready_timeout=120,
                            action_values=[-control.FORCE_MAG, control.FORCE_MAG]) as lp:
            with LearnerSupervisor(lp, interval=0.2, counters=counters,
                                   postmortem_dir=os.path.join(tmp, "pm")) as sup:
                first = lp.read_stats()
                pre, _ = await_stats(lp, lambda s: s.get("updates", 0) >= 3
                                     and s.get("last_ckpt_update", 0) >= 2, 120,
                                     "warm-up and the first cut")
                kill_ts = time.time()
                t_kill = time.monotonic()
                os.kill(lp.launch_info.processes[0].pid, signal.SIGKILL)
                # past the resume point too: a cut taken after ``pre`` was
                # read resumes the child beyond ``pre["updates"]`` already
                post, end_ts = await_stats(
                    lp, lambda s: s.get("pid") not in (None, pre["pid"])
                    and s.get("updates", 0) > max(pre["updates"], s.get("resumed_from") or 0),
                    120, "post-respawn progress")
                recovery_s = time.monotonic() - t_kill
                check(sup.await_deaths(1, 10) and sup.await_respawns(1, 10),
                      "ha_drill: the death and the respawn were counted")
    boot = post["boot"]
    split = {"detect_respawn_s": boot["boot_ts"] - kill_ts,
             "import_s": boot["import_s"], "cuda_init_s": boot["device_init_s"],
             "build_s": boot["build_s"], "restore_s": boot["restore_s"],
             "ready_to_first_update_s": post["first_update_ts"] - boot["ready_ts"],
             "first_update_to_recovered_s": end_ts - post["first_update_ts"]}
    doc = json.loads(open(sup.last_postmortem).read())
    rec = {"phase": "ha_drill", "card": CARD, "learner_recovery_s": recovery_s,
           "split": split, "first_boot": first.get("boot"),
           "prekill_updates": pre["updates"], "prekill_last_cut": pre["last_ckpt_update"],
           "resumed_from": post.get("resumed_from"), "postkill_updates": post["updates"],
           "deaths": counters.get("ha_learner_deaths"),
           "respawns": counters.get("ha_learner_respawns"),
           "postmortem_target": doc["extra"]["target"],
           "reference_targets": HA_REFERENCE_TARGETS,
           "reference_targets_note": "the reference's targets come from CPU runs"}
    emit(rec)
    check(rec["deaths"] == 1 and rec["respawns"] == 1, "ha_drill: one death, one respawn")
    check(rec["resumed_from"] >= pre["last_ckpt_update"] >= 2,
          "ha_drill: the respawn resumed from a real cut")
    check(post["updates"] > pre["updates"], "ha_drill: updates went past the pre-kill count")
    check(doc["extra"]["target"] == "learner", "ha_drill: the postmortem names the learner")
    return rec


def ha_phase(torch, btt, control, datagen, image, seqformer, flash, worldmodel, pendulum):
    """State and checkpoints on the card: ``ha_resume`` (the full-width
    detector through K1 and the flagship SeqFormer through K2-K4, resumed
    in place with their graphs), ``ha_al`` and ``ha_drill``.  Returns the
    kernels' launches in the resumed steps, and the flash kernels' by
    route (``flash_routes``)."""
    import functools
    import tempfile

    import numpy as np

    from blendjax_torch.models.train import TrainState

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="bjx-ha-")
    launches = {}
    try:
        dg = torch.Generator(device="cuda").manual_seed(1)
        target = torch.rand((MAIN_SHAPE[0], 8, 2), generator=dg, device="cuda")
        det_batches = [{"image": torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8,
                                               device="cuda", generator=dg),
                        "xy": target} for _ in range(2 * HA_STEPS)]

        def det_counts(zero=False):
            if zero:
                image.decode_frames_cuda.launches = 0
            return {"decode_u8": image.decode_frames_cuda.launches}

        det = _resume_model(
            torch, "detector",
            lambda seed: datagen.make_state(torch.Generator(device="cuda").manual_seed(seed)),
            datagen.make_loss(), det_batches, det_counts, tmp)
        check(det["launches"]["decode_u8"] == HA_STEPS,
              "ha_resume detector: one decode_u8 launch per resumed step")
        launches.update(det["launches"])
        del det_batches

        cfg = {k: SEQ[k] for k in ("obs_dim", "d_model", "n_heads", "n_layers")}
        rng = np.random.default_rng(3)
        seq_batches = [_episodes(torch, pendulum, rng, SEQ["batch"]) for _ in range(2 * HA_STEPS)]

        routes = {}

        def seq_counts(zero=False):
            if zero:
                _zero_flash_counts(flash)
            routes.update(_route_counts(flash))
            return {n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS}

        seq = _resume_model(
            torch, "seqformer",
            lambda seed: TrainState.create(seqformer.init(
                torch.Generator(device="cuda").manual_seed(seed), max_len=SEQ["seq_len"],
                device="cuda", **cfg), lr=SEQ["lr"]),
            functools.partial(seqformer.episode_loss_fn,
                              attn_fn=worldmodel.make_attn("flash", SEQ["seq_len"])),
            seq_batches, seq_counts, tmp)
        check(all(n == SEQ["n_layers"] * HA_STEPS for n in seq["launches"].values()),
              "ha_resume seqformer: one launch of each flash kernel per layer and resumed step")
        launches.update(seq["launches"])
        launches["flash_routes"] = dict(routes)
        del seq_batches

        al = _ha_al(torch, btt, control, tmp)
        drill = _ha_drill(torch, control, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "ha", "card": CARD,
          "resume": {r["model"]: {k: r[k] for k in ("bytes", "ha_snapshot_ms",
                                                    "ha_snapshot_reuse_ms",
                                                    "ha_serialize_s", "ha_restore_s")}
                     for r in (det, seq)},
          "ckpt_overhead_x": al["ckpt_overhead_x"],
          "learner_recovery_s": drill["learner_recovery_s"], "recovery_split": drill["split"],
          "seconds": time.perf_counter() - t_phase})
    return launches


# -- densityopt: the duplex channel, the discriminator, the ProbModel -----------

#: ``examples/densityopt/densityopt.py``'s defaults (:133-168, :70-81): 4
#: supershape producers, batch 8, 32 real frames at the hidden target (5, 5),
#: discriminator widths (32, 64, 128) in bf16, Adam at 2e-4 and 5e-2
DO_INSTANCES = 4
DO_BATCH = 8
DO_TARGET = (5.0, 5.0)
#: iterations of the loop; the example runs 100
DO_ITERATIONS = 20
#: stale frames read off full queues to time the join's read rate (the
#: queues hold ~130 frames of 49 KB per producer: 10 at each socket's HWM,
#: the rest in the TCP buffers)
DO_DRAIN = 300
#: one step of each on the card against the CPU, from the same parameters
#: and inputs, at f32 compute (TF32 off, see main): the RL phases' limit.
#: Adam's first step moves a parameter by lr * g / (|g| + eps), so where
#: |g| is near eps (1e-8) a gradient difference of 1e-9 moves it by ~5e-6
DO_ATOL = {"d_loss": 1e-5, "d_params": 1e-5, "scores": 1e-5, "p_loss": 1e-5,
           "p_params": 1e-5}


def _do_replays(torch, densityopt, real, frames, samples, live):
    """The live run's loop again over its own frames and samples, the steps
    eager and captured in :data:`FORMS` turns, each from the same initial
    parameters; every turn's history and final parameters must equal the
    first eager turn's bit for bit, and the live (captured) run's history
    too.  Emits one line per turn."""
    from blendjax_torch.models import discriminator
    from blendjax_torch.models.train import WARMUP_STEPS
    from blendjax_torch.utils.timing import StageTimer

    turns, ref = [], None
    for turn, form in enumerate(FORMS):
        d0 = discriminator.init(torch.Generator(device="cuda").manual_seed(1),
                                in_channels=3, device="cuda")
        steps = densityopt.make_steps(capture=form == "captured")
        frames_it, samples_it, last, times = iter(frames), iter(samples), {}, []

        def keep(rec):
            last.update(rec)
            times.append(rec["stages_ms"])

        _, history = densityopt.optimize(
            lambda p: next(frames_it), real, iterations=len(frames), batch_size=DO_BATCH,
            log_every=0, device="cuda", d_params=d0,
            draw=lambda p, n: torch.from_numpy(next(samples_it)).cuda(), steps=steps,
            timer=StageTimer(), on_iteration=keep)
        params = {**{f"d.{k}": v.detach().clone() for k, v in last["d_state"].params.items()},
                  **{f"p.{k}": v.detach().clone() for k, v in last["p_state"].params.items()}}
        flat = [v for h in history for v in (h[0], h[1], *h[2].tolist())]
        if ref is None:
            ref = (flat, params)
        rec = {"phase": "densityopt_turn", "turn": turn, "form": form,
               # after each step's warm-ups and capture
               "p50_ms": {k: statistics.median(t[k] for t in times[WARMUP_STEPS + 1:])
                          for k in ("decode", "d_step", "scores", "p_step")},
               "graphs": [len(st.graphs) for st in steps],
               "history_max_abs_diff": max(abs(a - b) for a, b in zip(flat, ref[0])),
               "param_max_abs_diff": _max_param_diff(torch, params, ref[1])}
        emit(rec)
        turns.append(rec)
        check(rec["graphs"] == ([1, 1, 1] if form == "captured" else [0, 0, 0]),
              f"densityopt {form}: one graph for each of d_step, p_step and scores")
        check(rec["history_max_abs_diff"] == 0 and rec["param_max_abs_diff"] == 0,
              f"densityopt {form} turn {turn}: history and parameters {CAPTURED_MATCH} to "
              "the first eager turn")
    live_flat = [v for h in live for v in (h[0], h[1], *h[2].tolist())]
    check(live_flat == ref[0], "the live run's history (captured) equals the eager replay's "
          "bit for bit")
    return turns


def _do_vs_cpu(torch, densityopt, d_params, pm_params, real, fake, samples, baseline):
    """The scores, one discriminator step and one ProbModel step on the card
    and on the CPU from the same parameters and inputs (fresh Adam state
    each; the ProbModel step takes the card's scores on both sides), at f32
    compute: the max abs differences of the losses, the scores and the
    updated parameters."""
    from blendjax_torch.models.train import TrainState

    sides, sim = {}, None
    for dev in ("cuda", "cpu"):
        d_step, p_step, scores = densityopt.make_steps(torch.float32, capture=False)
        d = TrainState.create({k: v.detach().to(dev).clone() for k, v in d_params.items()},
                              lr=2e-4)
        p = TrainState.create({k: v.detach().to(dev).clone() for k, v in pm_params.items()},
                              lr=5e-2)
        scored = scores(d.params, {"fake": fake.to(dev)})
        sim = scored if sim is None else sim  # the card's scores feed both ProbModel steps
        d, d_loss = d_step(d, {"real": real.to(dev), "fake": fake.to(dev)})
        p, p_loss = p_step(p, {"samples": samples.to(dev), "losses": sim.to(dev),
                               "baseline": baseline.to(dev)})
        sides[dev] = (d_loss, d.params, scored, p_loss, p.params)
    (dl, dp, ds, pl, pp), (cdl, cdp, cds, cpl, cpp) = sides["cuda"], sides["cpu"]
    return {"d_loss": _max_diff(torch, dl, cdl),
            "d_params": max(_max_diff(torch, dp[k], cdp[k]) for k in dp),
            "scores": _max_diff(torch, ds, cds),
            "p_loss": _max_diff(torch, pl, cpl),
            "p_params": max(_max_diff(torch, pp[k], cpp[k]) for k in pp)}


def densityopt_phase(torch, btt, image):
    """Densityopt on the card through its entry points:
    :data:`DO_INSTANCES` ``btb/supershape.blend.py`` producers under the fake
    Blender (``BLENDJAX_FAKE_BPY=1``) started by ``BlenderLauncher``
    (``DATA`` and ``CTRL`` sockets) -> ``RemoteIterableDataset`` + one
    ``btt.DuplexChannel`` per producer -> ``make_blender_renderer`` renders
    the 32 real frames at the target, then ``densityopt.optimize`` runs
    :data:`DO_ITERATIONS` iterations at the example's settings: each samples
    8 parameter pairs on the card, renders them through the fleet (sends,
    then the join by shape id, stale frames skipped), decodes the batch with
    K1, and replays the captured discriminator step, scores and ProbModel
    step.  The decode kernel's count is zeroed just before ``optimize`` and
    read just after.  Per iteration the stages' p50 (each synchronised at
    its end), the stale frames, iterations/s and renders/s.  Then the
    loop again over the recorded frames and samples, eager against captured
    (:func:`_do_replays`), and one step of each on the card against the CPU
    (:func:`_do_vs_cpu`)."""
    import numpy as np

    from blendjax_torch import densityopt
    from blendjax_torch.models.train import WARMUP_STEPS
    from blendjax_torch.utils.timing import StageTimer

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    t_phase = time.perf_counter()
    timer, iters, frames, samples, last = StageTimer(), [], [], [], {}
    steps = densityopt.make_steps()
    with btt.BlenderLauncher(scene="", script=str(densityopt.SCRIPT),
                             num_instances=DO_INSTANCES, named_sockets=["DATA", "CTRL"],
                             start_port=_port_block(2 * DO_INSTANCES), background=True,
                             seed=0) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=10**9,
                                       timeoutms=30000)
        duplexes = [btt.DuplexChannel(addr, btid=i)
                    for i, addr in enumerate(bl.launch_info.addresses["CTRL"])]
        try:
            stream = iter(ds)
            render = densityopt.make_blender_renderer(duplexes, stream, DO_BATCH)
            t0 = time.perf_counter()
            real = render(np.tile(DO_TARGET, (DO_BATCH * 4, 1)))
            real_s, real_stale = time.perf_counter() - t0, render.stale

            def recording(params):
                out = render(params)
                frames.append(out)
                recording.stale = render.stale
                return out

            recording.stale = render.stale

            def on_iteration(rec):
                samples.append(rec["samples"])
                last.update(rec)
                iters.append({k: rec[k] for k in ("iteration", "ms", "stages_ms", "stale",
                                                  "d_loss", "sim_loss_mean", "baseline")}
                             | {"pm_mean": rec["pm_mean"].tolist()})
                emit({"phase": "densityopt_iteration", **iters[-1]})

            image.decode_frames_cuda.launches = 0
            t0 = time.perf_counter()
            pm_params, history = densityopt.optimize(
                recording, real, iterations=DO_ITERATIONS, batch_size=DO_BATCH, log_every=0,
                device="cuda", steps=steps, timer=timer, on_iteration=on_iteration)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            launches = image.decode_frames_cuda.launches
            # the join's own read rate: once the producers have filled their
            # queues, frames taken off the stream with no request outstanding
            # (every one stale), fewer than the queues hold
            time.sleep(1.0)
            t0 = time.perf_counter()
            for _ in range(DO_DRAIN):
                next(stream)
            drain_per_s = DO_DRAIN / (time.perf_counter() - t0)
        finally:
            for d in duplexes:
                d.close()
    after = iters[WARMUP_STEPS + 1:]  # the iterations after each step's capture
    rec = {"phase": "densityopt", "instances": DO_INSTANCES, "batch": DO_BATCH,
           "iterations": DO_ITERATIONS, "target": DO_TARGET, "real_frames": len(real),
           "real_render_s": real_s, "real_stale": real_stale,
           "iterations_per_s": len(iters) / elapsed,
           "iterations_per_s_after_capture": len(after) * 1e3 / sum(r["ms"] for r in after),
           "renders_per_s": DO_BATCH * len(iters) / elapsed,
           "frames_received_per_s": (DO_BATCH * len(iters) + sum(r["stale"] for r in iters))
           / timer.summary()["render"]["total_s"],
           "drain_frames_per_s": drain_per_s,
           "p50_ms": {k: statistics.median(r["stages_ms"][k] for r in iters)
                      for k in densityopt.STAGES},
           "p50_ms_after_capture": {k: statistics.median(r["stages_ms"][k] for r in after)
                                    for k in densityopt.STAGES},
           "stale_p50": statistics.median(r["stale"] for r in iters),
           "iteration_p50_ms": statistics.median(r["ms"] for r in iters),
           "launches": {"decode_u8": launches},
           "graphs": [len(st.graphs) for st in steps],
           "first": iters[0], "last": iters[-1]}
    emit(rec)
    check(len(history) == DO_ITERATIONS and all(
        math.isfinite(d) and math.isfinite(sl) and np.isfinite(m).all() for d, sl, m in history),
        "densityopt history finite")
    check(all(bool(torch.isfinite(v).all()) for v in last["d_state"].params.values())
          and all(bool(torch.isfinite(v).all()) for v in pm_params.values()),
          "densityopt parameters finite")
    check(len(real) == 4 * DO_BATCH and real.shape[1:] == (128, 128, 3)
          and real.dtype == np.uint8, "densityopt real frames: 32 of 128x128x3 uint8")
    check(launches == DO_ITERATIONS + 1,
          "densityopt launched decode_u8 once for the real frames and once an iteration")
    check(rec["graphs"] == [1, 1, 1], "densityopt: each step captured one graph")

    real_dev = image.decode_frames(torch.from_numpy(real).cuda())
    turns = _do_replays(torch, densityopt, real, frames, samples, history)
    summary = {}
    for form in ("eager", "captured"):
        rs = [r for r in turns if r["form"] == form]
        summary[form] = {k: [r["p50_ms"][k] for r in rs] for k in rs[0]["p50_ms"]}
    emit({"phase": "densityopt_forms", "p50_ms_by_turn": summary,
          "captured_match": CAPTURED_MATCH})

    fake = image.decode_frames(torch.from_numpy(frames[-1]).cuda())
    diffs = _do_vs_cpu(torch, densityopt, last["d_state"].params, pm_params, real_dev, fake,
                       torch.from_numpy(samples[-1]),
                       torch.tensor(last["baseline"], dtype=torch.float32))
    emit({"phase": "densityopt_reference", "compute": "float32", "atol": DO_ATOL,
          "max_abs_diff": diffs})
    check(all(diffs[k] <= lim for k, lim in DO_ATOL.items()),
          "densityopt: one step of each on the card equals the CPU within the limits")
    emit({"phase": "densityopt_seconds", "seconds": time.perf_counter() - t_phase})
    return launches



# -- serving: int8 products, the policy server, dreaming, int8 inference -------

#: the flagship SeqFormer served (benchmarks/suite_device.py's widths, rope as
#: benchmarks/serve_benchmark.py builds the served model): 16 slots, a
#: 512-step ring; 8 clients, 32-step episodes, each client's first admitted
#: with a 16-step prefix
SERVE = dict(obs_dim=32, d_model=1024, n_heads=8, n_layers=8, slots=16, length=512,
             clients=8, episode_len=32, prefix=16, window_s=3.0, rounds=2)
#: serve_benchmark.py's own width, a short window: the launch-bound case
SERVE_SMALL = dict(obs_dim=8, d_model=64, n_heads=4, n_layers=2, slots=16, length=64,
                   clients=8, episode_len=32, prefix=16, window_s=1.0, rounds=1)
SERVE_MODES = ("batched", "serial", "int8")
#: the dream: batch 8, a 64-step prefix, 448 dreamed steps (T = 512 in all)
DREAM = dict(batch=8, prefix=64, steps=448)
#: card against CPU on small models (f32); int8 keypoints after K1
SERVE_ATOL = 1e-5
INFER_INT8_ATOL = 1e-3
#: the int8 layer walk's limits (``_int8_layer_walk``): the two devices'
#: activation scales for the same float input, relative; the float epilogue
#: on the same int32 accumulator; a differing int8 activation is a rounding
#: tie when it lies this close to its boundary, in quantization steps
INT8_SCALE_RTOL = 1e-6
INT8_EPILOGUE_ATOL = 1e-5
INT8_TIE_STEPS = 1e-4
#: the CPU's own chain, its ties resolved the card's way, against the card's
#: keypoints
INT8_CHAIN_ATOL = 1e-5


def _stamp(rec):
    """A record with the card's name and power limit beside its numbers."""
    return {**rec, "card": CARD}


def quant_phase(torch, quant, layers):
    """The int8 products (``torch._int_mm``, the weights laid out as the
    quantizers store them) on the card against the CPU's int64 products,
    exactly, at the flagship's projection shapes and the detector's three
    convs on (8, 480, 640, 3); each timed beside its f32 counterpart (TF32
    off)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cpu").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    d, ff = SEQ["d_model"], 4 * SEQ["d_model"]
    rows = []
    for m in (1, 8, 16):
        for k, n in ((d, d), (d, ff), (ff, d)):
            a = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
            # the weight as the quantizer stores it (column-major)
            b = quant.quantize_dense({"w": torch.randn((k, n), generator=g),
                                      "b": torch.zeros(n)})["w_q"]
            got = quant.int8_matmul(a.cuda(), b.cuda())
            check(got.dtype == torch.int32 and torch.equal(got.cpu().long(), a.long() @ b.long()),
                  f"int8 product ({m}, {k}) x ({k}, {n}) on the card == the CPU's int64")
            ac, bc = a.cuda(), b.cuda()
            af, bf = ac.float(), bc.float()
            rows.append({"shape": [m, k, n], "exact": True,
                         "int8_ms": time_ms(torch, lambda: quant.int8_matmul(ac, bc),
                                            flush=flush),
                         "f32_ms": time_ms(torch, lambda: af @ bf, flush=flush)})
    n, h, w = MAIN_SHAPE[:3]
    channels = (3, 32, 64, 128)
    for i in range(3):
        c_in, c_out = channels[i], channels[i + 1]
        hi, wi = h >> i, w >> i
        x = torch.randint(-127, 128, (n, hi, wi, c_in), dtype=torch.int8, generator=g)
        wq = quant.quantize_conv({"w": torch.randn((c_out, c_in, 3, 3), generator=g),
                                  "b": torch.zeros(c_out)})["w_q"]
        got = quant.conv_accumulate(x.cuda(), wq.cuda(), stride=2)
        # the CPU's reference: the same SAME conv in float64 (exact: every
        # partial sum of int8 products is an integer below 2**53)
        h0, h1 = layers.same_padding(hi, 3, 2)
        w0, w1 = layers.same_padding(wi, 3, 2)
        xp = F.pad(x.double().permute(0, 3, 1, 2), (w0, w1, h0, h1))
        want = F.conv2d(xp, wq.double(), stride=2).permute(0, 2, 3, 1).long()
        check(got.dtype == torch.int32 and torch.equal(got.cpu().long(), want),
              f"int8 conv {i} ({n}, {hi}, {wi}, {c_in}) -> {c_out} on the card == the CPU's")
        xc, wc = x.cuda(), wq.cuda()
        pf = {"w": wc.float(), "b": torch.zeros(c_out, device="cuda")}
        xf = xc.float()
        rows.append({"conv": i, "input": [n, hi, wi, c_in], "c_out": c_out, "exact": True,
                     "int8_ms": time_ms(torch, lambda: quant.conv_accumulate(xc, wc, 2),
                                        reps=20, flush=flush),
                     "f32_ms": time_ms(torch, lambda: layers.conv_apply(pf, xf, stride=2),
                                       reps=20, flush=flush)})
    emit(_stamp({"phase": "quant", "products": rows}))


def _serve_params(torch, seqformer, cfg, device="cuda", seed=0):
    return seqformer.init(torch.Generator(device=device).manual_seed(seed),
                          obs_dim=cfg["obs_dim"], d_model=cfg["d_model"],
                          n_heads=cfg["n_heads"], n_layers=cfg["n_layers"],
                          pos_encoding="rope", device=device)


def _ticks(np, cfg, model, n_ticks, seed):
    """Seeded ticks ``(idx, obs)`` over every bucket up to the slots: each
    tick's rows are distinct live slots, padded onto the pad row."""
    rng = np.random.default_rng(seed)
    out = []
    sizes = [b for b in (1, 2, 4, 8, 16) if b <= cfg["slots"]]
    for t in range(n_ticks):
        bucket = sizes[t % len(sizes)]
        live = rng.choice(cfg["slots"], size=int(rng.integers(1, bucket + 1)), replace=False)
        idx = np.full(bucket, model.pad_slot, np.int64)
        idx[:len(live)] = live
        obs = np.zeros((bucket, cfg["obs_dim"]), np.float32)
        obs[:len(live)] = rng.standard_normal((len(live), cfg["obs_dim"]))
        out.append((idx, obs, len(live)))
    return out


def _captured_vs_eager(torch, np, serve, params, cfg, int8):
    """Captured ticks bit-equal to eager ones over the same seeded ticks,
    every bucket, at ``int8``'s precision; returns the captured model and
    the buckets held."""
    what = "int8" if int8 else "f32"
    eager = serve.SeqFormerModel(params, cfg["slots"], cfg["length"], int8=int8,
                                 capture=False)
    captured = serve.SeqFormerModel(params, cfg["slots"], cfg["length"], int8=int8)
    check(captured.captured, f"the served {what} SeqFormer captures its ticks on the card")
    for idx, obs, _ in _ticks(np, cfg, eager, 20, seed=1):
        a, b = eager.step_rows(idx, obs), captured.step_rows(idx, obs)
        check(np.array_equal(a, b),
              f"captured {what} tick (bucket {len(idx)}) == eager, bit for bit")
    check(all(torch.equal(x, y) for x, y in zip(eager._cache["k"] + eager._cache["v"],
                                               captured._cache["k"] + captured._cache["v"]))
          and torch.equal(eager._cache["pos"], captured._cache["pos"]),
          f"the captured {what} ticks left the caches as the eager ones")
    return captured, sorted({sig[1][1][0] for sig in captured.graphs.graphs})


def _serve_checks(torch, np, seqformer, serve, cfg):
    """Captured ticks bit-equal to eager ones, every bucket, float and int8;
    batched per-row decode against each episode alone (scalar position);
    the card against the CPU on a small model, float and int8.  Returns the
    captured float model for timing."""
    params = _serve_params(torch, seqformer, cfg)
    buckets = {}
    _, buckets["int8"] = _captured_vs_eager(torch, np, serve, params, cfg, int8=True)
    captured, buckets["f32"] = _captured_vs_eager(torch, np, serve, params, cfg, int8=False)
    # batched per-row decode == each episode decoded alone, on the card
    rng = np.random.default_rng(2)
    lengths = (7, 3, 5, 1)
    episodes = [rng.standard_normal((t, cfg["obs_dim"])).astype(np.float32) for t in lengths]
    model = serve.SeqFormerModel(params, cfg["slots"], cfg["length"])
    batched = [[] for _ in episodes]
    for t in range(max(lengths)):
        live = [i for i, ep in enumerate(episodes) if t < len(ep)]
        idx = np.full(4, model.pad_slot, np.int64)
        idx[:len(live)] = live
        obs = np.zeros((4, cfg["obs_dim"]), np.float32)
        obs[:len(live)] = [episodes[i][t] for i in live]
        pred = model.step_rows(idx, obs)
        for j, i in enumerate(live):
            batched[i].append(pred[j])
    per_row_err = 0.0
    with torch.no_grad():
        for ep, got in zip(episodes, batched):
            cache = seqformer.init_cache(params, 1, dtype=torch.float32, length=cfg["length"])
            for t in range(len(ep)):
                want, cache = seqformer.decode_step(
                    params, cache, torch.from_numpy(ep[t][None]).cuda(),
                    compute_dtype=torch.float32)
                want = want[0].cpu().numpy()
                per_row_err = max(per_row_err, float(np.abs(got[t] - want).max()))
                check(np.allclose(got[t], want, atol=SERVE_ATOL, rtol=SERVE_ATOL),
                      "batched per-row decode == per-episode serial decode on the card")
    # the card against the CPU on a small model, float and int8
    small = dict(SERVE_SMALL, d_model=32, n_layers=2, length=16, slots=4)
    cpu_params = _serve_params(torch, seqformer, small, device="cpu")
    cpu_err = {}
    for int8 in (False, True):
        what = "int8" if int8 else "f32"
        on_cpu = serve.SeqFormerModel(cpu_params, small["slots"], small["length"], int8=int8)
        on_card = serve.SeqFormerModel({k: v.cuda() for k, v in cpu_params.items()},
                                       small["slots"], small["length"], int8=int8)
        cpu_err[what] = 0.0
        for idx, obs, _ in _ticks(np, small, on_cpu, 12, seed=3):
            a, b = on_cpu.step_rows(idx, obs), on_card.step_rows(idx, obs)
            cpu_err[what] = max(cpu_err[what], float(np.abs(a - b).max()))
            check(np.allclose(b, a, atol=SERVE_ATOL, rtol=SERVE_ATOL),
                  f"served {what} SeqFormer tick: card == CPU on a small model")
    return captured, {"captured_eq_eager_buckets": buckets, "per_row_vs_serial_err": per_row_err,
                      "card_vs_cpu_err": cpu_err, "atol": SERVE_ATOL}


def _tick_times(torch, captured, cfg):
    """Device time of each captured bucket's replay (CUDA events, the L2
    flushed), beside its bound: the weights and the rows' caches read once."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    weights = sum(t.numel() * t.element_size() for t in captured.params.values())
    cache = captured._cache
    row_bytes = sum(t[0].numel() * t.element_size() for t in cache["k"] + cache["v"])
    out = {}
    for sig, entry in sorted(captured.graphs.graphs.items(), key=lambda kv: kv[0][1][1][0]):
        rows = sig[1][1][0]
        ms = time_ms(torch, entry.graph.replay, reps=20, flush=flush)
        bound = (weights + rows * row_bytes) / HBM_RATE * 1e3
        out[str(rows)] = {"ms": ms, "bound_ms": bound, "bound_by": "bytes",
                          "weight_bytes": weights, "cache_bytes": rows * row_bytes}
    return out


def _tick_profile(torch, model, rows, replays=5):
    """Where one captured tick's device time goes: torch.profiler over
    ``replays`` replays of the ``rows``-row bucket, per replay the busy
    time, the kernel count, and the ten kernels with the most time."""
    from torch.profiler import ProfilerActivity, profile

    entry = next(e for sig, e in model.graphs.graphs.items() if sig[1][1][0] == rows)
    entry.graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            entry.graph.replay()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"rows": rows, "busy_us": sum(us for _, us in by_name.values()) / replays,
            "kernels": sum(n for n, _ in by_name.values()) / replays,
            "top_us": [[name[:90], n / replays, us / replays] for name, (n, us) in top]}


def _serve_window(np, serve, address, cfg, seconds, rng_seed):
    """``clients`` episode loops through the port's ``ServeClient`` for
    ``seconds``: each client's first episode admitted with a prefix, later
    ones from empty; returns (steps/s, per-step latencies in s)."""
    clients = cfg["clients"]
    lat = [[] for _ in range(clients)]
    counts = [0] * clients
    errors = []
    ready, go = threading.Barrier(clients + 1), threading.Barrier(clients + 1)
    deadline = [None]

    def run(i):
        # pinned to ZMQ, as in PRs 10-11: the transport phase measures ShmRPC
        client = serve.ServeClient(address, timeoutms=30000, shm=False)
        rng = np.random.default_rng(rng_seed + i)
        ep = rng.standard_normal((cfg["episode_len"], cfg["obs_dim"])).astype(np.float32)
        try:
            client.reset(prefix=ep[:cfg["prefix"]])
            t = cfg["prefix"]
            ready.wait(timeout=120)
            go.wait(timeout=60)
            while time.perf_counter() < deadline[0]:
                t0 = time.perf_counter()
                client.step(ep[t])
                lat[i].append(time.perf_counter() - t0)
                counts[i] += 1
                t += 1
                if t == cfg["episode_len"]:
                    client.close_episode()
                    client.reset()
                    t = 0
            client.close_episode()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"client {i}: {type(exc).__name__}: {exc}")
            ready.abort()
            go.abort()
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    try:
        ready.wait(timeout=120)
        deadline[0] = time.perf_counter() + seconds
        go.wait(timeout=60)
    except threading.BrokenBarrierError:
        pass  # a client failed before the start: reported below
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=seconds + 60)
    elapsed = time.perf_counter() - t0
    check(not errors, f"serve window: {errors}")
    return sum(counts) / elapsed, [x for per in lat for x in per]


def serve_phase(torch, seqformer, serve, cfg, label):
    """The served SeqFormer through ``PolicyServer`` and ``ServeClient``:
    float batched, serial and int8 windows in turns, with the serve
    benchmark's metric names; the checks and tick times at the flagship."""
    import numpy as np

    from blendjax_torch.utils.timing import SERVE_STAGES, EventCounters, StageTimer

    checks, ticks = {}, {}
    if label == "serve":
        captured, checks = _serve_checks(torch, np, seqformer, serve, cfg)
        ticks = _tick_times(torch, captured, cfg)
        del captured
    params = _serve_params(torch, seqformer, cfg)
    models = {
        "batched": serve.SeqFormerModel(params, cfg["slots"], cfg["length"]),
        "serial": serve.SeqFormerModel(params, cfg["slots"], cfg["length"]),
        "int8": serve.SeqFormerModel(params, cfg["slots"], cfg["length"], int8=True),
    }
    timers = {m: StageTimer() for m in SERVE_MODES}
    servers = {m: serve.start_server_thread(
        models[m], serial=(m == "serial"), tick_ms=1.0, max_batch=cfg["slots"],
        counters=EventCounters(), timer=timers[m]) for m in SERVE_MODES}
    qps = {m: [] for m in SERVE_MODES}
    lat = []
    try:
        for m in SERVE_MODES:
            # every bucket a window can hit: its warm-ups and capture
            model = models[m]
            for b in servers[m].server.buckets:
                for _ in range(3):
                    model.step_rows(np.full(b, model.pad_slot, np.int64),
                                    np.zeros((b, cfg["obs_dim"]), np.float32))
                if b >= cfg["clients"]:
                    break
            _serve_window(np, serve, servers[m].address, cfg, 0.3, 100)
        for r in range(cfg["rounds"]):
            order = SERVE_MODES[r % 3:] + SERVE_MODES[:r % 3]
            for m in order:
                rate, l = _serve_window(np, serve, servers[m].address, cfg, cfg["window_s"],
                                        1000 * (r + 1))
                qps[m].append(rate)
                if m == "batched":
                    lat.extend(l)
        counters = {m: servers[m].server.counters.snapshot() for m in SERVE_MODES}
    finally:
        for h in servers.values():
            h.close()
    profiles = {}
    if label == "serve":
        profiles = {m: _tick_profile(torch, models[m], cfg["clients"]) for m in ("batched", "int8")}
    med = {m: float(np.median(v)) for m, v in qps.items()}
    pairs = [b / s for b, s in zip(qps["batched"], qps["serial"]) if s]
    rec = {"phase": label, "config": cfg,
           "serve_qps": med["batched"],
           "serve_p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "serve_p99_ms": float(np.percentile(lat, 99)) * 1e3,
           "serve_batch_x": float(np.median(pairs)),
           "serve_int8_x": med["int8"] / med["batched"],
           "serve_qps_modes": med, "qps_turns": qps,
           "stages_p50_ms": {m: {s: timers[m].percentiles(s)["p50_ms"]
                                 for s in SERVE_STAGES} for m in SERVE_MODES},
           "batches": {m: counters[m].get("serve_batches", 0) for m in SERVE_MODES},
           "batch_pad": {m: counters[m].get("serve_batch_pad", 0) for m in SERVE_MODES},
           "errors": {m: counters[m].get("serve_errors", 0) for m in SERVE_MODES},
           "tick_device": ticks, "tick_profile": profiles, "checks": checks}
    emit(_stamp(rec))
    check(all(v > 0 for v in med.values()), f"{label}: every mode served steps")
    check(all(counters[m].get("serve_errors", 0) == 0 for m in SERVE_MODES),
          f"{label}: no request errored")
    check(all(counters[m].get("serve_prefills", 0) >= cfg["clients"] for m in SERVE_MODES),
          f"{label}: every client's first episode was admitted with a prefix")


def dream_phase(torch, seqformer, worldmodel, quant, pendulum, state):
    """``worldmodel.dream`` on the world-model phase's flash-trained model
    at the flagship width: a 64-step prefix, 448 dreamed steps of batch 8,
    float and int8 in turns; the rollout against the CPU on a small model."""
    import numpy as np

    episode = pendulum.simulate_episode(np.random.default_rng(123), DREAM["batch"],
                                        DREAM["prefix"] + DREAM["steps"], SEQ["obs_dim"])
    turns = []
    for int8 in (False, True, True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, mse = worldmodel.dream(state, episode, DREAM["prefix"], DREAM["steps"],
                                      int8=int8)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check(tuple(preds.shape) == (DREAM["batch"], DREAM["steps"], SEQ["obs_dim"])
              and bool(torch.isfinite(preds).all()) and math.isfinite(mse),
              f"dream (int8={int8}): finite predictions of the expected shape")
        turns.append({"int8": int8, "seconds": sec, "steps_per_s": DREAM["steps"] / sec,
                      "obs_per_s": DREAM["steps"] * DREAM["batch"] / sec, "mse": mse})
    # the card against the CPU on a small model, float and int8
    small = seqformer.init(torch.Generator().manual_seed(0), obs_dim=8, d_model=32, n_heads=4,
                           n_layers=2, max_len=64, device="cpu")
    prefix = torch.from_numpy(pendulum.simulate_episode(np.random.default_rng(0), 2, 16, 8))
    errs = {}
    with torch.no_grad():
        for int8 in (False, True):
            p = quant.quantize_seqformer(small) if int8 else small
            want = seqformer.rollout(p, prefix[:, :8], 8, compute_dtype=torch.float32)
            got = seqformer.rollout({k: v.cuda() for k, v in p.items()}, prefix[:, :8].cuda(),
                                    8, compute_dtype=torch.float32).cpu()
            errs["int8" if int8 else "f32"] = float((got - want).abs().max())
            check(torch.allclose(got, want, atol=SERVE_ATOL, rtol=SERVE_ATOL),
                  f"rollout (int8={int8}): card == CPU on a small model")
    emit(_stamp({"phase": "dream", "config": DREAM, "turns": turns,
                 "card_vs_cpu_err": errs, "atol": SERVE_ATOL}))


def _boundary_steps(np, x, scale):
    """Distance of ``x / scale`` from the nearest rounding boundary (k +
    0.5), in quantization steps, computed in float64."""
    v = np.asarray(x, np.float64) / np.asarray(scale, np.float64)
    return np.abs(v - np.floor(v) - 0.5)


def _int8_layer_walk(torch, qp, images, qp_ref, images_ref, xy, want):
    """``detector_apply_int8`` on ``qp``/``images``'s device (the device
    under test) against the CPU's ``qp_ref``/``images_ref``, layer by layer.
    Both chains are run by ``detector.apply`` itself, with the int8 layers
    of ``ops/quant.py`` in its seams, so the glue between the layers (GELU,
    the pool, the sigmoid) is the model's own.

    - The device's frames must equal the CPU's decode, its chain must give
      ``xy`` (its own ``detector_apply_int8``) bit for bit, and the CPU's
      chain run plainly must give ``want`` (the CPU's) bit for bit: the walk
      is the path under test on both devices.
    - At each int8 layer the device's float input is quantized on both
      devices: the scales agree within :data:`INT8_SCALE_RTOL`, relative,
      and every int8 value that differs lies within
      :data:`INT8_TIE_STEPS` of its rounding boundary under either scale.
      The device's own int8 activation and scale then go through the
      CPU's same layer: the int32 accumulators must be equal and the float
      epilogues within :data:`INT8_EPILOGUE_ATOL`.
    - The CPU's own chain quantizes its own input.  Each int8 value that
      differs from the device's must be one step away and lie within
      :data:`INT8_TIE_STEPS` of its boundary under the CPU's own input and
      scale; the tie is then resolved the device's way and the CPU's chain
      goes on.  So resolved, it must land within :data:`INT8_CHAIN_ATOL`
      of ``xy``: the end-to-end gap is then the ties' and nothing else's.

    Returns the per-layer records and the verdicts."""
    import numpy as np

    from blendjax_torch.models import detector
    from blendjax_torch.models import layers as L
    from blendjax_torch.ops import quant

    names = [f"convs.{i}" for i in range(L.num_layers(qp, "convs"))] + ["fc", "head"]
    card = []  # per layer: the device's float input, int8 activation, scale, output

    def card_layer(apply_int8, accumulate):
        def fn(p, x, *stride):
            xq, xs = quant.quantize_act(x)
            y = apply_int8(p, x, *stride)
            card.append({"x": x, "xq": xq, "xs": xs, "acc": accumulate(xq, p["w_q"], *stride),
                         "out": y, "accumulate": accumulate, "stride": stride})
            return y
        return fn

    def cpu_layer(accumulate, chain):
        """The CPU's layer on its own input; with ``chain`` a list, its
        differing int8 values are recorded and resolved the device's way."""
        def fn(p, x, *stride):
            cq, cs = quant.quantize_act(x)
            if chain is not None:
                dq = card[len(chain)]["xq"].cpu()
                diff = cq != dq
                dist = _boundary_steps(np, x.numpy(), np.broadcast_to(cs.numpy(), x.shape))
                far = (dist > INT8_TIE_STEPS) | ((cq.int() - dq.int()).abs() > 1).numpy()
                chain.append({"differing": int(diff.sum()),
                              "non_ties": int((far & diff.numpy()).sum()),
                              "boundary_steps": sorted(float(d) for d in dist[diff.numpy()])[-64:]})
                cq = torch.where(diff, dq, cq)
            return accumulate(cq, p["w_q"], *stride).to(torch.float32) * (cs * p["w_scale"]) \
                + p["b"]
        return fn

    def run(params, imgs, conv, dense):
        return detector.apply(params, imgs, compute_dtype=torch.float32, conv_fn=conv,
                              dense_fn=dense)

    chain = []
    with torch.no_grad():
        got = run(qp, images, card_layer(quant.conv_apply_int8, quant.conv_accumulate),
                  card_layer(quant.dense_apply_int8, quant.dense_accumulate))
        plain = run(qp_ref, images_ref, cpu_layer(quant.conv_accumulate, None),
                    cpu_layer(quant.dense_accumulate, None))
        resolved = run(qp_ref, images_ref, cpu_layer(quant.conv_accumulate, chain),
                       cpu_layer(quant.dense_accumulate, chain))
        recs = []
        for name, c, ch in zip(names, card, chain):
            p_ref = L.layer(qp_ref, name)
            x_host = c["x"].cpu()
            xq_ref, xs_ref = quant.quantize_act(x_host)
            diff = (c["xq"].cpu() != xq_ref).numpy()
            dist = np.minimum(
                _boundary_steps(np, x_host.numpy(), np.broadcast_to(c["xs"].cpu().numpy(),
                                                                    x_host.shape)),
                _boundary_steps(np, x_host.numpy(), np.broadcast_to(xs_ref.numpy(),
                                                                    x_host.shape)))
            acc_ref = c["accumulate"](c["xq"].cpu(), p_ref["w_q"], *c["stride"])
            out_ref = acc_ref.to(torch.float32) * (c["xs"].cpu() * p_ref["w_scale"]) + p_ref["b"]
            recs.append({"layer": name,
                         "scale_rel_err": float(((c["xs"].cpu() - xs_ref).abs() / xs_ref).max()),
                         "differing": int(diff.sum()),
                         "non_ties": int((dist[diff] > INT8_TIE_STEPS).sum()),
                         # the farthest ones, at most 64
                         "boundary_steps": sorted(float(d) for d in dist[diff])[-64:],
                         "acc_equal": bool(torch.equal(c["acc"].cpu(), acc_ref)),
                         "epilogue_err": float((c["out"].cpu() - out_ref).abs().max()),
                         "chain_differing": ch["differing"], "chain_non_ties": ch["non_ties"],
                         "chain_boundary_steps": ch["boundary_steps"]})
    walk = {"layers": recs,
            "frames_equal": bool(torch.equal(images.cpu(), images_ref)),
            "card_chain_equal": bool(torch.equal(got.cpu(), xy.cpu())),
            "cpu_chain_equal": bool(torch.equal(plain, want)),
            "acc_equal": all(r["acc_equal"] for r in recs),
            "scales_ok": all(r["scale_rel_err"] <= INT8_SCALE_RTOL for r in recs),
            "epilogue_ok": all(r["epilogue_err"] <= INT8_EPILOGUE_ATOL for r in recs),
            "non_ties": sum(r["non_ties"] for r in recs),
            "chain_non_ties": sum(r["chain_non_ties"] for r in recs),
            "resolved_err": float((resolved - xy.cpu()).abs().max())}
    walk["explained"] = (walk["frames_equal"] and walk["card_chain_equal"]
                         and walk["cpu_chain_equal"] and walk["acc_equal"] and walk["scales_ok"]
                         and walk["epilogue_ok"] and walk["non_ties"] == 0
                         and walk["chain_non_ties"] == 0
                         and walk["resolved_err"] <= INT8_CHAIN_ATOL)
    return walk


def _int8_verdict(err, walk):
    """The end-to-end int8 check: the card within :data:`INFER_INT8_ATOL`
    of the CPU, or a gap that the layer walk explains as rounding ties
    (``walk["explained"]``: the walk is the path under test on both
    devices, every layer holds on the same quantized inputs, every int8
    value in which the two chains differ is a tie, and the CPU's chain with
    those ties resolved the card's way lands on the card's keypoints)."""
    return err <= INFER_INT8_ATOL or walk["explained"]


def infer_int8_phase(torch, btt, datagen, image):
    """``generate.py --infer-int8``'s path: the stream's first batch held
    back, the detector trained on the rest, then K1's decode to f32 and the
    int8 detector on the held batch; against the CPU on the same frames."""
    _fake_blender()
    with btt.BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT), num_instances=2,
                             named_sockets=["DATA"], start_port=_port_block(),
                             background=True, seed=0) as bl:
        ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"], max_items=32,
                                       item_transform=datagen.item_transform)
        with btt.TorchStream(ds, batch_size=8, num_workers=2, device="cuda") as stream:
            it = iter(stream)
            hold = next(it)
            state, losses = datagen.train_on_stream(it, log_every=0)
            check(hold["image"].is_cuda and tuple(hold["image"].shape) == MAIN_SHAPE,
                  "the held batch is the stream's uint8 batch on the card")
            image.decode_frames_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xy = datagen.infer_int8(state, hold["image"])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches = image.decode_frames_cuda.launches
    cpu_state = type(state)(params={k: v.detach().cpu() for k, v in state.params.items()},
                            optimizer=None)
    want = datagen.infer_int8(cpu_state, hold["image"].cpu())
    err = float((xy.cpu() - want).abs().max())
    from blendjax_torch.ops.quant import quantize_detector

    with torch.no_grad():
        qp = quantize_detector({k: v.detach() for k, v in state.params.items()})
        qp_ref = quantize_detector(cpu_state.params)
        images = image.decode_frames(hold["image"], dtype=torch.float32)
        images_ref = image.decode_frames(hold["image"].cpu(), dtype=torch.float32)
    walk = _int8_layer_walk(torch, qp, images, qp_ref, images_ref, xy, want)
    emit(_stamp({"phase": "infer_int8", "batches_trained": len(losses),
                 "keypoints": list(xy.shape), "seconds": sec, "launches": {"decode_u8": launches},
                 "card_vs_cpu_err": err, "atol": INFER_INT8_ATOL,
                 "weights_equal": all(torch.equal(qp[k].cpu(), qp_ref[k]) for k in qp_ref),
                 "limits": {"scale_rtol": INT8_SCALE_RTOL, "epilogue_atol": INT8_EPILOGUE_ATOL,
                            "tie_steps": INT8_TIE_STEPS, "chain_atol": INT8_CHAIN_ATOL},
                 "layer_walk": walk}))
    check(tuple(xy.shape) == (MAIN_SHAPE[0], 8, 2) and bool(torch.isfinite(xy).all()),
          "int8 inference: finite keypoints of the expected shape")
    check(walk["frames_equal"], "int8 inference: the card's decoded frames equal the CPU's")
    check(walk["card_chain_equal"], "int8 inference: the layer walk's card chain gives the "
                                    "card's keypoints bit for bit")
    check(walk["cpu_chain_equal"], "int8 inference: the layer walk's CPU chain gives the CPU's "
                                   "keypoints bit for bit")
    check(walk["acc_equal"], "int8 inference: every int32 accumulator equals the CPU's on the "
                             "card's own quantized activations")
    check(walk["scales_ok"], "int8 inference: activation scales within "
                             f"{INT8_SCALE_RTOL} of the CPU's on the same inputs")
    check(walk["epilogue_ok"], f"int8 inference: float epilogues within {INT8_EPILOGUE_ATOL}")
    check(walk["non_ties"] == 0, "int8 inference: every int8 activation that differs from "
                                 f"the CPU's lies within {INT8_TIE_STEPS} of a step from its "
                                 "rounding boundary")
    check(walk["chain_non_ties"] == 0, "int8 inference: every int8 activation in which the "
                                       "CPU's own chain differs from the card's is one step off "
                                       f"and within {INT8_TIE_STEPS} of a step from its boundary")
    check(walk["resolved_err"] <= INT8_CHAIN_ATOL,
          "int8 inference: the CPU's chain with its ties resolved the card's way within "
          f"{INT8_CHAIN_ATOL} of the card's keypoints")
    check(_int8_verdict(err, walk), "int8 inference: card == CPU on the same frames (within "
                                    f"{INFER_INT8_ATOL}, or the gap is a rounding tie)")
    check(launches >= 1, "the infer_int8 path launched decode_u8")
    return launches

# -- replay_service and flywheel: the replay service and the weight bus on the card --------

#: the reference's replay-benchmark shape (benchmarks/replay_benchmark.py: 120x160x3
#: uint8 frames, a 4,096-row ring, batches of 32) over 2 shard processes; ``tail``
#: rows appended after the shards' checkpoint make the killed shard's spill tail
RS = dict(height=120, width=160, channels=3, capacity=4096, batch=32, shards=2,
          window_s=0.25, rounds=4, check_batches=8, tail=512)
#: the flywheel's actor-learner: the al phase's fleet over 2 shard processes
FLY = dict(shard_capacity=4096, replay_ratio=1, replay_batch=64, publish_every=2,
           turn_s=2.5, clients=2, episode_len=32)
FLY_ARMS = ("bus", "no_bus", "no_bus", "bus")
#: the flagship swap's client window: the publish lands ``publish_at_s`` into
#: it, and it ends ``after_s`` after the publish returns
SWAP = dict(publish_at_s=1.5, after_s=2.5, bucket_s=0.1)
PROM_LINE = re.compile(r'^(# (HELP|TYPE) .+|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? '
                       r'(-?[0-9.]+(e[-+]?[0-9]+)?|NaN|[-+]Inf))$')


def _rs_transition(np, rng):
    shape = (RS["height"], RS["width"], RS["channels"])
    return {"obs": rng.integers(0, 255, shape, dtype=np.uint8),
            "action": np.int32(rng.integers(0, 4)), "reward": np.float32(rng.random()),
            "next_obs": rng.integers(0, 255, shape, dtype=np.uint8),
            "done": bool(rng.random() < 0.02)}


class _CardFeed:
    """Sampled replay batches onto the card through pinned staging buffers:
    ``sample`` gathers into the pinned buffers, copies them to the card
    without blocking, and waits for the copy before the buffers are reused."""

    def __init__(self, torch, np):
        self.torch, self.np = torch, np
        self.pinned, self.card = {}, {}

    def _dst(self, key, shape, dtype):
        buf = self.pinned.get(key)
        if buf is None or tuple(buf.shape) != shape:
            buf = self.torch.from_numpy(self.np.empty(shape, dtype)).pin_memory()
            self.pinned[key] = buf
            self.card[key] = self.torch.empty_like(buf, device="cuda")
        return buf.numpy()

    def sample(self, buffer, batch):
        data, idx, w = buffer.sample(batch, out=self._dst)
        for key in data:
            self.card[key].copy_(self.pinned[key], non_blocking=True)
        self.torch.cuda.current_stream().synchronize()
        return self.card, idx, w

    def rate(self, buffer, batch, seconds):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.sample(buffer, batch)
            n += 1
        return n / (time.perf_counter() - t0)


def _shard_digest(np, buf, shard):
    """SHA-256 over every column of one shard's rows, read back over its
    client in local slot order.  Each reply (64 rows, 7.4 MB) stays under
    half of the 32 MiB shm reply ring: a larger record fits the ring only
    at some positions of its head (ROADMAP Queue 3)."""
    import hashlib

    h = hashlib.sha256()
    keys = sorted(buf.store.keys)
    for start in range(0, buf.shard_capacity, 64):
        data = buf.clients[shard].rpc(
            "gather", {"indices": list(range(start, start + 64)), "keys": keys},
            raw_buffers=True)["data"]
        for key in keys:
            h.update(np.ascontiguousarray(data[key]).tobytes())
    return h.hexdigest()


def _rs_wires(buf):
    """Each client's wire, channel generations and demotions."""
    return [{"transport": c.transport,
             "generations": c._chan.generations if c._chan is not None else 0,
             "demotions": c._chan.demotions if c._chan is not None else 0}
            for c in buf.clients]


def _rs_shm_bytes(meter):
    """Each shard's ``replay_shm_bytes`` counter, read over ``meter``'s tcp
    clients (a telemetry RPC over tcp adds no shm bytes)."""
    return [int(meter.shard_telemetry(s, timeout_ms=2000)["counters"]
                .get("replay_shm_bytes", 0)) for s in range(meter.num_shards)]


def _rs_measure(np, torch, feeds, arms, shards, meter):
    """Interleaved windows per round: the in-process buffer, each service arm
    healthy, then each arm with its last shard quarantined and re-admitted
    (the reference benchmark's ``measure_sharded`` windows).  Around every
    service window it reads each shard's ``replay_shm_bytes`` through
    ``meter``, and after each healthy window each client's wire, so the
    windows' labels rest on what the shards counted."""
    rates = {name: [] for name in ["inproc"] + [f"{a}{s}" for a in arms
                                                for s in ("", "_degraded")]}
    #: per arm and round, each shard's shm bytes in the healthy and the
    #: degraded window; per arm and round, the wires after the healthy window
    moved = {arm: [] for arm in arms}
    wires = {arm: [] for arm in arms}
    for _ in range(RS["rounds"]):
        rates["inproc"].append(feeds["inproc"][0].rate(feeds["inproc"][1], RS["batch"],
                                                       RS["window_s"]))
        for arm in arms:
            feed, buf = feeds[arm]
            b0 = _rs_shm_bytes(meter)
            rates[arm].append(feed.rate(buf, RS["batch"], RS["window_s"]))
            wires[arm].append(_rs_wires(buf))
            b1 = _rs_shm_bytes(meter)
            buf.quarantine_shard(shards - 1, reason="degraded window")
            rates[f"{arm}_degraded"].append(feed.rate(buf, RS["batch"], RS["window_s"]))
            check(buf.probe(), f"replay_service: the {arm} arm's shard re-admitted")
            b2 = _rs_shm_bytes(meter)
            moved[arm].append({"healthy": [b - a for a, b in zip(b0, b1)],
                               "degraded": [b - a for a, b in zip(b1, b2)]})
    return rates, moved, wires


def _median_ratio(np, num, den):
    return float(np.median([a / b for a, b in zip(num, den) if b > 0]))


def replay_service_phase(torch):
    """The sharded replay service at the reference benchmark's shape: 2 shard
    processes (``ShardFleet``: ``python -m blendjax_torch.replay.service``,
    durable under a temporary directory), one ``ShardedReplay`` over ShmRPC
    filled with 4,096 seeded rows and checkpointed, one over tcp restored
    from that cut, and an in-process ``ReplayBuffer`` filled alike.  Checks:
    the first batches of all three bit-equal on the card; then interleaved windows (``replay_shard_x``, the
    service over the in-process rate, and ``replay_degraded_x``, a shard
    quarantined over healthy, per wire); then SIGKILL shard 0 under a
    ``FleetSupervisor``: quarantined, respawned, restored crash-exact (its
    rows' digest unchanged) and re-admitted; nothing left under the fleet's
    ``/dev/shm`` prefixes."""
    import tempfile

    import numpy as np

    from blendjax_torch.btt import shm_rpc
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.faults import FaultPolicy
    from blendjax_torch.btt.supervise import FleetSupervisor
    from blendjax_torch.replay import ReplayBuffer, ShardedReplay
    from blendjax_torch.replay.service import ShardFleet
    from blendjax_torch.replay.shard_client import ShardClient
    from blendjax_torch.utils.timing import EventCounters

    t_phase = time.perf_counter()
    rng = np.random.default_rng(0)
    rows = [_rs_transition(np, rng) for _ in range(64)]
    cap, shards = RS["capacity"], RS["shards"]
    inproc = ReplayBuffer(cap, seed=0)
    for k in range(cap):
        inproc.append(rows[k % len(rows)])
    counters = EventCounters()
    policy = FaultPolicy(max_retries=1, backoff_base=0.02, backoff_max=0.1, deadline_s=2.0,
                         circuit_threshold=0, seed=3)
    with tempfile.TemporaryDirectory(prefix="bjx-replay-") as tmp, \
            ShardFleet(shards, capacity_per_shard=cap // shards, data_dir=tmp,
                       checkpoint_every=0) as fleet:
        svc = {"shm": ShardedReplay(fleet.addresses, seed=0, counters=counters,
                                    fault_policy=policy, timeoutms=2000)}
        t0 = time.perf_counter()
        for k in range(cap):
            svc["shm"].append(rows[k % len(rows)])
        fill_s = time.perf_counter() - t0
        # the shards checkpoint, and the tcp client restores the shm
        # client's cut over the same shards: the same draw state on another
        # wire
        cut = os.path.join(tmp, "client.npz")
        svc["shm"].save(cut)
        svc["tcp"] = ShardedReplay.restore(
            cut, [ShardClient(a, i, shm=False, timeoutms=2000)
                  for i, a in enumerate(fleet.addresses)], counters=EventCounters())
        check(svc["shm"].clients[0].transport == "shm"
              and svc["tcp"].clients[0].transport == "tcp",
              "replay_service: one client rides ShmRPC, the other tcp")
        feeds = {"inproc": (_CardFeed(torch, np), inproc),
                 **{arm: (_CardFeed(torch, np), buf) for arm, buf in svc.items()}}
        for _ in range(RS["check_batches"]):
            (want, wi, ww), *others = [f.sample(b, RS["batch"]) for f, b in feeds.values()]
            want = {k: v.clone() for k, v in want.items()}
            for got, gi, gw in others:
                check(np.array_equal(gi, wi) and np.array_equal(gw, ww)
                      and all(torch.equal(got[k], want[k]) for k in want),
                      "replay_service: the service's batches on the card equal the "
                      "in-process buffer's, bit for bit")
        for feed, buf in feeds.values():
            feed.rate(buf, RS["batch"], 0.1)  # warm-up
        rates, moved, wires = _rs_measure(np, torch, feeds, ("shm", "tcp"), shards,
                                          meter=svc["tcp"])
        svc["tcp"].close()

        # SIGKILL shard 0 under the supervisor, its rows a checkpoint and a
        # spill tail (the ring's head has wrapped to slot 0, so the tail rows
        # land on shard 0)
        buf = svc["shm"]
        for k in range(RS["tail"]):  # other rows than the checkpoint's in those slots
            buf.append(rows[(k + 7) % len(rows)])
        before = _shard_digest(np, buf, 0)
        with FleetSupervisor(fleet, pool=None, interval=0.15, counters=counters,
                             replay=buf, heal_interval=0.05, postmortem_dir=tmp) as sup:
            t_kill = time.perf_counter()
            kill_instance(fleet, 0)
            check(sup.await_deaths(1, timeout=30), "replay_service: shard 0's death seen")
            degraded_draws = 0
            for _ in range(5):
                dead = bool(buf.quarantined[0])
                _, idx, _ = buf.sample(RS["batch"])
                if dead and bool(buf.quarantined[0]):  # not re-admitted meanwhile
                    degraded_draws += 1
                    check(not (idx < buf.shard_capacity).any(),
                          "replay_service: degraded draws avoid the dead shard")
            check(sup.await_healthy(timeout=90), f"replay_service: shard 0 re-admitted "
                  f"({counters.snapshot()})")
            readmit_s = time.perf_counter() - t_kill
        after = _shard_digest(np, buf, 0)
        restored = buf.clients[0].rpc("hello")["restored_from"]
        health = sup.health()
        buf.close()
        bases = [b for b in fleet.shm_bases if b is not None]
    leaked = {b: shm_rpc.leaked_objects(b) for b in bases}
    shard_x = {arm: _median_ratio(np, rates[arm], rates["inproc"]) for arm in ("shm", "tcp")}
    degraded_x = {arm: _median_ratio(np, rates[f"{arm}_degraded"], rates[arm])
                  for arm in ("shm", "tcp")}
    emit(_stamp({"phase": "replay_service", "config": RS,
                 "replay_shard_x": shard_x, "replay_degraded_x": degraded_x,
                 "shm_rpc_x": _median_ratio(np, rates["shm"], rates["tcp"]),
                 "batches_per_s": {k: float(np.median(v)) for k, v in rates.items()},
                 "batches_per_s_rounds": rates, "fill_s": fill_s,
                 "shm_bytes_moved": moved, "wires": wires,
                 "kill": {"digest_before": before, "digest_after": after,
                          "restored_from": restored, "readmit_s": readmit_s,
                          "degraded_draws": degraded_draws,
                          "quarantined": counters.get("replay_shard_quarantined"),
                          "readmissions": counters.get("replay_shard_readmissions"),
                          "lost": counters.get("replay_shard_lost"),
                          "deaths": health["deaths"], "restarts": health["restarts"]},
                 "shm_leaked": leaked, "seconds": time.perf_counter() - t_phase}))
    check(all(w["transport"] == "shm" and w["demotions"] == 0
              for rnd in wires["shm"] for w in rnd),
          f"replay_service: every client of the shm arm rode ShmRPC through its healthy "
          f"windows, none demoted ({wires['shm']})")
    check(all(w["transport"] == "tcp" for rnd in wires["tcp"] for w in rnd),
          f"replay_service: every client of the tcp arm rode tcp ({wires['tcp']})")
    check(all(n > 0 for rnd in moved["shm"] for n in rnd["healthy"]),
          f"replay_service: every shard counted shm bytes in each healthy shm window "
          f"({moved['shm']})")
    check(all(n == 0 for rnd in moved["tcp"] for w in ("healthy", "degraded")
              for n in rnd[w]),
          f"replay_service: no shard counted shm bytes in the tcp windows ({moved['tcp']})")
    check(before == after, "replay_service: the respawned shard restored its rows exactly")
    check(restored is not None and restored[0] > 0 and restored[1] > 0,
          "replay_service: the respawn restored a checkpoint and a spill tail")
    check(counters.get("replay_shard_quarantined") >= 1
          and counters.get("replay_shard_readmissions") >= 1
          and counters.get("replay_shard_lost") == 0,
          "replay_service: the killed shard was quarantined and re-admitted, nothing lost")
    check(health["deaths"] == 1 and health["restarts"] == 1,
          "replay_service: one death, one respawn")
    check(not any(leaked.values()), f"replay_service: /dev/shm left clean ({leaked})")


def _prometheus_parses(text):
    lines = text.rstrip("\n").split("\n")
    return bool(lines) and all(PROM_LINE.match(line) for line in lines)


def _flywheel_learner(torch, btt, control, al_rates):
    """(a) The actor-learner path: the al phase's cartpole fleet -> an
    ``ActorLearner`` over a ``ShardedReplay`` on 2 shard processes at replay
    ratio 1, publishing every 2 updates on a ``WeightPublisher``, with a
    ``TelemetryHub``; a ``PolicyServer`` on the card subscribed to the bus
    serves 2 ``ServeClient``s in a child process throughout.  Turns with
    the bus on and off give env-steps/s with learning beside the al phase's
    (in-process replay) and the ``weight_publish`` stage."""
    import tempfile

    import numpy as np

    from blendjax_torch.models import policy
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.obs.hub import TelemetryHub
    from blendjax_torch.replay import ShardedReplay
    from blendjax_torch.replay.service import ShardFleet
    from blendjax_torch.serve import PolicyModel, start_server_thread
    from blendjax_torch.utils.timing import EventCounters, StageTimer
    from blendjax_torch.weights import WeightPublisher, WeightSubscriber

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"

    def forces(a):
        return list((np.asarray(a) * 2 - 1) * control.FORCE_MAG)

    hub = TelemetryHub("flywheel")
    server_counters, server_timer = EventCounters(), StageTimer()
    with tempfile.TemporaryDirectory(prefix="bjx-fly-") as tmp, \
            ShardFleet(2, capacity_per_shard=FLY["shard_capacity"], data_dir=tmp) as fleet, \
            WeightPublisher(counters=EventCounters()).start() as pub, \
            btt.launch_env_pool(scene="", script=str(control.SCRIPT), num_instances=RL_INSTANCES,
                                background=True, start_port=_port_block(RL_INSTANCES), seed=0,
                                real_time=False, pipeline_depth=RL_DEPTH,
                                counters=EventCounters()) as pool:
        replay = ShardedReplay(fleet.addresses, seed=0, counters=EventCounters())
        al = ActorLearner(pool, 3, 2, rollout_len=AL_ROLLOUT, queue_size=AL_QUEUE,
                          action_map=forces, replay=replay, replay_ratio=FLY["replay_ratio"],
                          replay_batch=FLY["replay_batch"], hub=hub, weight_bus=pub,
                          publish_every=FLY["publish_every"], device="cuda")
        served = PolicyModel(policy.init(torch.Generator(device="cuda").manual_seed(9), 3, 2,
                                         device="cuda"), 3)
        with start_server_thread(served, counters=server_counters, timer=server_timer,
                                 subscriber=WeightSubscriber(pub.address)) as srv:
            hub.register("policy_server", counters=server_counters, timer=server_timer)
            hub.register("weight_publisher", counters=pub.counters)
            stop_file = os.path.join(tmp, "clients.stop")
            clients = {}
            cfg = {"clients": FLY["clients"], "episode_len": FLY["episode_len"], "prefix": 0,
                   "obs_dim": 3, "check": False, "stop_file": stop_file}

            def run_clients():
                try:
                    clients.update(_serve_clients(srv.address, cfg, "auto", 600, 50))
                except SystemExit as exc:  # a failed check in this thread
                    clients["failure"] = str(exc)

            runner = threading.Thread(target=run_clients, daemon=True)
            runner.start()
            st = al.run(num_updates=3)  # each step's warm-ups and capture
            turns = []
            for turn, arm in enumerate(FLY_ARMS):
                al.weight_bus = pub if arm == "bus" else None
                st = al.run(seconds=FLY["turn_s"])
                stages = st["stages"]
                turns.append({"turn": turn, "arm": arm,
                              "env_steps_per_s": st["env_steps_per_sec"],
                              "updates_per_s": st["updates_per_sec"],
                              "updates": st["updates"], "replay_updates": st["replay_updates"],
                              "weight_publish_p50_ms": _stage_p50(stages, "weight_publish"),
                              "publishes": stages.get("weight_publish", {}).get("count", 0),
                              "update_p50_ms": _stage_p50(stages, "update"),
                              "replay_update_p50_ms": _stage_p50(stages, "replay_update")})
                emit({"phase": "flywheel_turn", **turns[-1]})
                check(all(math.isfinite(v) for v in st["losses"] + st["replay_losses"]),
                      f"flywheel turn {turn}: losses finite")
            final = pub.version
            deadline = time.monotonic() + 30
            while srv.server.weight_version != final and time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(1.0)  # the clients step at the final version
            open(stop_file, "w").close()
            runner.join(timeout=120)
            snap = hub.scrape()
            prom = hub.to_prometheus(snap)
        replay.close()
    check(not runner.is_alive() and "failure" not in clients and clients,
          f"flywheel: the client process finished ({clients.get('failure')})")
    versions = clients["versions"]
    emit({"phase": "flywheel_clients", "versions": versions, "final": final,
          "steps": clients["steps"], "errors": clients["errors"],
          "wires": clients["wires"]})
    check(not clients["errors"], f"flywheel: no client errored ({clients['errors']})")
    for i, seq in enumerate(versions):
        check(len(seq) >= 2 and all(a < b for a, b in zip(seq, seq[1:])) and seq[-1] == final,
              f"flywheel: client {i}'s weight versions rise strictly to the last publish "
              f"({seq} vs {final})")
    c = snap["counters"]
    check(c["replay_appends"] > 0 and c["serve_requests"] > 0 and c["weight_adopted"] >= 2
          and c["weight_published"] >= 2, "flywheel: the hub holds the replay's, the "
          "server's and the bus's counters")
    check(snap["components"]["actor_learner"]["probe"]["updates"] > 0
          and snap["stages"]["shard_srv_append"]["count"] > 0
          and "remote_errors" not in snap,
          "flywheel: the hub holds the learner's probe and the shards' remote stages")
    check(_prometheus_parses(prom), "flywheel: the Prometheus text parses")
    bus = [t["env_steps_per_s"] for t in turns if t["arm"] == "bus"]
    off = [t["env_steps_per_s"] for t in turns if t["arm"] == "no_bus"]
    pub_ms = [t["weight_publish_p50_ms"] for t in turns if t["arm"] == "bus"]
    rec = {"phase": "flywheel", "config": FLY,
           "env_steps_per_s": {"bus": statistics.mean(bus), "no_bus": statistics.mean(off),
                               "al_phase_inproc_replay": al_rates},
           "bus_x": statistics.mean(bus) / statistics.mean(off),
           "weight_publish_p50_ms": statistics.median(pub_ms),
           "published": c["weight_published"], "adopted": c["weight_adopted"],
           "hub_counters": {k: c[k] for k in ("replay_appends", "replay_samples",
                                              "serve_requests", "weight_published",
                                              "weight_adopted", "weight_syncs")},
           "server_weight_swap": server_timer.percentiles("weight_swap")}
    emit(_stamp(rec))
    return rec


def _swap_window(np, serve, address, cfg, rng_seed, publish):
    """``clients`` episode loops recording each reply's time and weight
    version; ``publish()`` runs :data:`SWAP` ``publish_at_s`` into the
    window, which ends ``after_s`` after the publish returns.  Returns
    (replies, publish return time, window start, window end, the publish's
    result)."""
    clients = cfg["clients"]
    replies = [[] for _ in range(clients)]
    errors = []
    ready, go = threading.Barrier(clients + 1), threading.Barrier(clients + 1)
    deadline = [None]

    def run(i):
        client = serve.ServeClient(address, timeoutms=60000, shm=False)
        rng = np.random.default_rng(rng_seed + i)
        ep = rng.standard_normal((cfg["episode_len"], cfg["obs_dim"])).astype(np.float32)
        try:
            client.reset(prefix=ep[:cfg["prefix"]])
            t = cfg["prefix"]
            ready.wait(timeout=120)
            go.wait(timeout=60)
            while time.perf_counter() < deadline[0]:
                r = client.step(ep[t])
                replies[i].append((time.perf_counter(), r.get("weight_version")))
                t += 1
                if t == cfg["episode_len"]:
                    client.close_episode()
                    client.reset()
                    t = 0
            client.close_episode()
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"client {i}: {type(exc).__name__}: {exc}")
            ready.abort()
            go.abort()
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    ready.wait(timeout=120)
    start = time.perf_counter()
    deadline[0] = start + 600.0  # until the publish has returned
    go.wait(timeout=60)
    time.sleep(SWAP["publish_at_s"])
    result = publish()
    t_pub = time.perf_counter()
    deadline[0] = t_pub + SWAP["after_s"]
    for t in threads:
        t.join(timeout=SWAP["after_s"] + 120)
    check(not errors, f"flagship swap window: {errors}")
    return replies, t_pub, start, deadline[0], result


def _dip(np, replies, start, t_pub, t_seen, seconds):
    """The weight benchmark's ``weight_swap_qps_dip_x``: the aggregate QPS of
    the 100 ms buckets from one before the publish to one after the first
    observation at the new version, over the median of the other buckets
    (edges trimmed)."""
    w = SWAP["bucket_s"]
    n = int(seconds / w)
    counts = np.zeros(n)
    for per in replies:
        for t, _ in per:
            b = int((t - start) / w)
            if 0 <= b < n:
                counts[b] += 1
    swap = set(range(int((t_pub - start) / w) - 1, int((t_seen - start) / w) + 2))
    steady = [counts[b] for b in range(1, n - 1) if b not in swap and counts[b] > 0]
    dipped = [counts[b] for b in sorted(swap) if 0 < b < n - 1]
    return float(np.median(dipped) / np.median(steady)), float(np.median(steady) / w)


def _flagship_swap(torch, seqformer, serve, int8):
    """(b) The flagship's served weights swapped over the bus: the flagship
    SeqFormer served (captured ticks) to ``SERVE["clients"]`` threads, a
    second parameter set published mid-window (``quantize="seqformer"``
    into an int8 server), then held: the count of captured graphs
    unchanged, the served tensors equal to the published ones (``w_q`` in
    the column-major layout ``torch._int_mm`` takes), and the first captured
    tick after a further swap bit-equal to an eager ``decode_step`` with the
    new params on the same cache."""
    import numpy as np

    from blendjax_torch.models.convert import params_from_jax, params_to_jax
    from blendjax_torch.ops.quant import quantize_seqformer
    from blendjax_torch.utils.timing import EventCounters, StageTimer
    from blendjax_torch.weights import WeightPublisher, WeightSubscriber

    what = "int8" if int8 else "f32"
    cfg = SERVE
    model = serve.SeqFormerModel(_serve_params(torch, seqformer, cfg), cfg["slots"],
                                 cfg["length"], int8=int8)
    new = [params_to_jax(_serve_params(torch, seqformer, cfg, seed=s)) for s in (1, 2)]
    # what the wire carries: the publisher quantizes on the CPU
    published = (params_to_jax(quantize_seqformer(params_from_jax(new[0], device="cpu")))
                 if int8 else new[0])
    counters, timer = EventCounters(), StageTimer()
    with WeightPublisher(quantize="seqformer" if int8 else None, history=1,
                         counters=counters).start() as pub, \
            serve.start_server_thread(model, tick_ms=1.0, max_batch=cfg["slots"],
                                      counters=counters, timer=timer,
                                      subscriber=WeightSubscriber(pub.address)) as srv:
        for b in srv.server.buckets:  # every bucket's warm-ups and capture
            for _ in range(3):
                model.step_rows(np.full(b, model.pad_slot, np.int64),
                                np.zeros((b, cfg["obs_dim"]), np.float32))
            if b >= cfg["clients"]:
                break
        graphs = len(model.graphs.graphs)
        strides = {k: t.stride() for k, t in model.params.items()}
        t_box = {}

        def publish():
            t0 = time.perf_counter()
            v = pub.publish(new[0], step=1)
            t_box["publish_ms"] = (time.perf_counter() - t0) * 1e3
            return v

        replies, t_pub, start, end, v1 = _swap_window(np, serve, srv.address, cfg, 300,
                                                      publish)
        seen = [t for per in replies for t, v in per if v == v1]
        check(bool(seen), f"flagship {what} swap: the clients saw the new version")
        t_seen = min(seen)
        for i, per in enumerate(replies):
            vs = [v for _, v in per if v is not None]
            check(vs == sorted(vs) and vs and vs[-1] == v1,
                  f"flagship {what} swap: client {i}'s versions rise to v{v1}")
        dip_x, qps = _dip(np, replies, start, t_pub, t_seen, end - start)
        check(len(model.graphs.graphs) == graphs,
              f"flagship {what} swap: no tick recaptured after the swap")
        want = params_from_jax(published, device="cuda")
        check(all(torch.equal(model.params[k], want[k]) for k in want),
              f"flagship {what} swap: the served tensors are the published ones")
        check({k: t.stride() for k, t in model.params.items()} == strides,
              f"flagship {what} swap: every served tensor kept its layout (w_q the "
              "column-major one torch._int_mm takes)")
        # the first captured tick after a swap against eager decode_step on
        # the same cache: no client ticks between the adoption and the check
        v2 = pub.publish(new[1], step=2)
        deadline = time.monotonic() + 60
        while srv.server.weight_version != v2 and time.monotonic() < deadline:
            time.sleep(0.01)
        check(srv.server.weight_version == v2, f"flagship {what}: v{v2} adopted")
        rng = np.random.default_rng(5)
        bucket = cfg["clients"]
        idx = np.arange(bucket, dtype=np.int64)
        obs = rng.standard_normal((bucket, cfg["obs_dim"])).astype(np.float32)
        cache = model._cache
        idx_t = torch.from_numpy(idx).to("cuda")
        rows = {"pos": cache["pos"][idx_t].clone(), "k": [k[idx_t].clone() for k in cache["k"]],
                "v": [v[idx_t].clone() for v in cache["v"]]}
        with torch.no_grad():
            eager, eager_rows = seqformer.decode_step(
                model.params, rows, torch.from_numpy(obs).to("cuda"),
                compute_dtype=torch.float32, window=model.window)
        captured = model.step_rows(idx, obs)
        tick_eq = (np.array_equal(captured, eager.cpu().numpy())
                   and all(torch.equal(c[idx_t], e) for c, e in
                           zip(cache["k"] + cache["v"], eager_rows["k"] + eager_rows["v"])))
        check(tick_eq, f"flagship {what} swap: the first captured tick after the swap equals "
              "an eager decode_step with the new params, bit for bit")
        check(len(model.graphs.graphs) == graphs, f"flagship {what}: still no recapture")
        snap_mb = sum(a.nbytes for a in _leaves(published)) / 1e6
        rec = {"precision": what, "snapshot_mb": snap_mb,
               "publish_ms": t_box["publish_ms"], "weight_swap_ms": (t_seen - t_pub) * 1e3,
               "weight_swap_qps_dip_x": dip_x, "qps_steady": qps,
               "server_weight_swap_ms": timer.percentiles("weight_swap"),
               "server_weight_assemble_ms": timer.percentiles("weight_assemble"),
               "graphs": graphs, "tick_eq_eager": tick_eq,
               "adopted": counters.get("weight_adopted"),
               "serve_errors": counters.get("serve_errors")}
    check(rec["adopted"] == 2 and rec["serve_errors"] == 0,
          f"flagship {what} swap: both snapshots adopted, no request errored")
    return rec


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def flywheel_phase(torch, btt, control, seqformer, serve, al_rates):
    t0 = time.perf_counter()
    rec = {"learner": _flywheel_learner(torch, btt, control, al_rates)}
    for int8 in (False, True):
        rec["int8" if int8 else "f32"] = _flagship_swap(torch, seqformer, serve, int8)
        emit(_stamp({"phase": "flywheel_swap", **rec["int8" if int8 else "f32"]}))
    emit({"phase": "flywheel_seconds", "seconds": time.perf_counter() - t0})
    return rec


# -- the scenario plane: catalog, randomizer, curriculum, heterogeneous fleets -------

#: the reference's scenario configuration (``benchmarks/scenario_benchmark.py``:
#: ``lite`` at 200 us of physics a frame, ``rich`` at 4,000, their density
#: ranges), 3 fleets of 2 envs (the bench's ``--instances 2``) assigned lite,
#: lite, rich by the uniform curriculum (``tests/test_scenario.py``'s run)
SCN_PHYSICS_US = {"lite": 200, "rich": 4000}
SCN_DENSITY = {"lite": (0.1, 0.4), "rich": (0.6, 1.0)}
SCN_FLEETS, SCN_ENVS = 3, 2
#: the curriculum's interval in updates, and seconds per timed run
SCN_INTERVAL = 4
SCN_RUN_S = 3.0
#: the fan-in's arms over the same fleet, in turns, and seconds per turn
SCN_FANIN_ARMS = (1, None, None, 1)
SCN_FANIN_S = 2.0
#: the pool-level arms (``scenario_hetero_x``'s), in turns, over 2 lite and 2
#: rich producers at 4 requests in flight per env
SCN_POOL_ARMS = ("lockstep", "ready_first", "ready_first", "lockstep")
SCN_POOL_S = 1.0
SCN_POOL_DEPTH = 4
#: the non-uniform mix of the strata draw, and draws timed per arm at
#: 200,000 rows
SCN_MIX = {"lite": 0.25, "rich": 0.75}
SCN_SAMPLE_DRAWS = 50
#: pushes into the killed producer, and the bound on all of them
#: (``tests/test_scenario.py``'s chaos case)
SCN_CHAOS_PUSHES = 12
SCN_CHAOS_BOUND_S = 6.0


def _scenario_catalog():
    from blendjax_torch.scenario import ScenarioCatalog, ScenarioSpec

    return ScenarioCatalog([ScenarioSpec(n, physics_rate_us=SCN_PHYSICS_US[n],
                                         ranges={"density": SCN_DENSITY[n]})
                            for n in ("lite", "rich")])


def _poll(cond, timeout):
    """Call ``cond`` until it returns true (True) or ``timeout`` seconds
    pass (False)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
    return False


def _scenario_counts(counters):
    from blendjax_torch.utils.timing import SCENARIO_EVENTS

    return {k: counters.get(k) for k in SCENARIO_EVENTS}


def _scenario_learner(fs, replay, rnd, cur, seed=0, hub=None):
    """The al phase's learner over the fleet set, with the scenario plane."""
    import numpy as np

    from blendjax_torch.models.actor_learner import ActorLearner

    values = np.array([0.0, 1.0])
    return ActorLearner(fs, 1, 2, rollout_len=AL_ROLLOUT, queue_size=AL_QUEUE, seed=seed,
                        action_map=lambda a: list(values[np.asarray(a)]), replay=replay,
                        replay_ratio=AL_REPLAY["ratio"], replay_batch=AL_REPLAY["batch"],
                        scenarios=rnd, curriculum=cur, fanin_min_ready=1, hub=hub,
                        device="cuda")


def _scenario_pool_ratio(btt):
    """``scenario_hetero_x``'s arms at the pool level: 2 lite and 2 rich
    echo producers stepped lockstep (``pool.step``, every step at the rich
    scene's rate) against ready-first (``step_wait(min_ready=1)``, each env
    resubmitted as its transition lands), in turns."""
    from blendjax_torch.btt.env import kwargs_to_cli

    cat = _scenario_catalog()
    args = [kwargs_to_cli({**cat.get(n).env_kwargs(), "horizon": 1_000_000_000})
            for n in ("lite", "lite", "rich", "rich")]
    n = len(args)
    rates = {arm: [] for arm in SCN_POOL_ARMS}
    per_scenario = {}
    with btt.BlenderLauncher(scene="", script=os.path.join(REPO, "tests", "blender",
                                                           "torch_env.blend.py"),
                             num_instances=n, named_sockets=["GYM"], start_port=_port_block(n),
                             background=True, instance_args=args) as bl:
        with btt.EnvPool(bl.launch_info.addresses["GYM"], timeoutms=30000,
                         pipeline_depth=SCN_POOL_DEPTH) as pool:
            pool.reset()
            for _ in range(8):
                pool.step([0.5] * n)
            for arm in SCN_POOL_ARMS:
                done, t0 = 0, time.perf_counter()
                if arm == "lockstep":
                    while time.perf_counter() - t0 < SCN_POOL_S:
                        pool.step([0.5] * n)
                        done += n
                else:
                    for _ in range(SCN_POOL_DEPTH):
                        pool.step_async([0.5] * n)
                    while time.perf_counter() - t0 < SCN_POOL_S:
                        idx, _, _, _, infos = pool.step_wait(min_ready=1)
                        pool.step_async([0.5] * len(idx), indices=list(idx))
                        done += len(idx)
                        for inf in infos:
                            sid = inf.get("scenario", "_unlabelled")
                            per_scenario[sid] = per_scenario.get(sid, 0) + 1
                rates[arm].append(done / (time.perf_counter() - t0))
                if arm != "lockstep":
                    pool.step_wait()  # drained before the next arm
    lock, ready = statistics.mean(rates["lockstep"]), statistics.mean(rates["ready_first"])
    return {"arms": rates, "lockstep_mean": lock, "ready_first_mean": ready,
            "ready_first_x": ready / lock, "per_scenario_steps": per_scenario,
            "instances": n, "pipeline_depth": SCN_POOL_DEPTH}


def _scenario_strata(torch, al, replay, counters):
    """A replay update on a batch drawn under :data:`SCN_MIX`: the card
    against the CPU, captured against eager over one Adam in turns; then
    ``sample``'s p50 at 200,000 rows with the strata draw and the plain one."""
    import numpy as np

    from blendjax_torch.models import policy
    from blendjax_torch.models.train import TrainState, make_train_step
    from blendjax_torch.replay import ReplayBuffer
    from blendjax_torch.utils.timing import EventCounters

    before = counters.get("scenario_strata_draws")
    keys = ("obs", "action", "reward")
    ids = replay._scenario_ids
    draws = []
    for _ in range(8):
        data, idx, w = replay.sample(AL_REPLAY["batch"], keys=keys, scenario_mix=SCN_MIX)
        stamps = replay._scenario[idx]
        draws.append({"obs": data["obs"], "action": data["action"], "reward": data["reward"],
                      "is_weight": w, "rich": int((stamps == ids["rich"]).sum()),
                      "lite": int((stamps == ids["lite"]).sum())})
    split = [(d["lite"], d["rich"]) for d in draws]
    check(all(x == (16, 48) for x in split) and counters.get("scenario_strata_draws") - before
          == len(draws), f"scenario_strata: every draw apportioned 16 lite and 48 rich rows "
          f"under {SCN_MIX} ({split})")
    batches = [{k: torch.as_tensor(d[k], device="cuda") for k in
                ("obs", "action", "reward", "is_weight")} for d in draws]

    sides = []
    for dev in ("cuda", "cpu"):
        params = {k: v.detach().to(dev) for k, v in al.state.params.items()}
        b = {k: v.to(dev) for k, v in batches[0].items()}
        sides.append(_grads(torch, lambda q, b=b: al.replay_loss_fn(q, b), params))
    diffs = {"loss": _max_diff(torch, sides[0][0], sides[1][0])}
    for k in sides[0][1]:
        diffs[f"grad.{k}"] = _max_diff(torch, sides[0][1][k], sides[1][1][k])
    check(all(d <= RL_ATOL for d in diffs.values()),
          f"scenario_strata: the card equals the CPU within {RL_ATOL} ({diffs})")

    turns, ref = [], None
    for turn, form in enumerate(FORMS):
        state = TrainState.create(policy.init(torch.Generator(device="cuda").manual_seed(1),
                                              1, 2, device="cuda"), lr=3e-3)
        step = make_train_step(al.replay_loss_fn, capture=form == "captured")
        state, losses, times = _timed_steps(torch, step, state, batches)
        params = {k: v.detach().clone() for k, v in state.params.items()}
        if ref is None:
            ref = (losses, params)
        rec = {"turn": turn, "form": form, "graphs": len(step.graphs),
               "median_step_ms": statistics.median(times),
               "loss_max_abs_diff": max(abs(a - b) for a, b in zip(losses, ref[0])),
               "param_max_abs_diff": _max_param_diff(torch, params, ref[1])}
        turns.append(rec)
        check(all(math.isfinite(v) for v in losses), f"scenario_strata {form}: losses finite")
        check(rec["graphs"] == (1 if form == "captured" else 0),
              f"scenario_strata {form}: one graph")
        check(rec["loss_max_abs_diff"] == 0 and rec["param_max_abs_diff"] == 0,
              f"scenario_strata {form} turn {turn}: losses and parameters {CAPTURED_MATCH} "
              "to the first eager turn")

    rng = np.random.default_rng(3)
    big = ReplayBuffer(AL_REPLAY["capacity"], seed=1, counters=EventCounters())
    chunk = 10_000
    for lo in range(0, AL_REPLAY["capacity"], chunk):
        obs = rng.random((chunk + 1, 1), dtype=np.float32)
        act = rng.integers(0, 2, chunk)
        rew = (act * 0.1).astype(np.float32)
        scen = np.where(rng.random(chunk) < 0.5, "lite", "rich")
        big.extend(({"obs": obs[i], "action": act[i], "reward": rew[i], "next_obs": obs[i + 1],
                     "done": False} for i in range(chunk)), scenarios=list(scen))
    check(len(big) == AL_REPLAY["capacity"], "scenario_strata: 200,000 rows appended")
    times = {"strata": [], "plain": []}
    for _ in range(SCN_SAMPLE_DRAWS):
        for arm, mix in (("strata", SCN_MIX), ("plain", None)):
            t0 = time.perf_counter()
            big.sample(AL_REPLAY["batch"], keys=keys, scenario_mix=mix)
            times[arm].append((time.perf_counter() - t0) * 1e3)
    return {"mix": SCN_MIX, "split": split[0], "draws": len(draws), "atol": RL_ATOL,
            "max_abs_diff": diffs, "turns": turns,
            "sample_rows": len(big), "sample_batch": AL_REPLAY["batch"],
            "sample_p50_ms": {k: statistics.median(v) for k, v in times.items()},
            "sample_strata_x": statistics.median(times["strata"])
            / statistics.median(times["plain"])}


class _LogLines(logging.Handler):
    """The messages of the records that contain ``needle``."""

    def __init__(self, needle):
        super().__init__(logging.WARNING)
        self.needle, self.lines = needle, []

    def emit(self, record):
        msg = record.getMessage()
        if self.needle in msg:
            self.lines.append(msg)


def scenario_phase(torch, btt):
    """The scenario plane on the card through its entry points:
    ``FleetSet(ctrl=True)`` of :data:`SCN_FLEETS` x :data:`SCN_ENVS` echo
    producers (``tests/blender/torch_env.blend.py``, launched lite, lite,
    rich) -> ``ActorLearner(scenarios=DomainRandomizer, curriculum=
    CurriculumScheduler, fanin_min_ready=1, device="cuda")`` over a
    200,000-row ``ReplayBuffer`` at ratio 2.  ``scenario_run``: the uniform
    curriculum's run, then a ``pin({"rich": 1.0})`` shift; ``scenario_fanin``:
    ``fanin_min_ready=1`` against the all-live barrier in turns, and the
    pool-level ready-first/lockstep ratio; ``scenario_strata``;
    ``scenario_ha``: a cut mid-curriculum resumed in place into a new learner
    over the same fleets; ``scenario_chaos``: a producer SIGKILLed, pushed
    into, respawned, its scenario following it back, and a second one killed
    with nothing pushed, which only ``reassign`` brings back to its
    scenario."""
    import tempfile

    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.faults import FaultPolicy
    from blendjax_torch.ha import TrainCheckpointer, latest_manifest, restore_replay
    from blendjax_torch.obs import TelemetryHub
    from blendjax_torch.parallel import FleetSet
    from blendjax_torch.replay import ReplayBuffer
    from blendjax_torch.scenario import CurriculumScheduler, DomainRandomizer
    from blendjax_torch.utils.timing import EventCounters

    _fake_blender()
    os.environ["BLENDJAX_FAKE_BPY"] = "1"
    t_phase = time.perf_counter()
    # an actor's failure is a warning of the learner's ("actor fleet N
    # failed (...)"); the phase must see none
    failed_fleets = _LogLines("actor fleet")
    logging.getLogger("blendjax_torch").addHandler(failed_fleets)
    cat = _scenario_catalog()
    script = os.path.join(REPO, "tests", "blender", "torch_env.blend.py")
    stride = SCN_ENVS * 2 * 2
    policy = FaultPolicy(max_retries=1, backoff_base=0.05, deadline_s=2.0, circuit_threshold=0,
                         seed=7)
    counters = EventCounters()  # the randomizer's, the curriculum's and the replay's
    hub = TelemetryHub("scenario")
    kinds = ["lite", "lite", "rich"]
    with FleetSet("", script, SCN_FLEETS, SCN_ENVS, start_port=_port_block(SCN_FLEETS * stride),
                  port_stride=stride, timeoutms=30000, fault_policy=policy, interval=0.2,
                  ctrl=True, horizon=1_000_000_000,
                  fleet_env_kwargs=[cat.get(k).env_kwargs() for k in kinds]) as fs, \
            tempfile.TemporaryDirectory(prefix="bjx-scenario-") as tmp:
        rnd = DomainRandomizer(cat, fs.ctrl_addresses, seed=0, counters=counters)
        cur = CurriculumScheduler(cat, policy="uniform", interval=SCN_INTERVAL,
                                  counters=counters)
        replay = ReplayBuffer(AL_REPLAY["capacity"], seed=0, counters=counters)
        al = _scenario_learner(fs, replay, rnd, cur, hub=hub)
        warm = al.run(num_updates=3)
        check(warm["updates"] == 3 and len(al._step.graphs) == 1,
              "scenario: the warm-up run captured the on-policy step")
        assigned_before = rnd.assignments
        check(assigned_before == kinds,
              f"scenario_run: the uniform curriculum assigned {kinds} ({assigned_before})")
        run_a = al.run(seconds=SCN_RUN_S)
        strata_a = replay.scenario_stats()
        check(all(strata_a.get(k, {}).get("rows", 0) > 0
                  and strata_a.get(k, {}).get("eligible", 0) > 0 for k in ("lite", "rich")),
              f"scenario_run: both scenarios have rows and eligible rows ({strata_a})")
        check(all(run_a["env_steps_by_scenario"].get(k, 0) > 0 for k in ("lite", "rich")),
              "scenario_run: both scenarios stepped")

        fanin = {1: [], None: []}
        for turn, arm in enumerate(SCN_FANIN_ARMS):
            al.fanin_min_ready = arm
            st = al.run(seconds=SCN_FANIN_S)
            fanin[arm].append(st["env_steps_per_sec"])
            emit(_stamp({"phase": "scenario_fanin_turn", "turn": turn, "fanin_min_ready": arm,
                         "env_steps_per_s": st["env_steps_per_sec"],
                         "updates_per_s": st["updates_per_sec"],
                         "env_steps_by_scenario": st["env_steps_by_scenario"],
                         "updates_by_scenario": st["updates_by_scenario"],
                         "segment_wait_p50_ms": _stage_p50(st["stages"], "segment_wait")}))
            check(st["updates"] > 0 and all(math.isfinite(v) for v in st["losses"]),
                  f"scenario_fanin turn {turn}: updates, losses finite")
        al.fanin_min_ready = 1

        cur.pin({"rich": 1.0})
        run_b = al.run(seconds=SCN_RUN_S)
        assigned_after = rnd.assignments
        confirmed = rnd.stats()["confirmed"]
        counts = _scenario_counts(counters)
        scrape = hub.scrape()
        run = {"updates": [warm["updates"], run_a["updates"], run_b["updates"]],
               "env_steps_per_s": [run_a["env_steps_per_sec"], run_b["env_steps_per_sec"]],
               "env_steps_by_scenario": [run_a["env_steps_by_scenario"],
                                         run_b["env_steps_by_scenario"]],
               "updates_by_scenario": [run_a["updates_by_scenario"],
                                       run_b["updates_by_scenario"]],
               "assignments_before": assigned_before, "assignments_after": assigned_after,
               "confirmed": confirmed, "counters": counts, "scenario_stats": strata_a,
               "scenario_stats_after": replay.scenario_stats(),
               "mix_after": cur.mix(), "curriculum": cur.stats(),
               "hub_scenario_counters": {k: scrape["counters"][k] for k in counts},
               "push_ms": rnd.timer.percentiles("scenario_push")}
        emit(_stamp({"phase": "scenario_run", **run}))
        check(assigned_after == ["rich"] * SCN_FLEETS,
              f"scenario_run: the pinned shift made every fleet rich ({assigned_after})")
        check(confirmed == [True] * SCN_FLEETS,
              "scenario_run: every pushed scenario was seen applied on the data plane")
        check(counts["scenario_mix_changes"] >= 1 and counts["scenario_pushes"]
              >= SCN_ENVS * (SCN_FLEETS + 2) and counts["scenario_applies"] >= SCN_FLEETS + 2
              and counts["scenario_push_failures"] == 0,
              f"scenario_run: the bootstrap and the shift pushed and applied ({counts})")
        check(counts["scenario_rows_stamped"] == replay.stats()["appends"],
              "scenario_run: every replay row stamped")
        check(run_b["updates_by_scenario"].get("rich", 0) > 0,
              "scenario_run: updates attributed to rich after the shift")
        check(run["hub_scenario_counters"] == counts, "scenario_run: the hub holds the counts")

        pool_ratio = _scenario_pool_ratio(btt)
        emit(_stamp({"phase": "scenario_fanin", "arms": {str(k): v for k, v in fanin.items()},
                     "min_ready_1_mean": statistics.mean(fanin[1]),
                     "barrier_mean": statistics.mean(fanin[None]),
                     "min_ready_x": statistics.mean(fanin[1]) / statistics.mean(fanin[None]),
                     "pool": pool_ratio}))

        strata = _scenario_strata(torch, al, replay, counters)
        emit(_stamp({"phase": "scenario_strata", **strata}))

        # a cut mid-curriculum, resumed in place into a new learner
        ck = TrainCheckpointer(os.path.join(tmp, "ha"), every_updates=10**9,
                               counters=EventCounters())
        for _ in range(SCN_INTERVAL):
            if cur.state_dict()["ticks"] % SCN_INTERVAL:
                break
            al.run(num_updates=1)
        cut = ck.checkpoint(al, block=True)
        cut_state = cur.state_dict()
        check(cut_state["ticks"] % SCN_INTERVAL != 0, "scenario_ha: the cut is mid-interval")
        man = latest_manifest(ck.directory)
        rnd.close()
        counters2 = EventCounters()
        rnd2 = DomainRandomizer(cat, fs.ctrl_addresses, seed=1, counters=counters2)
        cur2 = CurriculumScheduler(cat, policy="uniform", interval=SCN_INTERVAL,
                                   counters=counters2)
        t0 = time.perf_counter()
        buf2 = restore_replay(man, counters=counters2)
        al2 = _scenario_learner(fs, buf2, rnd2, cur2, seed=7)
        warm2 = al2.run(num_updates=3)  # the new learner's bootstrap and captures
        graphs = [g for step in (al2._step, al2._replay_step) for g in step.graphs.values()]
        pushes = counters2.get("scenario_pushes")
        TrainCheckpointer(ck.directory, counters=EventCounters()).restore(al2, man)
        restore_s = time.perf_counter() - t0
        repushed = counters2.get("scenario_pushes") - pushes
        restored_state = cur2.state_dict()
        resumed = al2.run(num_updates=SCN_INTERVAL)
        ha = {"cut": cut, "cut_ticks": cut_state["ticks"], "replay_rows": len(buf2),
              "restore_s": restore_s, "warmup_updates": warm2["updates"],
              "curriculum_equal": restored_state == cut_state, "repushed": repushed,
              "assignments": rnd2.assignments, "confirmed": rnd2.stats()["confirmed"],
              "graphs": len(graphs),
              "recaptured": [g for step in (al2._step, al2._replay_step)
                             for g in step.graphs.values()] != graphs,
              "updates_done": al2._updates_done, "resumed_updates": resumed["updates"],
              "resumed_env_steps_by_scenario": resumed["env_steps_by_scenario"],
              "ticks_after": cur2.state_dict()["ticks"]}
        emit(_stamp({"phase": "scenario_ha", **ha}))
        check(ha["curriculum_equal"], "scenario_ha: the restored curriculum equals the cut's")
        check(repushed == 2 * SCN_ENVS and ha["assignments"] == ["rich"] * SCN_FLEETS,
              f"scenario_ha: the cut's assignment re-pushed to the 2 changed fleets ({repushed})")
        check(ha["confirmed"] == [True] * SCN_FLEETS,
              "scenario_ha: the re-pushed scenarios were seen applied")
        check(ha["graphs"] == 2 and not ha["recaptured"],
              "scenario_ha: restored in place, the two captured graphs kept (no recapture)")
        check(resumed["updates"] == SCN_INTERVAL and al2._updates_done
              == cut + resumed["updates"] + resumed["replay_updates"],
              "scenario_ha: the update counter resumed from the cut")
        check(ha["ticks_after"] == cut_state["ticks"] + SCN_INTERVAL,
              "scenario_ha: the curriculum ticked on from the cut")
        check(all(bool(torch.isfinite(v).all()) for v in al2.state.params.values()),
              "scenario_ha: parameters finite")

        # SIGKILL a producer, push into it, and follow its scenario back
        pool, sup = fs.pools[0], fs.supervisors[0]
        deaths = sup.health()["deaths"]
        t_kill = time.perf_counter()
        kill_instance(fs.launchers[0], 0)
        push_s = []
        for _ in range(SCN_CHAOS_PUSHES):
            t0 = time.perf_counter()
            rnd2.assign(0, "rich")
            push_s.append(time.perf_counter() - t0)
        check(sum(push_s) < SCN_CHAOS_BOUND_S,
              f"scenario_chaos: {SCN_CHAOS_PUSHES} pushes returned within "
              f"{SCN_CHAOS_BOUND_S} s ({sum(push_s):.2f} s)")
        check(sup.await_deaths(deaths + 1, timeout=30) and sup.await_healthy(timeout=30),
              "scenario_chaos: the supervisor saw the death and respawned the producer")
        t_healthy = time.perf_counter()
        echoes, back = [], None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            _, _, _, infos = pool.step([0.5] * SCN_ENVS)
            for i, inf in enumerate(infos):
                if inf.get("readmitted"):
                    rnd2.reassign(0, i)
                rnd2.note_info(0, inf)
            echoes.append(infos[0].get("scenario"))
            if infos[0].get("readmitted") is None and echoes[-1] == "rich" and \
                    counters2.get("scenario_reassignments") >= 1:
                back = time.perf_counter()
                break
        chaos = {"pushes": SCN_CHAOS_PUSHES, "push_total_s": sum(push_s),
                 "push_max_ms": max(push_s) * 1e3,
                 "push_failures": counters2.get("scenario_push_failures"),
                 "reassignments": counters2.get("scenario_reassignments"),
                 "deaths": sup.health()["deaths"] - deaths,
                 "kill_to_healthy_s": t_healthy - t_kill,
                 "kill_to_scenario_back_s": None if back is None else back - t_kill,
                 "echoes_after_respawn": sorted(set(e for e in echoes if e is not None)),
                 "steps_after_respawn": len(echoes)}
        # the quiet drill: kill env 1 with nothing pushed in the outage, so
        # nothing is queued for the new incarnation; it must come back at
        # the fleet's launch scene (lite) and turn to the assigned rich by
        # reassign's push alone
        _poll(lambda: pool.step([0.5] * SCN_ENVS)[3][1].get("scenario") == "rich", 30)
        deaths = sup.health()["deaths"]
        reassigned = counters2.get("scenario_reassignments")
        t_kill = time.perf_counter()
        kill_instance(fs.launchers[0], 1)
        quiet_respawn = sup.await_deaths(deaths + 1, timeout=30) and sup.await_healthy(timeout=30)
        readmitted = quiet_respawn and _poll(
            lambda: pool.step([0.5] * SCN_ENVS)[3][1].get("readmitted"), 30)
        held = [pool.step([0.5] * SCN_ENVS)[3][1].get("scenario") for _ in range(3)] \
            if readmitted else []
        quiet_ok = readmitted and rnd2.reassign(0, 1)
        quiet_back = quiet_ok and _poll(
            lambda: pool.step([0.5] * SCN_ENVS)[3][1].get("scenario") == "rich", 30)
        chaos["quiet"] = {"respawned": quiet_respawn, "readmitted": bool(readmitted),
                          "held_before_reassign": held, "reassign_ok": bool(quiet_ok),
                          "reassignments": counters2.get("scenario_reassignments") - reassigned,
                          "kill_to_scenario_back_s":
                              time.perf_counter() - t_kill if quiet_back else None}
        emit(_stamp({"phase": "scenario_chaos", **chaos}))
        check(back is not None and chaos["reassignments"] >= 1,
              "scenario_chaos: the respawned producer's scenario followed it back")
        check(quiet_respawn and readmitted,
              "scenario_chaos: the quiet kill's producer was respawned and re-admitted")
        check(held == ["lite"] * 3,
              f"scenario_chaos: with nothing queued the respawn held its launch scene ({held})")
        check(quiet_ok and quiet_back and chaos["quiet"]["reassignments"] == 1,
              "scenario_chaos: reassign's push alone turned the respawned producer rich")
        rnd2.close()
        health = fs.health()
    logging.getLogger("blendjax_torch").removeHandler(failed_fleets)
    emit({"phase": "scenario_seconds", "seconds": time.perf_counter() - t_phase,
          "fleet_health": {k: health[k] for k in ("num_fleets", "num_envs", "healthy_envs",
                                                   "deaths", "restarts", "quarantines")},
          "failed_fleets": failed_fleets.lines})
    check(not failed_fleets.lines,
          f"scenario: no actor fleet failed ({failed_fleets.lines})")


# -- serve_fleet: replica processes behind the gateway, on the card ---------------------

#: the serve fleet: the flagship at SERVE's widths in 3 replica processes on
#: the card, one seed (so every replica serves the same weights), 16 client
#: threads of 32-step episodes (``benchmarks/serve_benchmark.py --gateway``'s
#: arms: all replicas but r0 drained for the 1-replica arm)
FLEET = dict(replicas=3, obs_dim=SERVE["obs_dim"], d_model=SERVE["d_model"],
             n_heads=SERVE["n_heads"], n_layers=SERVE["n_layers"], length=SERVE["length"],
             slots=16, max_batch=16, tick_ms=1.0, seed=0, clients=16, episode_len=32,
             window_s=3.0, rounds=2, shard_window_s=2.0, scrape_s=0.1, device="cuda",
             client_procs=4, start_lead_s=2.0)
#: a process (the clients') or a thread (the gateway's loop) using this
#: share of a core over a window is what bounds that window's rate: each is
#: one Python interpreter under its GIL
FLEET_SATURATED = 0.9
#: the buckets a replica's ticks pad to (``default_buckets(16)``), each one
#: graph captured before the replica serves (the server warms a captured model)
FLEET_BUCKETS = (1, 2, 4, 8, 16)
#: acknowledged predictions against the same episodes replayed on one
#: in-process flagship, eager, many episodes a tick: the batch shapes differ
#: from the replicas' ticks, so the float sums may differ in their last bits
FLEET_REPLAY_ATOL = 1e-4
#: the canary controller's settings on the card
FLEET_CANARY = dict(fraction=0.25, healthy_window_s=2.0, min_requests=20,
                    verdict_timeout_s=3.0)
#: the autoscale bench's two configurations (benchmarks/autoscale_benchmark.py).
#: A scale-up's healthy window runs from the decision, so it covers the
#: newcomer's spawn: a flagship replica boots in about 10 s and then syncs
#: the bus's 403 MB version
FLEET_AUTOSCALE = dict(up_window_s=30.0, down_window_s=3.0, min_requests=10,
                       drain_grace_s=30.0)
#: the reshard drill: the replay_service phase's rows in 2 shards of 512 slots
FLEET_RESHARD = dict(capacity_per_shard=512, fill=384, during=256, batches=8)


def _wait_for(cond, timeout, what):
    """Poll ``cond`` every 20 ms until it holds; a timeout fails the run."""
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out after {timeout} s: {what}")
        time.sleep(0.02)


def _fleet_args():
    """The replicas' command line as ``build_model`` reads it: the same
    seeded flagship in process (eager, 32 slots, for the replays)."""
    import argparse

    return argparse.Namespace(model="seqformer", device=FLEET["device"], seed=FLEET["seed"],
                              obs_dim=FLEET["obs_dim"], num_actions=4, slots=32,
                              length=FLEET["length"], window=None, d_model=FLEET["d_model"],
                              n_heads=FLEET["n_heads"], n_layers=FLEET["n_layers"], int8=False,
                              work_us=0)


def _card_memory(torch):
    """The card's memory in use (``mem_get_info``) and per process
    (``nvidia-smi --query-compute-apps``)."""
    free, total = torch.cuda.mem_get_info()
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    return {"used_mib": (total - free) / 2**20, "apps": apps}


def _replica_stats(serve, address):
    c = serve.ServeClient(address, timeoutms=30000, shm=False)
    try:
        return c.stats()
    finally:
        c.close()


def _captures(serve, addresses):
    return [_replica_stats(serve, a)["captures"].get("seqformer") for a in addresses]


def _episode_preds(serve, np, address, obs):
    """One episode alone: reset, a step per observation, close; returns the
    predictions and the replica stamp (None when dialled straight)."""
    c = serve.ServeClient(address, timeoutms=30000)
    try:
        c.reset()
        preds = np.stack([c.step(o)["pred"] for o in obs])
        c.close_episode()
        return preds, c.replica
    finally:
        c.close()


def _clients_async(address, cfg, seconds, seed):
    """``_serve_clients`` in a thread: returns (thread, result dict); a
    failed check lands under ``failure``."""
    out = {}

    def run():
        try:
            out.update(_serve_clients(address, cfg, "auto", seconds, seed))
        except SystemExit as exc:
            out["failure"] = str(exc)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _fleet_clients_cfg(**kw):
    return {"clients": FLEET["clients"], "episode_len": FLEET["episode_len"], "prefix": 0,
            "obs_dim": FLEET["obs_dim"], "check": False, **kw}


def _rate(out):
    return sum(out["steps"]) / out["elapsed"]


def _thread_cpu_s(thread):
    """CPU seconds a running thread has used (its own clock)."""
    return time.clock_gettime(time.pthread_getcpuclockid(thread.ident))


def _spread_clients(address, seconds, seed, gateway_thread):
    """One measured window of ``FLEET["clients"]`` client threads spread
    over ``FLEET["client_procs"]`` child processes that start stepping at
    one wall-clock instant: their rates summed, their records merged, each
    process's CPU share and the gateway loop thread's over the window."""
    procs = FLEET["client_procs"]
    cfg = _fleet_clients_cfg(clients=FLEET["clients"] // procs,
                             start_at=time.time() + FLEET["start_lead_s"])
    outs, threads = [None] * procs, []
    for k in range(procs):
        def run(k=k):
            try:
                outs[k] = _serve_clients(address, cfg, "auto", seconds, seed + 1000 * k)
            except SystemExit as exc:
                outs[k] = {"failure": str(exc)}
        threads.append(threading.Thread(target=run, daemon=True))
    for t in threads:
        t.start()
    time.sleep(max(0.0, cfg["start_at"] - time.time()))
    g0 = _thread_cpu_s(gateway_thread) if gateway_thread is not None else None
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=seconds + 300)
    wall = time.perf_counter() - t0
    fails = ["lost" if o is None else o["failure"] for o in outs if o is None or "failure" in o]
    check(not fails, f"spread serve clients: {fails}")
    merged = {"rate": sum(_rate(o) for o in outs),
              "latencies": [x for o in outs for x in o["latencies"]],
              "resets": sum(o["resets"] for o in outs),
              "retries": sum(o["retries"] for o in outs),
              "affinity_breaks": sum(o["affinity_breaks"] for o in outs),
              "client_cpu_share": [o["cpu_s"] / o["elapsed"] for o in outs],
              "replica_steps": {}}
    for o in outs:
        for rep, k in o["replica_steps"].items():
            merged["replica_steps"][rep] = merged["replica_steps"].get(rep, 0) + k
    if g0 is not None:
        merged["gateway_cpu_share"] = (_thread_cpu_s(gateway_thread) - g0) / wall
    return merged


def _bound_by(arm):
    """What bounds a window, by the measured CPU shares: the clients or the
    gateway loop when either is saturated, else the replicas."""
    if min(arm["client_cpu_share"]) >= FLEET_SATURATED:
        return "clients"
    if arm.get("gateway_cpu_share", 0.0) >= FLEET_SATURATED:
        return "gateway"
    return "replicas"


def _gateway_scale(serve, np, fleet, gw, counters):
    qps = {"3": [], "1": [], "direct": []}
    lat = {k: [] for k in qps}
    shares = {k: {"client_cpu_share": [], "gateway_cpu_share": []} for k in qps}
    breaks, stamped = 0, {"3": {}, "1": {}}
    before = counters.snapshot()
    for r in range(FLEET["rounds"]):
        for arm in (("1", "3", "direct") if r % 2 == 0 else ("direct", "3", "1")):
            if arm == "1":
                for rid in gw.gateway.replica_ids()[1:]:
                    gw.gateway.drain(rid)
            address = fleet.addresses[0] if arm == "direct" else gw.address
            out = _spread_clients(address, FLEET["window_s"], 100 * (r + 1), gw._thread)
            if arm == "1":
                for rid in gw.gateway.replica_ids()[1:]:
                    gw.gateway.undrain(rid)
            qps[arm].append(out["rate"])
            lat[arm].extend(out["latencies"])
            shares[arm]["client_cpu_share"].extend(out["client_cpu_share"])
            shares[arm]["gateway_cpu_share"].append(out["gateway_cpu_share"])
            if arm != "direct":
                breaks += out["affinity_breaks"]
                for rep, k in out["replica_steps"].items():
                    stamped[arm][rep] = stamped[arm].get(rep, 0) + k
    after = counters.snapshot()
    pairs = [a / b for a, b in zip(qps["3"], qps["1"]) if b]
    pct = {arm: {"p50_ms": float(np.percentile(v, 50)) * 1e3,
                 "p99_ms": float(np.percentile(v, 99)) * 1e3} for arm, v in lat.items()}
    names = ("gateway_affinity_hits", "gateway_rebalances", "gateway_routed",
             "gateway_errors", "gateway_stale_lease_redirects")
    return {"gateway_qps": float(np.median(qps["3"])),
            "gateway_qps_1replica": float(np.median(qps["1"])),
            "direct_qps": float(np.median(qps["direct"])),
            "gateway_scale_x": float(np.median(pairs)), "pair_ratios": pairs,
            "bound_by": {arm: _bound_by({"client_cpu_share": v["client_cpu_share"],
                                         "gateway_cpu_share": max(v["gateway_cpu_share"])})
                         for arm, v in shares.items()},
            "cpu_shares": shares, "client_procs": FLEET["client_procs"],
            "qps_turns": qps, "latency": pct,
            "gateway_hop_x": float(np.median(qps["1"])) / float(np.median(qps["direct"])),
            "counters": {k: after.get(k, 0) - before.get(k, 0) for k in names},
            "affinity_breaks": breaks, "replica_steps": stamped}


def _gateway_sharded(serve, np, fleet, shm_rpc):
    from blendjax_torch.utils.timing import EventCounters

    counters = EventCounters()
    qps = {1: [], 2: []}
    relays, shares = [], {1: [], 2: []}
    with serve.start_sharded_gateway_thread(fleet.addresses, workers=2, counters=counters,
                                            scrape_interval_s=FLEET["scrape_s"]) as sg:
        bases = list(sg.gateway._wbases)
        for r in range(FLEET["rounds"]):
            for n in ((2, 1) if r % 2 == 0 else (1, 2)):
                sg.set_active_workers(n)
                r0 = counters.get("gateway_front_relays")
                out = _spread_clients(sg.address, FLEET["shard_window_s"], 300 + 10 * r + n,
                                      sg._thread)
                qps[n].append(out["rate"])
                shares[n].append({k: out[k] for k in ("client_cpu_share", "gateway_cpu_share")})
                if n == 2:
                    relays.append({"relays": counters.get("gateway_front_relays") - r0,
                                   "resets": out["resets"], "retries": out["retries"]})
        merged = sg.gateway.gateway_counters()
    leaked = {b: shm_rpc.leaked_objects(b) for b in bases if b is not None}
    pairs = [a / b for a, b in zip(qps[2], qps[1]) if b]
    return {"gateway_qps_2workers": float(np.median(qps[2])),
            "gateway_qps_1worker": float(np.median(qps[1])),
            "gateway_shard_x": float(np.median(pairs)), "pair_ratios": pairs,
            "qps_turns": {str(k): v for k, v in qps.items()},
            "cpu_shares": {str(k): v for k, v in shares.items()},
            "gateway_front_relays": merged.get("gateway_front_relays", 0),
            "direct_windows": relays, "leaked": leaked,
            "counters": {k: merged.get(k, 0) for k in (
                "gateway_worker_deaths", "gateway_snapshot_applies",
                "gateway_snapshot_publishes", "gateway_errors")}}


def _replay_episodes(torch, np, ref, episodes):
    """Replay acknowledged episodes on the in-process flagship, eager, up to
    its slot count at a time; returns the largest gap to the acked
    predictions and how many steps were held."""
    gap, held = 0.0, 0
    rows = ref.slots
    for k in range(0, len(episodes), rows):
        group = episodes[k:k + rows]
        obs = [np.random.default_rng(e["seed"]).standard_normal(
            (FLEET["episode_len"], FLEET["obs_dim"])).astype(np.float32) for e in group]
        acked = [np.asarray(e["preds"], np.float32) for e in group]
        ref.reset_rows(np.arange(len(group)))
        for t in range(max(len(a) for a in acked)):
            live = [j for j, a in enumerate(acked) if len(a) > t]
            preds = ref.step_rows(np.asarray(live), np.stack([obs[j][t] for j in live]))
            for row, j in enumerate(live):
                gap = max(gap, float(np.abs(preds[row] - acked[j][t]).max()))
                held += 1
    return gap, held


def _double_step_gap(np, ref, episode):
    """The gap one double-applied step opens: the episode replayed with its
    middle observation applied twice, against its acknowledged
    predictions."""
    obs = np.random.default_rng(episode["seed"]).standard_normal(
        (FLEET["episode_len"], FLEET["obs_dim"])).astype(np.float32)
    acked = np.asarray(episode["preds"], np.float32)
    mid = len(acked) // 2
    ref.reset_rows(np.asarray([0]))
    gap = 0.0
    for t in range(len(acked)):
        pred = ref.step_rows(np.asarray([0]), obs[t][None])[0]
        if t == mid:
            pred = ref.step_rows(np.asarray([0]), obs[t][None])[0]
        if t >= mid:
            gap = max(gap, float(np.abs(pred - acked[t]).max()))
    return gap


def _gateway_chaos(torch, np, serve, fleet, gw, counters, ref, tmp):
    """SIGKILL r1 under traffic with a watchdog over the fleet."""
    from blendjax_torch.btt.chaos import kill_instance

    stop_file = os.path.join(tmp, "chaos.stop")
    spec = json.dumps({"address": gw.address, "clients": FLEET["clients"],
                       "episode_len": FLEET["episode_len"], "obs_dim": FLEET["obs_dim"],
                       "seed": 7000, "timeout_ms": 3000, "stop_file": stop_file})
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--chaos-clients", spec],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    replies0 = counters.get("gateway_replies")
    _wait_for(lambda: counters.get("gateway_replies") - replies0 >= 20 * FLEET["clients"], 60,
              "gateway_chaos: traffic before the kill")
    respawns0 = counters.get("gateway_replica_respawns")
    t_kill = time.perf_counter()
    kill_instance(fleet, 1)
    _wait_for(lambda: counters.get("gateway_replica_respawns") > respawns0, 120,
              "gateway_chaos: the killed replica's first answered scrape")
    t_scrape = time.perf_counter() - t_kill
    replies1 = counters.get("gateway_replies")
    _wait_for(lambda: counters.get("gateway_replies") - replies1 >= 20 * FLEET["clients"], 60,
              "gateway_chaos: traffic after the respawn")
    open(stop_file, "w").close()
    out, err = proc.communicate(timeout=300)
    check(proc.returncode == 0, f"gateway_chaos clients exited {proc.returncode}: {err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    eps = [e for per in res["episodes"] for e in per]
    stale = [sum(e["end"] == "stale" for e in per) for per in res["episodes"]]
    acked = [e for e in eps if e["preds"]]
    # the episodes that crossed the kill first, then the rest, at most 96
    acked.sort(key=lambda e: (e["end"] != "stale" and not e["timeouts"], e["seed"] % 1000))
    chosen = acked[:96]
    gap, held = _replay_episodes(torch, np, ref, chosen)
    full = next(e for e in chosen if len(e["preds"]) >= 8)
    return {"kill_to_first_scrape_s": t_scrape,
            "episodes": len(eps), "acked_steps": sum(len(e["preds"]) for e in eps),
            "stale_errors_per_client": stale, "timeouts": sum(e["timeouts"] for e in eps),
            "client_errors": res["errors"], "replayed_episodes": len(chosen),
            "replayed_steps": held, "replay_gap": gap, "atol": FLEET_REPLAY_ATOL,
            "double_step_gap": _double_step_gap(np, ref, full),
            "counters": {k: counters.get(k) for k in (
                "gateway_replica_quarantined", "gateway_replica_respawns",
                "gateway_stale_lease_redirects", "gateway_errors")}}


def _swap_probe(serve, np, ref, addresses, obs, before_tree):
    """Open one episode on each replica, alone, and step it twice before a
    swap; ``finish(after_tree)`` steps it once after the swap and holds all
    three predictions bit-equal to the in-process flagship, eager, with
    ``before_tree`` then ``after_tree``."""
    clients = [serve.ServeClient(a, timeoutms=30000) for a in addresses]
    pre = []
    for c in clients:
        c.reset()
        pre.append([c.step(o)["pred"] for o in obs[:2]])
    caps = _captures(serve, addresses)

    def finish(after_tree):
        post = [c.step(obs[2])["pred"] for c in clients]
        for c in clients:
            c.close_episode()
            c.close()
        ref.apply_weights(before_tree)
        ref.reset_rows(np.asarray([0]))
        want = [ref.step_rows(np.asarray([0]), o[None])[0] for o in obs[:2]]
        ref.apply_weights(after_tree)
        want.append(ref.step_rows(np.asarray([0]), obs[2][None])[0])
        got = [np.stack(p + [q]) for p, q in zip(pre, post)]
        return {"bit_equal": [bool(np.array_equal(g, np.stack(want))) for g in got],
                "max_abs_diff": [float(np.abs(g - np.stack(want)).max()) for g in got],
                "captures_before": caps, "captures_after": _captures(serve, addresses)}

    return finish


def _publish_adopted(serve, pub, addresses, tree, model=None):
    """Publish ``tree`` and wait for every replica to report its version;
    returns (version, seconds from the publish to each adoption)."""
    t0 = time.perf_counter()
    v = pub.publish(tree, model=model)
    when = {}
    deadline = time.monotonic() + 120
    while len(when) < len(addresses) and time.monotonic() < deadline:
        for i, a in enumerate(addresses):
            if i not in when and _replica_stats(serve, a).get("weight_version") == v:
                when[i] = time.perf_counter() - t0
        time.sleep(0.02)
    check(len(when) == len(addresses), f"canary: every replica adopted v{v} ({when})")
    return v, [when[i] for i in range(len(addresses))]


def _drive_ctl(ctl, until, deadline_s=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        action = ctl.tick()
        if action in until:
            return action, time.monotonic() - t0
        time.sleep(0.1)
    raise SystemExit(f"chip_smoke: FAILED: the controller never reached {until}")


def _canary(torch, np, serve, fleet, fleet_kwargs, gw, pub, ref, tmp):
    from blendjax_torch.models.convert import params_to_jax
    from blendjax_torch.weights.controller import WeightBusController

    addrs = [a for a in fleet.addresses if a is not None]
    ctl = WeightBusController(gw.gateway, pub, **FLEET_CANARY)
    rng = np.random.default_rng(21)
    tree1 = params_to_jax(ref.params)
    obs = rng.standard_normal((3, FLEET["obs_dim"])).astype(np.float32)
    swaps, adoption = {}, {}
    # v1: the replicas' own seeded weights
    finish = _swap_probe(serve, np, ref, addrs, obs, tree1)
    v1, adoption["v1"] = _publish_adopted(serve, pub, addrs, tree1)
    swaps["v1"] = finish(tree1)
    _wait_for(lambda: set(gw.gateway.fleet_versions().values()) == {v1}, 30,
              "canary: the gateway scraped v1 on every replica")
    check(ctl.tick() is None and gw.gateway.stable_version == v1,
          "canary: the first version is adopted as stable")
    # v2: a seeded perturbation, promoted under traffic
    tree2 = _perturbed(np, tree1, 22)
    finish = _swap_probe(serve, np, ref, addrs, obs, tree1)
    v2, adoption["v2"] = _publish_adopted(serve, pub, addrs, tree2)
    swaps["v2"] = finish(tree2)
    _wait_for(lambda: set(gw.gateway.fleet_versions().values()) == {v2}, 30,
              "canary: the gateway scraped v2 on every replica")
    check(ctl.tick() == "canary" and gw.gateway.canary_version == v2,
          "canary: a window opened at v2")
    stop = os.path.join(tmp, "canary2.stop")
    t, out = _clients_async(gw.address, _fleet_clients_cfg(stop_file=stop), 600, 500)
    promoted, promote_s = _drive_ctl(ctl, {"promote", "rollback"})
    open(stop, "w").close()
    t.join(timeout=300)
    check("failure" not in out and not out.get("errors"), f"canary: clients under v2 ({out})")
    check(promoted == "promote" and gw.gateway.stable_version == v2,
          f"canary: v2 promoted after its healthy window ({promoted})")
    stats_v2 = gw.gateway.version_stats()
    # v3: a canary replica of its own (the same flagship and seed) on a
    # canary bus, admitted drained, so the window sees the fleet serve v2 and
    # no reply at v3 (a wedged canary): the verdict timeout rolls it back,
    # and the stable weights are republished on the fleet's bus
    from blendjax_torch.weights import WeightPublisher

    finish = _swap_probe(serve, np, ref, addrs, obs, tree2)
    canary_pub = WeightPublisher(version_base=pub.version + 1).start()
    cp = serve.ServerProcess(subscribe=canary_pub.address, **fleet_kwargs)
    try:
        with cp:
            rid = gw.gateway.add_replica(cp.address, rid="canary")
            # no client runs until the drain: the admission applies on the
            # gateway's loop, then the drain gives the canary no traffic
            _wait_for(lambda: rid in gw.gateway.replica_ids(), 10,
                      "canary: the canary replica admitted")
            gw.gateway.drain(rid)
            v3, adoption["v3"] = _publish_adopted(serve, canary_pub, [cp.address],
                                                  _perturbed(np, tree2, 23))
            _wait_for(lambda: gw.gateway.fleet_versions().get(rid) == v3, 30,
                      "canary: the gateway scraped v3 on the canary replica")
            check(ctl.tick() == "canary" and gw.gateway.canary_version == v3,
                  "canary: a window opened at v3")
            stop = os.path.join(tmp, "canary3.stop")
            t, out = _clients_async(gw.address, _fleet_clients_cfg(stop_file=stop), 600, 600)
            rolled, rollback_s = _drive_ctl(ctl, {"promote", "rollback"})
            open(stop, "w").close()
            t.join(timeout=300)
            canary_requests = gw.gateway.version_stats().get(v3, {}).get("requests", 0)
            gw.gateway.remove_replica(rid)
    finally:
        canary_pub.close()
    check("failure" not in out and not out.get("errors"), f"canary: clients under v3 ({out})")
    v4 = gw.gateway.stable_version
    check(rolled == "rollback" and gw.gateway.rejected_version == v3 and v4 == pub.version
          and canary_requests == 0,
          f"canary: v3, given no traffic, rolled back by the verdict timeout, v{v4} "
          f"republished ({rolled}, {canary_requests} canary replies)")
    t0 = time.perf_counter()
    _wait_for(lambda: all(_replica_stats(serve, a).get("weight_version") == v4 for a in addrs),
              60, f"canary: the rollback republish v{v4} reached every replica")
    adoption["v4"] = time.perf_counter() - t0
    swaps["v4"] = finish(tree2)
    stats = gw.gateway.version_stats()
    counters = {k: gw.gateway.counters.get(k) for k in (
        "weight_canary_starts", "weight_canary_routes", "weight_canary_promotions",
        "weight_canary_rollbacks")}
    counters["weight_rollback_publishes"] = pub.counters.get("weight_rollback_publishes")
    counters["weight_published"] = pub.counters.get("weight_published")
    # each replica's bus counters: torn streams re-synced, snapshots adopted
    replicas = {}
    for a in addrs:
        c = _replica_stats(serve, a)["counters"]
        replicas[a] = {k: c.get(k, 0) for k in ("weight_adopted", "weight_torn_discarded",
                                                  "weight_syncs", "weight_apply_failed")}
    return {"versions": {"v1": v1, "v2": v2, "v3": v3, "v4": v4},
            "canary_replica_ready_s": cp.ready_s,
            "snapshot_mb": sum(a.nbytes for a in _leaves(tree1)) / 1e6,
            "adoption_s": adoption, "promote_s": promote_s, "rollback_s": rollback_s,
            "version_stats_at_promote": {str(k): v for k, v in stats_v2.items()},
            "version_stats": {str(k): v for k, v in stats.items()},
            "counters": counters, "replica_bus_counters": replicas, "swaps": swaps,
            "settings": FLEET_CANARY}


def _perturbed(np, tree, seed):
    """``tree`` with seeded noise of 1e-3 added to every float leaf."""
    rng = np.random.default_rng(seed)
    if isinstance(tree, dict):
        return {k: _perturbed(np, v, rng.integers(2**31)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturbed(np, v, rng.integers(2**31)) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.kind != "f":
        return arr
    return (arr + np.float32(1e-3) * rng.standard_normal(arr.shape, dtype=np.float32)
            ).astype(arr.dtype)


def _autoscale(torch, np, serve, fleet, gw, counters, tmp):
    from blendjax_torch.autoscale import AutoscaleController
    from blendjax_torch.utils.timing import StageTimer

    timer = StageTimer()
    stop = os.path.join(tmp, "autoscale.stop")
    t, out = _clients_async(gw.address, _fleet_clients_cfg(stop_file=stop), 900, 700)
    _wait_for(lambda: len(gw.gateway.replica_ids()) == FLEET["replicas"], 10,
              "autoscale: the canary replica left the route set")
    n0 = len(gw.gateway.replica_ids())
    mem = {"before_grow": _card_memory(torch)}
    up = AutoscaleController(gw.gateway, fleet, min_replicas=n0, max_replicas=n0 + 1,
                             up_queue_depth=-1.0, cooldown_up_s=0.0, cooldown_down_s=0.0,
                             max_p99_x=1e9, counters=counters, timer=timer,
                             healthy_window_s=FLEET_AUTOSCALE["up_window_s"],
                             min_requests=FLEET_AUTOSCALE["min_requests"])
    t0 = time.monotonic()
    _drive_ctl(up, {"grow"}, 300)
    grown = up._transition["rid"]
    action, _ = _drive_ctl(up, {"scale_up", "rollback"}, 120)
    settle_up = time.monotonic() - t0
    check(action == "scale_up" and len(gw.gateway.replica_ids()) == n0 + 1,
          f"autoscale: the grown replica {grown} committed ({action})")
    mem["after_grow"] = _card_memory(torch)
    down = AutoscaleController(gw.gateway, fleet, min_replicas=n0, max_replicas=n0 + 1,
                               up_queue_depth=1e9, up_p99_ms=1e9, down_queue_depth=1e9,
                               down_p99_ms=1e9, cooldown_up_s=0.0, cooldown_down_s=0.0,
                               counters=counters, timer=timer,
                               healthy_window_s=FLEET_AUTOSCALE["down_window_s"],
                               min_requests=FLEET_AUTOSCALE["min_requests"],
                               drain_grace_s=FLEET_AUTOSCALE["drain_grace_s"])
    # the always-down controller picks its own victim (the least-loaded
    # replica, whichever it is), drains it and carries it to the retire
    check(not any(r["draining"] for r in gw.gateway.replica_snapshots().values()),
          "autoscale: no replica is draining before the scale-down")
    t0 = time.monotonic()
    decided = down.tick()
    victim = down._transition["rid"] if down._transition else None
    check(decided == "drain" and victim in gw.gateway.replica_ids(),
          f"autoscale: the always-down controller chose a replica and drained it ({decided})")
    action, _ = _drive_ctl(down, {"scale_down", "rollback"}, 120)
    settle_down = time.monotonic() - t0
    check(action == "scale_down" and len(gw.gateway.replica_ids()) == n0
          and victim not in gw.gateway.replica_ids()
          and fleet._procs[int(victim[1:])] is None,
          f"autoscale: {victim} drained and retired ({action})")
    mem["after_retire"] = _card_memory(torch)
    open(stop, "w").close()
    t.join(timeout=300)
    check("failure" not in out and not out.get("errors"),
          f"autoscale: no client-visible error through both resizes ({out.get('errors')})")
    return {"grown": grown, "retired": victim, "resize_settle_s": {"up": settle_up,
                                                                    "down": settle_down},
            "card_memory": mem, "client_steps": sum(out["steps"]),
            "client_errors": len(out["errors"]),
            "counters": {k: counters.get(k) for k in (
                "autoscale_scale_ups", "autoscale_scale_downs", "autoscale_rollbacks",
                "autoscale_replica_spawns", "autoscale_replicas_retired", "gateway_drains")}}


def _reshard(torch, np, tmp):
    """2 -> 3 shards under appends against an unresharded twin; then the new
    shard SIGKILLed mid-handoff."""
    from blendjax_torch.autoscale import reshard_replay
    from blendjax_torch.btt.chaos import kill_instance
    from blendjax_torch.btt.faults import FaultPolicy
    from blendjax_torch.replay import ShardedReplay
    from blendjax_torch.replay.service import ShardFleet
    from blendjax_torch.replay.shard_client import ReshardAborted
    from blendjax_torch.utils.timing import EventCounters

    cfg = FLEET_RESHARD
    rng = np.random.default_rng(5)
    rows = [_rs_transition(np, rng) for _ in range(64)]
    counters = EventCounters()
    policy = FaultPolicy(max_retries=1, backoff_base=0.02, backoff_max=0.1, deadline_s=2.0,
                         circuit_threshold=0, seed=3)
    with ShardFleet(2, capacity_per_shard=cfg["capacity_per_shard"],
                    data_dir=os.path.join(tmp, "a"), checkpoint_every=0) as fleet, \
            ShardFleet(2, capacity_per_shard=cfg["capacity_per_shard"],
                       data_dir=os.path.join(tmp, "b"), checkpoint_every=0) as twin_fleet:
        buf = ShardedReplay(fleet.addresses, seed=9, counters=counters, fault_policy=policy,
                            timeoutms=2000)
        twin = ShardedReplay(twin_fleet.addresses, seed=9, timeoutms=2000)
        for k in range(cfg["fill"]):
            buf.append(rows[k % len(rows)])
            twin.append(rows[k % len(rows)])
        appended = []

        def appender():
            for k in range(cfg["fill"], cfg["fill"] + cfg["during"]):
                buf.append(rows[(3 * k) % len(rows)])
                twin.append(rows[(3 * k) % len(rows)])
                appended.append(k)

        writer = threading.Thread(target=appender)
        writer.start()
        t0 = time.perf_counter()
        shard, _ = reshard_replay(buf, fleet, counters=counters)
        reshard_s = time.perf_counter() - t0
        writer.join(timeout=120)
        owned = buf.stats()["shards"]["owned_slots"]
        feeds = (_CardFeed(torch, np), _CardFeed(torch, np))
        equal = []
        for _ in range(cfg["batches"]):
            (a, ia, wa), (b, ib, wb) = feeds[0].sample(buf, RS["batch"]), \
                feeds[1].sample(twin, RS["batch"])
            equal.append(bool(np.array_equal(ia, ib) and np.array_equal(wa, wb)
                              and all(torch.equal(a[k], b[k]) for k in b)))
        on_card = all(t.is_cuda for t in feeds[0].card.values())
        # the new shard SIGKILLed between its restore-spawn and the handoff
        before = buf.stats()["shards"]["owned_slots"]
        cut = buf.clients[0].rpc("save")
        idx, addr = fleet.grow(restore_ckpt=cut["path"])
        kill_instance(fleet, idx)
        aborted = False
        try:
            buf.adopt_shard(addr, source=0, cut_seq=int(cut["seq"]), timeoutms=500)
        except ReshardAborted:
            aborted = True
        after = buf.stats()["shards"]["owned_slots"]
        retired = fleet.retire(idx)
        _, i, _ = buf.sample(RS["batch"])
        buf.close()
        twin.close()
    return {"shards": shard + 1, "reshard_s": reshard_s, "owned_slots": owned,
            "appended_during": len(appended), "draws_equal": equal, "on_card": on_card,
            "rows_copied": counters.get("autoscale_reshard_rows_copied"),
            "handoffs": counters.get("autoscale_reshard_handoffs"),
            "aborted": aborted, "aborts": counters.get("autoscale_reshard_aborts"),
            "map_before_kill": before, "map_after_abort": after, "retired": retired,
            "draws_after_abort": len(i)}


def serve_fleet_phase(torch, serve):
    """The serve fleet on the card through the reference's entry points:
    ``ServerFleet(3, model="seqformer", device="cuda", subscribe=<bus>)`` at
    :data:`FLEET`'s widths behind ``start_gateway_thread``, then
    ``start_sharded_gateway_thread(workers=2)``, ``WeightBusController`` and
    ``AutoscaleController`` over the gateway, and ``reshard_replay``.
    ``fleet_boot``: spawn-to-ready per replica, the card's memory, one
    seeded episode bit-equal on every replica.  ``gateway_scale``: 1-replica
    and 3-replica windows in turns and a direct-dial arm (no client error,
    every step on its lease's replica, a seeded episode through the gateway
    bit-equal to it dialled straight).  ``gateway_sharded``: 2 active
    workers and 1 in turns (direct dial after the rendezvous, no
    ``/dev/shm`` left).  ``gateway_chaos``: r1 SIGKILLed under a watchdog,
    the acknowledged predictions replayed on one in-process flagship.
    ``canary``: v1, v2 promoted under traffic, v3 rolled back by the verdict
    timeout and the stable weights republished; each swap's first captured
    tick bit-equal to eager, no recapture.  ``autoscale``: a fourth replica
    grown and committed, then the always-down controller's own victim
    drained and retired, no client error.
    ``reshard``: 2 -> 3 shards under appends, draws on the card bit-equal
    to an unresharded twin's, and the new shard SIGKILLed mid-handoff.  No
    kernel is on this path."""
    import tempfile

    import numpy as np

    from blendjax_torch.btt import shm_rpc
    from blendjax_torch.btt.watchdog import FleetWatchdog
    from blendjax_torch.utils.timing import EventCounters, StageTimer
    from blendjax_torch.weights import WeightPublisher

    t_phase = time.perf_counter()
    pub = WeightPublisher(counters=EventCounters()).start()
    fleet_kwargs = dict(
        model="seqformer", device=FLEET["device"], seed=FLEET["seed"],
        obs_dim=FLEET["obs_dim"], slots=FLEET["slots"], length=FLEET["length"],
        tick_ms=FLEET["tick_ms"], max_batch=FLEET["max_batch"], ready_timeout=300.0,
        extra_args=["--d-model", str(FLEET["d_model"]), "--n-heads", str(FLEET["n_heads"]),
                    "--n-layers", str(FLEET["n_layers"])])
    fleet = serve.ServerFleet(FLEET["replicas"], subscribe=pub.address, **fleet_kwargs)
    gw = None
    wd = None
    mem0 = _card_memory(torch)
    fleet.__enter__()  # spawns every replica on the card and waits for each
    try:
        mem1 = _card_memory(torch)
        ready_s = [p.ready_s for p in fleet._procs]
        addrs = list(fleet.addresses)
        caps = _captures(serve, addrs)
        obs = np.random.default_rng(77).standard_normal(
            (FLEET["episode_len"], FLEET["obs_dim"])).astype(np.float32)
        direct = [_episode_preds(serve, np, a, obs)[0] for a in addrs]
        boot = {"ready_s": ready_s, "card_memory_before": mem0, "card_memory_after": mem1,
                "captures_after_warmup": caps,
                "episode_bit_equal": [bool(np.array_equal(direct[0], d)) for d in direct]}
        emit(_stamp({"phase": "fleet_boot", **boot}))
        check(all(boot["episode_bit_equal"]),
              "fleet_boot: one seeded episode bit-equal on every replica")
        check(caps == [len(FLEET_BUCKETS)] * len(addrs),
              f"fleet_boot: every bucket of every replica captured before serving ({caps})")

        counters = EventCounters()
        gw = serve.start_gateway_thread(addrs, counters=counters, timer=StageTimer(),
                                        scrape_interval_s=FLEET["scrape_s"])
        _wait_for(lambda: all(s["pid"] is not None
                              for s in gw.gateway.replica_snapshots().values()), 30,
                  "gateway_scale: the gateway's first scrape of every replica")
        scale = _gateway_scale(serve, np, fleet, gw, counters)
        via, rep = _episode_preds(serve, np, gw.address, obs)
        straight, _ = _episode_preds(serve, np, addrs[int(rep[1:])], obs)
        scale["episode_bit_equal"] = bool(np.array_equal(via, straight))
        scale["captures_after"] = _captures(serve, addrs)
        emit(_stamp({"phase": "gateway_scale", **scale}))
        check(scale["counters"]["gateway_errors"] == 0, "gateway_scale: no client error")
        check(scale["affinity_breaks"] == 0,
              "gateway_scale: every step of a lease landed on the replica that owns it")
        check(set(scale["replica_steps"]["1"]) == {"r0"},
              "gateway_scale: the 1-replica arm served from r0 alone")
        check(scale["episode_bit_equal"],
              "gateway_scale: a seeded episode through the gateway == dialled straight")
        check(scale["captures_after"] == caps,
              "gateway_scale: no capture landed in a measured window")

        sharded = _gateway_sharded(serve, np, fleet, shm_rpc)
        emit(_stamp({"phase": "gateway_sharded", **sharded}))
        check(all(w["relays"] <= w["resets"] + w["retries"] for w in sharded["direct_windows"]),
              "gateway_sharded: after the rendezvous the clients dialled their worker directly")
        check(not any(sharded["leaked"].values()),
              "gateway_sharded: no /dev/shm object left under a worker's base")

        from blendjax_torch.serve.server import build_model

        ref = build_model(_fleet_args())
        ref.captured = False  # the replays run eager
        wd = FleetWatchdog(fleet, interval=0.2, restart=True,
                           on_death=gw.gateway.notify_replica_death,
                           on_respawn=gw.gateway.notify_replica_respawn).start()
        with tempfile.TemporaryDirectory(prefix="bjx-fleet-") as tmp:
            chaos = _gateway_chaos(torch, np, serve, fleet, gw, counters, ref, tmp)
            emit(_stamp({"phase": "gateway_chaos", **chaos}))
            check(not chaos["client_errors"], f"gateway_chaos: {chaos['client_errors']}")
            check(chaos["counters"]["gateway_replica_respawns"] >= 1,
                  "gateway_chaos: the killed replica respawned and answered a scrape")
            check(max(chaos["stale_errors_per_client"]) <= 1
                  and sum(chaos["stale_errors_per_client"]) >= 1,
                  "gateway_chaos: each client saw at most one stale-lease error, and the "
                  "victim's clients one")
            check(chaos["replay_gap"] <= FLEET_REPLAY_ATOL,
                  f"gateway_chaos: every acked prediction within {FLEET_REPLAY_ATOL} of the "
                  "episode replayed on one in-process flagship")
            check(chaos["double_step_gap"] > 10 * FLEET_REPLAY_ATOL,
                  "gateway_chaos: a double-applied step opens a gap the check would see")
            # the respawned r1 has the seeded weights again; the bus brings
            # every replica to each version from here on
            canary = _canary(torch, np, serve, fleet, fleet_kwargs, gw, pub, ref, tmp)
            emit(_stamp({"phase": "canary", **canary}))
            for name, rec in canary["swaps"].items():
                check(all(rec["bit_equal"]),
                      f"canary: the first captured tick after the {name} swap == eager "
                      f"({rec['max_abs_diff']})")
                check(rec["captures_after"] == rec["captures_before"],
                      f"canary: no recapture across the {name} swap")
            del ref
            torch.cuda.empty_cache()
            scaled = _autoscale(torch, np, serve, fleet, gw, counters, tmp)
            emit(_stamp({"phase": "autoscale", **scaled}))
            resh = _reshard(torch, np, tmp)
        emit(_stamp({"phase": "reshard", **resh}))
        check(resh["shards"] == 3 and resh["handoffs"] == 1 and all(resh["draws_equal"])
              and resh["on_card"],
              "reshard: 2 -> 3 shards, the draws on the card bit-identical to the twin's")
        check(resh["aborted"] and resh["aborts"] == 1
              and resh["map_after_abort"] == resh["map_before_kill"] and resh["retired"],
              "reshard: the killed new shard's handoff aborted whole, the map unchanged")
    finally:
        if wd is not None:
            wd.stop()
        if gw is not None:
            gw.close()
        fleet.close()
        pub.close()
    emit({"phase": "serve_fleet_seconds", "seconds": time.perf_counter() - t_phase})


# -- the parallel layer: routed and dense MoE, data/tensor-parallel ranks ------

#: the flagship with experts (``benchmarks/suite_device.py:1161-1300``,
#: ``phase_moe_compare``; 8 experts, top-2 from ``benchmarks/suite.py:246-247``)
MOE = dict(n_experts=8, moe_k=2, moe_capacity_factor=1.25, moe_aux_weight=0.01)
#: the arms, in order: (label, moe_impl, moe_dispatch)
MOE_ARMS = (("topk_sort", "topk", "sort"), ("dense", "dense", "sort"),
            ("topk_scatter", "topk", "scatter"))
#: card against CPU on the small f32 MoE model (loss, gradients, rollout)
MOE_ATOL = 1e-5
#: a token whose top-k choice differs between card and CPU passes only as
#: a tie: its k-th and (k+1)-th router probabilities closer than this
MOE_TIE = 1e-6
#: sort against scatter dispatch on the card (``tests/test_moe.py``'s limit)
MOE_DISPATCH_ATOL = 1e-6


def _moe_routes(torch, moe, run, force=None):
    """``run()`` with the routing of every routed MoE layer call recorded as
    ``moe_apply_topk`` made it: ``(probs, idx)`` on the CPU, the router
    probabilities and choice-major expert ids its ``_topk_gates`` got and
    gave, in call order.  With ``force`` (an iterator of such ids, taken
    on another device) each call routes by the next of them instead, its
    gate weights this device's probabilities at those experts."""
    calls, chosen = [], moe._topk_gates

    def recording(probs, k):
        idx, gate_w = chosen(probs, k)
        if force is not None:
            idx = next(force).to(probs.device)
            gate_w = probs.gather(1, idx.reshape(k, probs.shape[0]).T)
            gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
        calls.append((probs.detach().cpu(), idx.cpu()))
        return idx, gate_w

    moe._topk_gates = recording
    try:
        out = run()
    finally:
        moe._topk_gates = chosen
    return out, calls


def _route_gaps(card, cpu, k):
    """Tokens whose choices (in order) differ between the card's and the
    CPU's routing, each with the CPU's probability gap between the expert
    the CPU chose and the one the card chose, the largest over the choices
    that differ (for a different k-th choice, the gap between the k-th and
    (k+1)-th probability)."""
    gaps = []
    for call, ((_, ia), (pb, ib)) in enumerate(zip(card, cpu)):
        n = pb.shape[0]
        a, b = ia.reshape(k, n).T, ib.reshape(k, n).T
        for tok in (a != b).any(1).nonzero().flatten().tolist():
            gap = max(abs(float(pb[tok, b[tok, j]] - pb[tok, a[tok, j]]))
                      for j in range(k) if a[tok, j] != b[tok, j])
            gaps.append({"layer_call": call, "token": tok, "gap": gap})
    return gaps


def _moe_vs_cpu(torch, moe, seqformer, flash, pendulum):
    """The small f32 MoE model on the card (flash kernels, f32 route) and on
    the CPU (plain attention): topk loss with the aux term, its gradients,
    and a rollout, with the routing compared token by token.  Where the
    card routed a token otherwise than the CPU, the gap must be a tie, and
    the card runs again with the CPU's routing, so that the values are
    held in full either way."""
    import numpy as np

    cfg = dict(obs_dim=8, d_model=64, n_heads=2, n_layers=2, max_len=128,
               n_experts=4)
    params = seqformer.init(torch.Generator().manual_seed(0), device="cpu", **cfg)
    ep = torch.from_numpy(pendulum.simulate_episode(np.random.default_rng(1), 2, 128))
    ep = ep.to(torch.float32)
    attn = flash.make_flash_attention(causal=True, block_q="auto", block_kv="auto")
    kw = dict(compute_dtype=torch.float32, moe_impl="topk", moe_k=2,
              moe_capacity_factor=MOE["moe_capacity_factor"],
              moe_aux_weight=MOE["moe_aux_weight"])

    def run_on(dev, force=None):
        p = {k: v.to(dev) for k, v in params.items()}
        batch = {"episode": ep.to(dev)}
        (loss, grads), calls = _moe_routes(torch, moe, lambda: _grads(
            torch, lambda q: seqformer.episode_loss_fn(q, batch, attn_fn=attn, **kw), p),
            force)
        with torch.no_grad():
            roll, roll_calls = _moe_routes(torch, moe, lambda: seqformer.rollout(
                p, batch["episode"][:, :32], 16, compute_dtype=torch.float32,
                moe_impl="topk", moe_k=2), force)
        return loss, grads, calls + roll_calls, roll

    cpu = run_on("cpu")
    card = run_on("cuda")
    check(len(card[2]) == len(cpu[2]) > 0,
          f"moe card vs CPU: as many routed layer calls ({len(card[2])}, {len(cpu[2])})")
    gaps = _route_gaps(card[2], cpu[2], 2)
    if gaps:
        card = run_on("cuda", force=iter([idx for _, idx in cpu[2]]))
    loss_err = _max_diff(torch, card[0], cpu[0])
    grad_err = max(_max_diff(torch, card[1][k], g) for k, g in cpu[1].items())
    roll_err = _max_diff(torch, card[3], cpu[3])
    rec = {"phase": "moe_reference", "config": cfg, "loss_cpu": float(cpu[0]),
           "loss_err": loss_err, "grad_err": grad_err, "rollout_err": roll_err,
           "atol": MOE_ATOL, "routes_compared": len(cpu[2]),
           "route_differences": gaps, "tie_limit": MOE_TIE,
           "held_with_cpu_routing": bool(gaps)}
    emit(rec)
    for g in gaps:
        check(g["gap"] < MOE_TIE, f"moe card vs CPU: token {g['token']} routed differently "
              f"with a probability gap of {g['gap']:.3g} (not a tie)")
    check(loss_err <= MOE_ATOL and grad_err <= MOE_ATOL and roll_err <= MOE_ATOL,
          f"moe card vs CPU within {MOE_ATOL}"
          f"{' (the card on the CPU routing)' if gaps else ''}: loss {loss_err:.3g}, grads "
          f"{grad_err:.3g}, rollout {roll_err:.3g}")


def _moe_dispatch_check(torch, moe):
    """Sort and scatter dispatch on the card, f32: outputs and gradients
    within ``MOE_DISPATCH_ATOL`` under capacity pressure and without."""
    g = torch.Generator(device="cuda").manual_seed(5)
    e, d, f = 8, 256, 1024
    p = {"gate": {"w": torch.randn((d, e), generator=g, device="cuda") * 0.1,
                  "b": torch.zeros(e, device="cuda")},
         "w1": torch.randn((e, d, f), generator=g, device="cuda") * d ** -0.5,
         "b1": torch.zeros((e, f), device="cuda"),
         "w2": torch.randn((e, f, d), generator=g, device="cuda") * f ** -0.5,
         "b2": torch.zeros((e, d), device="cuda")}
    x = torch.randn((2, 256, d), generator=g, device="cuda")
    errs = {}
    for cf in (1.25, 0.5):
        outs = {}
        for dispatch in ("sort", "scatter"):
            leaves = {"gate": {m: w.clone().requires_grad_(True) for m, w in p["gate"].items()},
                      **{n: p[n].clone().requires_grad_(True) for n in ("w1", "b1", "w2", "b2")}}
            y, aux = moe.moe_apply_topk(leaves, x, torch.float32, k=2, capacity_factor=cf,
                                        dispatch=dispatch)
            (torch.mean(y * y) + 0.01 * aux["aux_loss"]).backward()
            outs[dispatch] = [y] + [leaves["gate"][m].grad for m in ("w", "b")] + [
                leaves[n].grad for n in ("w1", "b1", "w2", "b2")] + [aux["dispatch_fraction"]]
        errs[cf] = max(_max_diff(torch, a, b) for a, b in zip(outs["sort"], outs["scatter"]))
    emit({"phase": "moe_dispatch", "shape": [2, 256, d], "experts": e, "k": 2,
          "max_abs_err": {str(k): v for k, v in errs.items()}, "atol": MOE_DISPATCH_ATOL})
    check(all(v <= MOE_DISPATCH_ATOL for v in errs.values()),
          f"moe sort and scatter dispatch agree within {MOE_DISPATCH_ATOL}: {errs}")


def moe_phase(torch, seqformer, flash, worldmodel, pendulum, TrainState):
    """The flagship SeqFormer with experts, three arms through K2-K4, each
    eager and captured in turns as the seqformer phase; returns each flash
    kernel's launches in the arms' turns, in all and by route."""
    import functools

    import numpy as np

    from blendjax_torch.models import moe

    _moe_dispatch_check(torch, moe)
    _moe_vs_cpu(torch, moe, seqformer, flash, pendulum)

    cfg = {k: SEQ[k] for k in ("obs_dim", "d_model", "n_heads", "n_layers")}
    rng = np.random.default_rng(0)
    batches = [_episodes(torch, pendulum, rng, SEQ["batch"]) for _ in range(8)]
    attn = worldmodel.make_attn("flash", SEQ["seq_len"])
    launched = {n: 0 for n in FLASH_KERNELS}
    routes = {n: {"tc": 0, "f32": 0} for n in FLASH_KERNELS}

    def make_state():
        return TrainState.create(seqformer.init(
            torch.Generator(device="cuda").manual_seed(0), max_len=SEQ["seq_len"],
            n_experts=MOE["n_experts"], device="cuda", **cfg), lr=SEQ["lr"])

    def counts(zero=False):
        if zero:
            _zero_flash_counts(flash)
        return {"launches": {n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS},
                "launches_by_route": _route_counts(flash)}

    arms = {}
    for label, impl, dispatch in MOE_ARMS:
        t0 = time.perf_counter()
        routing = dict(moe_impl=impl, moe_k=MOE["moe_k"],
                       moe_capacity_factor=MOE["moe_capacity_factor"], moe_dispatch=dispatch)
        loss = functools.partial(seqformer.episode_loss_fn, attn_fn=attn,
                                 moe_aux_weight=MOE["moe_aux_weight"], **routing)
        turns = _forms(torch, "moe_" + label, make_state, loss, batches, counts,
                       {f"{n}_tc_kernel": getattr(flash, n + "_cuda") for n in FLASH_KERNELS})
        _check_forms("moe_" + label, turns)
        for rec in turns:
            for n in FLASH_KERNELS:
                launched[n] += rec["launches"]["launches"][n]
                for route, c in rec["launches"]["launches_by_route"][n].items():
                    routes[n][route] += c
            check(all(r == {"tc": SEQ["n_layers"] * len(batches), "f32": 0}
                      for r in rec["launches"]["launches_by_route"].values()),
                  f"moe {label} {rec['form']}: every forward, dQ and dK/dV launch took the "
                  "tensor-core route, one per layer and step")
        stats = None
        if impl == "topk":
            with torch.no_grad():
                state = make_state()
                stats = seqformer.moe_stats(
                    state.params, seqformer.make_episode_batch(batches[0]["episode"]),
                    attn_fn=attn, moe_k=MOE["moe_k"],
                    moe_capacity_factor=MOE["moe_capacity_factor"], moe_dispatch=dispatch)
                stats = {k: float(v) for k, v in stats.items()}
                del state
            torch.cuda.empty_cache()
        forms = _form_summary(turns)
        flops = seqformer.train_flops(SEQ["batch"], SEQ["seq_len"], **cfg,
                                      n_experts=MOE["n_experts"], moe_impl=impl,
                                      moe_k=MOE["moe_k"],
                                      moe_capacity_factor=MOE["moe_capacity_factor"])
        med = forms["captured"]["median_step_ms"]
        arms[label] = {"moe_impl": impl, "dispatch": dispatch, "params": turns[0]["params"],
                       "losses": turns[1]["losses"], "forms": forms,
                       "median_step_ms": med, "train_flops": flops,
                       "model_tflop_per_s": flops / (med * 1e-3) / 1e12,
                       "moe_stats": stats, "seconds": time.perf_counter() - t0}
    rec = {"phase": "moe", "config": {**SEQ, **MOE}, "arms": arms,
           "captured_match": CAPTURED_MATCH,
           "topk_over_dense": arms["topk_sort"]["median_step_ms"]
           / arms["dense"]["median_step_ms"],
           "topk_scatter_over_sort": arms["topk_scatter"]["median_step_ms"]
           / arms["topk_sort"]["median_step_ms"],
           "launches": launched}
    emit(rec)
    for label in ("topk_sort", "topk_scatter"):
        frac = arms[label]["moe_stats"]["dispatch_fraction"]
        check(0 < frac <= 1, f"moe {label}: a measured dispatch fraction in (0, 1]")
    return launched, routes


#: the dp phase: ranks on the one card, items each rank streams, the held
#: check's steps, and its limits (f32 compute; each rank's half batch goes
#: through the whole model and the all-reduce averages the halves'
#: gradients, in another order than one process over the whole batch: Adam
#: moves a parameter by about lr = 1e-3 a step, and the held parameters
#: may differ by 5% of one step)
DP = dict(ranks=2, producers=2, items=64, local_batch=4, steps=4, param_atol=5e-5,
          loss_rtol=1e-5, timeout_s=150)


def dp_rank_main(spec):
    """One rank of the dp phase (``python3 chip_smoke.py --dp-rank
    '<json>'``), on ``cuda:0`` in a gloo process group with the other: its
    2 producers' frames through ``BatchLoader(shard=(rank, 2))`` and
    ``TorchStream(sharding=data_sharding(mesh))`` into
    ``datagen.train_on_stream(mesh=)`` (K1 inside the loss); then the held
    check, ``DP["steps"]`` data-parallel f32 steps on a seeded global batch
    against one process's eager steps (rank 0 computes them); then the
    same for a ``{"model": 2}`` tensor-parallel step with
    ``detector_rules()``.  Prints one JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from blendjax_torch import btt, datagen
    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.models import convert, detector
    from blendjax_torch.models.train import TrainState, make_train_step
    from blendjax_torch.ops import image
    from blendjax_torch.parallel import (
        data_mesh,
        data_sharding,
        detector_rules,
        make_mesh,
        make_sharded_train_step,
        replicated,
    )

    # a rank that crashes, or sticks in a collective, prints every thread's
    # stack (the latter before the phase's limit, then exits), so the phase
    # reports where it stood
    cfg, stage = _rank_world(spec, "dp", DP["timeout_s"])
    rank, world = cfg["rank"], cfg["world"]
    out = {"rank": rank}
    try:
        mesh = data_mesh()
        stage("mesh made")
        out["mesh"] = {"device_type": mesh.device_type, "shape": list(mesh.shape),
                       "device": torch.cuda.current_device()}
        _fake_blender()
        image.decode_frames_cuda.launches = 0
        with btt.BlenderLauncher(scene="", script=str(datagen.FRAMES_SCRIPT),
                                 num_instances=DP["producers"], named_sockets=["DATA"],
                                 start_port=cfg["start_port"], background=True,
                                 seed=rank) as bl:
            stage("producers up")
            ds = btt.RemoteIterableDataset(bl.launch_info.addresses["DATA"],
                                           max_items=DP["items"],
                                           item_transform=datagen.item_transform)
            with btt.TorchStream(ds, batch_size=DP["local_batch"], num_workers=2,
                                 sharding=data_sharding(mesh), shard=(rank, world)) as stream:
                t0 = time.perf_counter()
                stage("streaming")
                _, losses = datagen.train_on_stream(stream, mesh=mesh, log_every=0)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        out["stream"] = {"batches": len(losses), "losses": losses, "seconds": seconds,
                         "global_items_per_s": len(losses) * DP["local_batch"] * world
                         / seconds, "decode_u8": image.decode_frames_cuda.launches}

        def held(mesh, sharding, rows, rules, label):
            """``DP["steps"]`` sharded f32 steps against one process's eager
            steps on the whole batch (each rank runs them, and holds its own
            shard of every parameter to them: no gather needed)."""
            g = torch.Generator(device="cuda").manual_seed(7)
            frames = torch.randint(0, 256, MAIN_SHAPE, dtype=torch.uint8, device="cuda",
                                   generator=g)
            xy = torch.rand((MAIN_SHAPE[0], 8, 2), generator=g, device="cuda")
            loss = datagen.make_loss(torch.float32)
            init = detector.init(torch.Generator(device="cuda").manual_seed(0))
            init_sharded, step = make_sharded_train_step(loss, mesh, rules=rules)
            stage(f"{label}: placing the state")
            # a state's parameters are updated in place, and a replicated
            # DTensor shares its local tensor: the reference keeps its own
            state = init_sharded({k: v.clone() for k, v in init.items()})
            batch = put_batch({"image": frames[rows], "xy": xy[rows]}, sharding)
            launches0 = image.decode_frames_cuda.launches
            stage(f"{label}: stepping")
            dp_losses, dp_ms = [], []
            for _ in range(DP["steps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, value = step(state, batch)
                dp_losses.append(float(value))
                dp_ms.append((time.perf_counter() - t0) * 1e3)
            launched = image.decode_frames_cuda.launches - launches0
            dist.barrier()
            ref = TrainState.create({k: v.clone() for k, v in init.items()})
            ref_step = make_train_step(loss, capture=False)
            ref_losses, ref_ms = [], []
            for _ in range(DP["steps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref, value = ref_step(ref, {"image": frames, "xy": xy})
                ref_losses.append(float(value))
                ref_ms.append((time.perf_counter() - t0) * 1e3)

            def shard_of(whole, dt):
                for mesh_dim, placement in enumerate(dt.placements):
                    if placement.is_shard():
                        whole = whole.chunk(dt.device_mesh.size(mesh_dim), dim=placement.dim)[
                            dt.device_mesh.get_local_rank(mesh_dim)]
                return whole

            out[label] = {
                "losses": dp_losses, "step_ms": dp_ms, "decode_u8": launched,
                "single_losses": ref_losses, "single_step_ms": ref_ms,
                "param_max_abs_diff": max(
                    (v.to_local() - shard_of(ref.params[k].detach(), v)).abs().max().item()
                    for k, v in state.params.items()),
                "loss_max_rel_diff": max(abs(a - b) / abs(b)
                                         for a, b in zip(dp_losses, ref_losses)),
                "placements": {k: [repr(p) for p in v.placements]
                               for k, v in state.params.items()
                               if k.startswith(("fc", "head"))}}
            if label == "tp":
                out[label]["gather"] = tp_gather(state, shard_of)
            dist.barrier()

        def tp_gather(state, shard_of):
            """The TP state's parameters and Adam moments through
            ``convert.train_state_arrays`` (c10d's all-gather,
            ``sharding.gather_whole``): each whole array's share of this rank
            must be bit-equal to its local shard, so the arrays are the
            ranks' shards put together."""
            stage("tp: gathering the state")
            arrays = convert.train_state_arrays(state)
            names = convert.jax_order(state.params)
            adam = [state.optimizer.state[state.params[n]] for n in names]
            tensors = ([state.params[n] for n in names] + [a["exp_avg"] for a in adam]
                       + [a["exp_avg_sq"] for a in adam])
            p = len(names)
            leaves = list(arrays[:p]) + list(arrays[p + 1:3 * p + 1])
            equal, sharded = True, 0
            for t, arr in zip(tensors, leaves):
                whole = torch.from_numpy(np.ascontiguousarray(convert._from_jax(arr)))
                local = t.to_local().detach().cpu()
                sharded += int(any(q.is_shard() for q in t.placements))
                equal &= tuple(whole.shape) == tuple(t.shape) and torch.equal(
                    shard_of(whole, t), local)
            return {"leaves": len(leaves), "sharded": sharded, "bit_equal": bool(equal)}

        local = MAIN_SHAPE[0] // world
        stage("held dp")
        held(mesh, data_sharding(mesh), slice(rank * local, (rank + 1) * local), {}, "dp")
        stage("held tp")
        tp_mesh = make_mesh({"model": world})
        held(tp_mesh, replicated(tp_mesh), slice(None), detector_rules(), "tp")
    finally:
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    stage("done")
    print(json.dumps(out), flush=True)
    return 0


def dp_phase(torch):
    """Two rank processes on ``cuda:0`` over gloo (NCCL refuses two ranks
    on one device): :func:`dp_rank_main` in each.  Checks both ranks'
    stream and held steps; returns the K1 launches both made."""
    port, start = _port_block(1), _port_block(DP["ranks"] * DP["producers"] + 2)
    t0 = time.perf_counter()
    outs = _spawn_ranks("--dp-rank", [
        {"rank": r, "world": DP["ranks"], "port": port, "start_port": start + r * DP["producers"]}
        for r in range(DP["ranks"])], DP["timeout_s"], "dp")
    r0, r1 = outs
    rec = {"phase": "dp", "ranks": DP["ranks"], "config": DP, "seconds": time.perf_counter() - t0,
           "mesh": r0["mesh"], "stream": [o["stream"] for o in outs],
           "dp": [o["dp"] for o in outs], "tp": [o["tp"] for o in outs],
           "dp_step_ms": statistics.median(r0["dp"]["step_ms"][1:]),
           "single_step_ms": statistics.median(r0["dp"]["single_step_ms"][1:]),
           "decode_u8_by_rank": [o["stream"]["decode_u8"] + o["dp"]["decode_u8"]
                                 + o["tp"]["decode_u8"] for o in outs]}
    emit(rec)
    check(r0["mesh"]["device_type"] == "cuda", "dp: the mesh is on the card")
    for o in outs:
        s = o["stream"]
        check(s["batches"] == DP["items"] // DP["ranks"] // DP["local_batch"],
              f"dp rank {o['rank']}: its shard of the stream delivered every batch")
        check(all(math.isfinite(v) for v in s["losses"]), f"dp rank {o['rank']}: losses finite")
        check(s["decode_u8"] >= 1,
              f"dp rank {o['rank']}: K1 launched inside the loss on this rank's stream")
    check(r0["stream"]["losses"] == r1["stream"]["losses"],
          "dp: both ranks saw one loss per step (the global batch's)")
    check(r0["dp"]["losses"] == r1["dp"]["losses"], "dp: the held losses agree across ranks")
    check(r0["tp"]["losses"] == r1["tp"]["losses"], "tp: the held losses agree across ranks")
    for o in outs:
        g = o["tp"]["gather"]
        check(g["bit_equal"] and g["sharded"] >= 3,
              f"tp rank {o['rank']}: the TP state's arrays through train_state_arrays (c10d "
              f"all-gather) are the ranks' shards put together, bit for bit ({g})")
    for label in ("dp", "tp"):
        for o in outs:
            r = o[label]
            check(r["decode_u8"] == DP["steps"],
                  f"{label} rank {o['rank']}: K1 launched inside each held step's loss")
            check(r["param_max_abs_diff"] <= DP["param_atol"]
                  and r["loss_max_rel_diff"] <= DP["loss_rtol"],
                  f"{label} rank {o['rank']}: {DP['steps']} sharded steps within "
                  f"{DP['param_atol']} (params) and {DP['loss_rtol']} (losses, relative) of "
                  f"one process's: {r['param_max_abs_diff']:.3g}, "
                  f"{r['loss_max_rel_diff']:.3g}")
    return sum(rec["decode_u8_by_rank"])


def _spawn_ranks(flag, specs, timeout_s, label, script=__file__):
    """Run ``python3 <script> <flag> '<spec>'`` (this file by default) once
    per spec, the ranks of one gloo world on ``cuda:0``; returns each rank's
    last stdout line, parsed.  A rank that fails or overstays fails the
    phase with its stderr's tail."""
    import tempfile

    logs = tempfile.mkdtemp(prefix=f"bjx-{label}-")
    procs = []
    for rank, spec in enumerate(specs):
        # output to files, not pipes: a rank's producers inherit its
        # descriptors, and a pipe they hold open would outlive the rank
        with open(os.path.join(logs, f"{rank}.out"), "w") as out, \
                open(os.path.join(logs, f"{rank}.err"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script), flag, json.dumps(spec)],
                stdout=out, stderr=err, cwd=REPO, start_new_session=True))
    t0 = time.perf_counter()
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, timeout_s + 10 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = []
    for rank, p in enumerate(procs):
        with open(os.path.join(logs, f"{rank}.err")) as f:
            err = "\n".join(ln for ln in f.read().splitlines() if "redistribut" not in ln)
        with open(os.path.join(logs, f"{rank}.out")) as f:
            stdout = f.read()
        check(p.returncode == 0, f"{label} rank {rank} exited {p.returncode}: {err[-6000:]}")
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    shutil.rmtree(logs, ignore_errors=True)
    return outs


def _rank_world(spec, label, timeout_s):
    """A rank process's start: its gloo process group on ``cuda:0`` with the
    others, full float32 for the f32 checks, and a stack dump (then exit)
    if it sticks past the phase's limit.  Returns ``(cfg, stage)``: the
    rank's spec, and ``stage(name)``, which logs its progress to stderr."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    cfg = json.loads(spec)
    rank, world = cfg["rank"], cfg["world"]
    faulthandler.enable()
    faulthandler.dump_traceback_later(timeout_s - 20, exit=True)
    t_rank = time.perf_counter()

    def stage(name):
        print(f"{label} rank {rank}: {name} at {time.perf_counter() - t_rank:.1f} s",
              file=sys.stderr, flush=True)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{cfg['port']}",
                            rank=rank, world_size=world)
    stage("joined")
    return cfg, stage


#: the ring phase: 2 rank processes on ``cuda:0`` over gloo, mesh {"seq": 2}.
#: bf16 schemes against one process's K2-K4 on the whole sequence: values
#: within ``value_atol``, each q/k/v gradient within ``grad_rtol`` of the
#: largest entry of the rank's own rows of the reference (the ring combines
#: the kernels' f32 partials in f32 and rounds once to bf16, the single
#: kernel rounds its own f32 sum once: they differ by bf16 roundings, 2^-8
#: of an O(1) value; a first run on an H100 read 3.9e-3 and 2.9e-3); the
#: f32 plain ring against the plain full attention within the reference's
#: 2e-5 and 5e-4.  The flagship's ``steps`` Adam steps: losses within
#: ``loss_rtol`` (read: 2.9e-5); the first step's gradient within
#: ``grad_rtol`` in norm, relative to the reference's (per tensor, a bias
#: whose gradient is zero but for rounding, as a key bias's is under a
#: softmax, would compare rounding with rounding); and the parameters within
#: ``param_atol`` wherever every step's gradient is well determined, its
#: gap to the reference's under 1/``grad_margin`` of its size: there Adam's
#: m/sqrt(v) agree within about 2/``grad_margin``, so each step within
#: 2 lr/``grad_margin``.  Elsewhere a gradient at rounding level can turn
#: Adam's step (about lr) around; ``well_share`` is the least share of the
#: parameters that the held set must cover.
RING = dict(ranks=2, window=128, reps=5, value_atol=1e-2, grad_rtol=1e-2,
            f32_value_atol=2e-5, f32_grad_atol=5e-4, steps=4, loss_rtol=1e-4,
            grad_margin=100, param_atol=1e-5, well_share=0.5, timeout_s=300)
#: (label, impl, causal, window) of the bf16 schemes
RING_CASES = (("ring_flash_causal", "ring_flash", True, None),
              ("ring_flash", "ring_flash", False, None),
              ("zigzag_flash_causal", "zigzag_flash", True, None),
              ("ulysses_flash_causal", "ulysses_flash", True, None),
              ("ring_flash_window128", "ring_flash", True, RING["window"]))


def _ms_median(torch, fn, reps, barrier=None):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ring_flagship(torch, mesh, cols, seed=0):
    """The flagship SeqFormer's ``RING["steps"]`` ring_flash Adam steps on
    this rank's ``cols`` of the sequence against one process's eager steps
    on the whole sequence, from the parameters ``seqformer.init`` draws
    from ``seed`` and episodes drawn from ``seed``; both sides run in this
    rank process, so a patch of the model applies to both.  Returns the
    record :func:`ring_phase` checks, with the flash kernels' launches and
    the layer norm kernels' (K5) in the sharded steps."""
    import functools

    import numpy as np
    import torch.distributed as dist

    from blendjax_torch.btb import pendulum
    from blendjax_torch.models import seqformer
    from blendjax_torch.models.train import TrainState, make_train_step
    from blendjax_torch.ops import flash_attention as flash
    from blendjax_torch.ops import layer_norm as ln
    from blendjax_torch.parallel import make_seqformer_train_step

    s = mesh.get_local_rank("seq")
    wcfg = {k: SEQ[k] for k in ("obs_dim", "d_model", "n_heads", "n_layers")}
    init = seqformer.init(torch.Generator(device="cuda").manual_seed(seed),
                          max_len=SEQ["seq_len"], device="cuda", **wcfg)
    rng = np.random.default_rng(seed)
    episodes = [_episodes(torch, pendulum, rng, SEQ["batch"])["episode"]
                for _ in range(RING["steps"])]
    batches = [seqformer.make_episode_batch(ep) for ep in episodes]
    init_sharded, step, sharding = make_seqformer_train_step(
        mesh, lr=SEQ["lr"], attn_impl="ring_flash")
    from blendjax_torch.btt.prefetch import put_batch

    state = init_sharded({k: x.clone() for k, x in init.items()})
    names = list(init)
    _zero_flash_counts(flash)
    ln_before = {n: getattr(ln, n + "_cuda").launches for n in LN_KERNELS}
    losses, step_ms, step_grads = [], [], []
    for batch in batches:
        local = put_batch({k: x[:, cols].contiguous() for k, x in batch.items()}, sharding)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, local)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_grads.append([state.params[k].grad.to_local().clone() for k in names])
    torch.cuda.synchronize()
    launched = {n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS}
    routes = _route_counts(flash)
    ln_launched = {n: getattr(ln, n + "_cuda").launches - ln_before[n] for n in LN_KERNELS}
    try:  # the sharded step runs eager: a capture request raises
        make_train_step(lambda p, x: p["head.b"].sum(), capture=True)(state, {})
        capture = "ran"
    except RuntimeError as exc:
        capture = str(exc)
    ref_losses, ref_ms = [], []
    for turn in range(RING["ranks"]):  # each rank's reference alone on the card
        dist.barrier()
        if turn != s:
            continue
        ref = TrainState.create({k: x.clone() for k, x in init.items()}, lr=SEQ["lr"])
        loss_fn = functools.partial(
            seqformer.loss_fn, attn_fn=flash.make_flash_attention(
                causal=True, block_q="auto", block_kv="auto"))
        ref_step = make_train_step(loss_fn, capture=False)
        wells, first_gap, first_norm, worst = [True] * len(names), 0.0, 0.0, None
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, value = ref_step(ref, batch)
            ref_losses.append(float(value))
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            for j, k in enumerate(names):
                g = ref.params[k].grad
                gap = (step_grads[i][j] - g).abs()
                if i == 0:
                    first_gap += float(gap.square().sum())
                    first_norm += float(g.square().sum())
                    rel = (gap.max() / g.abs().max()).item()
                    if worst is None or rel > worst[1]:
                        worst = (k, rel, g.abs().max().item())
                wells[j] = wells[j] & (g.abs() >= RING["grad_margin"] * gap)
        torch.cuda.synchronize()
        gaps = [(state.params[k].to_local() - ref.params[k].detach()).abs() for k in names]
        well_gap = max(gp[w].max().item() if w.any() else 0.0
                       for gp, w in zip(gaps, wells))
        well_share = sum(int(w.sum()) for w in wells) / sum(w.numel() for w in wells)
        gaps = torch.cat([gp.reshape(-1) for gp in gaps])
    del step_grads
    dist.barrier()
    return {
        "seed": seed, "losses": losses, "single_losses": ref_losses, "step_ms": step_ms,
        "single_step_ms": ref_ms, "launches": launched, "launches_by_route": routes,
        "ln_launches": ln_launched, "capture": capture,
        "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "first_grad_err": math.sqrt(first_gap / first_norm),
        "first_grad_worst_tensor": {"name": worst[0], "max_gap_over_max": worst[1],
                                    "max_abs_grad": worst[2]},
        "param_max_abs_diff_where_well": well_gap, "well_share": well_share,
        "param_max_abs_diff": gaps.max().item(),
        "param_p999_abs_diff": torch.quantile(gaps[::97].float(), 0.999).item(),
        "param_median_abs_diff": gaps[::97].median().item(),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def ring_flagship_ok(fl):
    """Whether a :func:`ring_flagship` record is within :data:`RING`'s
    limits."""
    return (fl["loss_max_rel_diff"] <= RING["loss_rtol"]
            and fl["first_grad_err"] <= RING["grad_rtol"]
            and fl["param_max_abs_diff_where_well"] <= RING["param_atol"]
            and fl["well_share"] >= RING["well_share"])


def ring_rank_main(spec):
    """One rank of the ring phase (``python3 chip_smoke.py --ring-rank
    '<json>'``): the bf16 flash schemes on this rank's half of the flagship
    attention shape against one process's K2-K4 on the whole sequence, with
    the kernels' launches by route and the rotations counted per case; the
    f32 plain ring against the plain full attention; then the flagship
    SeqFormer's ring_flash step against one process's eager steps.  Prints
    one JSON line."""
    import functools

    import torch
    import torch.distributed as dist

    cfg, stage = _rank_world(spec, "ring", RING["timeout_s"])
    from blendjax_torch.ops import flash_attention as flash
    from blendjax_torch.parallel import make_mesh, make_ring_attention
    from blendjax_torch.parallel import p2p
    from blendjax_torch.parallel.ring_attention import full_attention

    out = {"rank": cfg["rank"]}
    try:
        mesh = make_mesh({"seq": RING["ranks"]})
        s = mesh.get_local_rank("seq")
        b, t, h, d = FLASH_SHAPE
        cols = slice(s * t // RING["ranks"], (s + 1) * t // RING["ranks"])
        g = torch.Generator(device="cuda").manual_seed(11)
        q, k, v, do = (torch.randn((b, t, h, d), generator=g, device="cuda") for _ in range(4))

        def grads_of(attn, qkv, rows):
            x = [y[:, rows].detach().clone().requires_grad_(True) for y in qkv]
            o = attn(*x)
            (o.float() * do[:, rows]).sum().backward()
            return o.detach(), [y.grad for y in x]

        def inner_flash(q, k, v, causal=False, scale=None, window=None):
            blk = flash.flash_block_size(q.shape[1])
            return flash.flash_attention(q, k, v, causal, scale, blk, blk, window)

        def compare(o, gr, ref_o, ref_gr):
            return {"value_err": (o.float() - ref_o[:, cols].float()).abs().max().item(),
                    "grad_err": max((a.float() - r[:, cols].float()).abs().max().item()
                                    / r[:, cols].float().abs().max().item()
                                    for a, r in zip(gr, ref_gr))}

        bf = [x.to(torch.bfloat16) for x in (q, k, v)]
        out["cases"] = {}
        for label, impl, causal, window in RING_CASES:
            stage(label)
            attn = make_ring_attention(mesh, causal=causal,
                                       impl="ulysses" if impl == "ulysses_flash" else impl,
                                       inner_attn=inner_flash if impl == "ulysses_flash" else None,
                                       window=window)
            single = functools.partial(inner_flash, causal=causal, window=window)
            ref_o, ref_gr = grads_of(single, bf, slice(None))
            _zero_flash_counts(flash)
            p2p.reset_counts()
            o, gr = grads_of(attn, bf, cols)
            torch.cuda.synchronize()
            rec = {"launches": {n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS},
                   "launches_by_route": _route_counts(flash), "p2p": dict(p2p.counts),
                   **compare(o, gr, ref_o, ref_gr)}
            rec["ms"] = _ms_median(torch, lambda: grads_of(attn, bf, cols), RING["reps"],
                                   barrier=dist.barrier)
            dist.barrier()
            if s == 0:  # one process alone on the card
                rec["single_ms"] = _ms_median(torch, lambda: grads_of(single, bf, slice(None)),
                                              RING["reps"])
            dist.barrier()
            out["cases"][label] = rec

        stage("f32 plain ring")
        p2p.reset_counts()
        o, gr = grads_of(make_ring_attention(mesh, causal=True, impl="ring"), [q, k, v], cols)
        ref_o, ref_gr = grads_of(functools.partial(full_attention, causal=True), [q, k, v],
                                 slice(None))
        out["f32_ring"] = {"value_err": (o - ref_o[:, cols]).abs().max().item(),
                           "grad_err": max((a - r[:, cols]).abs().max().item()
                                           for a, r in zip(gr, ref_gr)),
                           "p2p": dict(p2p.counts)}
        del q, k, v, do, bf

        stage("flagship ring_flash step")
        out["flagship"] = ring_flagship(torch, mesh, cols)
    finally:
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    stage("done")
    print(json.dumps(out), flush=True)
    return 0


def ring_phase(torch):
    """The ``ring`` phase: :func:`ring_rank_main` in 2 rank processes.
    Checks every case on both ranks; returns the flash kernels' launches and
    launches by route that both ranks made, the layer norm kernels'
    launches in both ranks' sharded flagship steps, and the messages of the
    flagship steps that fell outside :data:`RING`'s limits, for the caller
    to fail on once its other phases have run (the loss limit lies within
    the spread of rounding over seeds: ``probes/ring_norm.py``)."""
    t0 = time.perf_counter()
    port = _port_block(1)
    outs = _spawn_ranks("--ring-rank", [{"rank": r, "world": RING["ranks"], "port": port}
                                        for r in range(RING["ranks"])],
                        RING["timeout_s"], "ring")
    from blendjax_torch.parallel import p2p

    rec = {"phase": "ring", "config": RING, "ranks": RING["ranks"],
           "seconds": time.perf_counter() - t0, "p2p_cuda_routes": p2p.CUDA_ROUTES,
           "cases": {label: [o["cases"][label] for o in outs] for label, *_ in RING_CASES},
           "f32_ring": [o["f32_ring"] for o in outs], "flagship": [o["flagship"] for o in outs]}
    emit(rec)
    launched = {n: 0 for n in FLASH_KERNELS}
    routes = {n: {"tc": 0, "f32": 0} for n in FLASH_KERNELS}
    ln_launched = {n: 0 for n in LN_KERNELS}
    flagship_failures = []
    for o in outs:
        r = o["rank"]
        for label, *_ in RING_CASES:
            c = o["cases"][label]
            check(c["value_err"] <= RING["value_atol"] and c["grad_err"] <= RING["grad_rtol"],
                  f"ring {label} rank {r}: output within {RING['value_atol']} and gradients "
                  f"within {RING['grad_rtol']} (of the largest) of one process's K2-K4: "
                  f"{c['value_err']:.3g}, {c['grad_err']:.3g}")
            for n in FLASH_KERNELS:
                check(c["launches"][n] >= 1 and c["launches_by_route"][n]["f32"] == 0
                      and c["launches_by_route"][n]["tc"] == c["launches"][n],
                      f"ring {label} rank {r}: {n} launched, every launch on the tc route")
                launched[n] += c["launches"][n]
                routes[n]["tc"] += c["launches_by_route"][n]["tc"]
        for label in ("ring_flash_causal", "ring_flash", "zigzag_flash_causal",
                      "ring_flash_window128"):
            check(o["cases"][label]["p2p"]["rotate"] >= 1,
                  f"ring {label} rank {r}: the ring rotated")
        check(o["cases"]["ulysses_flash_causal"]["p2p"]["all_to_all"] >= 6,
              f"ring ulysses rank {r}: q, k, v and the output went through the all-to-all")
        f = o["f32_ring"]
        check(f["value_err"] <= RING["f32_value_atol"] and f["grad_err"] <= RING["f32_grad_atol"],
              f"ring f32 plain ring rank {r}: within {RING['f32_value_atol']} (values) and "
              f"{RING['f32_grad_atol']} (gradients) of full attention: {f['value_err']:.3g}, "
              f"{f['grad_err']:.3g}")
        fl = o["flagship"]
        check(all(math.isfinite(x) for x in fl["losses"]), f"ring flagship rank {r}: finite")
        if not ring_flagship_ok(fl):
            flagship_failures.append(
                f"ring flagship rank {r}: {RING['steps']} ring_flash steps within "
                f"{RING['loss_rtol']} (losses, relative) and {RING['grad_rtol']} (the first "
                f"step's gradient, in norm, relative) of one process's, the parameters "
                f"within {RING['param_atol']} where every gradient is within "
                f"1/{RING['grad_margin']} of its own, on at least {RING['well_share']} of them: "
                f"{fl['loss_max_rel_diff']:.3g}, {fl['first_grad_err']:.3g}, "
                f"{fl['param_max_abs_diff_where_well']:.3g} on {fl['well_share']:.3g}")
        check("cannot capture" in fl["capture"], f"ring flagship rank {r}: eager, no capture")
        norms = (2 * SEQ["n_layers"] + 1) * RING["steps"]
        check(all(fl["ln_launches"][n] == norms for n in LN_KERNELS),
              f"ring flagship rank {r}: every layer norm of the sharded steps through K5, "
              f"{norms} forward and backward ({fl['ln_launches']})")
        for n in LN_KERNELS:
            ln_launched[n] += fl["ln_launches"][n]
        for n in FLASH_KERNELS:
            check(fl["launches"][n] >= SEQ["n_layers"] * RING["steps"]
                  and fl["launches_by_route"][n]["tc"] == fl["launches"][n],
                  f"ring flagship rank {r}: {n} launched on the tc route in every layer")
            launched[n] += fl["launches"][n]
            routes[n]["tc"] += fl["launches_by_route"][n]["tc"]
    check(outs[0]["flagship"]["losses"] == outs[1]["flagship"]["losses"],
          "ring flagship: one loss per step on both ranks")
    return launched, routes, ln_launched, flagship_failures


#: the rl_dp phase: 2 rank processes on ``cuda:0``, mesh {"data": 2}, each
#: rank's FleetSet of ``producers`` cartpole producers.  The held update: a
#: seeded ``held_t``-step rollout of ``held_envs`` envs (rank 0's real rows
#: and rank 1's, padded to rank 0's count) through one sharded update against
#: one process's: the loss within 1e-6 (plus 1e-5 relative), the gradients
#: within 1e-5, the parameters within 1e-5 wherever the single process's
#: gradient is at least 1e-6 (below that Adam's first step, g/(|g| + eps),
#: turns a rounding of g into a change of up to lr)
RL_DP = dict(ranks=2, producers=2, rollout=32, updates=8, iterations=3, horizon=32,
             held_envs=(4, 2), held_t=32, loss_atol=1e-6, grad_atol=1e-5, param_atol=1e-5,
             timeout_s=200)


def rl_dp_rank_main(spec):
    """One rank of the rl_dp phase (``python3 chip_smoke.py --rl-dp-rank
    '<json>'``): the held sharded update against one process's, then its
    own FleetSet of cartpole producers through ``ActorLearner(mesh=)`` and
    ``control.train_reinforce(mesh=)``; rank 0 then runs the same alone
    (no mesh) for the rates.  Prints one JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    cfg, stage = _rank_world(spec, "rl_dp", RL_DP["timeout_s"])
    from blendjax_torch import control
    from blendjax_torch.btt.prefetch import put_batch
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.models.train import TrainState, make_train_step
    from blendjax_torch.parallel import FleetSet, data_sharding, make_mesh

    rank = cfg["rank"]
    out = {"rank": rank}
    try:
        mesh = make_mesh({"data": RL_DP["ranks"]})
        stage("held update")
        rng = np.random.default_rng(5)
        t_len, n = RL_DP["held_t"], sum(RL_DP["held_envs"])
        tm = {"obs": rng.random((t_len, n, 3)).astype(np.float32),
              "actions": rng.integers(0, 2, (t_len, n)),
              "rewards": rng.random((t_len, n)).astype(np.float32),
              "dones": rng.random((t_len, n)) < 0.1}
        first, most = RL_DP["held_envs"][0], max(RL_DP["held_envs"])
        mine = slice(0, first) if rank == 0 else slice(first, n)
        local = {k: np.ascontiguousarray(v[:, mine].swapaxes(0, 1)) for k, v in tm.items()}
        real = local["rewards"].shape[0]
        local = {k: np.concatenate([v, np.zeros((most - real,) + v.shape[1:], v.dtype)])
                 for k, v in local.items()}
        local["mask"] = (np.arange(most) < real).astype(np.float32)
        al = ActorLearner(None, 3, 2, seed=3, mesh=mesh)
        state, loss = al._step(al.state, put_batch(local, data_sharding(mesh)))
        single = ActorLearner(None, 3, 2, seed=3)
        ref = TrainState.create({k: x.detach().clone() for k, x in single.state.params.items()},
                                lr=3e-3)
        ref, ref_loss = make_train_step(single.loss_fn, capture=False)(
            ref, {k: torch.as_tensor(v, device="cuda") for k, v in tm.items()})
        well = {k: ref.params[k].grad.abs() >= 1e-6 for k in ref.params}
        out["held"] = {
            "loss": float(loss), "single_loss": float(ref_loss),
            "grad_max_abs_diff": max((state.params[k].grad.to_local() - ref.params[k].grad)
                                     .abs().max().item() for k in ref.params),
            "param_max_abs_diff": max((state.params[k].to_local() - ref.params[k].detach())
                                      .abs().max().item() for k in ref.params),
            "param_max_abs_diff_where_grad_1e-6": max(
                (state.params[k].to_local() - ref.params[k].detach())[well[k]].abs().max().item()
                for k in ref.params),
            "rows": [real, most]}

        def forces(a):
            return list((np.asarray(a) * 2 - 1) * control.FORCE_MAG)

        _fake_blender()
        os.environ["BLENDJAX_FAKE_BPY"] = "1"
        stage("fleets")
        with FleetSet("", str(control.SCRIPT), num_fleets=1, envs_per_fleet=RL_DP["producers"],
                      start_port=cfg["start_port"], real_time=False) as fs:
            al = ActorLearner(fs, 3, 2, rollout_len=RL_DP["rollout"], mesh=mesh,
                              action_map=forces)
            al.run(num_updates=2)  # first updates: the fan-in's and the step's setup
            st = al.run(num_updates=RL_DP["updates"])
            out["actor_learner"] = {k: st[k] for k in (
                "updates", "losses", "env_steps", "env_steps_per_sec", "updates_per_sec",
                "elapsed_s", "sharded", "dead_fleets")}
            stage("train_reinforce")
            recs = []
            _, returns = control.train_reinforce(
                fs.pools[0], iterations=RL_DP["iterations"], horizon=RL_DP["horizon"],
                log_every=0, mesh=mesh, on_iteration=recs.append)
            out["reinforce"] = {"losses": [r["loss"] for r in recs], "returns": returns,
                                "update_ms": [r["update_ms"] for r in recs],
                                "rollout_ms": [r["rollout_ms"] for r in recs]}
            dist.barrier()
            if rank == 0:  # one process alone, for the record
                stage("single process")
                single = ActorLearner(fs, 3, 2, rollout_len=RL_DP["rollout"],
                                      action_map=forces)
                single.run(num_updates=3)  # warm-ups and capture
                st = single.run(num_updates=RL_DP["updates"])
                out["single_actor_learner"] = {k: st[k] for k in (
                    "updates", "env_steps_per_sec", "updates_per_sec", "elapsed_s")}
                recs = []
                control.train_reinforce(fs.pools[0], iterations=RL_DP["iterations"],
                                        horizon=RL_DP["horizon"], log_every=0,
                                        on_iteration=recs.append)
                out["single_reinforce"] = {"update_ms": [r["update_ms"] for r in recs],
                                           "rollout_ms": [r["rollout_ms"] for r in recs]}
            dist.barrier()
    finally:
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    stage("done")
    print(json.dumps(out), flush=True)
    return 0


def rl_dp_phase(torch):
    """The ``rl_dp`` phase: :func:`rl_dp_rank_main` in 2 rank processes."""
    t0 = time.perf_counter()
    port = _port_block(1)
    start = _port_block(RL_DP["ranks"] * 100)
    outs = _spawn_ranks("--rl-dp-rank", [
        {"rank": r, "world": RL_DP["ranks"], "port": port, "start_port": start + 100 * r}
        for r in range(RL_DP["ranks"])], RL_DP["timeout_s"], "rl_dp")
    r0, r1 = outs
    al = [o["actor_learner"] for o in outs]
    rec = {"phase": "rl_dp", "config": RL_DP, "seconds": time.perf_counter() - t0,
           "held": [o["held"] for o in outs], "actor_learner": al,
           "reinforce": [o["reinforce"] for o in outs],
           "single_actor_learner": r0["single_actor_learner"],
           "single_reinforce": r0["single_reinforce"],
           "global_env_steps_per_sec": sum(a["env_steps_per_sec"] for a in al),
           "updates_per_sec": min(a["updates_per_sec"] for a in al),
           "reinforce_update_ms": statistics.median(r0["reinforce"]["update_ms"]),
           "single_reinforce_update_ms": statistics.median(r0["single_reinforce"]["update_ms"])}
    emit(rec)
    for o in outs:
        h, r = o["held"], o["rank"]
        check(abs(h["loss"] - h["single_loss"]) <= RL_DP["loss_atol"] + 1e-5 * abs(
              h["single_loss"]) and h["grad_max_abs_diff"] <= RL_DP["grad_atol"]
              and h["param_max_abs_diff_where_grad_1e-6"] <= RL_DP["param_atol"],
              f"rl_dp rank {r}: the sharded update of an uneven split held to one process's "
              f"({h['loss']:.8g} vs {h['single_loss']:.8g}, gradients "
              f"{h['grad_max_abs_diff']:.3g}, params {h['param_max_abs_diff_where_grad_1e-6']:.3g})")
        a = o["actor_learner"]
        check(a["updates"] == RL_DP["updates"] and a["sharded"] and a["dead_fleets"] == []
              and a["env_steps"] > 0 and all(math.isfinite(x) for x in a["losses"]),
              f"rl_dp rank {r}: ActorLearner(mesh=) took its updates over live fleets")
        check(all(math.isfinite(x) for x in o["reinforce"]["losses"]),
              f"rl_dp rank {r}: train_reinforce(mesh=) losses finite")
    check(r0["actor_learner"]["losses"] == r1["actor_learner"]["losses"],
          "rl_dp: one loss per update on both ranks")
    check(r0["reinforce"]["losses"] == r1["reinforce"]["losses"],
          "rl_dp: train_reinforce's loss the same on both ranks")


#: the pipe phase's SPMD leg: 2 rank processes on ``cuda:0`` over gloo, mesh
#: ``{"pipe": 2}``; ``tests/test_pipeline.py``'s residual stage at the
#: flagship width, f32 (TF32 off), ``microbatches`` of ``rows`` rows, an
#: ``in_proj`` d_in -> d and an ``out_proj`` d -> d_out, MSE.  Held to one
#: process's sequential autograd on the card: the forward within
#: ``value_rtol`` of the largest reference value, the loss within
#: ``loss_rtol``, each gradient within ``grad_rtol`` of its tensor's largest
#: entry (the reference's rtol).  Both sides compute the same f32 products;
#: the pipeline's per microbatch, the sequential forward's over the stacked
#: microbatches, and the gradients' sums run in another order, so the gaps
#: are f32 roundings of 1024-term dot products (about 1e-6 of a value).
PIPE = dict(ranks=2, d=SEQ["d_model"], d_in=32, d_out=8, microbatches=8, rows=64,
            value_rtol=1e-5, loss_rtol=1e-5, grad_rtol=1e-4, reps=5, timeout_s=240)
#: the MPMD leg, at ``benchmarks/pipeline_benchmark.py:46-50,112-118``'s
#: setting (lr 1e-3, seed 0, work_us 0): ``updates`` per family held to
#: full-model plain SGD on the card within the reference's rtol/atol
#: (``tests/test_mpmd.py:73-111``); ``rounds`` of ``window`` updates on the
#: 3-stage and the 1-stage fleet in turns for updates/s; the kill drill's
#: ``kill_updates`` with the middle stage SIGKILLed at ``kill_after``; the
#: pipeline learner at cartpole's dims (obs 4, 2 actions, wire 64), its state
#: within ``learner_rtol`` of the fleet's parameters, and its losses and the
#: fleet's parameters within ``rtol``/``atol`` of plain SGD.  Once its fleet is warm
#: (a stage's first records on the card take seconds), the drill's driver
#: gives up on an update after ``finish_timeout_s``, the reference's test's.
MPMD = dict(n_procs=3, n_layers=6, wire=64, d_in=32, d_out=8, batch=64, microbatches=8,
            lr=1e-3, seed=0, work_us=0, updates=4, rounds=3, window=6, kill_updates=6,
            kill_after=3, finish_timeout_s=10.0, rtol=1e-4, atol=1e-5, learner_updates=3,
            learner_batch=64, learner_rtol=1e-6)


def pipe_rank_main(spec):
    """One rank of the pipe phase's SPMD leg (``python3 chip_smoke.py
    --pipe-rank '<json>'``), on ``cuda:0`` in a gloo group with the other:
    ``make_pipeline``'s forward, then ``make_pipeline_train`` with
    ``"gpipe"`` and ``"1f1b"``, each held to the sequential model's autograd
    on this rank; the rotations each made (``p2p.counts``) and its ms per
    step, and the sequential step's ms (rank 0, the other rank waiting);
    the K1-K4 launches it counted (``launches``: none expected).  Prints one
    JSON line."""
    import torch
    import torch.distributed as dist

    cfg, stage = _rank_world(spec, "pipe", PIPE["timeout_s"])
    from blendjax_torch.models.layers import dense_apply, dense_init, gelu, layer
    from blendjax_torch.ops import flash_attention as flash
    from blendjax_torch.ops import image
    from blendjax_torch.parallel import (
        make_mesh,
        make_pipeline,
        make_pipeline_train,
        p2p,
        stack_stage_params,
    )

    rank, world = cfg["rank"], cfg["world"]
    out = {"rank": rank}
    image.decode_frames_cuda.launches = 0
    _zero_flash_counts(flash)
    try:
        mesh = make_mesh({"pipe": world})
        stage("mesh made")
        out["mesh"] = {"device_type": mesh.device_type, "device": torch.cuda.current_device()}
        d, m, rows = PIPE["d"], PIPE["microbatches"], PIPE["rows"]
        g = torch.Generator().manual_seed(11)

        def dense(a, b):
            return {k: v.cuda() for k, v in dense_init(a, b, generator=g, device="cpu").items()}

        stages = [{f"fc.{k}": v for k, v in dense(d, d).items()} for _ in range(world)]
        proj = (dense(PIPE["d_in"], d), dense(d, PIPE["d_out"]))
        x = torch.randn((m, rows, d), generator=g).cuda()
        xi = torch.randn((m, rows, PIPE["d_in"]), generator=g).cuda()
        tgt = torch.randn((m, rows, PIPE["d_out"]), generator=g).cuda()
        stacked = stack_stage_params(stages)

        def stage_fn(p, h):
            return h + gelu(dense_apply(layer(p, "fc"), h))

        def mse(a, b):
            return torch.mean((a - b) ** 2)

        def gap(got, want):
            return ((got - want).abs().max() / want.abs().max()).item()

        def counted(fn):
            p2p.reset_counts()
            result = fn()
            torch.cuda.synchronize()
            return result, {k: p2p.counts[k] for k in ("rotate", "host_staged")}

        y, counts = counted(lambda: make_pipeline(stage_fn, mesh)(stacked, x))
        ref = x
        for sp in stages:
            ref = stage_fn(sp, ref)
        out["forward"] = {"value_gap": gap(y, ref), "rotations": counts}
        stage("forward held")

        leaves = [*stages[rank].values(), *proj[0].values(), *proj[1].values()]
        live = [v.detach().requires_grad_(True) for v in leaves]
        n_stage = len(stages[rank])

        def seq_grads():
            sp = [dict(s) for s in stages]
            sp[rank] = dict(zip(stages[rank], live[:n_stage]))
            pe = dict(zip(proj[0], live[n_stage:n_stage + 2]))
            po = dict(zip(proj[1], live[n_stage + 2:]))
            losses = []
            for i in range(m):
                h = dense_apply(pe, xi[i])
                for s in sp:
                    h = stage_fn(s, h)
                losses.append(mse(dense_apply(po, h), tgt[i]))
            loss = torch.stack(losses).mean()
            return loss, torch.autograd.grad(loss, live)

        ref_loss, ref_grads = seq_grads()
        for schedule in ("gpipe", "1f1b"):
            train = make_pipeline_train(stage_fn, mse, mesh, schedule=schedule,
                                        in_proj=dense_apply, out_proj=dense_apply)
            (loss, (gs, gp)), counts = counted(lambda: train(stacked, proj, xi, tgt))
            got = [gs[k][0] for k in stages[rank]] + list(gp[0].values()) + list(gp[1].values())
            dist.barrier()
            ms = _ms_median(torch, lambda: train(stacked, proj, xi, tgt), PIPE["reps"],
                            barrier=dist.barrier)
            out[schedule] = {
                "loss": float(loss), "loss_gap": abs(float(loss) - float(ref_loss))
                / abs(float(ref_loss)),
                "grad_gap": max(gap(a, b) for a, b in zip(got, ref_grads)),
                "rotations": counts, "step_ms": ms}
            stage(f"{schedule} held")
        dist.barrier()
        if rank == 0:  # the other rank waits: one process on the card
            out["sequential_step_ms"] = _ms_median(torch, seq_grads, PIPE["reps"])
        dist.barrier()
        out["sequential_loss"] = float(ref_loss)
        out["launches"] = _pipe_launches(image, flash)
    finally:
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()
    stage("done")
    print(json.dumps(out), flush=True)
    return 0


def _mpmd_spec(family, n_procs=MPMD["n_procs"], **kw):
    from blendjax_torch.parallel.mpmd import normalize_spec

    spec = dict(family=family, d_in=MPMD["d_in"], wire=MPMD["wire"], d_out=MPMD["d_out"],
                n_layers=MPMD["n_layers"], n_procs=n_procs, lr=MPMD["lr"], seed=MPMD["seed"])
    spec.update(kw)
    return normalize_spec(spec)


def mpmd_batches(np, spec, k, seed, batch=MPMD["batch"]):
    """``k`` seeded whole batches (x, target record) of ``batch`` rows for
    the spec's family (``pg``: a normalized advantage, importance weights
    in [0.5, 1.5]).  ``tests/test_torch_mpmd.py`` draws its batches here."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        x = rng.standard_normal((batch, spec["d_in"])).astype(np.float32)
        if spec["family"] == "mse":
            tgt = {"y": rng.standard_normal((batch, spec["d_out"])).astype(np.float32)}
        else:
            r = rng.standard_normal(batch)
            tgt = {"action": rng.integers(0, spec["d_out"], batch).astype(np.int32),
                   "adv": ((r - r.mean()) / (r.std() + 1e-6)).astype(np.float32),
                   "w": rng.uniform(0.5, 1.5, batch).astype(np.float32)}
        out.append((x, tgt))
    return out


def mpmd_plain_sgd(torch, spec, batches, m, device="cuda"):
    """Full-model SGD on ``device`` with the stages' arithmetic, from
    ``build_full_params(spec)``: per-microbatch mean losses, gradients
    summed over microbatches, ``p - lr*g/m``.  Returns the parameters as
    numpy and the losses.  ``tests/test_torch_mpmd.py`` holds the stage
    fleets to it on the CPU."""
    from blendjax_torch.models.layers import dense_apply, layer
    from blendjax_torch.parallel.mpmd import build_full_params, make_loss_fn
    from blendjax_torch.parallel.pipeline import microbatch

    loss_fn = make_loss_fn(spec["family"])
    params = build_full_params(spec, device)
    losses = []
    for x, tgt in batches:
        xs, tgts = microbatch(x, m), microbatch(tgt, m)
        gsum, lsum = None, 0.0
        for i in range(m):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            h = torch.tensor(xs[i], device=device)
            for j in range(spec["n_layers"] + 1):
                h = torch.tanh(dense_apply(layer(p, f"layers.{j}"), h))
            loss = loss_fn(dense_apply(layer(p, "out"), h),
                           {k: torch.tensor(v[i], device=device) for k, v in tgts.items()})
            g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            lsum += float(loss.detach())
            gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
        with torch.no_grad():
            params = {k: v - spec["lr"] * gsum[k] / m for k, v in params.items()}
        losses.append(lsum / m)
    return {k: v.cpu().numpy() for k, v in params.items()}, losses


def _mpmd_gaps(np, got, want, losses, ref_losses):
    """The largest excess over the reference's limits (<= 0: within), and
    the raw gaps."""
    excess = max(float(np.max(np.abs(got[k] - want[k]) - MPMD["atol"]
                              - MPMD["rtol"] * np.abs(want[k]))) for k in want)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    return {"param_excess": excess, "loss_gap": loss_gap, "keys_equal": sorted(got) == sorted(want),
            "param_max_abs_diff": max(float(np.max(np.abs(got[k] - want[k]))) for k in want)}


def _mpmd_updates(driver, batches, m):
    driver.hello_all()
    return [float(driver.update(x, tgt, m)) for x, tgt in batches]


def _mpmd_rates(driver, single, batch, m):
    """``MPMD['rounds']`` windows of ``MPMD['window']`` updates on each
    driver in turns; updates/s per window."""
    rates = {"mpmd": [], "single": []}
    x, tgt = batch
    for r in range(MPMD["rounds"]):
        order = (("mpmd", driver), ("single", single))
        for name, d in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            for _ in range(MPMD["window"]):
                d.update(x, tgt, m)
            rates[name].append(MPMD["window"] / (time.perf_counter() - t0))
    return rates


def kill_mid_update(fleet, idx, update, out):
    """SIGKILL stage ``idx`` of ``fleet`` once it is inside ``update`` (its
    ``stage_info`` says so); ``out["kill_info"]`` is that last answer.
    ``tests/test_torch_mpmd.py``'s drill kills its stage here too."""
    import zmq

    from blendjax_torch import wire

    sock = zmq.Context.instance().socket(zmq.DEALER)
    sock.setsockopt(zmq.LINGER, 0)
    sock.connect(fleet.addresses[idx])
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            msg = {"cmd": "stage_info"}
            mid = wire.stamp_message_id(msg)
            wire.send_message_dealer(sock, msg)
            if not sock.poll(1000, zmq.POLLIN):
                continue
            reply = wire.recv_message_dealer(sock)
            if reply.get(wire.BTMID_KEY) == mid and reply.get("current") == update:
                os.kill(fleet.launch_info.processes[idx].pid, signal.SIGKILL)
                out["kill_info"] = {k: reply[k] for k in ("applied", "current", "bwd_done")}
                return
    finally:
        sock.close(0)


def _mpmd_kill_drill(fleet, driver, batches, m, done):
    """The SIGKILL drill on ``fleet`` (stages checkpointing every commit),
    after its first ``done`` updates (the warm-up, taken with the other
    fleets'): the middle stage killed inside the next update under
    ``FleetWatchdog(restart=True)``, then the rest of ``batches``; a last
    ``hello_all`` sees every incarnation."""
    from blendjax_torch.btt.watchdog import FleetWatchdog

    t0 = time.perf_counter()
    update_s, rec = [], {}
    driver.finish_timeout_s = MPMD["finish_timeout_s"]
    with FleetWatchdog(fleet, interval=0.25, restart=True) as wd:
        killer = threading.Thread(target=kill_mid_update,
                                  args=(fleet, 1, driver.updates_done + 1, rec))
        killer.start()
        for x, tgt in batches[len(done):]:
            t1 = time.perf_counter()
            done.append(float(driver.update(x, tgt, m)))
            update_s.append(time.perf_counter() - t1)
        killer.join(timeout=30)
        driver.hello_all()
        got = driver.gather_params()
        infos = driver.stage_infos()
        deadline = time.monotonic() + 10
        while not wd.deaths and time.monotonic() < deadline:
            time.sleep(0.1)
        deaths = [d[0] for d in wd.deaths]
    return {"losses": done, "params": got, "seconds": time.perf_counter() - t0,
            "update_s": update_s, "deaths": deaths, "applied": [i["applied"] for i in infos],
            "kill_info": rec.get("kill_info"),
            "respawned_restores": infos[1]["counters"].get("pipe_ckpt_restores", 0),
            "counters": driver.counters.snapshot()}


def _pipe_learner(np, torch):
    """``ActorLearner(pipeline_stages=)`` over a 2-stage ``pg`` fleet of
    stage threads on the card at cartpole's dims: ``run_offline`` from a
    seeded prioritized ``ReplayBuffer`` (priorities off uniform, so the
    importance weights are off 1; rewards off mean 0 and std 1).  The
    learner's state against the fleet's; the losses and the fleet's
    parameters against plain SGD on the batches the learner drew, their
    advantage normalized here."""
    from blendjax_torch.models.actor_learner import ActorLearner
    from blendjax_torch.parallel.mpmd import MpmdTrain, start_stage_threads
    from blendjax_torch.replay import ReplayBuffer

    spec = _mpmd_spec("pg", n_procs=2, d_in=4, d_out=2, n_layers=2)
    rng = np.random.default_rng(5)
    buf = ReplayBuffer(1024, seed=0)
    for _ in range(512):
        buf.append({"obs": rng.standard_normal(4).astype(np.float32),
                    "action": int(rng.integers(0, 2)),
                    "reward": float(1.0 + 2.0 * rng.standard_normal())})
    buf.update_priorities(np.arange(512), rng.uniform(0.1, 2.0, 512))
    drawn = []
    with start_stage_threads(spec) as handle:
        driver = MpmdTrain(handle.addresses, spec)
        try:
            driver.hello_all()
            al = ActorLearner(None, 4, 2, replay=buf, pipeline_stages=driver)
            update = al._pipeline_replay_update

            def recorded(*batch):  # (obs, action, reward, is_weight), off the arena
                drawn.append([np.array(a) for a in batch])
                return update(*batch)

            al._pipeline_replay_update = recorded
            stats = al.run_offline(num_updates=MPMD["learner_updates"],
                                   batch_size=MPMD["learner_batch"])
            fleet = driver.gather_params()
            infos = driver.stage_infos()
        finally:
            driver.close()
    batches = []
    for obs, action, reward, w in drawn:
        r = reward.astype(np.float64)
        batches.append((obs, {"action": action, "w": w,
                              "adv": ((r - r.mean()) / (r.std() + 1e-6)).astype(np.float32)}))
    want, ref_losses = mpmd_plain_sgd(torch, spec, batches, al.pipeline_microbatches)
    state = {k: v.detach().cpu().numpy() for k, v in al.state.params.items()}
    return {"updates": stats["updates"], "losses": stats["losses"], "step": al.state.step,
            "device": str(al.device), "stage_devices": [i["device"] for i in infos],
            "keys_equal": sorted(state) == sorted(fleet),
            "param_max_rel_diff": max(float(np.max(np.abs(state[k] - fleet[k])
                                                   / np.maximum(np.abs(fleet[k]), 1e-30)))
                                      for k in fleet),
            "snapshot_equal": all(np.array_equal(al._actor_params[0][k].cpu().numpy(), fleet[k])
                                  for k in fleet),
            "weights_off_one": all(not np.allclose(w, 1.0) for *_, w in drawn),
            "plain": {"losses": ref_losses,
                      **_mpmd_gaps(np, fleet, want, stats["losses"], ref_losses)}}


def _pipe_mpmd(torch):
    """The MPMD leg (``MPMD``): 4 fleets of stage processes on the card
    booted together (mse, pg, 1-stage, the drill's), then the checks in
    turn."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from blendjax_torch.parallel.mpmd import MpmdTrain, StageFleet

    m = MPMD["microbatches"]
    specs = {"mse": _mpmd_spec("mse"), "pg": _mpmd_spec("pg"), "single": _mpmd_spec("mse", 1),
             "kill": _mpmd_spec("mse")}
    tmp = tempfile.mkdtemp(prefix="bjx-pipe-")
    rec = {}
    try:
        with contextlib.ExitStack() as stack:
            fleets = {k: StageFleet(spec, work_us=MPMD["work_us"],
                                    ckpt_dir=os.path.join(tmp, "ck") if k == "kill" else None)
                      for k, spec in specs.items()}
            bases = [b for b in fleets["kill"].shm_bases if b]
            for f in fleets.values():
                stack.callback(f.close)
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(fleets)) as pool:
                for fut in [pool.submit(f.__enter__) for f in fleets.values()]:
                    fut.result()
            rec["boot_s"] = time.perf_counter() - t0
            drivers = {k: MpmdTrain(fleets[k].addresses, specs[k]) for k in ("mse", "pg", "single")}
            for d in drivers.values():
                stack.callback(d.close)

            def checked(family):
                """The family's held updates (the fleet's first: each stage's
                first records pay its CUDA warm-up, off the rates' clock)."""
                spec = specs[family]
                batches = mpmd_batches(np, spec, MPMD["updates"], seed=1)
                t0 = time.perf_counter()
                losses = _mpmd_updates(drivers[family], batches, m)
                seconds = time.perf_counter() - t0
                want, ref_losses = mpmd_plain_sgd(torch, spec, batches, m)
                infos = drivers[family].stage_infos()
                return {"losses": losses, "plain_losses": ref_losses, "seconds": seconds,
                        "applied": [i["applied"] for i in infos],
                        "devices": [i["device"] for i in infos],
                        "restarts": drivers[family].counters.get("pipe_restarts"),
                        **_mpmd_gaps(np, drivers[family].gather_params(), want, losses,
                                     ref_losses)}

            # the warm-up updates under the driver's default finish timeout
            drill = MpmdTrain(fleets["kill"].addresses, specs["kill"])
            stack.callback(drill.close)
            drill_batches = mpmd_batches(np, specs["kill"], MPMD["kill_updates"], seed=3)
            drill_losses = []

            def drill_warm():
                drill.hello_all()
                for x, tgt in drill_batches[:MPMD["kill_after"]]:
                    drill_losses.append(float(drill.update(x, tgt, m)))

            # every fleet's first updates at once (their stages' warm-ups overlap)
            with ThreadPoolExecutor(4) as pool:
                futs = {f: pool.submit(checked, f) for f in ("mse", "pg")}
                warm = [pool.submit(_mpmd_updates, drivers["single"],
                                    mpmd_batches(np, specs["single"], 1, seed=2), m),
                        pool.submit(drill_warm)]
                for family, fut in futs.items():
                    rec[family] = fut.result()
                for fut in warm:
                    fut.result()
            rates = _mpmd_rates(drivers["mse"], drivers["single"],
                                mpmd_batches(np, specs["mse"], 1, seed=2)[0], m)
            rec["rates"] = rates
            rec["pipe_mpmd_x"] = statistics.median(
                a / b for a, b in zip(rates["mpmd"], rates["single"]))
            rec["driver_counters"] = drivers["mse"].counters.snapshot()
            rec["driver_stages_ms"] = drivers["mse"].timer.summary()
            result = _mpmd_kill_drill(fleets["kill"], drill, drill_batches, m, drill_losses)
            want, ref_losses = mpmd_plain_sgd(torch, specs["kill"], drill_batches, m)
            got = result.pop("params")
            rec["kill"] = {**result, "plain_losses": ref_losses,
                           **_mpmd_gaps(np, got, want, result["losses"], ref_losses)}
        rec["kill"]["leaked_shm"] = [p for b in bases for p in glob.glob(f"/dev/shm/{b}*")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    rec["learner"] = _pipe_learner(np, torch)
    rec["learner"]["seconds"] = time.perf_counter() - t0
    return rec


def _pipe_launches(image, flash):
    return {"decode_u8": image.decode_frames_cuda.launches,
            **{n: getattr(flash, n + "_cuda").launches for n in FLASH_KERNELS}}


def pipe_phase(torch, image, flash):
    """The ``pipe`` phase: the SPMD leg in 2 rank processes
    (:func:`pipe_rank_main`), then the MPMD leg and the pipeline learner in
    this process (:func:`_pipe_mpmd`).  Returns the K1-K4 launches it
    counted, ``(here, ranks)``: in this process (the MPMD drivers, the
    learner's stage threads, the references) and in both SPMD ranks, none
    expected.  The stage processes' counts are not read: a stage process
    enrolls no kernel wrapper (``tests/test_torch_mpmd.py`` checks that
    one imports no ``blendjax_torch.ops`` module)."""
    before = _pipe_launches(image, flash)
    t0 = time.perf_counter()
    port = _port_block(1)
    outs = _spawn_ranks("--pipe-rank", [{"rank": r, "world": PIPE["ranks"], "port": port}
                                        for r in range(PIPE["ranks"])], PIPE["timeout_s"], "pipe")
    spmd_s = time.perf_counter() - t0
    r0 = outs[0]
    emit({"phase": "pipe_spmd", "config": PIPE, "seconds": spmd_s,
          "mesh": r0["mesh"], "ranks": outs,
          "gpipe_step_ms": r0["gpipe"]["step_ms"], "1f1b_step_ms": r0["1f1b"]["step_ms"],
          "sequential_step_ms": r0["sequential_step_ms"]})
    check(r0["mesh"]["device_type"] == "cuda", "pipe: the mesh is on the card")
    for o in outs:
        r = o["rank"]
        check(o["forward"]["value_gap"] <= PIPE["value_rtol"],
              f"pipe rank {r}: make_pipeline's forward within {PIPE['value_rtol']} of the "
              f"sequential model's largest value ({o['forward']['value_gap']:.3g})")
        m, n = PIPE["microbatches"], PIPE["ranks"]
        # GPipe: one rotation a forward tick, and the backward of each but the
        # last (whose output nothing reads); 1F1B: two a tick
        for schedule, rotations in (("gpipe", 2 * (m + n - 1) - 1), ("1f1b", 2 * (m + 2 * n - 2))):
            h = o[schedule]
            check(h["loss_gap"] <= PIPE["loss_rtol"] and h["grad_gap"] <= PIPE["grad_rtol"],
                  f"pipe rank {r}: {schedule}'s loss and gradients held to sequential "
                  f"autograd ({h['loss_gap']:.3g} <= {PIPE['loss_rtol']}, "
                  f"{h['grad_gap']:.3g} <= {PIPE['grad_rtol']})")
            rot = h["rotations"]
            check(rot["rotate"] == rotations and rot["host_staged"] == rot["rotate"],
                  f"pipe rank {r}: {schedule} made {rotations} rotations, each staged through "
                  f"the host ({rot})")
        check(o["forward"]["rotations"]["rotate"] == PIPE["microbatches"] + PIPE["ranks"] - 1,
              f"pipe rank {r}: the forward rotated once a tick ({o['forward']['rotations']})")
    check(outs[0]["gpipe"]["loss"] == outs[1]["gpipe"]["loss"]
          and outs[0]["1f1b"]["loss"] == outs[1]["1f1b"]["loss"],
          "pipe: both ranks return one loss")

    t1 = time.perf_counter()
    rec = _pipe_mpmd(torch)
    rec["seconds"] = time.perf_counter() - t1
    emit({"phase": "pipe_mpmd", "config": MPMD, **{k: v for k, v in rec.items()}})
    for family in ("mse", "pg"):
        f = rec[family]
        check(f["keys_equal"] and f["param_excess"] <= 0 and f["loss_gap"] <= MPMD["rtol"],
              f"pipe {family}: {MPMD['updates']} MPMD updates held to plain SGD on the card "
              f"(rtol {MPMD['rtol']}, atol {MPMD['atol']}; params {f['param_max_abs_diff']:.3g}, "
              f"losses {f['loss_gap']:.3g})")
        check(f["restarts"] == 0 and f["applied"] == [MPMD["updates"]] * MPMD["n_procs"],
              f"pipe {family}: no restart, every stage applied {MPMD['updates']} commits "
              f"({f['applied']})")
        check(all(dev.startswith("cuda") for dev in f["devices"]),
              f"pipe {family}: every stage on the card ({f['devices']})")
    k = rec["kill"]
    check(k["kill_info"] is not None and k["kill_info"]["current"] == MPMD["kill_after"] + 1,
          f"pipe kill: the middle stage was killed inside update {MPMD['kill_after'] + 1} "
          f"({k['kill_info']})")
    check(k["deaths"] == [1] and k["counters"].get("pipe_stage_respawns", 0) >= 1
          and k["respawned_restores"] >= 1,
          f"pipe kill: the middle stage died, was respawned and restored its cut ({k['deaths']}, "
          f"{k['counters']}, restores {k['respawned_restores']})")
    check(k["keys_equal"] and k["param_excess"] <= 0 and k["loss_gap"] <= MPMD["rtol"]
          and k["applied"] == [MPMD["kill_updates"]] * MPMD["n_procs"],
          f"pipe kill: {MPMD['kill_updates']} updates equal the uninterrupted plain SGD run "
          f"(params {k['param_max_abs_diff']:.3g}, losses {k['loss_gap']:.3g}, applied "
          f"{k['applied']})")
    check(not k["leaked_shm"], f"pipe kill: no /dev/shm object left ({k['leaked_shm']})")
    a = rec["learner"]
    check(a["updates"] == MPMD["learner_updates"] and a["step"] == MPMD["learner_updates"]
          and a["keys_equal"] and a["param_max_rel_diff"] <= MPMD["learner_rtol"]
          and a["snapshot_equal"] and a["device"].startswith("cuda")
          and all(dev.startswith("cuda") for dev in a["stage_devices"]),
          f"pipe learner: ActorLearner(pipeline_stages=)'s state equals its fleet's parameters "
          f"after {MPMD['learner_updates']} updates ({a})")
    p = a["plain"]
    check(a["weights_off_one"] and p["keys_equal"] and p["param_excess"] <= 0
          and p["loss_gap"] <= MPMD["rtol"],
          f"pipe learner: its losses and its fleet's parameters held to plain SGD on the "
          f"batches it drew, importance weights off 1 (rtol {MPMD['rtol']}, atol "
          f"{MPMD['atol']}; params {p['param_max_abs_diff']:.3g}, losses {p['loss_gap']:.3g})")
    launched = {n: v - before[n] for n, v in _pipe_launches(image, flash).items()}
    ranks = {n: sum(o["launches"][n] for o in outs) for n in launched}
    check(not any(launched.values()) and not any(ranks.values()),
          f"pipe: the phase launched no K1-K4 here ({launched}) or in its ranks ({ranks})")
    emit({"phase": "pipe_seconds", "spmd": spmd_s, "mpmd": rec["seconds"],
          "seconds": time.perf_counter() - t0})
    return launched, ranks


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from blendjax_torch import btt, control, datagen, serve, worldmodel
    from blendjax_torch.btb import pendulum
    from blendjax_torch.models import detector, layers, moe, policy, seqformer
    from blendjax_torch.models.train import TrainState
    from blendjax_torch.ops import _build, image, quant
    from blendjax_torch.ops import flash_attention as flash
    from blendjax_torch.ops import layer_norm as ln

    global CARD, HBM_RATE

    # full float32 for the float32 checks (cuDNN would take TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    CARD = card
    emit({"card": card})
    emit({"kernels": ["decode_u8"] + list(FLASH_KERNELS) + list(LN_KERNELS)
          + ["rms_norm_fwd", "rms_norm_bwd"]})
    name = card.split(",")[0]
    hbm, flops_peak = peak_rate(HBM_PEAK, name), peak_rate(BF16_PEAK, name)
    HBM_RATE = hbm
    t0 = time.perf_counter()
    ring_build = {}

    def build_ring():
        from blendjax_torch.native import ring

        try:
            ring_build["library"] = ring.build_library()
        except RuntimeError as exc:  # the compiler's output rides the message
            ring_build["error"] = str(exc)
        ring_build["seconds"] = time.perf_counter() - t0

    ring_thread = threading.Thread(target=build_ring)
    ring_thread.start()
    _build.load_library()
    kernel_s = time.perf_counter() - t0
    ring_thread.join()
    emit({"phase": "build", "sources": _build.SOURCES, "seconds": kernel_s,
          "ring": ring_build})
    if "error" in ring_build:
        print(ring_build["error"], file=sys.stderr)
    check("library" in ring_build, "the native ring built")

    # K5's launches in each phase that runs the SeqFormer in this process
    ln_by_path = {}

    @contextlib.contextmanager
    def ln_path(name):
        before = {n: getattr(ln, n + "_cuda").launches for n in LN_KERNELS}
        yield
        ln_by_path[name] = {n: getattr(ln, n + "_cuda").launches - before[n]
                            for n in LN_KERNELS}
        emit({"phase": "layer_norm_launches", "path": name, **ln_by_path[name]})

    with smi_window("kernel"):
        timing = kernel_phase(torch, image, hbm)
    train_phase(torch, datagen, detector, image)
    decode_launches = stream_phase(torch, btt, datagen, image)
    stream_ab_phase(torch, btt, datagen, image)
    with ln_path("transport_serve"):
        shm_launches = transport_phase(torch, btt, datagen, image, seqformer, serve)
    check(shm_launches >= 1, "the shm datagen path launched decode_u8")
    obs_launches = obs_phase(torch, btt, datagen, image, control, policy, flops_peak)
    flash_errs = flash_phase(torch, flash)
    with smi_window("flash_time"):
        flash_timing = flash_time_phase(torch, flash, hbm, flops_peak)
    ln_errs = layer_norm_phase(torch, ln)
    with smi_window("layer_norm_time"):
        ln_timing = layer_norm_time_phase(torch, ln, hbm)
    ln_per_replay = layer_norm_engagement(torch, ln, seqformer, worldmodel, pendulum,
                                          TrainState)
    mla_flash_errs = mla_flash_phase(torch, flash)
    rms_errs = rms_norm_phase(torch, ln)
    grouped_phase(torch, moe)
    with smi_window("mla_kernels_time"):
        mla_timing = mla_kernels_time_phase(torch, flash, ln, moe, hbm, flops_peak)
    with smi_window("moonlight_step"):
        moonlight_launches = moonlight_step_phase(torch, seqformer, flash, ln, pendulum,
                                                  TrainState)
    with ln_path("seqformer"):
        seqformer_phase(torch, seqformer, flash, worldmodel, pendulum, TrainState)
    with ln_path("worldmodel_stream"):
        flash_launches, flash_routes, wm_state = worldmodel_phase(torch, btt, worldmodel, flash)
    rl_rates = rl_phase(torch, btt, control, policy)
    al_rates = actor_learner_phase(torch, btt, control, rl_rates)
    with smi_window("densityopt"):
        densityopt_launches = densityopt_phase(torch, btt, image)
    check(densityopt_launches >= 1, "the densityopt path launched decode_u8")
    quant_phase(torch, quant, layers)
    with smi_window("serve"), ln_path("serve"):
        serve_phase(torch, seqformer, serve, SERVE, "serve")
    with ln_path("serve_small"):
        serve_phase(torch, seqformer, serve, SERVE_SMALL, "serve_small")
    with ln_path("dream"):
        dream_phase(torch, seqformer, worldmodel, quant, pendulum, wm_state)
    del wm_state
    infer_launches = infer_int8_phase(torch, btt, datagen, image)
    with ln_path("ha_resume"):
        ha_launches = ha_phase(torch, btt, control, datagen, image, seqformer, flash,
                               worldmodel, pendulum)
    replay_service_phase(torch)
    with ln_path("flywheel_swap"):
        flywheel_phase(torch, btt, control, seqformer, serve, al_rates)
    scenario_phase(torch, btt)
    with ln_path("serve_fleet_replay"):
        serve_fleet_phase(torch, serve)
    t_parallel = time.perf_counter()
    with ln_path("moe"):
        moe_launches, moe_routes = moe_phase(torch, seqformer, flash, worldmodel, pendulum,
                                             TrainState)
    dp_launches = dp_phase(torch)
    ring_launches, ring_routes, ln_by_path["ring_ranks"], ring_failures = ring_phase(torch)
    rl_dp_phase(torch)
    pipe_launches, pipe_rank_launches = pipe_phase(torch, image, flash)
    emit({"phase": "parallel_seconds", "seconds": time.perf_counter() - t_parallel})

    kernels = [{
        "name": "decode_u8", "route": "cuda",
        "source": "blendjax_torch/ops/csrc/decode.cu",
        "replaces": "blendjax/ops/image.py:69",
        "launches": (decode_launches + obs_launches + shm_launches + densityopt_launches
                     + infer_launches + ha_launches["decode_u8"] + dp_launches),
        "launches_by_path": {"datagen_stream": decode_launches,
                             "obs_feed": obs_launches,
                             "datagen_shm": shm_launches,
                             "densityopt": densityopt_launches,
                             "infer_int8": infer_launches,
                             "ha_resume": ha_launches["decode_u8"],
                             "dp_ranks": dp_launches,
                             "pipe": pipe_launches["decode_u8"],
                             "pipe_ranks": pipe_rank_launches["decode_u8"]},
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes",
        "library_ms": timing["library_ms"], "ms_clean_l2": timing["ms_clean_l2"],
        "densityopt_shape": {k: timing["densityopt"][k] for k in (
            "shape", "out", "kernel_us", "ms", "ms_clean_l2", "plain_ms", "library_ms",
            "library_kernel_us", "bound_ms")},
    }]
    # the flagship's bf16 inputs run the tensor-core kernels; f32 inputs
    # take the CUDA-core ones, whose time on these bf16 inputs is previous_ms
    replaces = {"flash_fwd": ("flash_fwd_tc.cu", "flash_fwd.cu", 203),
                "flash_dq": ("flash_bwd_tc.cu", "flash_bwd.cu", 257),
                "flash_dkv": ("flash_bwd_tc.cu", "flash_bwd.cu", 296)}
    for kname, (src, previous_src, line) in replaces.items():
        rec = flash_timing[kname]
        # the Moonlight step's launches are all on the tensor cores (its check)
        by_route = {route: (flash_routes[kname].get(route, 0)
                            + ha_launches["flash_routes"][kname].get(route, 0)
                            + moe_routes[kname].get(route, 0)
                            + ring_routes[kname].get(route, 0)
                            + (moonlight_launches[kname] if route == "tc" else 0))
                    for route in ("tc", "f32")}
        launched = (flash_launches[kname] + ha_launches[kname] + moe_launches[kname]
                    + ring_launches[kname] + moonlight_launches[kname])
        check(sum(by_route.values()) == launched,
              f"{kname}: every launch of the line counted on a route ({by_route}, {launched})")
        kernels.append({
            "name": kname, "route": "cuda", "source": f"blendjax_torch/ops/csrc/{src}",
            "replaces": f"blendjax/ops/flash_attention.py:{line}",
            "launches": launched,
            "launches_by_path": {"worldmodel_stream": flash_launches[kname],
                                 "ha_resume": ha_launches[kname],
                                 "moe": moe_launches[kname],
                                 "moonlight_step": moonlight_launches[kname],
                                 "ring_ranks": ring_launches[kname],
                                 "pipe": pipe_launches[kname],
                                 "pipe_ranks": pipe_rank_launches[kname]},
            "max_abs_err": flash_errs[kname],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "ms_clean_l2": rec["ms_clean_l2"], "launches_by_route": by_route,
            "previous_ms": rec["previous_ms"],
            "previous_source": f"blendjax_torch/ops/csrc/{previous_src}",
            "mla": {"head_dims": list(MLA_DIMS), "shape": list(MLA_TIME_SHAPE),
                    "max_abs_err": mla_flash_errs[kname],
                    **{k: mla_timing[kname][k] for k in (
                        "ms", "ms_clean_l2", "profiled_us", "bound_ms", "bound_by")}},
        })
    for kname in LN_KERNELS:
        rec = ln_timing[("train", kname[len("layer_norm_"):])]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"blendjax_torch/ops/csrc/{kname}.cu",
            "replaces": "none (XLA fuses blendjax/models/seqformer.py::_ln_apply)",
            "launches": sum(c[kname] for c in ln_by_path.values()),
            "launches_by_path": {"seqformer_big_replay": ln_per_replay[kname],
                                 **{path: c[kname] for path, c in ln_by_path.items()}},
            "max_abs_err": ln_errs[kname[len("layer_norm_"):]],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "ms_clean_l2": rec["ms_clean_l2"],
        })
    # K5's RMS mode: the Moonlight step's norms, nothing else runs them
    for kname in ("rms_norm_fwd", "rms_norm_bwd"):
        rec = mla_timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"blendjax_torch/ops/csrc/layer_norm_{kname[-3:]}.cu",
            "replaces": "none (the JAX package has no RMSNorm)",
            "launches": moonlight_launches[kname],
            "launches_by_path": {"moonlight_step": moonlight_launches[kname]},
            "max_abs_err": rms_errs[kname[-3:]], "shape": rec["shape"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "ms_clean_l2": rec["ms_clean_l2"],
        })
    emit({"kernels": kernels})
    # every path that runs the SeqFormer on the card took K5: the training
    # paths forward and backward, the served and dreamed ones forward
    for path, c in ln_by_path.items():
        trains = path in ("seqformer", "worldmodel_stream", "ha_resume", "moe", "ring_ranks")
        check(c["layer_norm_fwd"] >= 1 and (c["layer_norm_bwd"] >= 1 or not trains),
              f"{path}: the SeqFormer's layer norms went through K5 ({c})")
    check(not ring_failures, "; ".join(ring_failures))
    emit({"phase": "smoke_seconds", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-clients"]:
        sys.exit(serve_clients_main(sys.argv[2]))
    if sys.argv[1:2] == ["--chaos-clients"]:
        sys.exit(chaos_clients_main(sys.argv[2]))
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--ring-rank"]:
        sys.exit(ring_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--rl-dp-rank"]:
        sys.exit(rl_dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--pipe-rank"]:
        sys.exit(pipe_rank_main(sys.argv[2]))
    sys.exit(main())
