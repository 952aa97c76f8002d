#!/usr/bin/env python3
"""Drive the PyTorch port (ray_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:

Before phase 1 the script keeps the bytecode of every import, its own and
that of every process it starts, under ``build/pycache`` (``_keep_bytecode``).

1. Card and build: the card's name and power limit, then the build of every
   CUDA source of the port (nvcc for sm_90a, flash_fwd.cu and flash_bwd.cu
   in parallel), with its seconds and ptxas' register and spill report; for
   the bf16 forward, dK/dV and dQ kernels (TMA ring, warp-specialised,
   wgmma) also their registers at launch, local memory and dynamic shared
   memory. Any spill in those kernels fails the run.
2. Kernel against its plain version: the flash-attention forward kernel
   (csrc/flash_fwd.cu) and ``flash_fwd_plain`` on the same card tensors, at
   bf16 and f32, over the serving path's prefill shape, the flagship's
   max_seq, a ragged length, Sq < Sk, causal Sq > Sk (whose rows that see
   no key must hold exactly O = 0 and LSE = -1e30), q, k and v as strided
   views of one fused [B, S, 3, H, D] tensor, GQA, head_dim 64 and the ViT
   training shape (B 128, S 197, 6 heads of 64, not causal). O and LSE
   errors are printed beside their tolerances, with the kernel's time (CUDA
   events around the wrapper, and the kernel's own device time from
   torch.profiler), the plain version's, the least time the card could take
   (the bound) and, as a yardstick only, torch's
   scaled_dot_product_attention (the port never calls it).
2b. Backward kernels against their plain version: the Δ pass, dK/dV and dQ
   kernels (csrc/flash_bwd.cu) and ``flash_bwd_plain`` on the same card
   tensors with a random dO, at bf16 and f32, over the flagship's training
   shape, a non-causal case, a ragged length, Sq < Sk, GQA, head_dim 64 and
   the ViT training shape; errors relative to each gradient's largest
   magnitude, a second call that must give the same bits, each kernel's
   time (CUDA events and profiler device time) and share of its bound, the
   whole wrapper's time, the plain version's, the bound and, as a yardstick
   only, the backward of scaled_dot_product_attention.
3. Serving at full width: the flagship LM (vocab 32768, d_model 2048, 10
   layers, 16 heads, head_dim 128, d_ff 8192, tied embeddings; random
   weights from a seed) answers a batch of 8 prompts of 128 tokens with 256
   greedy tokens through ``generate``, whose decode steps replay one CUDA
   graph (captured once a call), and through the eager loop
   (``_generate_eager``, one eager ``decode_step`` a token), in turns
   (graph, eager, graph). The kernel must launch once per layer (the
   prefill) on both paths and the graph replay once a decode step; the
   graph's tokens equal the eager loop's over the first 32 columns, and a
   sampled run's 16 tokens equal the eager loop's for the same seed. One
   eager decode step runs under CUDA's sync debug mode "error" (no device
   value read on the host), greedy and sampled. The prefill's
   last-position logits are held against the plain attention path; time to
   first token, the capture's seconds, and for both paths tokens/s, decode
   ms a step, the card's busy share and kernels a decode step
   (torch.profiler). Then a small f32 model on the card against the CPU:
   its prefill logits and cache, and 16 tokens of the card's graph path
   against the CPU's eager loop (tokens equal, cache within tolerance).
4. Long prefill: batch 2 at S = 2048 (max_seq) through the kernel, against
   the plain path.
5. Training at full width: the flagship (bench.py's bench_lm configuration,
   remat on) takes 2 warm-up and 5 timed steps of ``make_lm_train_step`` on
   a fixed batch of 8 x 2048 tokens. Each step must launch the forward
   kernel 2 x n_layers times (forward and remat recompute) and each backward
   kernel (Δ, dK/dV, dQ) n_layers times, with finite metrics and a falling
   loss; the first step is held against the plain attention path. Step
   time, tokens/s, MFU, peak memory, and one profiled step's device time by
   kernel class (flash kernels, cuBLAS products, AdamW, element-wise).
6. A small f32 model takes one training step on the card (the kernels) and
   one on the CPU (the plain versions): loss, grad_norm and every updated
   parameter agree.
7. flagship-MoE serving: phase 3 with 4 experts, top-2, in every layer
   (2,248,271,872 parameters), routing dropless at inference. Routing flips
   between the kernel and the plain path (a token whose top-2 gates are
   within bf16 rounding) are counted; rows whose last position kept its
   experts are held to the logit tolerance. Also the MoE layer's device
   time at the decode shape, timed alone, against a decode step's.
8. flagship-MoE training: phase 5 with the same experts (capacity factor
   1.25), the routing flips of the first step counted, and the MoE layer's
   routing, dispatch, expert and combine products timed alone at one
   layer's training shape.
9. ViT training: ``ViTConfig()``'s defaults (224² images, patch 16, 6
   layers, 6 heads of 64, S 197, bidirectional, remat) at batch 128 on
   seeded random images: each step must launch the forward kernel 12 times
   and each backward kernel 6 times, with a falling loss; step time,
   images/s, peak memory and one profiled step.
10. A small f32 MoE LM and a small ViT on the card against the CPU: logits
   and one training step.
11. ResNet-50 training at bench.py's bench_resnet point: 1000 classes, 224²
   images, batch 256 of seeded normal images (NHWC) and labels, SGD at lr
   0.1 with Nesterov momentum 0.9 through ``make_resnet_train_step`` (bf16
   convolutions in cuDNN, channels_last, ``torch.backends.cudnn.benchmark``
   on for this phase only); 3 warm-up steps, then the best of two windows
   of 30 steps. No flash kernel runs on this path (the JAX ResNet runs no
   Pallas kernel): every count must stay 0. Step ms, images/s, the tensor
   cores' bound for the step's convolutions, peak memory, a falling and
   finite loss, batch statistics moved from their init, an eval-mode
   forward's finite logits, and one profiled step's device time by kernel
   class (convolutions, BatchNorm, element-wise, SGD, other).
12. A small f32 ResNet (stages 1, 1, 1, 1; 32² images, 10 classes) on the
   card with TF32 off against the CPU: logits in train and eval mode, then
   one training step's loss, updated parameters and batch statistics.
13. PPO on CartPole (``ray_tpu_torch.rl``) at the JAX package's learning
   gate (tests/test_rl.py): 2 in-process rollout workers x 16 envs x 64
   steps, hiddens (64, 64), lr 3e-4, 8 epochs of minibatch 256, entropy
   0.01, seed 0, 25 iterations in PPO.training_step's order (sample,
   concat, PPOLearner.update on the card, get_weights back to the
   workers). The best mean reward must reach 120. Env steps/s, sample and
   update ms of an iteration, SGD steps/s, and one profiled update's busy
   share and kernels a SGD step. Then the same with the workers on the CPU
   (as the JAX cluster places its rollout actors). No flash kernel runs on
   an RL path (the JAX RL stack reaches no Pallas kernel): every count must
   stay 0.
14. The PPO learner at Atari frame size: ConvRLModule on 84x84x4 frames, 4
   actions, one update of a seeded 5,000-frame batch at minibatch 500 for
   10 epochs, clip 0.1, entropy 0.01 (RLlib's atari-ppo batch settings):
   update ms, samples/s, peak memory, finite stats, a profiled update.
15. Small f32 RL modules (MLP, CNN, LSTM and GTrXL with dones) on the card
   (TF32 off) against the CPU: logits, values, final states, logp and
   entropy of fixed actions, one PPOLearner.update (MLP, CNN) or the
   gradients of a loss over a sequence (LSTM, GTrXL).
16. PPO through its drivers: ``ray_tpu_torch.init(local_mode=True)``, then
   ``PPOConfig()`` at phase 13's gate settings, built with ``device`` left
   at ``None``: the rollout workers and the learner run as actors of the
   port's in-process runtime, their parameters on the card. Train until the
   best mean reward reaches 120, at most 25 iterations (failing the gate
   fails the run); env steps/s (the sum of ``num_env_steps_sampled`` over
   the sum of ``time_this_iter_s``) and the median iteration ms with its
   sample and update parts, beside phase 13's hand loop over as many
   iterations in this same run, with the ratio. Then ``save``, the
   learner as a remote actor holding one card for 3 iterations (finite
   stats), and a fresh ``build()`` that ``restore`` s the checkpoint:
   bitwise-equal weights, the same iteration, one more ``train()``; and one
   sampling round of both workers at fixed weights, in turn in one thread
   against two runtime actors at once. No flash kernel runs (every count
   stays 0), and ``ray_tpu_torch.shutdown()`` must return with no thread
   of the runtime left.
17. IMPALA, APPO and A2C on CartPole through their drivers (``device`` left
   at ``None``: workers and learner on the card). APPO at the JAX
   package's gate (tests/test_rl_appo_vtrace.py:77: 2 workers x 8 envs x 32
   steps, train batch 1024, lr 5e-4, seed 0; best mean reward >= 150
   within 40 iterations): env steps/s, the median iteration with its
   update ms, the updates an iteration and the share of the driver's time
   spent waiting in ``rt.wait``; then save, a fresh ``build()`` and
   ``restore`` with bitwise-equal weights. IMPALA at tests/test_rl.py:129's
   settings (train batch 512) for 3 iterations of at least 512 env steps
   with finite stats; A2C to its gate (>= 40 within 35 iterations, 1 worker
   x 8 envs x 32 steps, batch 256). ``shutdown()`` leaves no runtime thread.
18. The APPO learner at Atari frame size: phase 14's ConvRLModule (84x84x4,
   4 actions) on a seeded synthetic structured batch of T 50 x N 10 = 500
   frames (the fragment length and train batch of RLlib's IMPALA Atari
   tuned example): 20 updates, the median update ms, samples/s, peak
   memory, one profiled update's busy share and kernels, and V-trace's own
   kernels and time at that shape.
19. Off-policy on the card through the drivers: DQN at tests/test_rl.py:116's
   settings for 3 iterations (finite TD loss, epsilon falling), SAC to its
   gate (>= 100 within 40 iterations), TD3 on Pendulum to its assertion
   (>= -700 within 60, stopping when met) and DDPG for 2 iterations; each
   with env steps/s, updates/s and the median update ms (2 windows of 20
   updates on minibatches from its own buffer, each ending in a
   synchronize), and a bitwise save -> build() -> restore.
20. Offline on the card: ``collect_experiences`` with the JAX tests'
   pole-angle controller (4,000 steps) into a temporary directory, then BC,
   MARWIL and CQL for 5 iterations each at the JAX tests' settings, with
   updates/s and a greedy evaluation; CQL must hold ``cql_loss >= 0`` and
   evaluate to a mean reward >= 60.
21. Small f32 learners on the card (TF32 off) against the CPU from the same
   weights and batch, one update each: APPOLearner (V-trace on the card),
   DQN's TD step, SACLearner, TD3Learner at target_noise=0, CQL, QMIX's TD
   step and MADDPG's update (past the actor delay); every parameter and
   target leaf within 1e-4, and each learner's seeded initial weights
   bitwise equal on the card and the CPU.
22. The rest of RL on the card, each at its JAX test's settings and seed,
   none cut, ``device`` left at ``None``: QMIX on ``TwoStepCoopEnv(horizon=
   8)`` (epsilon decay 1,500, seed 1) above 6.0 after 14 iterations
   (tests/test_rl_breadth.py:29); MADDPG on ``CoopSpreadEnv(horizon=10)``
   (seed 2) above -5.5 after 12 and its greedy median error on
   ``CoopSpreadEnv(seed=77)`` below 0.3 (:81); ES on CartPole (2 workers as
   runtime actors, 12 perturbations, horizon 200, seed 3) above max(40,
   first + 10) after 12 more (:64); the shared-policy collector
   (``MultiAgentCollector``, a torch Adam at 3e-3) above 0.9 within 40
   iterations of 64 steps (tests/test_rl_connectors_multiagent.py:88); and
   the bandits (UCB, TS) on the host, their regret halved and below 0.1
   (:107). Each prints where the gate was first met and the best value,
   env steps/s (QMIX, MADDPG, the collector) or episodes/s (ES), and for
   QMIX and MADDPG the median update ms over windows of 20 updates, each
   ending in a synchronize. QMIX, MADDPG and ES each save, build afresh
   and restore bitwise; ``shutdown()`` leaves no runtime thread.

23. The parallel layer on one rank (``ray_tpu_torch.parallel``, ``ops``):
   ``build_mesh(MeshSpec())`` with ``device`` left at ``None`` starts a
   one-rank NCCL group whose ``DeviceMesh`` is on ``cuda`` with the seven
   axis names; every function of ``parallel/collectives.py`` returns its
   input bitwise on every axis and on (dp, fsdp); ring and Ulysses
   attention at the flagship's attention shape (B 8, S 2048, 16 heads of
   128, causal) against ``attention_reference`` in f32, from f32 and from
   bf16 inputs, with their milliseconds beside the flash kernel's (CUDA
   events); ``pipeline_apply`` at pp = 1 over 2 microbatches of 2 flagship
   layers against ``_stage_apply``; the flagship train step (phase 5's
   configuration, B 8 x 2048) through ``make_lm_train_step(cfg, mesh)``:
   3 steps from the seeded init of ``mesh=None``'s 3, each loss within
   2e-3 of its, flash launches of (20, 10, 10, 10) a step, both paths'
   step ms and their ratio (DTensor's cost at one rank), and
   ``attn_impl="ring"``'s loss within 2e-3 of the flash loss, and each
   leaf's first-step gradient with the mesh against ``mesh=None``; one
   ``PPOLearner.update`` with the mesh within 1e-5 of ``mesh=None`` (f32);
   the ViT (phase 9's ``ViTConfig()`` at B 128) through
   ``make_vit_train_step(cfg, mesh)`` and ResNet-50 (phase 11's B 256 at
   224²) through ``make_resnet_train_step(mesh)`` (BatchNorm over the
   global batch), each 3 steps from the seeded init of ``mesh=None``'s 3,
   each loss within 2e-3 of its, the ViT's flash launches (12, 6, 6, 6) a
   step, ResNet's 0 and its new batch statistics within 1e-2 of each
   leaf's magnitude, both paths' step ms and their ratio. Expert
   parallelism needs an ``ep`` axis above 1, so more than one rank, which
   is one card each under NCCL: the phase says so and leaves it to the
   CPU tests. The phase destroys its process group.
24. Serve over HTTP (``ray_tpu_torch.serve`` on the port's in-process
   runtime, ``init(local_mode=True)``): the flagship (phase 3's
   configuration, bf16, weights drawn on the card from a seed) behind
   ``@serve.deployment(num_replicas=1)``, whose one
   ``@serve.batch(max_batch_size=8)`` method left-pads the prompts, calls
   ``generate`` (prompts of 128 tokens, ``HTTP_NEW`` = 64 greedy tokens,
   cut from 256) and records each batch's prompts in order; started by
   ``serve.run(..., http_host="127.0.0.1")`` on an ephemeral port. 8
   client threads each POST one seeded prompt at once, for one warm round
   and then 1 timed round. Every response must be 200; each response's
   tokens must equal those of a direct ``generate`` of the batch the
   deployment formed, in
   its row order; the forward kernel must launch n_layers times per
   ``generate`` call the deployment made (and no backward kernel); after
   ``serve.shutdown()`` no proxy may be open and no replica alive, and
   after ``shutdown()`` no runtime thread left. Prints the batch sizes,
   requests/s, generated tokens/s through HTTP and p50/p99 request latency
   of the timed rounds, beside phase 3's direct ``generate`` tokens/s from
   this run and their ratio (the serve front's cost).

25. The cluster runtime (``ray_tpu_torch.cluster``, worker processes, the
   shm object store): ``cluster_utils.Cluster(initialize_head=True,
   head_node_args={"num_cpus": 4, "object_store_bytes": ...})``, then
   ``ray_tpu_torch.init(address=c.address)``. ``cluster_resources()`` must
   count the card as ``"GPU": 1`` (``gpu/topology.py``); ``df -B1
   /dev/shm`` and the store's size are printed, and the store and the
   table below are sized to fit (the phase fails, with both numbers, if
   1024 rows of the table cannot). A plain task must see
   ``CUDA_VISIBLE_DEVICES=""`` and no card. An actor with ``num_gpus=1``
   (``FlagshipWorker``, a fresh worker process that sees one card) draws
   the flagship on the card from seed 0 (phase 3's configuration, bf16,
   full width and depth), checks the flash forward against its plain
   version in its process (phase 2's bf16 tolerance), and runs
   ``generate`` on phase 3's 8 seeded prompts of 128 tokens for 64 greedy
   tokens (cut from 256: the phase measures the path): its tokens (through the store) must equal the driver's direct
   ``generate`` of the same weights and prompts in this run, with 10
   forward launches and no backward one in the worker; its tokens/s
   (measured in the worker) is printed beside the driver's and their
   ratio. The driver ``put`` s the flagship's embedding table as f32 numpy
   (32768 x 2048, 268 MB); the actor gets it, moves it to the card and
   returns it doubled; the result must be bitwise 2x the table, with MB/s
   each way. Then the actor is killed, ``shutdown()`` and
   ``Cluster.shutdown()``: no process of the session, no store segment of
   the port's prefix and no worker's context on the card may be left:
   ``nvidia-smi --query-compute-apps`` must list more contexts while the
   GPU actor lives than before the phase, and no more than before once
   the cluster is down (it counts them: in a container its pids are the
   host's).

26. A compiled graph on the card (``ray_tpu_torch.dag``): on a port
   ``Cluster`` as in phase 25, a ``num_gpus=1`` actor draws the flagship's
   activation shape at the serve cell ([8, 128, 2048] bf16) on its card
   from a per-call seed, and a CPU actor reduces it (f32 sum and a few
   values). The same two-step graph runs compiled (``InputNode`` ->
   ``make`` -> ``reduce``, ``experimental_compile``) at the default 1 MiB
   slot (the 4 MiB tensor spills to the store) and at a 6 MiB slot that
   holds it, and as the classic ``.remote()`` chain; each prints round
   trips/s (sequential execute-and-get). Every result must equal the
   classic path's. After ``teardown()`` no compiled graph may be alive, no
   channel segment of the cluster's stores left and no loop on either
   worker.
27. MPMD pipeline training at full width (``train.pipeline.PipelineTrainer``
   on the port's cluster): the flagship with ``tied_embeddings=False``
   (805,306,368 parameters) and remat, 2 stages of 5 layers each in two
   ``num_gpus=0.5`` stage actors that share the card, the ``1f1b`` schedule
   over 4 microbatches of the train cell's batch (8 x 2048, seeded), AdamW
   at 3e-4. First the same weights (drawn on the card from the seed) and
   batches through ``make_lm_train_step`` in the driver: the pipeline's
   first loss must be within ``PIPE_LOSS_TOL`` of it and the next three
   within ``PIPE_LATER_TOL``. The stage actors must launch the flash
   forward, dK/dV, dQ and Δ kernels (100, 40, 40, 40) times a step, counted
   in their processes from 0 just before the timed steps. Prints step ms,
   tokens/s, each stage's busy and codec seconds (the codec is the
   transport: copies between card and host, pickling, spills through the
   store), the measured efficiency beside ``bubble_bound`` (with both stages on one
   card the efficiency measures the transport and two contexts taking
   turns on the card, not the schedule's bubble), and each actor's peak
   card memory; then the same at ``pipeline_slot_bytes`` of 17 MiB, where
   the 16 MiB microbatch activations ride the ring instead of the store.
   Teardown leaves no process of the session, no segment and no extra card
   context.
28. The trainer on the card (``train.TorchTrainer`` on a port ``Cluster``
   whose head counts the card as ``"GPU": 1``): first the driver runs
   phase 5's program (the flagship, remat, tied, AdamW at batch 8 x 2048,
   weights and tokens from seed 3) for 1 settling and 2 timed steps and
   frees it. Then ``TorchTrainer(gang_loop, scaling_config=
   ScalingConfig(topology=<the head's NVLink domain type>))``: one rank a
   card of the domain (one here), gang-placed with strategy ``SLICE``,
   whose placement group must name the head's domain; a one-rank NCCL
   gang whose worker process leases the card. The
   loop checks its NCCL group of one and its device (``cuda:0`` of one
   visible card), runs the same program on ``torch_utils.get_device()``
   with a ``session.report`` each step, the flash launches counted in the
   worker from 0 before the timed steps (they must be (40, 20, 20, 20)),
   and its peak card memory; then ResNet-50 at phase 11's point (3 warm
   and 3 timed steps, no flash launch). The gang's losses must be within
   ``GANG_LOSS_TOL`` of the driver's and its first ResNet loss within
   ``RESNET_FIRST_LOSS_TOL`` of phase 11's. Prints step ms, tokens/s, MFU,
   the ratio to the driver's step ms, the seconds from ``fit()`` to the
   first report and of the whole ``fit()``, and ResNet-50's images/s
   beside phase 11's. Teardown leaves no process, segment or extra card
   context.
29. The data library feeding the trainer (``ray_tpu_torch.data`` on a port
   ``Cluster`` whose head counts the card as ``"GPU": 1``, 4 CPUs and a 2
   GiB store): at least 2 MiB of seeded synthetic text (words drawn from
   ``DATA_WORDS``) through ``from_items(parallelism=16)`` ->
   ``tokenize_and_pack(seq_len=2048)`` -> ``random_shuffle(seed=3)``,
   materialized on the cluster's CPU workers, with its documents, bytes,
   rows, seconds and tokens/s; and 6 blocks of 256 seeded uint8 images at
   224² (``range(...).map_batches(data_images)``, 231 MB). Then
   ``TorchTrainer(data_gang_loop, datasets={"train": ..., "images": ...},
   scaling_config=ScalingConfig(num_workers=1))``: the worker trains the
   flagship at phase 28's cell from its shard's batches
   (``iter_torch_batches(batch_size=8, drop_last=True)``, each copied to
   the card), 1 settling and 2 timed steps that must launch (40, 20, 20,
   20), with the wait for each batch, then drains the rest of its shard
   through the copy to the card (rows/s, MB/s); then ResNet-50 from the
   image shard (each batch copied to the card and converted there), 3 warm
   and 3 timed steps. The losses must be within ``GANG_LOSS_TOL`` of the
   driver's steps on the same rows and the first ResNet loss within
   ``RESNET_FIRST_LOSS_TOL``. Prints step ms and images/s beside phase
   28's, tokens/s, MFU and the seconds from ``fit()`` to the first report.
   pyarrow, pandas and PIL must not be loaded in the driver or the worker.
   Teardown leaves no process, segment or extra card context.

30. Serve on the cluster runtime (``serve`` on a port ``Cluster`` whose
   head counts the card as ``"GPU": 1``, 4 CPUs): the controller, the HTTP
   proxy and every replica are worker processes. ``ServeLM``, a
   module-level deployment with ``ray_actor_options={"num_gpus": 1}``,
   draws the flagship's weights from seed 24 on its replica's card and
   serves phase 24's traffic (8 clients x 2 rounds, 1 warm, seed-24
   prompts of 128 tokens, ``HTTP_NEW`` = 64 new tokens) behind the same
   ``@serve.batch``. Every status must be 200, each prompt in exactly one batch, every
   answer equal to the driver's direct ``generate`` of its batch with the
   same weights (their f64 digests equal), and the replica must count
   ``n_layers`` forward launches a ``generate``. Prints requests/s,
   tokens/s, p50/p99, the ratio to phase 24's tokens/s, the replica's
   start seconds (spawn, CUDA, weights) and the card contexts (the driver
   and the replica: the controller and the proxy hold none). Then
   ``serve.run(..., compile=True)``: the handle's calls must ride the
   replica's compiled graph and answer as the classic handle does, and
   after ``teardown_compiled()`` the classic path answers the same; a
   module-level CPU ``SmokeDoubler``'s 100 round trips through the classic
   and the compiled handle, in turns, beside phase 26's ratio. Then the
   replica calls ``os._exit(1)``: the controller sees it DEAD through the
   conductor and starts a new GPU replica; the seconds from the kill to
   the first 200, whose answer must equal the driver's. Teardown leaves
   no process, segment (store or channel) or extra card context.
31. The RL drivers on the cluster runtime (a port ``Cluster`` whose head
   counts the card as ``"GPU": 1``, 4 CPUs; ``init(address=...)``). (a)
   PPO at phase 13's gate settings with the learner on the card in the
   driver and the 2 rollout workers as CPU worker processes (each must see
   no card, make no CUDA context and run one torch thread); the gate must
   be met within 25 iterations. Env steps/s (also after the first
   iteration, which pays the workers' start), the median iteration with
   its sample and update parts, beside phase 16's in-process drivers and
   phase 13's CPU-worker hand loop from this call. (b) The same with
   ``learner_remote=True, learner_num_gpus=1``: the learner in a GPU
   worker process, the same gate, 2 card contexts while it trains (the
   driver's and the learner's); then ``save()`` and a fresh build with the
   learner in the driver ``restore`` s it: 12 of 12 leaves bitwise equal.
   (c) IMPALA and APPO, 2 iterations each (env steps/s, the ``rt.wait``
   share); then a fresh build stopped at once, its first samples in flight
   (``SlowCartPole``, 100 ms a step): both refs must fail as dead-actor
   errors and no actor stay ALIVE. (d) DQN, TD3 and ES: one ``train()``
   each, finite stats, the collectors and ES workers CPU processes.
   Teardown leaves no process, segment or extra card context.
32. The head's control surface (``init()``, ``python -m ray_tpu_torch``,
   ``client://``, jobs, the state API, the dashboard). ``init()`` with no
   address must start a head in this process whose
   ``cluster_resources()["GPU"]`` is 1.0 and whose node
   ``state.list_nodes()`` shows; its daemon's NVLink domain
   (``detect_domain``) must name the card's generation and count the
   visible cards, and the conductor's ``get_slices()`` must hold it,
   complete, with the head as its one host; ``shutdown()`` leaves no process or
   segment. Then ``python -m ray_tpu_torch start --head --port 0`` with a
   ``TMPDIR`` of its own, ``client-server``, and a driver script that
   connects with ``init("client://...")``: a ``num_gpus=1`` actor
   (``ControlLM``) draws phase 3's flagship from seed 32 on its card and
   generates for 8 seeded prompts of 128 tokens, 32 greedy tokens (cut
   from 256: the phase measures the path, not the decode loop); its
   tokens must equal the driver's direct ``generate`` of the same weights
   and prompts, with 10 forward launches in that worker; then 100 round
   trips of a trivial task through the client. Before the actor the client
   sends a ``num_gpus=1`` task named by ``import_path``
   (``chip_smoke:control_generate_task``) on the proxy's wire, with no
   function blob, as a client in another language does: its tokens must
   equal the driver's row for row, with 10 forward launches in its worker,
   which goes back to the pool for the actor to take (printed). ``job
   submit --follow`` runs a script that connects with
   ``init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])`` and runs the
   same ``generate`` in a ``num_gpus=1`` task (``control_generate_task``): the job must end
   ``SUCCEEDED`` with the driver's token digest in its logs and 10 launches
   in its worker. ``state.list_actors()`` must show the client's actor
   DEAD after its kill, ``list_jobs()`` the job, the dashboard's
   ``/api/cluster`` and ``status`` one GPU; ``stop`` must leave no process,
   segment or extra card context. Prints each step's seconds, the head's
   start, the GPU worker's start behind the client and the job, the
   client's round trips/s and both ``generate`` s' tokens/s beside the
   driver's.

33. The elastic and durable runtime (``python -m ray_tpu_torch up``,
   the autoscaler, ``submit``, workflows, ``down``). A JSON spec with a head
   of ``{"CPU": 2}`` and no card, the ``fake`` provider and a node type
   ``gpu_worker`` of ``{"CPU": 1, "GPU": 1}`` (0 to 1 nodes, idle timeout
   3 s) goes ``up`` with a ``TMPDIR`` of its own; the state API must show
   one node at ``GPU`` 0. A ``submit`` ted job runs a workflow on a
   directory storage: a ``num_gpus=1`` step that is phase 32's
   ``control_generate_task`` (seed 32, the same prompts, 32 new tokens), a
   CPU step that digests its tokens, and a CPU step that fails on its first
   run. The job must end ``FAILED`` with the workflow resumable, the
   autoscaler must have launched exactly one ``gpu_worker`` node, the
   digest step's checkpoint must equal phase 32's job digest, and the card
   step's worker must count 10 forward launches. The idle GPU node must
   then be terminated: no GPU node alive, the state API at ``GPU`` 0 and
   no more card contexts than before the phase. A second job calls
   ``workflow.resume``: it must end ``SUCCEEDED`` with the same digest,
   run no card step (no GPU node launched) and see ``GPU`` 0. ``down``
   must leave no head session, session process, segment, state file or
   extra card context. Prints the seconds from ``submit`` to the GPU
   node's registration and to the card step's answer, the GPU worker's
   spawn seconds, the flagship's tokens/s in it, the seconds from the card
   step's answer to the node's termination, the resume's seconds and the
   phase's.
34. The control plane's microbenchmarks: ``python -m
   ray_tpu_torch.cluster.microbench --quick`` in a subprocess on the card's
   host, on a port cluster of its own whose head has no card. Every result
   name of the JAX suite must be there with a finite, positive value, or be
   one of the port's listed divergences with its reason; each is printed
   with its family's wall seconds (host numbers). rtcheck over
   ``ray_tpu_torch/`` (in this process and as ``python -m
   ray_tpu_torch.devtools.rtcheck``) must find nothing, and ``python -m
   ray_tpu_torch microbenchmark --address ...`` must exit non-zero. No
   process, segment or card context may be left.
35. Tune on the card: a head from ``init()`` counts the card as ``"GPU"``;
   a ``Tuner`` runs ``tune_flagship_trial`` (the flagship at full width,
   remat, bf16, the flash kernels, ``make_lm_train_step`` at batch 4 x 2048
   from seed 35) over 4 learning rates (``grid_search``) under
   ``AsyncHyperBandScheduler(max_t=6, grace_period=2,
   reduction_factor=2)``, each trial a task holding ``{"CPU": 1, "GPU":
   0.5}``, two at a time, one training step a report. All 4 trials must
   end, ASHA must stop at least one before ``max_t``, each trial's first
   loss must equal the driver's first step on the same weights and batch
   within ``TRAIN_LOSS_TOL``, every step must launch the forward 20 times
   and each backward kernel 10 times in the trial's worker, the best
   trial's loss must fall, and afterwards ``GPU`` must be back at 1 and no
   card context left. Prints each trial's losses, seconds to its start and
   first report, step ms against phase 5's, and peak memory.

36. The port's examples on the card:
   ``examples_torch/02_train_lm_multichip.py`` (a one-rank NCCL gang on a
   one-card mesh, on the in-process runtime),
   ``03_serve_lm.py --local-mode`` (the LM behind a replica thread over
   HTTP) and ``05_rl_cartpole.py --local-mode`` (PPO, the learner on the
   card): ``02``'s 5 losses finite
   and falling and launches (20, 10, 10, 10), ``03``'s 16 tokens and
   launches (2, 0, 0, 0), ``05``'s 5 iterations of 1,024 env steps and no
   launch; no card context left. They run through ``runpy`` in this
   process, which has paid ``import torch`` and torch._dynamo's already.

No flash kernel runs on phases 13-22 and 31 (the JAX RL stack reaches no
Pallas kernel): each path's counts must stay 0, as they must for ring,
Ulysses and the PPO learner in phase 23. Every phase prints its seconds.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}`` with the one card the run used.
Without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.rl.env import CartPoleVectorEnv

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12      # outside the tensor cores: the f32 kernel's FMA
PEAK_BYTES = 3.35e12

# Tolerances, kernel against its plain version on the same card tensors.
# bf16: P is rounded to bf16 per kv tile against the running max in the
# kernel, once per row against the final max in the plain version, and O is
# rounded to bf16 (one ulp of a value near 1 is 2^-8); LSE is f32 in both.
# f32: only the order of the f32 sums differs.
TOL = {torch.bfloat16: {"out": 2e-2, "lse": 1e-3},
       torch.float32: {"out": 1e-4, "lse": 1e-4}}
# Flagship logits, kernel path against the plain attention path at bf16:
# both round every layer's activations to bf16, so the two drift apart by a
# few bf16 ulps of the logits (std ~1) over 10 layers.
LOGIT_TOL_BF16 = 0.25
# A small f32 model, card (kernel, cuBLAS) against CPU (plain path).
LOGIT_TOL_F32 = 1e-3
# Backward kernels against their plain version on the same card tensors, on
# the largest error of dq, dk and dv relative to that gradient's largest
# magnitude (bf16 gradients at S 2048 are far from 1). bf16: P and dS are
# rounded to bf16 in both versions, from f32 values summed in another order,
# and the outputs are rounded to bf16 (2^-8 of their size). f32: the order
# of the f32 sums.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# First training step of the flagship, kernel path against the plain
# attention path, both at bf16: the loss (~ln 32768 = 10.4 at random
# weights) is a mean over 16k tokens, so the per-logit drift of a few bf16
# ulps averages out to well under 1e-2; the gradient norm sums bf16 products
# of every layer, 2% relative. The same holds for flagship-MoE: a token whose
# top-2 flips between the paths (router logits within bf16 rounding of a
# tie) carries another hidden state into the later layers, so flips compound
# with depth, but each changes its own loss term by a random sign and the
# mean over 16k tokens stays far inside 1e-2.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GNORM_RTOL = 2e-2


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10):
    """Mean milliseconds of device time of the kernels ``fn`` launches
    (torch.profiler's kernel intervals), free of the host's launch cost;
    None where the profiler records no device events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_kernels(prof)
    if not events:
        return None
    return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _visible_pairs(sq, sk, causal):
    """(q, k) pairs the mask leaves, the diagonal offset by sk - sq."""
    if not causal:
        return sq * sk
    rows = np.arange(sq) + (sk - sq) + 1
    return int(np.clip(rows, 0, sk).sum())


def _bound(flops, nbytes, dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, sq, sk, h, kvh, d, causal, dtype):
    """Least milliseconds for the forward: each input byte read once, each
    output byte written once; operations 4*D per visible (q, k) pair."""
    es = torch.empty((), dtype=dtype).element_size()
    flops = 4.0 * b * h * d * _visible_pairs(sq, sk, causal)
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kvh * d) * es + b * h * sq * 4
    return _bound(flops, nbytes, dtype)


def backward_bound(b, sq, sk, h, kvh, d, causal, dtype, part="all"):
    """Least milliseconds for the backward, or for one of its kernels.

    all: q, k, v, o, dO and LSE in, dq, dk, dv out; 10*D operations per
    visible pair (Q K^T, dV, dP, dK, dQ). dkv: q, k, v, dO, LSE and Delta
    in, dk, dv out; 8*D (Q K^T, dV, dP, dK). dq: the same in, dq out; 6*D
    (Q K^T, dP, dQ)."""
    es = torch.empty((), dtype=dtype).element_size()
    q_elems, kv_elems, stats = b * sq * h * d, b * sk * kvh * d, b * h * sq
    ops_per_d, ins, outs = {
        "all": (10, 3 * q_elems + 2 * kv_elems, q_elems + 2 * kv_elems),
        "dkv": (8, 2 * q_elems + 2 * kv_elems, 2 * kv_elems),
        "dq": (6, 2 * q_elems + 2 * kv_elems, q_elems),
    }[part]
    flops = ops_per_d * b * h * d * _visible_pairs(sq, sk, causal)
    nbytes = (ins + outs) * es + stats * 4 * (1 if part == "all" else 2)
    return _bound(flops, nbytes, dtype)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    from ray_tpu_torch import require_sm90
    from ray_tpu_torch.ops import _build
    require_sm90(torch.device("cuda", 0))
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] seconds={time.perf_counter() - t0:.1f} (nvcc for every "
          f"stale source, in parallel) into {_build.BUILD_DIR}", flush=True)
    spills = {}
    for name in ("flash_fwd", "flash_bwd"):
        entry = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "spill stores" in line and "bf16_kernel" in entry:
                spills[f"{name}:{entry[-60:]}"] = line.strip()
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "C75" in line or "arning" in line):
                print(f"[build] {name}: {line.strip()}")
    from ray_tpu_torch.ops import flash
    attrs = {f"fwd_bf16_d{d}": flash.fwd_kernel_attributes(d)
             for d in (64, 128)}
    for d in (64, 128):
        for part, a in flash.bwd_kernel_attributes(d).items():
            attrs[f"bwd_{part}_bf16_d{d}"] = a
    for name, a in attrs.items():
        print(f"[build] {name}: {a['registers']} registers a thread at "
              f"launch (setmaxnreg then moves them: producer 24, consumers "
              f"240), {a['local_bytes']} bytes of local memory a thread, "
              f"{a['smem_bytes']} bytes of dynamic shared memory", flush=True)
    # the forward, dK/dV and dQ bf16 kernels at D 64 and 128
    check(len(spills) == 6 and all("0 bytes spill stores" in v
                                   for v in spills.values())
          and all(a["local_bytes"] == 0 for a in attrs.values()),
          f"bf16 flash kernels spill or are missing from ptxas' report: "
          f"{spills}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[setup] torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False: f32 products run in full "
          "f32", flush=True)
    return card, {"attributes": attrs, "ptxas_bf16_spills": spills}


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# name, (b, sq, sk, h, kvh, d), causal
CASES = [
    ("serve_prefill", (8, 128, 128, 16, 16, 128), True),
    ("max_seq_causal", (8, 2048, 2048, 16, 16, 128), True),
    ("max_seq_full", (8, 2048, 2048, 16, 16, 128), False),
    ("ragged", (2, 1000, 1000, 16, 16, 128), True),
    ("sq_lt_sk", (2, 300, 1000, 16, 16, 128), True),
    ("sq_gt_sk", (2, 300, 100, 16, 16, 128), True),
    ("fused_qkv_view", (2, 1000, 1000, 16, 16, 128), True),
    ("gqa", (2, 512, 512, 16, 4, 128), True),
    ("head_dim_64", (2, 777, 777, 8, 8, 64), True),
    ("vit_train", (128, 197, 197, 6, 6, 64), False),
]
# cases whose q, k and v are strided views of one [B, S, 3, H, D] tensor
FUSED = {"fused_qkv_view"}


def _case_inputs(name, shape, gen):
    """q, k, v maker for one case: fn(dtype) -> (q, k, v) on the card."""
    b, sq, sk, h, kvh, d = shape
    if name in FUSED:
        qkv = torch.randn(b, sq, 3, h, d, generator=gen, device="cuda")
        return lambda dtype: qkv.to(dtype).unbind(2)
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda")
    k = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
    v = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
    return lambda dtype: (q.to(dtype), k.to(dtype), v.to(dtype))


def _library_ms(q, k, v, causal):
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = {"enable_gqa": k.shape[2] != q.shape[2]}
    if causal and sq != sk:   # bottom-right diagonal, as the kernel's
        kw["attn_mask"] = torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device).tril(sk - sq)
    else:
        kw["is_causal"] = causal

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    return cuda_ms(sdpa), device_ms(sdpa)


def phase_kernel_checks():
    from ray_tpu_torch.ops import flash
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for name, shape, causal in CASES:
        b, sq, sk, h, kvh, d = shape
        make = _case_inputs(name, shape, gen)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make(dtype)
            with torch.inference_mode():
                out, lse = flash.flash_fwd(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want, want_lse = flash.flash_fwd_plain(q, k, v, causal=causal)
                err = (out.float() - want.float()).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                check(torch.isfinite(out).all().item(), f"{name}: non-finite O")
                exact = ""
                if causal and sq > sk:   # rows that see no key, exactly
                    blind = sq - sk
                    check(bool((lse[:, :, :blind] == -1e30).all())
                          and bool((out[:, :blind] == 0).all())
                          and bool((want_lse[:, :, :blind] == -1e30).all()),
                          f"{name}: rows that see no key are not exactly "
                          f"O = 0, LSE = -1e30")
                    exact = f" rows_without_key={blind}: O=0, LSE=-1e30 exact"

                def fn():
                    return flash.flash_fwd(q, k, v, causal=causal)

                ms, dev_ms = cuda_ms(fn), device_ms(fn)
                plain_ms = cuda_ms(lambda: flash.flash_fwd_plain(
                    q, k, v, causal=causal), iters=3, warmup=1)
                lib_ms, lib_dev_ms = _library_ms(q, k, v, causal)
            bound_ms, bound_by = attention_bound(b, sq, sk, h, kvh, d,
                                                 causal, dtype)
            tol = TOL[dtype]
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"[kernel] {name} {tag} b={b} sq={sq} sk={sk} h={h} "
                  f"kvh={kvh} d={d} causal={causal}"
                  f"{' fused-qkv strided views' if name in FUSED else ''}: "
                  f"max_abs_err O={err:.3e} (tol {tol['out']:.0e}) "
                  f"LSE={lse_err:.3e} (tol {tol['lse']:.0e}){exact} "
                  f"kernel_ms={ms:.4f} device_ms={_fmt(dev_ms)} "
                  f"plain_ms={plain_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} ({bound_by}) "
                  f"library_ms={lib_ms:.4f} library_device_ms="
                  f"{_fmt(lib_dev_ms)} bound/kernel={bound_ms / ms:.3f}",
                  flush=True)
            check(err <= tol["out"] and lse_err <= tol["lse"],
                  f"{name} {tag}: kernel disagrees with its plain version")
            results[(name, tag)] = dict(
                max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, shape=[b, sq, sk, h, kvh, d])
            del q, k, v
        del make
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 2b
# ---------------------------------------------------------------------------

# name, (b, sq, sk, h, kvh, d), causal
BWD_CASES = [
    ("train_causal", (8, 2048, 2048, 16, 16, 128), True),
    ("full", (2, 2048, 2048, 16, 16, 128), False),
    ("ragged", (2, 1000, 1000, 16, 16, 128), True),
    ("sq_lt_sk", (2, 300, 1000, 16, 16, 128), True),
    ("gqa", (2, 512, 512, 16, 4, 128), True),
    ("head_dim_64", (2, 777, 777, 8, 8, 64), True),
    ("vit_train", (128, 197, 197, 6, 6, 64), False),
]


def _library_bwd_ms(q, k, v, do, causal):
    """scaled_dot_product_attention's backward alone: its forward plus
    backward, less its forward (both recorded under autograd)."""
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    kw = {"enable_gqa": k.shape[2] != q.shape[2]}
    if causal and sq != sk:
        kw["attn_mask"] = torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device).tril(sk - sq)
    else:
        kw["is_causal"] = causal

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    return cuda_ms(fwd_bwd) - cuda_ms(fwd)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def delta_bound(b, sq, h, d, dtype):
    """Least milliseconds for the Δ pass: O and dO read once, LSE read once
    and LSE·log2 e written (bf16 only), Δ written; 2*D operations a row on
    the FMA units."""
    es = torch.empty((), dtype=dtype).element_size()
    stats = b * h * sq * 4 * (3 if dtype == torch.bfloat16 else 1)
    nbytes = 2 * b * sq * h * d * es + stats
    t_ops = 2.0 * b * sq * h * d / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _share(bound, times):
    """Share of the bound reached: by device time where the profiler gave
    one, else by CUDA-event time."""
    ms_events, ms_device = times
    return bound / (ms_device if ms_device is not None else ms_events)


def phase_backward_checks():
    from ray_tpu_torch.ops import flash
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = {}
    for name, (b, sq, sk, h, kvh, d), causal in BWD_CASES:
        q0 = torch.randn(b, sq, h, d, generator=gen, device="cuda")
        k0 = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
        v0 = torch.randn(b, sk, kvh, d, generator=gen, device="cuda")
        do0 = torch.randn(b, sq, h, d, generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (x.to(dtype) for x in (q0, k0, v0, do0))
            scale = d ** -0.5
            with torch.inference_mode():
                out, lse = flash.flash_fwd(q, k, v, causal=causal)
                got = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
                torch.cuda.synchronize()
                again = flash.flash_bwd(q, k, v, out, lse, do, causal=causal)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                want = flash.flash_bwd_plain(q, k, v, out, lse, do,
                                             causal=causal)
                rel = [_rel_err(g, w) for g, w in zip(got, want)]
                abs_err = [(g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want)]
                check(all(torch.isfinite(g).all().item() for g in got),
                      f"{name}: non-finite gradient")
                check(same, f"{name}: two backward calls differ")
                lse_k, delta = flash.bwd_preprocess(out, do, lse)
                delta_want = flash.bwd_delta(out, do)
                delta_err = _rel_err(delta[..., :sq], delta_want)
                delta_abs = (delta[..., :sq] - delta_want).abs().max().item()
                args = (q, k, v, do, lse_k, delta,
                        *(torch.empty_like(g) for g in got), causal, scale)

                def run_delta():
                    flash.bwd_preprocess(out, do, lse)

                def run_dkv():
                    flash.bwd_dkv(*args)

                def run_dq():
                    flash.bwd_dq(*args)

                def run_all():
                    flash.flash_bwd(q, k, v, out, lse, do, causal=causal)

                times = {part: (cuda_ms(fn), device_ms(fn)) for part, fn in
                         (("delta", run_delta), ("dkv", run_dkv),
                          ("dq", run_dq), ("wrapper", run_all))}
                delta_plain_ms = cuda_ms(lambda: flash.bwd_delta(out, do))
                plain_ms = cuda_ms(lambda: flash.flash_bwd_plain(
                    q, k, v, out, lse, do, causal=causal), iters=3, warmup=1)
                del want, got, again
            lib_ms = _library_bwd_ms(q, k, v, do, causal)
            shape = (b, sq, sk, h, kvh, d, causal, dtype)
            bounds = {"wrapper": backward_bound(*shape),
                      "dkv": backward_bound(*shape, part="dkv"),
                      "dq": backward_bound(*shape, part="dq"),
                      "delta": delta_bound(b, sq, h, d, dtype)}
            tol = BWD_TOL[dtype]
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            timing = " ".join(
                f"{part}: ms={times[part][0]:.4f} device_ms="
                f"{_fmt(times[part][1])} bound_ms={bounds[part][0]:.4f} "
                f"({bounds[part][1]}) share="
                f"{_share(bounds[part][0], times[part]):.3f};"
                for part in ("delta", "dkv", "dq", "wrapper"))
            print(f"[backward] {name} {tag} b={b} sq={sq} sk={sk} h={h} "
                  f"kvh={kvh} d={d} causal={causal}: max_rel_err "
                  f"dq={rel[0]:.3e} dk={rel[1]:.3e} dv={rel[2]:.3e} "
                  f"(tol {tol:.0e}; max_abs_err dq={abs_err[0]:.3e} "
                  f"dk={abs_err[1]:.3e} dv={abs_err[2]:.3e}) delta_rel_err="
                  f"{delta_err:.3e} (tol 1e-5) bitwise_repeatable={same} | "
                  f"{timing} delta_plain_ms={delta_plain_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}",
                  flush=True)
            check(max(rel) <= tol and delta_err <= 1e-5,
                  f"{name} {tag}: backward kernels disagree with their "
                  f"plain version")
            results[(name, tag)] = dict(
                rel=rel, abs=abs_err, delta_err=delta_err,
                delta_abs=delta_abs, times=times,
                bounds=bounds, plain_ms=plain_ms,
                delta_plain_ms=delta_plain_ms, library_ms=lib_ms,
                shape=[b, sq, sk, h, kvh, d])
        del q0, k0, v0, do0
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 3, 4 and 7
# ---------------------------------------------------------------------------

def flagship_cfg(**kw):
    """bench.py's flagship decode configuration (the ~0.74B LM)."""
    from ray_tpu_torch.models import TransformerConfig
    return TransformerConfig(vocab_size=32768, d_model=2048, n_layers=10,
                             n_heads=16, n_kv_heads=16, d_ff=8192,
                             max_seq=2048, attn_impl="auto",
                             tied_embeddings=True, **kw)


def _prefill_logits(params, prompt, cfg, max_len):
    from ray_tpu_torch.models import prefill
    from ray_tpu_torch.models.generate import _cast_params
    with torch.inference_mode():
        logits, _ = prefill(_cast_params(params, cfg.dtype), prompt, cfg,
                            max_len)
    torch.cuda.synchronize()
    return logits


def moe_cfg(**kw):
    """flagship-MoE: the flagship's widths and depth with 4 experts, top-2
    (the repo's own MoE setting, tests/test_models_train_step.py)."""
    return flagship_cfg(num_experts=4, expert_top_k=2, **kw)


@contextlib.contextmanager
def _recorded_routing():
    """Within the block, every call of the MoE layer also records its
    tokens' top-k experts, sorted, as [B, S, k] on the host in call order
    (no flash kernel runs in the recording)."""
    from ray_tpu_torch.models import moe
    apply, calls = moe.moe_apply, []

    def recording(cfg, moe_params, h, **kw):
        with torch.no_grad():
            logits = torch.einsum("bsd,de->bse", h,
                                  moe_params["router"].to(h.dtype))
            top = torch.topk(logits.float().softmax(-1), cfg.expert_top_k,
                             dim=-1).indices
            calls.append(top.sort(-1).values.cpu())
        return apply(cfg, moe_params, h, **kw)

    moe.moe_apply = recording
    try:
        yield calls
    finally:
        moe.moe_apply = apply


def _routing_flips(got, want, layers):
    """[L, B, S] bool: where the first ``layers`` recorded calls of two runs
    chose different top-k experts."""
    return torch.stack([(a != b).any(-1) for a, b in
                        zip(got[:layers], want[:layers])])


SERVE_HELD = 32   # leading columns the graph's tokens must equal the eager's
SAMPLED_NEW = 16  # a sampled run's tokens, graph against eager


def _tgen():
    # the package exports a function named `generate`, hiding the module
    return importlib.import_module("ray_tpu_torch.models.generate")


def _check_no_host_sync(params, prompt, cfg, tag):
    """One eager decode step, the function the graph captures, greedy and
    sampled, under CUDA's sync debug mode "error": no operation of the step
    may read a device value on the host."""
    tgen = _tgen()
    icfg = tgen._inference_cfg(cfg)
    errors = {}
    with torch.inference_mode():
        p16 = tgen._cast_params(params, icfg.dtype)
        for temperature in (0.0, 0.8):
            state, gen = tgen._start(p16, prompt, icfg, 2, temperature, 50,
                                     0, torch.device("cuda"))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tgen._step(p16, icfg, state, gen, temperature, 50)
            except RuntimeError as e:
                errors[temperature] = str(e).splitlines()[0]
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    print(f"[{tag}] an eager decode step under sync debug mode 'error' "
          f"(greedy, sampled): {errors or 'no host sync'}", flush=True)
    check(not errors, f"{tag}: a decode step reads the device on the host: "
          f"{errors}")


def phase_serving(card, cfg, tag, seed):
    """Serve 8 prompts of 128 tokens with 256 greedy tokens each through
    ``generate`` (the decode graph) and the eager loop, in turns; ``tag``
    names the path in the output and the counts."""
    from ray_tpu_torch.models import transformer_init
    from ray_tpu_torch.models import transformer_num_params
    tgen = _tgen()
    batch, prompt_len, new = 8, 128, 256
    params = transformer_init(torch.Generator(device="cuda").manual_seed(
        seed), cfg)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len))).cuda()
    print(f"[{tag}] params={transformer_num_params(cfg)} "
          f"experts={cfg.num_experts} top_k={cfg.expert_top_k} "
          f"batch={batch} prompt={prompt_len} new={new}", flush=True)
    tgen.generate(params, prompt, cfg, max_new_tokens=4)   # warm-up
    tgen._generate_eager(params, prompt, cfg, max_new_tokens=4)
    torch.cuda.synchronize()
    _check_no_host_sync(params, prompt, cfg, tag)

    turns = []
    for path in ("graph", "eager", "graph"):
        _reset_launch_counts()
        captures, replays = tgen.graph_captures, tgen.graph_replays
        t0 = time.perf_counter()
        if path == "graph":
            tokens = tgen.generate(params, prompt, cfg, max_new_tokens=new)
        else:
            tokens, _ = tgen._generate_eager(params, prompt, cfg,
                                             max_new_tokens=new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        graphs = (tgen.graph_captures - captures,
                  tgen.graph_replays - replays)
        want = (1, new - 1) if path == "graph" else (0, 0)
        check(launches == (cfg.n_layers, 0, 0, 0),
              f"{tag} {path}: kernels launched {launches} times (fwd, dkv, "
              f"dq, delta), want ({cfg.n_layers}, 0, 0, 0)")
        check(graphs == want, f"{tag} {path}: graph captures and replays "
              f"{graphs}, want {want}")
        check(tokens.shape == (batch, new),
              f"tokens shape {tuple(tokens.shape)}")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              "token out of range")
        turns.append(dict(path=path, tokens=tokens, seconds=seconds,
                          tokens_per_s=batch * new / seconds,
                          capture_s=tgen.last_capture_s if path == "graph"
                          else None, launches=launches, graphs=graphs))
    graph, eager = turns[0], turns[1]
    same = (graph["tokens"] == eager["tokens"]).all(0)
    agree = int(same.long().cumprod(0).sum())
    check(torch.equal(turns[2]["tokens"], graph["tokens"]),
          f"{tag}: two graph runs gave different tokens")
    check(agree >= SERVE_HELD, f"{tag}: the graph's tokens equal the eager "
          f"loop's over {agree} leading columns, want {SERVE_HELD}")
    for t in turns:
        capture = "" if t["capture_s"] is None else \
            f", capture {t['capture_s'] * 1e3:.1f} ms"
        print(f"[{tag}] generate, {t['path']} path: {t['tokens_per_s']:.1f} "
              f"tokens/s ({t['seconds']:.3f} s for {batch}x{new} greedy "
              f"tokens; flash launches={t['launches'][0]}, graph captures "
              f"and replays {t['graphs']}{capture}) on {card}", flush=True)
    print(f"[{tag}] graph tokens equal the eager loop's over {agree} of "
          f"{new} leading columns (held: {SERVE_HELD}); graph/eager tokens/s "
          f"{graph['tokens_per_s'] / eager['tokens_per_s']:.2f}", flush=True)
    kw = dict(max_new_tokens=SAMPLED_NEW, temperature=0.8, top_k=50,
              seed=seed)
    sampled = tgen.generate(params, prompt, cfg, **kw)
    sampled_eager, _ = tgen._generate_eager(params, prompt, cfg, **kw)
    check(torch.equal(sampled, sampled_eager), f"{tag}: sampled tokens of "
          f"the graph differ from the eager loop's for the same seed")
    print(f"[{tag}] sampled (temperature 0.8, top_k 50, seed {seed}): "
          f"{SAMPLED_NEW} tokens of the graph equal the eager loop's",
          flush=True)

    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    with _recorded_routing() as kernel_routes:
        kernel = _prefill_logits(params, prompt, cfg, prompt_len + new)
    with _recorded_routing() as plain_routes:
        plain = _prefill_logits(params, prompt, plain_cfg, prompt_len + new)
    check(torch.isfinite(kernel).all().item(), "non-finite prefill logits")
    row_diff = (kernel - plain).abs().amax(-1)
    first = (kernel.argmax(-1) == plain.argmax(-1)).float().mean().item()
    checked = torch.ones(batch, dtype=torch.bool)
    flips = ""
    if cfg.num_experts:
        # A token whose top-k differs between the paths runs other experts,
        # which moves its own logits by O(1): a bf16 rounding flip, not a
        # fault. Flips at other positions reach the last one only through
        # attention, diluted over the prompt, so rows whose last position
        # kept its experts in every layer are held to the tolerance.
        f = _routing_flips(kernel_routes, plain_routes, cfg.n_layers)
        checked = ~f[:, :, -1].any(0)
        flips = (f" routing flips (token-layers whose top-{cfg.expert_top_k}"
                 f" differs) {int(f.sum())} of {f.numel()}, rows checked "
                 f"{int(checked.sum())} of {batch} (the rest flipped at the "
                 f"last position)")
        check(bool(checked.any()), "every row's last position flipped")
    diff = row_diff[checked.cuda()].max().item()
    print(f"[{tag}] prefill logits kernel vs plain path: max_abs_diff="
          f"{diff:.4e} (tol {LOGIT_TOL_BF16}; all rows "
          f"{row_diff.max().item():.4e}), logit std="
          f"{plain.std().item():.3f}, first-token agreement={first:.3f}"
          f"{flips}", flush=True)
    check(diff <= LOGIT_TOL_BF16, "prefill logits: kernel path disagrees")
    breakdown = _serving_breakdown(params, prompt, cfg, prompt_len + new, tag)
    del params
    torch.cuda.empty_cache()
    return dict(launches=graph["launches"][0],
                tokens_per_s=graph["tokens_per_s"],
                eager_tokens_per_s=eager["tokens_per_s"],
                graph_turns_tokens_per_s=[turns[0]["tokens_per_s"],
                                          turns[2]["tokens_per_s"]],
                capture_s=graph["capture_s"],
                graph_replays_per_generate=graph["graphs"][1],
                tokens_equal_columns=agree, **breakdown)


def _device_kernels(prof):
    """The kernels of a torch.profiler trace: device events, less the
    ranges that annotate the device timeline (``Optimizer.step#...``)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _decode_window(run, steps):
    """(ms a step by the host clock, the profiler's kernels, the profiled
    window's wall µs) of ``run(steps)`` after ``run(2)``; ``run`` ends in a
    synchronize."""
    from torch.profiler import ProfilerActivity, profile
    run(2)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        wall_us = (time.perf_counter() - t0) * 1e6
    return step_ms, _device_kernels(prof), wall_us


def _serving_breakdown(params, prompt, cfg, max_len, tag, steps=16):
    """Where a request's time goes: prefill against decode steps (host clock
    around work that ends in a synchronize), and for both decode paths (the
    graph's replays, eager ``decode_step`` calls) ms a step, the card's busy
    share (torch.profiler's kernel intervals over the wall time) and its
    kernels a step. With experts, also the MoE layer's device time at the
    decode shape, timed alone (its routing, then its products) against an
    eager step's."""
    from ray_tpu_torch.models import decode_step, prefill
    tgen = _tgen()
    icfg = tgen._inference_cfg(cfg)
    card = torch.device("cuda")
    with torch.inference_mode():
        p16 = tgen._cast_params(params, cfg.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(p16, prompt, cfg, max_len)
        token = logits.argmax(-1)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        pos = prompt.shape[1]

        def eager(n):
            nonlocal token, cache, pos
            for _ in range(n):
                logits, cache = decode_step(p16, token, pos, cache, cfg)
                token = logits.argmax(-1)
                pos += 1
            torch.cuda.synchronize()

        windows = {"eager": _decode_window(eager, steps)}
        del cache
        state, gen = tgen._start(p16, prompt, icfg, max_len - pos, 0.0,
                                 None, 0, card)
        graph = tgen._decode_graph(
            lambda: tgen._step(p16, icfg, state, gen, 0.0, None), state,
            gen, card)

        def replay(n):
            for _ in range(n):
                graph.replay()
            torch.cuda.synchronize()

        windows["graph"] = _decode_window(replay, steps)
        del graph, state
        moe = _moe_decode_ms(p16, prompt.shape[0], cfg) \
            if cfg.num_experts else None
    out = dict(prefill_ms=prefill_ms)
    b = prompt.shape[0]
    print(f"[{tag}] prefill (time to first token) {prefill_ms:.2f} ms "
          f"(batch {b} x {prompt.shape[1]})", flush=True)
    for path in ("graph", "eager"):
        step_ms, kernels, wall_us = windows[path]
        key = "" if path == "graph" else "eager_"
        out[key + "decode_step_ms"] = step_ms
        host = "1 graph replay" if path == "graph" else "eager launches"
        print(f"[{tag}] decode, {path} path: {step_ms:.3f} ms/step "
              f"({b / step_ms * 1e3:.1f} tokens/s in steady decode; "
              f"{host})", flush=True)
        if not kernels:
            print(f"[{tag}] decode, {path} path: busy share not measured "
                  f"(the profiler recorded no device events)", flush=True)
            continue
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        out.update({key + "busy_share": busy_us / wall_us,
                    key + "kernels_per_step": len(kernels) / steps,
                    key + "decode_device_ms": busy_us / steps / 1e3})
        print(f"[{tag}] decode, {path} path: device busy share "
              f"{busy_us / wall_us:.3f} over {steps} steps "
              f"({len(kernels) / steps:.0f} device kernels/step, "
              f"{busy_us / steps / 1e3:.3f} ms device time/step)",
              flush=True)
        if path == "eager":
            by_name = {}
            for e in kernels:
                by_name[e.name] = by_name.get(e.name, 0.0) + \
                    e.time_range.elapsed_us()
            for name, us in sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:5]:
                print(f"[{tag}]   {us / steps / 1e3:.4f} ms/step  "
                      f"{name[:90]}")
    if moe is not None and "eager_decode_device_ms" in out:
        step_dev = out["eager_decode_device_ms"]
        layer_ms, route_ms = moe
        out.update(moe_ms=layer_ms * cfg.n_layers,
                   moe_share=layer_ms * cfg.n_layers / step_dev,
                   moe_products_share=(layer_ms - route_ms) * cfg.n_layers
                   / step_dev)
        print(f"[{tag}] MoE layer at the decode shape, timed alone (device "
              f"time), x {cfg.n_layers} layers: {layer_ms * cfg.n_layers:.3f}"
              f" ms/step = {out['moe_share']:.3f} of an eager decode step's "
              f"device time; of which the routing "
              f"{route_ms * cfg.n_layers:.3f} ms and the dispatch, expert "
              f"and combine einsums {(layer_ms - route_ms) * cfg.n_layers:.3f}"
              f" ms = {out['moe_products_share']:.3f}", flush=True)
    return out


def _moe_decode_ms(p16, batch, cfg):
    """Device ms of one MoE layer (layer 0's cast weights) on a decode
    step's input [B, 1, D] under the inference config, and of its routing
    alone."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.models.generate import _inference_cfg
    icfg = _inference_cfg(cfg)
    layer = {k: v[0] for k, v in p16["layers"]["moe"].items()}
    h = torch.randn(batch, 1, cfg.d_model, device="cuda").to(cfg.dtype)
    layer_ms = device_ms(lambda: moe.moe_apply(icfg, layer, h))
    route_ms = device_ms(lambda: moe.route(icfg, layer["router"], h))
    return layer_ms or float("nan"), route_ms or float("nan")


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda()


def phase_small_reference():
    """A small f32 model on the card (kernel) against the CPU (plain)."""
    from ray_tpu_torch.models import (TransformerConfig, prefill,
                                      transformer_init)
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, max_seq=256,
                            dtype=torch.float32)
    params = transformer_init(torch.Generator().manual_seed(1), cfg,
                              device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 200)))
    with torch.inference_mode():
        want, cache_cpu = prefill(params, prompt, cfg, 256, device="cpu")
        card = _to_card(params)
        got, cache = prefill(card, prompt, cfg, 256)
    diff = (got.cpu() - want).abs().max().item()
    kdiff = (cache["k"].cpu() - cache_cpu["k"]).abs().max().item()
    print(f"[reference] small f32 model (GQA 2:1, head_dim 128) card vs "
          f"CPU: logits max_abs_diff={diff:.3e}, cache k {kdiff:.3e} "
          f"(tol {LOGIT_TOL_F32})", flush=True)
    check(diff <= LOGIT_TOL_F32 and kdiff <= LOGIT_TOL_F32,
          "card disagrees with the CPU reference")
    # 16 tokens: the card's decode graph against the CPU's eager loop
    tgen = _tgen()
    new = 16
    want, want_cache = tgen._generate_eager(params, prompt, cfg,
                                            max_new_tokens=new, device="cpu")
    replays = tgen.graph_replays
    with torch.inference_mode():
        got, got_cache = tgen._generate_loop(
            card, prompt, tgen._inference_cfg(cfg), new, 0.0, None, 0,
            torch.device("cuda"))
    replayed = tgen.graph_replays - replays
    cdiff = max((got_cache[n].cpu() - want_cache[n]).abs().max().item()
                for n in ("k", "v"))
    print(f"[reference] {new} greedy tokens, the card's graph ({replayed} "
          f"replays) vs the CPU's eager loop: tokens equal "
          f"{torch.equal(got.cpu(), want)}, cache max_abs_diff={cdiff:.3e} "
          f"(tol {LOGIT_TOL_F32})", flush=True)
    check(replayed == new - 1 and torch.equal(got.cpu(), want)
          and cdiff <= LOGIT_TOL_F32,
          "the card's decode graph disagrees with the CPU's eager loop")


def phase_long_prefill():
    from ray_tpu_torch.models import transformer_init
    from ray_tpu_torch.ops import flash
    cfg = flagship_cfg()
    params = transformer_init(torch.Generator(device="cuda").manual_seed(2),
                              cfg)
    s = cfg.max_seq
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, s))).cuda()
    _prefill_logits(params, prompt, cfg, s)           # warm-up
    flash.launches = 0
    t0 = time.perf_counter()
    kernel = _prefill_logits(params, prompt, cfg, s)
    kernel_s = time.perf_counter() - t0
    check(flash.launches == cfg.n_layers,
          f"long prefill launched the kernel {flash.launches} times")
    plain_cfg = dataclasses.replace(cfg, attn_impl="reference")
    _prefill_logits(params, prompt, plain_cfg, s)
    t0 = time.perf_counter()
    plain = _prefill_logits(params, prompt, plain_cfg, s)
    plain_s = time.perf_counter() - t0
    check(torch.isfinite(kernel).all().item(), "non-finite logits")
    diff = (kernel - plain).abs().max().item()
    print(f"[prefill] batch 2 x {s}: kernel path {kernel_s * 1e3:.1f} ms, "
          f"plain path {plain_s * 1e3:.1f} ms, logits max_abs_diff="
          f"{diff:.4e} (tol {LOGIT_TOL_BF16})", flush=True)
    check(diff <= LOGIT_TOL_BF16, "long prefill: kernel path disagrees")


# ---------------------------------------------------------------------------
# phases 5, 6 and 8
# ---------------------------------------------------------------------------

def _launch_counts():
    from ray_tpu_torch.ops import flash
    return (flash.launches, flash.bwd_dkv_launches, flash.bwd_dq_launches,
            flash.bwd_delta_launches)


def _reset_launch_counts():
    from ray_tpu_torch.ops import flash
    flash.launches = flash.bwd_dkv_launches = flash.bwd_dq_launches = 0
    flash.bwd_delta_launches = 0


def _first_step(cfg, tokens, seed):
    """Loss and grad_norm of one training step from seeded weights, and the
    routing its forward recorded (empty without experts)."""
    from ray_tpu_torch.train import make_lm_train_step
    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    with _recorded_routing() as routes:
        _, metrics = step_fn(state, place({"tokens": tokens}))
    return metrics["loss"].item(), metrics["grad_norm"].item(), routes


def _kernel_class(name):
    """Which part of a training step a kernel belongs to, by its name."""
    if "flash_" in name:
        return "flash"
    if "multi_tensor_apply" in name:     # AdamW's foreach updates
        return "adamw"
    if any(t in name.lower() for t in ("gemm", "sm90_", "xmma", "cutlass",
                                       "nvjet", "cublas")):
        return "products"
    return "elementwise"


def _profile_step(step_fn, state, data, tag):
    """One profiled training step: its kernels' device time by class (the
    flash kernels, AdamW, the cuBLAS products, and the element-wise and
    reduction kernels), against the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    if not kernels:
        print(f"[{tag}] device time breakdown: not measured (the profiler "
              f"recorded no device events)", flush=True)
        return state, None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    by_class = {}
    for n, us in by_name.items():
        by_class[_kernel_class(n)] = by_class.get(_kernel_class(n), 0.0) + us
    flash_us = {n: us for n, us in by_name.items() if "flash_" in n}
    bwd_us = sum(us for n, us in flash_us.items() if "flash_bwd" in n)
    print(f"[{tag}] profiled step: wall {wall_us / 1e3:.1f} ms, device "
          f"time {busy / 1e3:.1f} ms (busy share {busy / wall_us:.3f}, "
          f"{len(kernels)} kernels); " + ", ".join(
              f"{c} {by_class.get(c, 0.0) / 1e3:.2f} ms = "
              f"{by_class.get(c, 0.0) / busy:.4f}"
              for c in ("flash", "products", "adamw", "elementwise"))
          + f"; the flash backward (Δ, dK/dV, dQ) {bwd_us / 1e3:.2f} ms = "
          f"{bwd_us / busy:.4f}", flush=True)
    for n, us in sorted(flash_us.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   flash {us / 1e3:.3f} ms  {n[:90]}")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[{tag}]   top {us / 1e3:.3f} ms  {n[:90]}")
    return state, dict(
        wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
        busy_share=busy / wall_us, flash_ms=sum(flash_us.values()) / 1e3,
        flash_bwd_ms=bwd_us / 1e3, flash_bwd_share=bwd_us / busy,
        by_class_ms={c: us / 1e3 for c, us in by_class.items()})


def _moe_piece_ms(cfg, moe_params, b, s):
    """Milliseconds (CUDA events) of the MoE layer's pieces at one layer's
    training shape [B, S, D], timed alone: the forward, and the forward
    with its backward, of the routing (router product, softmax, top-k
    loop), the dispatch product, the expert products (SwiGLU) and the
    combine product. Under remat a step runs each piece's forward twice and
    its backward once per layer."""
    from ray_tpu_torch.models import moe
    dt = cfg.dtype
    gen = torch.Generator(device="cuda").manual_seed(9)
    leaf = {n: moe_params[n].detach().to(dt).requires_grad_()
            for n in ("router", "w1", "w3", "w2")}
    h = torch.randn(b, s, cfg.d_model, generator=gen,
                    device="cuda").to(dt).requires_grad_()
    with torch.no_grad():
        _, dispatch, combine = moe.route(cfg, leaf["router"], h)
        xs = torch.einsum("bsec,bsd->becd", dispatch.to(dt), h)
    xs.requires_grad_()
    ys = torch.randn_like(xs).requires_grad_()
    combine.requires_grad_()

    def experts():
        gate = torch.nn.functional.silu(
            torch.einsum("becd,edf->becf", xs, leaf["w1"]))
        up = torch.einsum("becd,edf->becf", xs, leaf["w3"])
        return torch.einsum("becf,efd->becd", gate * up, leaf["w2"])

    pieces = {
        "routing": (lambda: moe.route(cfg, leaf["router"], h)[2],
                    (leaf["router"], h)),
        "dispatch": (lambda: torch.einsum("bsec,bsd->becd", dispatch.to(dt),
                                          h), (h,)),
        "experts": (experts, (xs, leaf["w1"], leaf["w3"], leaf["w2"])),
        "combine": (lambda: torch.einsum("bsec,becd->bsd", combine.to(dt),
                                         ys), (combine, ys)),
    }
    out = {}
    for name, (fn, inputs) in pieces.items():
        with torch.no_grad():
            grad = torch.randn_like(fn())
        fwd = cuda_ms(lambda: fn(), iters=3, warmup=1)
        both = cuda_ms(lambda: torch.autograd.grad(fn(), inputs, grad),
                       iters=3, warmup=1)
        out[name] = (fwd, both)
        del grad
    return out


def phase_training(card, cfg, tag, seed):
    """Train at batch 8 x 2048 with remat: 2 warm-up steps counted step by
    step, the first held against the plain attention path, then 5 timed
    steps and one profiled step."""
    from ray_tpu_torch.models import transformer_num_params
    from ray_tpu_torch.train import make_lm_train_step
    batch, seq = 8, cfg.max_seq
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, seq))
    n_params = transformer_num_params(cfg)
    L = cfg.n_layers
    per_step = (2 * L, L, L, L)   # forward + remat recompute, dK/dV, dQ, Δ

    plain = _first_step(dataclasses.replace(cfg, attn_impl="reference"),
                        tokens, seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    data = place({"tokens": tokens})
    print(f"[{tag}] params={n_params} experts={cfg.num_experts} "
          f"top_k={cfg.expert_top_k} batch={batch} seq={seq} "
          f"remat={cfg.remat} attn_impl={cfg.attn_impl}", flush=True)
    losses, gnorms = [], []
    for i in range(2):                  # warm-up, counted step by step
        _reset_launch_counts()
        with _recorded_routing() as routes:
            state, metrics = step_fn(state, data)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        check(_launch_counts() == per_step,
              f"a training step launched {_launch_counts()}, want "
              f"{per_step} (forward, dK/dV, dQ, Δ)")
        if i == 0:
            first_routes = routes
    flips = ""
    if cfg.num_experts:
        # at bf16 a token whose top-k gates are within rounding of each
        # other may choose another expert on one path: expected noise
        f = _routing_flips(first_routes, plain[2], L)
        flips = (f", tokens whose top-{cfg.expert_top_k} differs between "
                 f"the paths {int(f.any(0).sum())} of {batch * seq} "
                 f"(token-layers {int(f.sum())} of {f.numel()}; by layer "
                 f"{f.sum((1, 2)).tolist()})")
    print(f"[{tag}] first step kernel path vs plain attention path: loss "
          f"{losses[0]:.6f} vs {plain[0]:.6f} (diff "
          f"{abs(losses[0] - plain[0]):.3e}, tol {TRAIN_LOSS_TOL}), "
          f"grad_norm {gnorms[0]:.6f} vs {plain[1]:.6f} (rel diff "
          f"{abs(gnorms[0] - plain[1]) / plain[1]:.3e}, tol "
          f"{TRAIN_GNORM_RTOL}){flips}", flush=True)
    check(abs(losses[0] - plain[0]) <= TRAIN_LOSS_TOL
          and abs(gnorms[0] - plain[1]) <= TRAIN_GNORM_RTOL * plain[1],
          f"first step: kernel path loss {losses[0]}, grad_norm "
          f"{gnorms[0]}; plain path {plain[:2]}")
    del plain, first_routes, routes

    steps = 5
    _reset_launch_counts()
    timed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
        timed.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    check(launches == tuple(steps * n for n in per_step),
          f"{steps} training steps launched {launches}")
    losses += [m["loss"].item() for m in timed]
    gnorms += [m["grad_norm"].item() for m in timed]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"non-finite metrics: loss {losses}, grad_norm {gnorms}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    step_ms = seconds / steps * 1e3
    tokens_per_s = batch * seq * steps / seconds
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mfu, mfu_text = None, "MFU not stated (6N counts every weight once)"
    if not cfg.num_experts:
        flops_per_token = 6 * n_params + 12 * L * cfg.d_model * seq
        mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
        mfu_text = (f"MFU {mfu:.4f} (6N + 12LdS = {flops_per_token:.4e} "
                    f"flop/token against 989 TFLOP/s)")
    print(f"[{tag}] losses {[round(x, 4) for x in losses]} grad_norms "
          f"{[round(x, 4) for x in gnorms]}", flush=True)
    print(f"[{tag}] {steps} timed steps: {step_ms:.1f} ms/step, "
          f"{tokens_per_s:.0f} tokens/s, {mfu_text}, peak memory "
          f"{peak_gb:.2f} GB, launches (fwd, dkv, dq, delta) {launches} on "
          f"{card}", flush=True)
    state, profile = _profile_step(step_fn, state, data, tag)
    pieces = None
    if cfg.num_experts:
        layer0 = {k: v[0].detach().clone()
                  for k, v in state.params["layers"]["moe"].items()}
        del state
        torch.cuda.empty_cache()
        raw = _moe_piece_ms(cfg, layer0, batch, seq)
        pieces = {name: L * (fwd + both) for name, (fwd, both) in raw.items()}
        print(f"[{tag}] MoE pieces timed alone at one layer's training "
              f"shape (CUDA events; forward, forward + backward ms): "
              + ", ".join(f"{n} {f:.3f}, {b:.3f}" for n, (f, b)
                          in raw.items())
              + f"; a step (x {L} layers, forward twice under remat): "
              + ", ".join(f"{n} {ms:.1f} ms = {ms / step_ms:.3f} of the "
                          f"step" for n, ms in pieces.items()), flush=True)
    else:
        del state
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms, tokens_per_s=tokens_per_s,
                mfu=mfu, peak_gb=peak_gb, profile=profile, moe_pieces=pieces)


def _card_vs_cpu_step(make_step, cpu_params, batch):
    """One training step from the same f32 params on the CPU (the plain
    versions) and on the card (the kernels) -> (metric diffs, the largest
    difference of an updated parameter)."""
    card_params = _to_card(cpu_params)
    results = []
    for params, device in ((cpu_params, "cpu"), (card_params, None)):
        init_fn, step_fn, place = make_step(device)
        state, metrics = step_fn(init_fn(params), place(batch))
        results.append((state.params, metrics))
    (want, wm), (got, gm) = results
    diffs = {k: abs(gm[k].item() - wm[k].item())
             for k in wm if k != "step"}
    return diffs, _max_diff(got, want)


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _max_diff(card_tree, cpu_tree):
    """The largest difference of a leaf of ``card_tree`` from the same
    leaf of ``cpu_tree``."""
    cpu_leaves = dict(_named_leaves(cpu_tree))
    return max((v.detach().cpu() - cpu_leaves[k].detach()).abs().max()
               .item() for k, v in _named_leaves(card_tree))


def phase_small_training():
    """One f32 training step on the card (kernels) against the CPU (plain)."""
    from ray_tpu_torch.models import TransformerConfig, transformer_init
    from ray_tpu_torch.train import make_lm_train_step
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, max_seq=256,
                            dtype=torch.float32, attn_impl="flash")
    cpu_params = transformer_init(torch.Generator().manual_seed(4), cfg,
                                  device="cpu")
    batch = {"tokens": np.random.default_rng(4).integers(0, 512, (2, 200))}
    diffs, param_diff = _card_vs_cpu_step(
        lambda device: make_lm_train_step(cfg, device=device), cpu_params,
        batch)
    print(f"[reference] small f32 model (GQA 2:1, head_dim 128, S 200) one "
          f"training step card vs CPU: loss diff {diffs['loss']:.3e}, "
          f"grad_norm diff {diffs['grad_norm']:.3e}, updated params max "
          f"diff {param_diff:.3e} (tol {LOGIT_TOL_F32})", flush=True)
    check(max(*diffs.values(), param_diff) <= LOGIT_TOL_F32,
          "training step: card disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# phases 9 and 10: ViT, and small f32 MoE and ViT models card vs CPU
# ---------------------------------------------------------------------------

def phase_vit_training(card):
    """ViTConfig()'s defaults (224² images, patch 16, d_model 384, 6 layers,
    6 heads of 64, 1000 classes, remat) at batch 128 on seeded random
    images and labels: 2 warm-up steps counted step by step, 5 timed."""
    from ray_tpu_torch.models import ViTConfig
    from ray_tpu_torch.train import make_vit_train_step
    from ray_tpu_torch.train.step import _leaves
    cfg = ViTConfig()
    batch, L = 128, cfg.n_layers
    per_step = (2 * L, L, L, L)
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = {"image": torch.randn(batch, cfg.image_size, cfg.image_size, 3,
                                 generator=gen, device="cuda"),
            "label": torch.randint(0, cfg.num_classes, (batch,),
                                   generator=gen, device="cuda")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn, place = make_vit_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(12))
    n_params = sum(p.numel() for p in _leaves(state.params))
    data = place(data)
    print(f"[vit] params={n_params} image={cfg.image_size} patch="
          f"{cfg.patch_size} seq={cfg.seq_len} d_model={cfg.d_model} "
          f"layers={L} heads={cfg.n_heads} batch={batch} remat={cfg.remat}",
          flush=True)
    losses = []
    for _ in range(2):
        _reset_launch_counts()
        state, metrics = step_fn(state, data)
        losses.append(metrics["loss"].item())
        check(_launch_counts() == per_step,
              f"a ViT step launched {_launch_counts()}, want {per_step}")
    steps = 5
    _reset_launch_counts()
    timed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
        timed.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    check(launches == tuple(steps * n for n in per_step),
          f"{steps} ViT steps launched {launches}")
    losses += [m["loss"].item() for m in timed]
    accs = [m["accuracy"].item() for m in timed]
    check(all(np.isfinite(losses)), f"non-finite ViT loss {losses}")
    check(losses[-1] < losses[0], f"the ViT loss did not fall: {losses}")
    step_ms = seconds / steps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[vit] losses {[round(x, 4) for x in losses]} accuracy "
          f"{[round(x, 4) for x in accs]}", flush=True)
    print(f"[vit] {steps} timed steps: {step_ms:.2f} ms/step, "
          f"{batch * steps / seconds:.0f} images/s, peak memory "
          f"{peak_gb:.3f} GB, launches (fwd, dkv, dq, delta) {launches} on "
          f"{card}", flush=True)
    state, profile = _profile_step(step_fn, state, data, "vit")
    del state
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms,
                images_per_s=batch * steps / seconds, peak_gb=peak_gb,
                profile=profile)


def phase_small_moe_and_vit():
    """A small f32 MoE LM and a small ViT (head_dim 64, 17 tokens, not
    causal) on the card (the kernels) against the CPU (the plain versions):
    logits, then one training step."""
    from ray_tpu_torch.models import (TransformerConfig, ViTConfig, prefill,
                                      transformer_init, vit_apply, vit_init)
    from ray_tpu_torch.train import make_lm_train_step, make_vit_train_step
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, max_seq=256,
                            dtype=torch.float32, attn_impl="flash",
                            num_experts=4, expert_top_k=2)
    cpu_params = transformer_init(torch.Generator().manual_seed(13), cfg,
                                  device="cpu")
    rng = np.random.default_rng(13)
    prompt = torch.from_numpy(rng.integers(0, 512, (2, 200)))
    with torch.inference_mode():
        want, _ = prefill(cpu_params, prompt, cfg, 256, device="cpu")
        got, _ = prefill(_to_card(cpu_params), prompt, cfg, 256)
    logit_diff = (got.cpu() - want).abs().max().item()
    diffs, param_diff = _card_vs_cpu_step(
        lambda device: make_lm_train_step(cfg, device=device), cpu_params,
        {"tokens": rng.integers(0, 512, (2, 200))})
    print(f"[reference] small f32 MoE model (4 experts, top-2, GQA 2:1, "
          f"head_dim 128) card vs CPU: prefill logits max_abs_diff="
          f"{logit_diff:.3e}; one training step (capacity factor 1.25) loss "
          f"diff {diffs['loss']:.3e}, grad_norm diff "
          f"{diffs['grad_norm']:.3e}, updated params max diff "
          f"{param_diff:.3e} (tol {LOGIT_TOL_F32})", flush=True)
    check(max(logit_diff, *diffs.values(), param_diff) <= LOGIT_TOL_F32,
          "small MoE model: card disagrees with the CPU reference")

    vcfg = ViTConfig(image_size=64, patch_size=16, num_classes=10,
                     d_model=128, n_layers=2, n_heads=2, dtype=torch.float32)
    cpu_params = vit_init(torch.Generator().manual_seed(14), vcfg,
                          device="cpu")
    images = torch.from_numpy(rng.standard_normal((4, 64, 64, 3))
                              .astype(np.float32))
    with torch.inference_mode():
        want = vit_apply(cpu_params, images, vcfg, device="cpu")
        got = vit_apply(_to_card(cpu_params), images, vcfg)
    logit_diff = (got.cpu() - want).abs().max().item()
    diffs, param_diff = _card_vs_cpu_step(
        lambda device: make_vit_train_step(vcfg, device=device), cpu_params,
        {"image": images.numpy(), "label": rng.integers(0, 10, (4,))})
    print(f"[reference] small f32 ViT (head_dim 64, 17 tokens, not causal) "
          f"card vs CPU: logits max_abs_diff={logit_diff:.3e}; one training "
          f"step loss diff {diffs['loss']:.3e}, accuracy diff "
          f"{diffs['accuracy']:.3e}, updated params max diff "
          f"{param_diff:.3e} (tol {LOGIT_TOL_F32})", flush=True)
    check(max(logit_diff, *diffs.values(), param_diff) <= LOGIT_TOL_F32,
          "small ViT: card disagrees with the CPU reference")


# ---------------------------------------------------------------------------
# phases 11 and 12: ResNet-50
# ---------------------------------------------------------------------------

def resnet_train_flops(model, image_size, batch):
    """Tensor-core operations of one training step: 2 per multiply-add of
    every convolution and the Dense head, forward, weight gradient and input
    gradient (none for the first convolution: the images need none)."""
    size = (image_size + 2 * 3 - 7) // 2 + 1          # conv_init, 7x7/2
    stem = size * size * 64 * 3 * 49
    size = -(-size // 2)                              # max pool, SAME /2
    macs = 0
    for _, block, c_in in model.blocks():
        f, out = block.filters, -(-size // block.strides)
        macs += size * size * f * c_in + out * out * (f * f * 9 + 4 * f * f)
        if block.strides != 1 or c_in != 4 * f:
            macs += out * out * 4 * f * c_in
        size = out
    macs += math.prod(model.variable_shapes()["params"]["Dense_0"]["kernel"])
    return 2 * batch * (3 * macs + 2 * stem)


def _resnet_kernel_class(name):
    """Which part of a ResNet step a kernel belongs to, by its name."""
    low = name.lower()
    if "multi_tensor_apply" in low:          # SGD's foreach updates
        return "sgd"
    if "batch_norm" in low or "batchnorm" in low or "bn_" in low:
        return "batchnorm"
    if any(t in low for t in ("conv", "xmma", "implicit_gemm", "fprop",
                              "dgrad", "wgrad", "gemm", "sm90_", "cutlass",
                              "nvjet", "cudnn")):
        return "convolution"
    if "elementwise" in low or "threshold" in low or "clamp" in low:
        return "elementwise"
    return "other"


RESNET_CLASSES = ("convolution", "batchnorm", "elementwise", "sgd", "other")


def _profile_resnet_step(step_fn, state, data):
    """One profiled ResNet step: device time by kernel class against the
    wall time, and the largest kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    if not kernels:
        print("[resnet] device time breakdown: not measured (the profiler "
              "recorded no device events)", flush=True)
        return state, None
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    by_class = {}
    for n, us in by_name.items():
        c = _resnet_kernel_class(n)
        by_class[c] = by_class.get(c, 0.0) + us
    print(f"[resnet] profiled step: wall {wall_us / 1e3:.1f} ms, device "
          f"time {busy / 1e3:.1f} ms (busy share {busy / wall_us:.3f}, "
          f"{len(kernels)} kernels); " + ", ".join(
              f"{c} {by_class.get(c, 0.0) / 1e3:.2f} ms = "
              f"{by_class.get(c, 0.0) / busy:.4f}" for c in RESNET_CLASSES),
          flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[resnet]   top {us / 1e3:.3f} ms  "
              f"({_resnet_kernel_class(n)}) {n[:90]}")
    return state, dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
                       busy_share=busy / wall_us, kernels=len(kernels),
                       by_class_ms={c: us / 1e3
                                    for c, us in by_class.items()})


def phase_resnet_training(card):
    """bench.py's bench_resnet point on one card: ResNet-50, 1000 classes,
    224² images, batch 256, SGD lr 0.1 with Nesterov momentum 0.9; 3
    warm-up steps, then the best of two windows of 30 steps, each ending in
    a synchronize."""
    from ray_tpu_torch.models import resnet50, resnet50_apply
    from ray_tpu_torch.train import make_resnet_train_step
    from ray_tpu_torch.train.step import _leaves
    batch, size, steps = 256, 224, 30
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    print(f"[resnet] torch.backends.cudnn.benchmark=True for this phase "
          f"(cuDNN times its algorithms at each new convolution shape and "
          f"keeps the fastest); back to {prior} after it", flush=True)
    try:
        model = resnet50()
        rng = np.random.default_rng(0)       # bench_resnet's data
        host = {"image": rng.normal(size=(batch, size, size, 3))
                .astype(np.float32),
                "label": rng.integers(0, 1000, (batch,))}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        init_fn, step_fn, place = make_resnet_train_step(
            num_classes=1000, image_size=size, learning_rate=0.1)
        state = init_fn(torch.Generator(device="cuda").manual_seed(0))
        stats0 = [t.clone() for t in _leaves(state.params["batch_stats"])]
        n_params = sum(t.numel() for t in _leaves(state.params["params"]))
        data = place(host)
        del host
        print(f"[resnet] params={n_params} batch_stats="
              f"{sum(t.numel() for t in stats0)} batch={batch} image={size} "
              f"dtype=bfloat16 channels_last", flush=True)
        metrics = []
        t0 = time.perf_counter()
        for _ in range(3):                   # warm-up (and cuDNN's search)
            state, m = step_fn(state, data)
            metrics.append(m)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        _reset_launch_counts()
        windows = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, m = step_fn(state, data)
                metrics.append(m)
            torch.cuda.synchronize()
            windows.append(time.perf_counter() - t0)
        launches = _launch_counts()
        check(launches == (0, 0, 0, 0),
              f"the ResNet step launched flash kernels {launches}")
        losses = [m["loss"].item() for m in metrics]
        accs = [m["accuracy"].item() for m in metrics]
        check(all(np.isfinite(losses)) and all(np.isfinite(accs)),
              f"non-finite ResNet metrics: loss {losses}, accuracy {accs}")
        check(losses[-1] < losses[0], f"the ResNet loss did not fall: "
                                      f"{losses}")
        best = min(windows)
        step_ms = best / steps * 1e3
        images_per_s = steps * batch / best
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        flops = resnet_train_flops(model, size, batch)
        bound_ms = flops / PEAK_BF16_FLOPS * 1e3
        moved = sum(not torch.equal(a, b) for a, b in
                    zip(stats0, _leaves(state.params["batch_stats"])))
        check(moved == len(stats0) and all(
            torch.isfinite(t).all().item()
            for t in _leaves(state.params["batch_stats"])),
            f"{len(stats0) - moved} of {len(stats0)} batch statistics did "
            f"not move, or are not finite")
        with torch.inference_mode():
            logits = resnet50_apply(model, state.params, data["image"],
                                    train=False)
        check(logits.shape == (batch, 1000) and logits.dtype == torch.float32
              and torch.isfinite(logits).all().item(),
              "eval-mode logits are not finite [256, 1000] f32")
        print(f"[resnet] losses {[round(x, 4) for x in losses[:3]]} (warm-up)"
              f" ... {[round(x, 4) for x in losses[3::10]]} (every 10th "
              f"timed) ... {round(losses[-1], 4)} (last); accuracy "
              f"{round(accs[0], 4)} -> {round(accs[-1], 4)}; all finite; "
              f"{moved} of {len(stats0)} batch statistics moved from their "
              f"init; eval-mode logits finite, std "
              f"{logits.std().item():.4f}", flush=True)
        print(f"[resnet] warm-up 3 steps {warmup_s:.2f} s; windows of "
              f"{steps} steps {[round(w, 4) for w in windows]} s; best "
              f"{step_ms:.2f} ms/step, {images_per_s:.1f} images/s, peak "
              f"memory {peak_gb:.2f} GB; convolutions and head "
              f"{flops / 1e12:.3f} TFLOP a step, tensor-core bound "
              f"{bound_ms:.2f} ms at 989 TFLOP/s = {bound_ms / step_ms:.3f} "
              f"of the step; flash launches {launches} on {card}",
              flush=True)
        state, profile = _profile_resnet_step(step_fn, state, data)
        if profile is not None:
            profile["device_over_timed_step"] = profile["device_ms"] / step_ms
            print(f"[resnet] the profiled step's device time over the timed "
                  f"step: {profile['device_over_timed_step']:.3f} (the "
                  f"profiler's own cost is in its wall time)", flush=True)
        del state, data, logits
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=step_ms,
                images_per_s=images_per_s, peak_gb=peak_gb,
                windows_s=windows, flops=flops, bound_ms=bound_ms,
                losses=[losses[0], losses[-1]], profile=profile)


@contextlib.contextmanager
def _tf32_off():
    """f32 convolutions and products in full f32 for the block (the
    library flips no global switch; this script does, for its own check)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _perturbed(variables, gen):
    """``variables`` with every BatchNorm scale and running variance in
    [0.5, 1.5) and every bias and running mean normal(0.1), from ``gen``:
    the init zeroes each block's last scale, which would hide its branch."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else 0.5 + torch.rand(v.shape, generator=gen)
                if k in ("scale", "var")
                else 0.1 * torch.randn(v.shape, generator=gen)
                if k in ("bias", "mean") else v
                for k, v in tree.items()}
    return walk(variables)


def phase_small_resnet():
    """A small f32 ResNet on the card (cuDNN, TF32 off) against the CPU:
    logits in train and eval mode, then one training step."""
    from ray_tpu_torch.models import ResNet, resnet50_apply
    from ray_tpu_torch.train import make_resnet_train_step
    model = ResNet((1, 1, 1, 1), 10, torch.float32)
    gen = torch.Generator().manual_seed(16)
    cpu_vars = _perturbed(model.init(gen, device="cpu"), gen)
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.standard_normal((4, 32, 32, 3))
                              .astype(np.float32))
    with _tf32_off():
        print("[reference] small ResNet: cudnn.allow_tf32 and "
              "cuda.matmul.allow_tf32 False for this check", flush=True)
        diffs = {}
        with torch.inference_mode():
            card_vars = _to_card(cpu_vars)
            for train in (True, False):
                want = resnet50_apply(model, cpu_vars, images, train=train,
                                      device="cpu")
                got = resnet50_apply(model, card_vars, images, train=train)
                if train:
                    (want, want_stats), (got, got_stats) = want, got
                    diffs["batch_stats"] = _max_diff(got_stats, want_stats)
                diffs[f"logits_{'train' if train else 'eval'}"] = (
                    got.cpu() - want).abs().max().item()
        step_diffs, param_diff = _card_vs_cpu_step(
            lambda device: make_resnet_train_step(
                num_classes=10, image_size=32, dtype=torch.float32,
                stage_sizes=(1, 1, 1, 1), device=device), cpu_vars,
            {"image": images.numpy(), "label": rng.integers(0, 10, (4,))})
    print(f"[reference] small f32 ResNet (stages 1, 1, 1, 1; 32² images, "
          f"batch 4, 10 classes) card vs CPU: logits train "
          f"{diffs['logits_train']:.3e}, eval {diffs['logits_eval']:.3e}, "
          f"new batch statistics {diffs['batch_stats']:.3e}; one training "
          f"step loss diff {step_diffs['loss']:.3e}, accuracy diff "
          f"{step_diffs['accuracy']:.3e}, updated params and batch "
          f"statistics max diff {param_diff:.3e} (tol {LOGIT_TOL_F32})",
          flush=True)
    check(max(*diffs.values(), *step_diffs.values(), param_diff)
          <= LOGIT_TOL_F32, "small ResNet: card disagrees with the CPU")
    return dict(diffs, step_loss=step_diffs["loss"], step_params=param_diff)


# ---------------------------------------------------------------------------
# phases 13, 14 and 15: the RL stack (ray_tpu_torch.rl)
# ---------------------------------------------------------------------------

# The JAX package's PPO learning gate (tests/test_rl.py): 2 rollout workers x
# 16 CartPole envs x 64 steps, hiddens (64, 64), lr 3e-4, 8 SGD epochs of
# minibatch 256, entropy 0.01, clip 0.2, grad clip 0.5, seed 0; best mean
# reward >= 120 within 25 iterations. Workers seeded as WorkerSet seeds them.
PPO_SPEC = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}
PPO_GATE, PPO_ITERS = 120.0, 25
# Small f32 RL models, card (TF32 off) against the CPU: the same products
# summed in another order, through at most 16 recurrent steps and 2 Adam
# steps.
RL_TOL_F32 = 1e-4


def _rl_profile(fn, sgd_steps, tag):
    """Device time, busy share and kernels a SGD step of ``fn`` (one
    learner update) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_kernels(prof)
    if not kernels:
        print(f"[{tag}] busy share: not measured (the profiler recorded no "
              f"device events)", flush=True)
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3,
               busy_share=busy / wall_us, kernels=len(kernels),
               kernels_per_sgd_step=len(kernels) / sgd_steps)
    print(f"[{tag}] profiled update: wall {out['wall_ms']:.2f} ms, device "
          f"time {out['device_ms']:.2f} ms, busy share "
          f"{out['busy_share']:.4f}, {len(kernels)} kernels = "
          f"{out['kernels_per_sgd_step']:.1f} a SGD step; largest: " +
          "; ".join(f"{n[:60]} {us / 1e3:.2f} ms" for n, us in top),
          flush=True)
    return out


def _ppo_cartpole(worker_device, tag):
    """PPO.training_step's order with the workers in-process: sample on
    every worker, concat, PPOLearner.update on the card, get_weights back to
    the workers; PPO_ITERS iterations, each timed on the host clock (the
    learner's stats are floats, so an update ends in a sync)."""
    from ray_tpu_torch.rl import PPOLearner, RolloutWorker, SampleBatch
    learner = PPOLearner(PPO_SPEC, lr=3e-4, clip_param=0.2, grad_clip=0.5,
                         num_sgd_iter=8, sgd_minibatch_size=256,
                         entropy_coeff=0.01, seed=0)
    workers = [RolloutWorker("CartPole-v1", PPO_SPEC, 64, 16, 0.99, 0.95,
                             seed=1000 * (i + 1), device=worker_device)
               for i in range(2)]
    weights, rewards, sample_s, update_s, steps = \
        learner.get_weights(), [], [], [], 0
    _reset_launch_counts()
    for _ in range(PPO_ITERS):
        t0 = time.perf_counter()
        batch = SampleBatch.concat_samples([w.sample(weights)
                                            for w in workers])
        t1 = time.perf_counter()
        stats = learner.update(batch)
        weights = learner.get_weights()
        t2 = time.perf_counter()
        sample_s.append(t1 - t0)
        update_s.append(t2 - t1)
        steps += batch.count
        check(all(np.isfinite(v) for v in stats.values()),
              f"[{tag}] non-finite learner stats {stats}")
        means = [s["episode_reward_mean"] for s in
                 (w.episode_stats() for w in workers) if s["episodes"] > 0]
        rewards.append(float(np.mean(means)) if means else float("nan"))
    launches = _launch_counts()
    best = max((r for r in rewards if not np.isnan(r)), default=0.0)
    first = next((i + 1 for i, r in enumerate(rewards) if r >= PPO_GATE),
                 None)
    total = sum(sample_s) + sum(update_s)
    sgd_steps = 8 * (batch.count // 256)
    out = dict(launches=launches, worker_device=worker_device or "cuda",
               learner_device="cuda", iterations=PPO_ITERS, env_steps=steps,
               iteration_s=[a + b for a, b in zip(sample_s, update_s)],
               sample_s=sample_s, update_s=update_s,
               env_steps_per_s=steps / total,
               sample_env_steps_per_s=steps / sum(sample_s),
               sample_ms=1e3 * float(np.median(sample_s)),
               update_ms=1e3 * float(np.median(update_s)),
               sgd_steps_per_s=sgd_steps / float(np.median(update_s)),
               best_reward=best, gate_iteration=first,
               rewards=[round(r, 2) for r in rewards])
    print(f"[{tag}] workers on {out['worker_device']}, learner on the card: "
          f"{PPO_ITERS} iterations, {steps} env steps in {total:.2f} s = "
          f"{out['env_steps_per_s']:.1f} env steps/s (sampling alone "
          f"{out['sample_env_steps_per_s']:.1f}); median iteration: sample "
          f"{out['sample_ms']:.1f} ms, update {out['update_ms']:.1f} ms "
          f"({sgd_steps} SGD steps = {out['sgd_steps_per_s']:.1f} SGD "
          f"steps/s); mean reward by iteration {out['rewards']}; best "
          f"{best:.2f} (gate {PPO_GATE}, first reached at iteration "
          f"{first}); flash launches {launches}", flush=True)
    check(launches == (0, 0, 0, 0),
          f"[{tag}] PPO launched flash kernels {launches}")
    check(best >= PPO_GATE, f"[{tag}] PPO failed to learn CartPole within "
                            f"{PPO_ITERS} iterations: {rewards}")
    return out, learner, batch, sgd_steps


def phase_ppo_cartpole(card):
    """PPO on CartPole at the JAX package's learning-gate setting, first
    with the rollout workers on the card, then on the CPU (as the JAX
    cluster places its rollout actors) with the learner on the card."""
    run, learner, batch, sgd_steps = _ppo_cartpole(None, "ppo")
    run["profile"] = _rl_profile(lambda: learner.update(batch), sgd_steps,
                                 "ppo")
    cpu, _, _, _ = _ppo_cartpole("cpu", "ppo-cpu-workers")
    print(f"[ppo] env steps/s: workers on the card "
          f"{run['env_steps_per_s']:.1f}, workers on the CPU "
          f"{cpu['env_steps_per_s']:.1f} (learner on the card in both) on "
          f"{card}", flush=True)
    return run, cpu


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

def _gate_config(**resources):
    """PPOConfig at the JAX package's learning gate (phase 13's settings)."""
    from ray_tpu_torch.rl.algorithms import PPOConfig
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=16,
                      rollout_fragment_length=64)
            .training(lr=3e-4, num_sgd_iter=8, sgd_minibatch_size=256,
                      entropy_coeff=0.01)
            .debugging(seed=0).resources(**resources))


def _driver_devices(algo):
    """Where the learner's and each rollout worker's parameters live, read
    through the in-process runtime's actor table."""
    from ray_tpu_torch.core import api
    actors = api._runtime._actors
    group = algo.learner_group
    learner = (actors[group.actor.actor_id].instance if group.remote
               else group.local)
    workers = [actors[w.actor_id].instance for w in algo.workers.workers]
    return [str(x.params["pi"][0]["w"].device) for x in [learner, *workers]]


def _time_driver_parts(algo):
    """Host seconds of each iteration's sampling round (both workers,
    through the runtime) and learner update, as phase 13 splits its hand
    loop: wraps the instance's ``workers.sample`` and
    ``learner_group.update``."""
    spent = {"sample": [], "update": []}

    def timed(fn, part):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[part].append(time.perf_counter() - t0)
            return out
        return run

    algo.workers.sample = timed(algo.workers.sample, "sample")
    algo.learner_group.update = timed(algo.learner_group.update, "update")
    return spent


def _hand_over(run, n):
    """A hand loop's (``_ppo_cartpole``) rate and median parts over its
    first ``n`` iterations."""
    its = run["iteration_s"][:n]
    return dict(env_steps_per_s=2048 * n / sum(its),
                iteration_ms=1e3 * float(np.median(its)),
                sample_ms=1e3 * float(np.median(run["sample_s"][:n])),
                update_ms=1e3 * float(np.median(run["update_s"][:n])))


def _sampling_rounds(rt, n=3):     # cut from 12, then 6 (PERF.md §6)
    """Median ms of one sampling round of phase 13's two workers at fixed
    weights: in turn in this thread, and as two actors of the runtime
    sampling at once (as ``WorkerSet.sample`` does)."""
    from ray_tpu_torch.rl import PPOLearner, RolloutWorker
    weights = PPOLearner(PPO_SPEC, seed=0).get_weights()
    args = ("CartPole-v1", PPO_SPEC, 64, 16, 0.99, 0.95)
    local = [RolloutWorker(*args, seed=1000 * (i + 1)) for i in range(2)]
    actor_cls = rt.remote(RolloutWorker)
    actors = [actor_cls.remote(*args, seed=1000 * (i + 1)) for i in range(2)]
    ref = rt.put(weights)

    def median_ms(fn):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(times))

    out = dict(in_turn_ms=median_ms(lambda: [w.sample(weights)
                                             for w in local]),
               actors_ms=median_ms(lambda: rt.get(
                   [a.sample.remote(ref) for a in actors])))
    for a in actors:
        rt.kill(a)
    return out


def _check_finite_info(result, tag):
    info = {k: v for k, v in result.items() if k.startswith("info/")}
    check(info and all(np.isfinite(v) for v in info.values()),
          f"[{tag}] non-finite or missing learner stats {info}")


def phase_ppo_drivers(card, hand):
    """PPO through ``PPOConfig().build().train()`` on the card, against
    phase 13's hand loop (``hand``) from this same run. (The hand loop no
    longer runs again just before: a repeated timed window, cut to pay for
    phase 33's seconds; PERF.md §6.)"""
    import tempfile
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime_local import THREAD_PREFIX
    from ray_tpu_torch.rl.learner import _named_leaves as rl_leaves
    tag = "ppo-drivers"
    rt.init(local_mode=True)
    _reset_launch_counts()
    try:
        algo = _gate_config().build()
        spent = _time_driver_parts(algo)
        results, best = [], 0.0
        for _ in range(PPO_ITERS):
            result = algo.train()
            _check_finite_info(result, tag)
            results.append(result)
            r = result["episode_reward_mean"]
            if not np.isnan(r):
                best = max(best, r)
            if best >= PPO_GATE:
                break
        devices = _driver_devices(algo)
        check(all(d.startswith("cuda") for d in devices),
              f"[{tag}] learner and workers not on the card: {devices}")
        rewards = [round(r["episode_reward_mean"], 2) for r in results]
        check(best >= PPO_GATE, f"[{tag}] PPO failed to learn CartPole "
                                f"within {PPO_ITERS} iterations: {rewards}")
        n = len(results)
        steps = sum(r["num_env_steps_sampled"] for r in results)
        secs = sum(r["time_this_iter_s"] for r in results)
        out = dict(
            worker_device=devices[1], learner_device=devices[0],
            iterations=n, env_steps=steps, env_steps_per_s=steps / secs,
            iteration_ms=1e3 * float(np.median(
                [r["time_this_iter_s"] for r in results])),
            sample_ms=1e3 * float(np.median(spent["sample"])),
            update_ms=1e3 * float(np.median(spent["update"])),
            best_reward=best, gate_iteration=n, rewards=rewards,
            hand_phase13=_hand_over(hand, n))
        out["hand_phase13"]["ratio"] = (
            out["env_steps_per_s"] / out["hand_phase13"]["env_steps_per_s"])
        print(f"[{tag}] PPOConfig().build().train() with the learner and 2 "
              f"workers on {devices}: gate met at iteration {n} (best "
              f"{best:.2f}); {steps} env steps in {secs:.2f} s = "
              f"{out['env_steps_per_s']:.1f} env steps/s, median iteration "
              f"{out['iteration_ms']:.1f} ms (sample {out['sample_ms']:.1f}, "
              f"update {out['update_ms']:.1f}); mean reward by iteration "
              f"{rewards} on {card}", flush=True)
        h = out["hand_phase13"]
        print(f"[{tag}] phase 13's hand loop, its first {n} iterations in "
              f"this run: {h['env_steps_per_s']:.1f} env steps/s, median "
              f"iteration {h['iteration_ms']:.1f} ms (sample "
              f"{h['sample_ms']:.1f}, update {h['update_ms']:.1f}); "
              f"drivers / hand loop = {h['ratio']:.3f}", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = algo.save(tmp)
            want = algo.get_state()["weights"]
            iteration = algo.iteration
            algo.stop()
            remote = _gate_config(learner_remote=True,
                                  learner_num_gpus=1).build()
            for _ in range(3):
                result = remote.train()
                _check_finite_info(result, tag + "-remote")
            remote_devices = _driver_devices(remote)
            check(all(d.startswith("cuda") for d in remote_devices),
                  f"[{tag}] remote learner not on the card: "
                  f"{remote_devices}")
            remote.stop()
            out["remote_learner"] = dict(
                devices=remote_devices, iterations=3,
                iteration_ms=1e3 * result["time_this_iter_s"],
                info={k: v for k, v in result.items()
                      if k.startswith("info/")})
            print(f"[{tag}] learner_remote=True, learner_num_gpus=1: 3 "
                  f"iterations on {remote_devices}, last "
                  f"{out['remote_learner']['iteration_ms']:.1f} ms, stats "
                  f"{out['remote_learner']['info']}", flush=True)
            fresh = _gate_config().build()
            fresh.restore(ckpt)
        got = rl_leaves(fresh.get_state()["weights"])
        same = [got[k].tobytes() == v.tobytes()
                for k, v in rl_leaves(want).items()]
        check(len(same) == 12 and all(same) and fresh.iteration == iteration,
              f"[{tag}] restore: {sum(same)} of {len(same)} leaves equal, "
              f"iteration {fresh.iteration} (saved {iteration})")
        _check_finite_info(fresh.train(), tag + "-restored")
        fresh.stop()
        print(f"[{tag}] save -> fresh build() -> restore: 12 of 12 weight "
              f"leaves bitwise equal, iteration {iteration}; one more "
              f"train() at iteration {fresh.iteration}", flush=True)
        out["sampling_round"] = _sampling_rounds(rt)
        print(f"[{tag}] one sampling round of both workers at fixed "
              f"weights (medians of 3): in turn in this thread "
              f"{out['sampling_round']['in_turn_ms']:.1f} ms, as two "
              f"runtime actors at once "
              f"{out['sampling_round']['actors_ms']:.1f} ms", flush=True)
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
    out["shutdown_s"] = time.perf_counter() - t0
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(THREAD_PREFIX) and t.is_alive()]
    check(not alive, f"[{tag}] runtime threads alive after shutdown: "
                     f"{alive}")
    out["launches"] = _launch_counts()
    print(f"[{tag}] ray_tpu_torch.shutdown() returned in "
          f"{out['shutdown_s']:.3f} s, no runtime thread left; flash "
          f"launches {out['launches']}", flush=True)
    check(out["launches"] == (0, 0, 0, 0),
          f"[{tag}] PPO launched flash kernels {out['launches']}")
    return out


def _atari_batch(count, obs_dim, seed):
    """A seeded train batch of synthetic frames (pixel values k / 255)."""
    from ray_tpu_torch.rl import SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (count, obs_dim), dtype=np.uint8)
    obs = obs.astype(np.float32) / np.float32(255)
    f32 = lambda x: x.astype(np.float32)
    vf = f32(rng.standard_normal(count))
    return SampleBatch({
        sb.OBS: obs, sb.ACTIONS: f32(rng.integers(0, 4, count)),
        sb.ACTION_LOGP: f32(np.log(0.25) + 0.1 *
                            rng.standard_normal(count)),
        sb.ADVANTAGES: f32(rng.standard_normal(count)),
        sb.VF_PREDS: vf, sb.VALUE_TARGETS: vf + f32(
            rng.standard_normal(count)),
    })


def phase_ppo_atari_learner(card):
    """The CNN learner at Atari frame size: ConvRLModule on 84x84x4 frames
    (filters (16, 3, 2), (32, 3, 2); hiddens (128,); 4 actions), one
    PPOLearner.update of a seeded 5,000-frame batch at minibatch 500 for 10
    epochs, clip 0.1, entropy 0.01 (RLlib's atari-ppo batch, minibatch and
    epochs). f32 with TF32 off (phase 1's setting). A first update warms
    up; the second is timed, the third profiled."""
    from ray_tpu_torch.rl import PPOLearner
    count, mb, epochs = 5000, 500, 10
    spec = {"encoder": "cnn", "obs_dim": 84 * 84 * 4, "num_actions": 4,
            "obs_shape": (84, 84, 4)}
    t0 = time.perf_counter()
    batch = _atari_batch(count, spec["obs_dim"], 14)
    make_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    learner = PPOLearner(spec, clip_param=0.1, entropy_coeff=0.01,
                         num_sgd_iter=epochs, sgd_minibatch_size=mb, seed=0)
    n_params = sum(p.numel() for p in learner._leaves)
    _reset_launch_counts()
    times, stats = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        stats.append(learner.update(batch))
        times.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sgd_steps = epochs * (count // mb)
    check(all(np.isfinite(v) for s in stats for v in s.values()),
          f"[ppo-atari] non-finite learner stats {stats}")
    check(launches == (0, 0, 0, 0),
          f"[ppo-atari] the learner launched flash kernels {launches}")
    update_ms = times[1] * 1e3
    out = dict(launches=launches, params=n_params, batch=count,
               minibatch=mb, epochs=epochs, batch_bytes=batch["obs"].nbytes,
               update_ms=update_ms, first_update_ms=times[0] * 1e3,
               samples_per_s=count / times[1],
               sample_passes_per_s=count * epochs / times[1],
               sgd_steps_per_s=sgd_steps / times[1], peak_gb=peak_gb,
               total_loss=stats[1]["total_loss"], stats=stats[1])
    print(f"[ppo-atari] ConvRLModule 84x84x4, {n_params} params; batch "
          f"{count} frames ({batch['obs'].nbytes / 1e6:.1f} MB of f32 obs, "
          f"made in {make_s:.2f} s on the host), minibatch {mb}, {epochs} "
          f"epochs = {sgd_steps} SGD steps: update {update_ms:.1f} ms "
          f"(first {times[0] * 1e3:.1f} ms), {out['samples_per_s']:.1f} "
          f"train-batch samples/s ({out['sample_passes_per_s']:.1f} "
          f"sample passes/s, {out['sgd_steps_per_s']:.1f} SGD steps/s), "
          f"peak memory "
          f"{peak_gb:.3f} GB; stats {stats[1]}; flash launches {launches} "
          f"on {card}", flush=True)
    out["profile"] = _rl_profile(lambda: learner.update(batch), sgd_steps,
                                 "ppo-atari")
    del learner, batch
    torch.cuda.empty_cache()
    return out


RL_SMALL = {
    "mlp": {"obs_dim": 8, "num_actions": 4, "hiddens": (64, 64)},
    "cnn": {"encoder": "cnn", "obs_dim": 42 * 42 * 4, "num_actions": 4,
            "obs_shape": (42, 42, 4)},
    "lstm": {"encoder": "lstm", "obs_dim": 8, "num_actions": 4,
             "hidden_size": 64},
    "gtrxl": {"encoder": "gtrxl", "obs_dim": 8, "num_actions": 4,
              "hidden_size": 64, "num_layers": 2, "num_heads": 4,
              "memory_len": 8},
}


def _rl_card_vs_cpu(name, spec):
    """One small f32 module on the card and on the CPU from the same
    weights -> {check: largest difference}. Flat encoders: logits and
    values, logp_entropy on fixed actions, then one PPOLearner.update (2 SGD
    steps) from the same weights and seed. Sequence encoders (the JAX
    package has no logp_entropy for them, so no PPO learner): apply_seq with
    dones (logits, values, final state), the distribution's logp and
    entropy of fixed actions over those logits, and the gradients of a loss
    over them."""
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models.convert import rl_params_to_numpy
    from ray_tpu_torch.rl import PPOLearner, SampleBatch, make_module
    from ray_tpu_torch.rl import sample_batch as sb
    from ray_tpu_torch.rl.learner import _named_leaves
    from ray_tpu_torch.rl.rollout import place_params

    def leaves(tree):
        return list(_named_leaves(tree).values())
    module = make_module(spec)
    rng = np.random.default_rng(15)
    cpu = module.init(torch.Generator().manual_seed(15), device="cpu")
    card = place_params(cpu, module, resolve_device(None))
    results = []
    if name in ("mlp", "cnn"):
        B = 64
        obs = rng.standard_normal((B, spec["obs_dim"])).astype(np.float32)
        actions = rng.integers(0, 4, B).astype(np.float32)
        batch = SampleBatch({
            sb.OBS: obs, sb.ACTIONS: actions,
            sb.ACTION_LOGP: (np.log(0.25) + 0.3 * rng.standard_normal(B))
            .astype(np.float32),
            sb.ADVANTAGES: rng.standard_normal(B).astype(np.float32),
            sb.VF_PREDS: rng.standard_normal(B).astype(np.float32),
            sb.VALUE_TARGETS: rng.standard_normal(B).astype(np.float32)})
        for params, dev in ((cpu, "cpu"), (card, None)):
            with torch.no_grad():
                out = {"logits_values": module.apply(params, obs),
                       "logp_entropy": module.logp_entropy(params, obs,
                                                           actions)}
            learner = PPOLearner(spec, num_sgd_iter=1, sgd_minibatch_size=32,
                                 seed=15, device=dev)
            learner.set_weights(rl_params_to_numpy(cpu))
            stats = learner.update(batch)
            out["update_stats"] = [torch.tensor(stats[k])
                                   for k in sorted(stats)]
            out["update_params"] = learner.params
            results.append(out)
    else:
        T, B = 16, 8
        obs = rng.standard_normal((T, B, spec["obs_dim"])).astype(np.float32)
        dones = (rng.random((T, B)) < 0.2).astype(np.float32)
        actions = rng.integers(0, 4, (T, B))
        for params, dev in ((cpu, "cpu"), (card, None)):
            trainable = leaves(params)
            for t in trainable:
                t.requires_grad_(True)
            logits, values, final = module.apply_seq(
                params, obs, module.initial_state(B, device=dev), dones)
            logp, ent = module.dist_logp_entropy(logits, actions)
            loss = -logp.mean() + values.square().mean() - 0.01 * ent.mean()
            results.append({"logits_values_state": (logits, values, final),
                            "logp_entropy": (logp, ent),
                            "grads": torch.autograd.grad(loss, trainable)})
    want, got = results
    diffs = {}
    for k in want:
        g, w = leaves(got[k]), leaves(want[k])
        check(len(g) == len(w), f"{name} {k}: the trees differ")
        diffs[k] = max((a.detach().cpu() - b.detach()).abs().max().item()
                       for a, b in zip(g, w))
    return diffs


def phase_small_rl():
    """Small f32 RL modules (MLP, CNN, LSTM and GTrXL with dones) on the
    card, TF32 off, against the CPU."""
    out = {}
    with _tf32_off():
        for name, spec in RL_SMALL.items():
            out[name] = _rl_card_vs_cpu(name, spec)
            print(f"[reference] small f32 {name} card vs CPU: " + ", ".join(
                f"{k} {v:.3e}" for k, v in out[name].items())
                + f" (tol {RL_TOL_F32})", flush=True)
    check(max(v for d in out.values() for v in d.values()) <= RL_TOL_F32,
          "small RL modules: card disagrees with the CPU")
    return out


# ---------------------------------------------------------------------------
# phases 17-21: RL beyond PPO (IMPALA, APPO, A2C, DQN, SAC, TD3, DDPG and
# offline RL)
# ---------------------------------------------------------------------------

# The JAX package's gates (its tier-1 tests): APPO (test_rl_appo_vtrace.py:
# 77) best mean reward >= 150 within 40 iterations, A2C (test_rl_ddpg_marwil
# .py:90) >= 40 within 35, SAC (test_rl_sac_offline.py:46) >= 100 within 40,
# TD3 (test_rl_td3_models.py:45) >= -700 within 60, CQL (test_rl_ddpg_marwil
# .py:113) an evaluated mean >= 60 with cql_loss >= 0.
APPO_GATE, APPO_ITERS = 150.0, 40
# APPO consumes its two workers' batches in the order they arrive, which the
# threads decide, so one seed gives more than one trajectory: the gate is
# held in each of APPO_RUNS fresh builds from seed 0.
APPO_RUNS = 3
A2C_GATE, A2C_ITERS = 40.0, 35
SAC_GATE, SAC_ITERS = 100.0, 40
DDPG_ITERS = 2            # cut from 3 (PERF.md §6)
TD3_GATE, TD3_ITERS = -700.0, 60
CQL_GATE = 60.0


def _runtime_threads():
    import threading

    from ray_tpu_torch.core.runtime_local import THREAD_PREFIX
    return [t.name for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX) and t.is_alive()]


@contextlib.contextmanager
def _timed_calls(owner, name, spent):
    """Host seconds of every call of ``owner.name`` in the block, appended
    to ``spent``."""
    fn = getattr(owner, name)

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent.append(time.perf_counter() - t0)
    setattr(owner, name, run)
    try:
        yield spent
    finally:
        setattr(owner, name, fn)


def _train_to(algo, gate, iters, tag, key="episode_reward_mean"):
    """train() until the best ``key`` reaches ``gate`` (at most ``iters``
    iterations; missing it fails the run) -> the results."""
    results, best = [], -math.inf
    for _ in range(iters):
        result = algo.train()
        results.append(result)
        r = result.get(key)
        if r is not None and not np.isnan(r):
            best = max(best, r)
        if best >= gate:
            break
    rewards = [round(float(r.get(key, float("nan"))), 2) for r in results]
    check(best >= gate, f"[{tag}] best mean reward {best} missed the gate "
                        f"{gate} within {iters} iterations: {rewards}")
    return results, best, rewards


def _rate(results, steps_key):
    """Env steps over the iterations' own seconds."""
    steps = sum(r[steps_key] for r in results)
    return steps, steps / sum(r["time_this_iter_s"] for r in results)


def _bitwise_restore(algo, config, state, tag):
    """save -> a fresh build() -> restore: every leaf of ``state(algo)``
    bitwise equal, and the iteration."""
    import tempfile

    from ray_tpu_torch.rl.learner import _named_leaves
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = algo.save(tmp)
        fresh = config.copy().build()
        fresh.restore(ckpt)
    want, got = _named_leaves(state(algo)), _named_leaves(state(fresh))
    same = [k in got and np.asarray(got[k]).tobytes() ==
            np.asarray(v).tobytes() for k, v in want.items()]
    check(len(same) == len(got) > 0 and all(same)
          and fresh.iteration == algo.iteration,
          f"[{tag}] restore: {sum(same)} of {len(want)} leaves equal, "
          f"iteration {fresh.iteration} (saved {algo.iteration})")
    fresh.stop()
    print(f"[{tag}] save -> fresh build() -> restore: {len(same)} of "
          f"{len(same)} leaves bitwise equal at iteration {algo.iteration}",
          flush=True)
    return len(same)


def _async_config(cls, **training):
    return (cls().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, num_envs_per_worker=8,
                      rollout_fragment_length=32)
            .training(**training).debugging(seed=0))


def phase_async_drivers(card):
    """IMPALA, APPO and A2C on CartPole through ``XConfig().build()
    .train()`` with ``device`` left at ``None``: workers and learner on the
    card, as actors of the port's runtime (the learner in the driver's
    thread)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl.algorithms import A2CConfig, APPOConfig, ImpalaConfig
    out = {}
    rt.init(local_mode=True)
    _reset_launch_counts()
    try:
        # APPO at its gate, with its driver's time split
        config = _async_config(APPOConfig, train_batch_size=1024, lr=5e-4)
        algo = config.build()
        waits, updates = [], []
        with _timed_calls(rt, "wait", waits), \
                _timed_calls(algo.learner, "update", updates):
            results, best, rewards = _train_to(algo, APPO_GATE, APPO_ITERS,
                                               "appo")
        steps, rate = _rate(results, "num_env_steps_sampled")
        secs = sum(r["time_this_iter_s"] for r in results)
        n = len(results)
        out["appo"] = dict(
            iterations=n, env_steps=steps, env_steps_per_s=rate,
            iteration_ms=1e3 * float(np.median(
                [r["time_this_iter_s"] for r in results])),
            update_ms=1e3 * float(np.median(updates)),
            updates_per_iteration=len(updates) / n,
            wait_share=sum(waits) / secs, best_reward=best, rewards=rewards,
            device=str(algo.learner.params["pi"][0]["w"].device))
        check(out["appo"]["device"].startswith("cuda"),
              "[appo] the learner is not on the card")
        print(f"[appo] APPOConfig().build().train(): gate met at iteration "
              f"{n} (best {best:.2f}); {steps} env steps in {secs:.2f} s = "
              f"{rate:.1f} env steps/s; median iteration "
              f"{out['appo']['iteration_ms']:.1f} ms, "
              f"{out['appo']['updates_per_iteration']:.2f} updates an "
              f"iteration of median {out['appo']['update_ms']:.2f} ms; "
              f"share of the driver's time waiting in rt.wait "
              f"{out['appo']['wait_share']:.4f}; rewards {rewards} on {card}",
              flush=True)
        out["appo"]["restored_leaves"] = _bitwise_restore(
            algo, config, lambda a: a.get_state()["weights"], "appo")
        algo.stop()
        # the same gate in fresh builds from the same seed
        out["appo"]["repeats"] = []
        for k in range(2, APPO_RUNS + 1):
            algo = config.build()
            results, best, rewards = _train_to(algo, APPO_GATE, APPO_ITERS,
                                               f"appo run {k}")
            algo.stop()
            out["appo"]["repeats"].append(dict(
                iterations=len(results), best_reward=best, rewards=rewards))
            print(f"[appo] run {k} of {APPO_RUNS} from seed 0: gate met at "
                  f"iteration {len(results)} (best {best:.2f}); rewards "
                  f"{rewards}", flush=True)
        # IMPALA at tests/test_rl.py:129's settings
        algo = _async_config(ImpalaConfig, train_batch_size=512).build()
        results = [algo.train() for _ in range(3)]
        for r in results:
            _check_finite_info(r, "impala")
            check(r["num_env_steps_sampled"] >= 512,
                  f"[impala] {r['num_env_steps_sampled']} env steps")
        steps, rate = _rate(results, "num_env_steps_sampled")
        out["impala"] = dict(iterations=3, env_steps=steps,
                             env_steps_per_s=rate)
        info = {k: round(v, 4) for k, v in results[-1].items()
                if k.startswith("info/")}
        print(f"[impala] 3 iterations, {steps} env steps, {rate:.1f} env "
              f"steps/s, stats {info}", flush=True)
        algo.stop()
        # A2C to its gate: 1 worker x 8 envs x 32 steps, batch 256
        algo = (_async_config(A2CConfig, train_batch_size=256)
                .rollouts(num_rollout_workers=1).build())
        results, best, rewards = _train_to(algo, A2C_GATE, A2C_ITERS, "a2c")
        steps, rate = _rate(results, "num_env_steps_sampled")
        out["a2c"] = dict(iterations=len(results), env_steps=steps,
                          env_steps_per_s=rate, best_reward=best,
                          rewards=rewards)
        print(f"[a2c] gate {A2C_GATE} met at iteration {len(results)} (best "
              f"{best:.2f}); {rate:.1f} env steps/s", flush=True)
        algo.stop()
    finally:
        rt.shutdown()
    alive = _runtime_threads()
    check(not alive, f"[appo] runtime threads alive after shutdown: {alive}")
    launches = _launch_counts()
    check(launches == (0, 0, 0, 0),
          f"[appo] the async drivers launched flash kernels {launches}")
    for k in out:
        out[k]["launches"] = launches
    return out


def _atari_structured(T, N, obs_dim, seed):
    """A seeded structured batch of synthetic frames (pixel values k / 255)
    in time-major [T * N] rows, as a worker's ``sample(structured=True)``."""
    from ray_tpu_torch.rl import SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    rng = np.random.default_rng(seed)
    frames = lambda n: rng.integers(0, 256, (n, obs_dim), dtype=np.uint8
                                    ).astype(np.float32) / np.float32(255)
    batch = SampleBatch({
        sb.OBS: frames(T * N),
        sb.ACTIONS: rng.integers(0, 4, T * N).astype(np.float32),
        sb.REWARDS: (rng.random(T * N) < 0.05).astype(np.float32),
        sb.DONES: (rng.random(T * N) < 0.01).astype(np.float32),
        sb.ACTION_LOGP: (np.log(0.25) + 0.1 * rng.standard_normal(T * N))
        .astype(np.float32)})
    batch.rollout_shape = (T, N)
    batch.last_obs = frames(N)
    return batch


def phase_appo_atari_learner(card):
    """The APPO learner at Atari frame size: ConvRLModule on 84x84x4 frames
    (phase 14's module, 4 actions), 20 updates of one seeded structured
    batch of T 50 x N 10 = 500 frames (the fragment length and train batch
    of RLlib's IMPALA Atari tuned example,
    rllib/tuned_examples/impala/atari-impala.yaml). f32 with TF32 off."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.rl.algorithms.appo import APPOLearner
    from ray_tpu_torch.rl.vtrace import vtrace_returns
    T, N = 50, 10
    spec = {"encoder": "cnn", "obs_dim": 84 * 84 * 4, "num_actions": 4,
            "obs_shape": (84, 84, 4)}
    batch = _atari_structured(T, N, spec["obs_dim"], 18)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    learner = APPOLearner(spec, lr=5e-4, entropy_coeff=0.01, seed=0)
    _reset_launch_counts()
    times, stats = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        stats.append(learner.update(batch))   # floats: ends in a sync
        times.append(time.perf_counter() - t0)
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(v) for s in stats for v in s.values()),
          f"[appo-atari] non-finite learner stats {stats[-1]}")
    check(launches == (0, 0, 0, 0),
          f"[appo-atari] the learner launched flash kernels {launches}")
    update_ms = 1e3 * float(np.median(times[1:]))
    out = dict(launches=launches, batch=T * N, rollout_shape=[T, N],
               update_ms=update_ms, first_update_ms=1e3 * times[0],
               samples_per_s=T * N / (update_ms / 1e3), peak_gb=peak_gb,
               stats=stats[-1])
    print(f"[appo-atari] ConvRLModule 84x84x4, structured batch T {T} x N "
          f"{N} = {T * N} frames: median update {update_ms:.2f} ms over 19 "
          f"(first {out['first_update_ms']:.1f} ms), "
          f"{out['samples_per_s']:.1f} samples/s, peak memory "
          f"{peak_gb:.3f} GB; stats {stats[-1]}; flash launches {launches} "
          f"on {card}", flush=True)
    out["profile"] = _rl_profile(lambda: learner.update(batch), 1,
                                 "appo-atari")
    # V-trace's own kernels at this shape
    dev = learner.device
    g = torch.Generator(device=dev).manual_seed(0)
    tn = lambda: torch.randn(T, N, device=dev, generator=g)
    args = (tn(), tn(), tn(), tn(), (tn() > 2).float(),
            torch.randn(N, device=dev, generator=g))
    vtrace_returns(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        vtrace_returns(*args)
        torch.cuda.synchronize()
    vk = _device_kernels(prof)
    out["vtrace_kernels"] = len(vk)
    out["vtrace_device_ms"] = sum(e.time_range.elapsed_us() for e in vk) / 1e3
    out["vtrace_ms"] = cuda_ms(lambda: vtrace_returns(*args), iters=20)
    print(f"[appo-atari] vtrace_returns at T {T} x N {N}: "
          f"{out['vtrace_kernels']} kernels ({T} of them the backward "
          f"recurrence), {out['vtrace_device_ms']:.4f} ms of device time, "
          f"{out['vtrace_ms']:.4f} ms by events", flush=True)
    del learner, batch
    torch.cuda.empty_cache()
    return out


def _update_window(step, sample, n=20, windows=2):   # windows cut from 3
    """Median ms of one update over ``windows`` windows of ``n`` updates,
    each on a fresh minibatch from the algorithm's own buffer (the numpy
    draw and the copy to the card included, as in its training step); each
    window ends in a synchronize."""
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(sample())
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / n)
    return 1e3 * float(np.median(per))


def phase_offpolicy(card):
    """DQN, SAC, TD3 and DDPG through their drivers on the card (``device``
    left at ``None``; the collectors are runtime actors, SAC's in the
    driver's thread), each with env steps/s, the median update ms and
    updates/s over windows of updates from its own buffer, and a bitwise
    save -> build() -> restore."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl.algorithms import (DDPGConfig, DQNConfig,
                                             SACConfig, TD3Config)
    from ray_tpu_torch.rl.algorithms.dqn import TRANSITION
    from ray_tpu_torch.rl.learner import batch_to_device
    out = {}
    rt.init(local_mode=True)
    _reset_launch_counts()
    try:
        # DQN at tests/test_rl.py:116's settings, 3 iterations
        config = (DQNConfig().environment("CartPole-v1")
                  .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                            rollout_fragment_length=32)
                  .training(learning_starts=128).debugging(seed=0))
        algo = config.build()
        results = [algo.train() for _ in range(3)]
        eps = [r["epsilon"] for r in results]
        check(np.isfinite(results[-1]["info/td_loss"]) and eps[-1] < eps[0],
              f"[dqn] td loss {results[-1]['info/td_loss']}, epsilon {eps}")
        samp = lambda: batch_to_device(algo.buffer.sample(32), TRANSITION,
                                       algo.device)
        out["dqn"] = dict(iterations=3, epsilon=eps,
                          env_steps_per_s=3 * 256 / sum(
                              r["time_this_iter_s"] for r in results),
                          update_ms=_update_window(algo.td_step, samp),
                          td_loss=results[-1]["info/td_loss"])
        out["dqn"]["restored_leaves"] = _bitwise_restore(
            algo, config, lambda a: a.get_state(), "dqn")
        algo.stop()
        # SAC to its gate; TD3 to its gate, stopping when met; DDPG 2 its
        sac_cfg = (SACConfig().environment("CartPole-v1")
                   .rollouts(num_envs_per_worker=8,
                             rollout_fragment_length=32).debugging(seed=0))
        td3_cfg = (TD3Config().environment("Pendulum-v1")
                   .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                             rollout_fragment_length=64).debugging(seed=0))
        ddpg_cfg = (DDPGConfig().environment("Pendulum-v1")
                    .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                              rollout_fragment_length=64).debugging(seed=0))
        for name, config, gate, iters, state in (
                ("sac", sac_cfg, SAC_GATE, SAC_ITERS,
                 lambda a: a.get_state()),
                ("td3", td3_cfg, TD3_GATE, TD3_ITERS,
                 lambda a: a.get_state()["learner"]),
                ("ddpg", ddpg_cfg, None, DDPG_ITERS,
                 lambda a: a.get_state()["learner"])):
            algo = config.build()
            t0 = time.perf_counter()
            if gate is None:
                results = [algo.train() for _ in range(iters)]
                best = max(r["episode_reward_mean"] for r in results)
                rewards = [round(r["episode_reward_mean"], 2)
                           for r in results]
                check(all(np.isfinite(r[k]) for r in results[1:]
                          for k in ("critic_loss", "actor_loss")),
                      f"[{name}] non-finite losses {results[-1]}")
            else:
                results, best, rewards = _train_to(algo, gate, iters, name)
            wall = time.perf_counter() - t0
            steps = algo._timesteps_total
            secs = sum(r["time_this_iter_s"] for r in results)
            updates = sum(config.updates_per_iter for r in results
                          if set(r) & {"q_loss", "critic_loss"})
            device = str(algo.learner.params["q1"][0]["w"].device)
            check(device.startswith("cuda"), f"[{name}] learner on {device}")
            samp = (lambda a=algo, c=config: batch_to_device(
                a.buffer.sample(c.train_batch_size), TRANSITION, a.device))
            update_ms = _update_window(algo.learner.step, samp)
            out[name] = dict(iterations=len(results), env_steps=steps,
                             env_steps_per_s=steps / secs,
                             updates=updates, updates_per_s_in_training=(
                                 updates / secs),
                             update_ms=update_ms,
                             updates_per_s=1e3 / update_ms,
                             best_reward=best, rewards=rewards,
                             wall_s=wall, device=device)
            print(f"[{name}] {len(results)} iterations (best {best:.2f}"
                  + (f", gate {gate}" if gate is not None else "")
                  + f"), {steps} env steps in {secs:.2f} s = "
                  f"{out[name]['env_steps_per_s']:.1f} env steps/s, "
                  f"{updates} updates = "
                  f"{out[name]['updates_per_s_in_training']:.1f} updates/s "
                  f"of training time; median update "
                  f"{update_ms:.3f} ms ({out[name]['updates_per_s']:.1f} "
                  f"updates/s, windows of 20 from the buffer); rewards "
                  f"{rewards} on {card}", flush=True)
            out[name]["restored_leaves"] = _bitwise_restore(
                algo, config, state, name)
            algo.stop()
        print(f"[dqn] 3 iterations, epsilon {eps}, td loss "
              f"{out['dqn']['td_loss']:.4f}, "
              f"{out['dqn']['env_steps_per_s']:.1f} env steps/s; median TD "
              f"step {out['dqn']['update_ms']:.3f} ms", flush=True)
    finally:
        rt.shutdown()
    alive = _runtime_threads()
    check(not alive, f"[off-policy] runtime threads alive after shutdown: "
                     f"{alive}")
    launches = _launch_counts()
    check(launches == (0, 0, 0, 0),
          f"[off-policy] launched flash kernels {launches}")
    for k in out:
        out[k]["launches"] = launches
    return out


def phase_offline(card):
    """collect_experiences with the JAX tests' pole-angle controller (4,000
    steps) into a temporary directory, then BC, MARWIL (150 updates an
    iteration, lr 3e-3) and CQL (200 updates, lr 5e-4, alpha 1) for 5
    iterations each on the card, each evaluated greedily on 10 episodes."""
    import tempfile

    from ray_tpu_torch.rl.algorithms import CQLConfig
    from ray_tpu_torch.rl.offline import (BCConfig, MARWILConfig,
                                          collect_experiences)
    out = {}
    _reset_launch_counts()
    with tempfile.TemporaryDirectory() as path:
        collect_experiences(
            "CartPole-v1", path, num_steps=4000, seed=0,
            policy_fn=lambda obs: (obs[:, 2] + 0.5 * obs[:, 3] > 0)
            .astype(int))
        for name, cls, training in (
                ("bc", BCConfig, dict(updates_per_iter=150, lr=3e-3)),
                ("marwil", MARWILConfig,
                 dict(updates_per_iter=150, lr=3e-3, beta=1.0)),
                ("cql", CQLConfig,
                 dict(updates_per_iter=200, lr=5e-4, alpha=1.0))):
            algo = cls().offline_data(input_path=path).training(
                **training).build()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                stats = algo.train()        # floats: ends in a sync
                times.append(time.perf_counter() - t0)
            ev = algo.evaluate(num_episodes=10)["episode_reward_mean"]
            check(np.isfinite(stats["total_loss"]),
                  f"[{name}] non-finite stats {stats}")
            n = training["updates_per_iter"]
            out[name] = dict(updates_per_s=n / float(np.median(times[1:])),
                             first_iteration_s=times[0], evaluated=ev,
                             stats=stats)
            print(f"[{name}] 5 iterations of {n} updates: "
                  f"{out[name]['updates_per_s']:.1f} updates/s (median of "
                  f"iterations 2-5; the first {times[0]:.2f} s); evaluated "
                  f"mean reward {ev:.2f}; stats {stats} on {card}",
                  flush=True)
    check(out["cql"]["stats"]["cql_loss"] >= 0
          and out["cql"]["evaluated"] >= CQL_GATE,
          f"[cql] cql_loss {out['cql']['stats']['cql_loss']}, evaluated "
          f"{out['cql']['evaluated']} (gate {CQL_GATE})")
    launches = _launch_counts()
    check(launches == (0, 0, 0, 0),
          f"[offline] launched flash kernels {launches}")
    for k in out:
        out[k]["launches"] = launches
    return out


def _small_learners(dev, path):
    """{name: (learner, its state as numpy, one update of a host batch)}
    for the small f32 learners of phase 21 on ``dev``."""
    from ray_tpu_torch.rl.algorithms import (CQLConfig, DQNConfig,
                                             MADDPGConfig, QMIXConfig)
    from ray_tpu_torch.rl.algorithms.appo import APPOLearner
    from ray_tpu_torch.rl.algorithms.dqn import TRANSITION
    from ray_tpu_torch.rl.algorithms.sac import SACLearner
    from ray_tpu_torch.rl.algorithms.td3 import TD3Learner
    from ray_tpu_torch.rl.learner import batch_to_device
    from ray_tpu_torch.rl.multi_agent import TwoStepCoopEnv
    spec = {"obs_dim": 8, "num_actions": 4, "hiddens": (64, 64)}
    appo = APPOLearner(spec, lr=1e-3, seed=21, device=dev)
    dqn = (DQNConfig().rollouts(num_rollout_workers=0).environment(
        "CartPole-v1").resources(device=dev).build())
    sac = SACLearner(spec, seed=21, device=dev)
    td3 = TD3Learner({"obs_dim": 8, "num_actions": -1, "action_dim": 2},
                     target_noise=0.0, target_noise_clip=0.0, policy_delay=1,
                     action_low=-2.0, action_high=2.0, seed=21, device=dev)
    cql = CQLConfig().offline_data(input_path=path).resources(
        device=dev).build()
    qmix = QMIXConfig().resources(device=dev).debugging(seed=21)
    qmix.env_fn = lambda: TwoStepCoopEnv(horizon=8)
    qmix = qmix.build()
    maddpg = MADDPGConfig().resources(device=dev).debugging(seed=21).build()
    tens = lambda a, b: batch_to_device(b, TRANSITION, a.device)
    joint = lambda a, b: tuple(torch.as_tensor(x).to(a.device) for x in b)
    return {
        "appo": (appo, appo.get_weights, appo.set_weights, appo.update),
        "dqn": (dqn, dqn.get_state, dqn.set_state,
                lambda b: dqn.td_step(tens(dqn, b))),
        "sac": (sac, sac.get_state, sac.set_state, sac.update),
        "td3": (td3, td3.state, td3.set_state, td3.update),
        "cql": (cql, cql.get_state, cql.set_state,
                lambda b: cql.step(tens(cql, b))),
        "qmix": (qmix, qmix.get_state, qmix.set_state,
                 lambda b: qmix.td_step(joint(qmix, b))),
        "maddpg": (maddpg, maddpg.get_state, maddpg.set_state,
                   lambda b: maddpg.update(joint(maddpg, b), 1.0)),
    }


def _small_batch(name, rng):
    from ray_tpu_torch.rl import SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    obs_dim = 4 if name in ("dqn", "cql") else 8
    if name in ("qmix", "maddpg"):   # joint batches: 2 agents
        B, d = 128, (2 if name == "qmix" else 3)
        obs = rng.random((B, 2, d)).astype(np.float32)
        nobs = rng.random((B, 2, d)).astype(np.float32)
        done = (rng.random(B) < 0.2).astype(np.float32)
        if name == "qmix":
            return (obs, rng.integers(0, 2, (B, 2)).astype(np.int32),
                    rng.standard_normal(B).astype(np.float32), nobs, done,
                    obs.reshape(B, -1), nobs.reshape(B, -1))
        return (obs, rng.uniform(-1, 1, (B, 2, 1)).astype(np.float32),
                rng.standard_normal((B, 2)).astype(np.float32), nobs, done)
    if name == "appo":
        T, N = 16, 8
        batch = SampleBatch({
            sb.OBS: rng.standard_normal((T * N, 8)).astype(np.float32),
            sb.ACTIONS: rng.integers(0, 4, T * N).astype(np.float32),
            sb.REWARDS: rng.standard_normal(T * N).astype(np.float32),
            sb.DONES: (rng.random(T * N) < 0.1).astype(np.float32),
            sb.ACTION_LOGP: (np.log(0.25) + 0.3 * rng.standard_normal(
                T * N)).astype(np.float32)})
        batch.rollout_shape = (T, N)
        batch.last_obs = rng.standard_normal((N, 8)).astype(np.float32)
        return batch
    n = 128
    return SampleBatch({
        sb.OBS: rng.standard_normal((n, obs_dim)).astype(np.float32),
        sb.ACTIONS: (rng.uniform(-2, 2, (n, 2)).astype(np.float32)
                     if name == "td3" else
                     rng.integers(0, 4 if name == "sac" else 2, n)),
        sb.REWARDS: rng.standard_normal(n).astype(np.float32),
        sb.NEXT_OBS: rng.standard_normal((n, obs_dim)).astype(np.float32),
        sb.DONES: (rng.random(n) < 0.2).astype(np.float32)})


def phase_small_offpolicy():
    """Small f32 learners on the card (TF32 off) against the CPU: from the
    same weights and batch, one update of APPOLearner (V-trace on the
    card), DQN's TD step, SACLearner, TD3Learner at target_noise=0, CQL,
    QMIX's TD step and MADDPG's update (past the actor delay); the largest
    difference of any parameter (and target) leaf."""
    import tempfile

    from ray_tpu_torch.rl.learner import _named_leaves
    from ray_tpu_torch.rl.offline import collect_experiences
    out, init_same = {}, {}
    with tempfile.TemporaryDirectory() as path, _tf32_off():
        collect_experiences("CartPole-v1", path, num_steps=256, seed=0)
        cpu, card = _small_learners("cpu", path), _small_learners(None, path)
        for name in cpu:
            _, cpu_state, _, cpu_update = cpu[name]
            _, card_state, card_set, card_update = card[name]
            # one seed, the same initial weights on the card and the host
            want, got = (_named_leaves(cpu_state()),
                         _named_leaves(card_state()))
            init_same[name] = sorted(want) == sorted(got) and all(
                np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
                for k, v in want.items())
            card_set(cpu_state())
            batch = _small_batch(name, np.random.default_rng(21))
            cpu_update(batch)
            card_update(batch)
            want, got = (_named_leaves(cpu_state()),
                         _named_leaves(card_state()))
            check(sorted(want) == sorted(got), f"{name}: the trees differ")
            out[name] = max(float(np.max(np.abs(np.asarray(got[k])
                                                - np.asarray(v))))
                            for k, v in want.items())
    print("[reference] small f32 learners card vs CPU after one update, "
          "largest parameter difference: " + ", ".join(
              f"{k} {v:.3e}" for k, v in out.items())
          + f" (tol {RL_TOL_F32}); initial weights bitwise equal: "
          + ", ".join(f"{k} {v}" for k, v in init_same.items()), flush=True)
    check(all(init_same.values()),
          f"small RL learners: seeded initial weights differ between the "
          f"card and the CPU: {init_same}")
    check(max(out.values()) <= RL_TOL_F32,
          "small RL learners: card disagrees with the CPU")
    return out


# ---------------------------------------------------------------------------
# phase 22: the rest of RL (multi-agent collection, QMIX, MADDPG, ES, the
# bandits)
# ---------------------------------------------------------------------------

# The JAX package's gates, each at its test's settings and seed:
# tests/test_rl_breadth.py:29 (QMIX above 6.0 after 14 iterations), :81
# (MADDPG above -5.5 after 12, the greedy median error below 0.3), :64 (ES
# above max(40, first + 10) after 12 more), :107 (the bandits' regret
# halves over 8 more iterations and ends below 0.1), and
# tests/test_rl_connectors_multiagent.py:88 (the shared policy's mean
# reward above 0.9 within 40 iterations of 64 steps).
QMIX_GATE, QMIX_ITERS = 6.0, 14
MADDPG_GATE, MADDPG_ITERS, MADDPG_ERR = -5.5, 12, 0.3
ES_ITERS = 12
COOP_GATE, COOP_ITERS = 0.9, 40
BANDIT_ITERS, BANDIT_REGRET = 8, 0.1


def _fixed_run(algo, iters, gate, tag):
    """train() ``iters`` times, as the JAX test does; the last mean reward
    must clear ``gate`` -> the results, the rewards, the first iteration
    above the gate and the best reward."""
    results = [algo.train() for _ in range(iters)]
    values = [float(r["episode_reward_mean"]) for r in results]
    above = [i + 1 for i, v in enumerate(values) if v > gate]
    check(values[-1] > gate,
          f"[{tag}] mean reward {values[-1]} after {iters} iterations, "
          f"gate {gate}: {[round(v, 3) for v in values]}")
    return results, values, above[0], max(values)


def _joint_update_ms(algo, step):
    """The median update ms (windows of 20, ending in a synchronize) on
    minibatches of the algorithm's own joint buffer."""
    rng = np.random.default_rng(22)
    n = algo.config.train_batch_size
    return _update_window(step, lambda: algo.sample_batch(
        rng.integers(0, len(algo._buf), n)))


def phase_rest_of_rl(card):
    """QMIX, MADDPG and ES through their entry points with ``device`` left
    at ``None`` (ES's workers are runtime actors), the shared-policy
    collector with a torch Adam, all on the card, and the bandits on the
    host; each at its JAX test's settings and seed."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.rl import make_module
    from ray_tpu_torch.rl import sample_batch as sb
    from ray_tpu_torch.rl.algorithms import (Bandit, BanditConfig,
                                             ContextualBanditEnv,
                                             CoopSpreadEnv, ESConfig,
                                             MADDPGConfig, QMIXConfig)
    from ray_tpu_torch.rl.learner import _named_leaves
    from ray_tpu_torch.rl.multi_agent import (MultiAgentCollector,
                                              TwoStepCoopEnv)
    from ray_tpu_torch.rl.rollout import place_params
    out = {}
    rt.init(local_mode=True)
    _reset_launch_counts()
    try:
        # QMIX at tests/test_rl_breadth.py:29's settings
        config = QMIXConfig().debugging(seed=1)
        config.env_fn = lambda: TwoStepCoopEnv(horizon=8)
        config.epsilon_decay_steps = 1500
        algo = config.build()
        results, rewards, at, best = _fixed_run(algo, QMIX_ITERS, QMIX_GATE,
                                                "qmix")
        device = str(algo.params["q"][0]["w"].device)
        check(device.startswith("cuda") and
              np.isfinite(results[-1]["info/td_loss"]),
              f"[qmix] on {device}, td loss {results[-1]['info/td_loss']}")
        secs = sum(r["time_this_iter_s"] for r in results)
        restored = _bitwise_restore(algo, config, lambda a: a.get_state(),
                                    "qmix")
        out["qmix"] = dict(
            iterations=QMIX_ITERS, gate_first_met_at=at, best_reward=best,
            last_reward=rewards[-1], rewards=[round(r, 3) for r in rewards],
            env_steps=algo._timesteps_total,
            env_steps_per_s=algo._timesteps_total / secs,
            updates=QMIX_ITERS * config.updates_per_iter,
            update_ms=_joint_update_ms(algo, algo.td_step), device=device,
            restored_leaves=restored)
        print(f"[qmix] TwoStepCoopEnv(horizon=8), seed 1: {rewards[-1]:.2f} "
              f"after {QMIX_ITERS} iterations (gate {QMIX_GATE}, first above "
              f"it at iteration {at}, best {best:.2f}); "
              f"{algo._timesteps_total} env steps, "
              f"{out['qmix']['env_steps_per_s']:.1f} env steps/s; median TD "
              f"step {out['qmix']['update_ms']:.3f} ms (windows of 20); "
              f"rewards {out['qmix']['rewards']} on {card}", flush=True)
        # MADDPG at :81's settings
        config = MADDPGConfig().debugging(seed=2)
        config.env_fn = lambda: CoopSpreadEnv(horizon=10)
        algo = config.build()
        results, rewards, at, best = _fixed_run(
            algo, MADDPG_ITERS, MADDPG_GATE, "maddpg")
        errs, env = [], CoopSpreadEnv(horizon=10, seed=77)
        for _ in range(5):
            a = algo._act(algo.params["actors"],
                          algo._stack_obs(env.reset())).ravel()
            errs.append(max(abs(a[0] - env.target), abs(a[1] - env.target)))
        err = float(np.median(errs))
        check(err < MADDPG_ERR, f"[maddpg] greedy median error {err} "
                                f"(gate {MADDPG_ERR}): {errs}")
        device = str(algo.params["actors"][0][0]["w"].device)
        check(device.startswith("cuda"), f"[maddpg] on {device}")
        secs = sum(r["time_this_iter_s"] for r in results)
        restored = _bitwise_restore(algo, config, lambda a: a.get_state(),
                                    "maddpg")
        out["maddpg"] = dict(
            iterations=MADDPG_ITERS, gate_first_met_at=at, best_reward=best,
            last_reward=rewards[-1], rewards=[round(r, 3) for r in rewards],
            greedy_median_error=err, env_steps=algo._timesteps_total,
            env_steps_per_s=algo._timesteps_total / secs,
            updates=MADDPG_ITERS * config.updates_per_iter,
            update_ms=_joint_update_ms(
                algo, lambda b: algo.update(b, 1.0)),
            device=device, restored_leaves=restored)
        print(f"[maddpg] CoopSpreadEnv(horizon=10), seed 2: {rewards[-1]:.3f}"
              f" after {MADDPG_ITERS} iterations (gate {MADDPG_GATE}, first "
              f"above it at iteration {at}, best {best:.3f}); greedy median "
              f"error {err:.4f} (gate {MADDPG_ERR}); "
              f"{out['maddpg']['env_steps_per_s']:.1f} env steps/s; median "
              f"update {out['maddpg']['update_ms']:.3f} ms (windows of 20); "
              f"rewards {out['maddpg']['rewards']} on {card}", flush=True)
        # ES at :64's settings: 2 workers, 12 perturbations, horizon 200
        config = (ESConfig().environment("CartPole-v1")
                  .rollouts(num_rollout_workers=2).debugging(seed=3))
        config.num_perturbations, config.episode_horizon = 12, 200
        algo = config.build()
        first = algo.train()
        gate = max(40.0, first["episode_reward_mean"] + 10.0)
        results, rewards, at, best = _fixed_run(algo, ES_ITERS, gate, "es")
        results = [first] + results
        secs = sum(r["time_this_iter_s"] for r in results)
        episodes = 2 * config.num_perturbations * len(results)
        restored = _bitwise_restore(algo, config, lambda a: a.get_state(),
                                    "es")
        actors = rt.core.api._runtime._actors
        device = ", ".join(sorted({str(actors[w.actor_id].instance.device)
                                   for w in algo.workers}))
        check(device.startswith("cuda") and "cpu" not in device,
              f"[es] workers on {device}")
        algo.stop()
        out["es"] = dict(
            iterations=len(results), first_reward=first[
                "episode_reward_mean"], gate=gate, gate_first_met_at=at + 1,
            best_reward=best, last_reward=rewards[-1],
            rewards=[round(r["episode_reward_mean"], 2) for r in results],
            episodes=episodes, episodes_per_s=episodes / secs,
            device=device, restored_leaves=restored)
        print(f"[es] CartPole, 2 workers x 12 perturbations, horizon 200, "
              f"seed 3: first {first['episode_reward_mean']:.2f}, "
              f"{rewards[-1]:.2f} after {ES_ITERS} more (gate {gate:.2f}, "
              f"first above it at iteration {at + 1}, best {best:.2f}); "
              f"{episodes} episodes in {secs:.2f} s = "
              f"{out['es']['episodes_per_s']:.2f} episodes/s; rewards "
              f"{out['es']['rewards']} on {card}", flush=True)
        # the shared policy learning to coordinate (tests/
        # test_rl_connectors_multiagent.py:88), a torch Adam at lr 3e-3
        module = make_module({"obs_dim": 2, "num_actions": 2,
                              "hiddens": (32,)})
        dev = resolve_device(None)
        params = place_params(module.init(torch.Generator().manual_seed(0),
                                          "cpu"), module, dev)
        leaves = list(_named_leaves(params).values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=3e-3)
        col = MultiAgentCollector(TwoStepCoopEnv(horizon=8),
                                  {"shared": module}, {"shared": params},
                                  seed=0)
        check(col.generator.device.type == "cuda",
              f"[coop] the collector draws on {col.generator.device}")
        means, collect_s = [], 0.0
        t0 = time.perf_counter()
        for _ in range(COOP_ITERS):
            c0 = time.perf_counter()
            b = col.collect(64)["shared"]
            collect_s += time.perf_counter() - c0
            logp, entropy, _ = module.logp_entropy(params, b[sb.OBS],
                                                   b[sb.ACTIONS])
            rew = torch.as_tensor(b[sb.REWARDS], device=dev)
            loss = -(logp * (rew - rew.mean())).mean() \
                - 0.01 * entropy.mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            col.set_params({"shared": params})
            means.append(float(np.mean(b[sb.REWARDS])))
            if means[-1] > COOP_GATE:
                break
        wall = time.perf_counter() - t0
        check(means[-1] > COOP_GATE,
              f"[coop] agents never coordinated: {[round(m, 3) for m in means]}")
        steps = 64 * len(means)
        out["coop"] = dict(
            iterations=len(means), gate_first_met_at=len(means),
            best_reward=max(means), rewards=[round(m, 3) for m in means],
            env_steps=steps, env_steps_per_s=steps / wall,
            collect_env_steps_per_s=steps / collect_s,
            device=str(col.params["shared"]["pi"][0]["w"].device))
        print(f"[coop] MultiAgentCollector, shared policy (32,), torch Adam "
              f"3e-3: mean reward {means[-1]:.3f} > {COOP_GATE} at iteration "
              f"{len(means)} of {COOP_ITERS}; {steps} env steps at "
              f"{out['coop']['env_steps_per_s']:.1f} env steps/s "
              f"({out['coop']['collect_env_steps_per_s']:.1f} collecting "
              f"alone) on {card}", flush=True)
    finally:
        rt.shutdown()
    alive = _runtime_threads()
    check(not alive, f"[rest of RL] runtime threads alive after shutdown: "
                     f"{alive}")
    # the bandits on the host (numpy; the JAX package's too): no device
    for exploration in ("ucb", "ts"):
        config = BanditConfig()
        config.exploration = exploration
        config.env_fn = lambda: ContextualBanditEnv(
            num_arms=4, context_dim=8, noise=0.05, seed=4)
        algo = Bandit(config.debugging(seed=4))
        results = [algo.train() for _ in range(BANDIT_ITERS + 1)]
        regret = [r["info/regret_per_step"] for r in results]
        check(regret[-1] < 0.5 * regret[0] and regret[-1] < BANDIT_REGRET,
              f"[bandit-{exploration}] regret per step {regret}")
        secs = sum(r["time_this_iter_s"] for r in results)
        steps = algo._timesteps_total
        out[f"bandit_{exploration}"] = dict(
            iterations=len(results), regret_per_step=regret,
            steps=steps, steps_per_s=steps / secs, device="host")
        print(f"[bandit-{exploration}] regret per step {regret[0]:.4f} -> "
              f"{regret[-1]:.4f} over {len(results)} iterations (gate: "
              f"halved and < {BANDIT_REGRET}); {steps / secs:.1f} steps/s on "
              f"the host", flush=True)
    launches = _launch_counts()
    check(launches == (0, 0, 0, 0),
          f"[rest of RL] launched flash kernels {launches}")
    for k in out:
        out[k]["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 23: the parallel layer on one rank
# ---------------------------------------------------------------------------

# Ring and Ulysses attention against attention_reference in f32 on the same
# inputs. f32 inputs (TF32 off): the order of the f32 sums only. bf16
# inputs: both round Q K^T to bf16 before the scale (a logit of |q.k| ~ 68,
# 6 sigma at D 128, is off by up to 0.25 * 128^-0.5 = 0.022), P to bf16
# before the PV product and O to bf16 (values up to ~4): 2% of a value
# near 4 is 0.08.
SP_ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-1}
# pipeline_apply at pp = 1 against _stage_apply: the same kernels on the
# same shapes, so bitwise is expected; the bound is the bf16 one of a few
# ulps of activations near 4.
PIPE_TOL = 2e-2
# The flagship step on a one-rank mesh against the one-device step from the
# same weights and batch: the same products, but for the embedding lookup's
# backward (F.embedding's sums in another order than indexing's), so the
# losses differ by bf16 rounding, well under 2e-3; attn_impl
# "ring" at n = 1 runs _block_step's one block in place of the flash
# kernel, both at bf16 (2e-3 of a loss near ln 32768).
MESH_LOSS_TOL = 2e-3
# The PPO learner (f32, TF32 off) with a one-rank mesh against none.
MESH_PPO_TOL = 1e-5
# ResNet-50's new batch statistics after 3 steps with a one-rank mesh
# against mesh=None, as a share of each leaf's largest magnitude: the mesh
# path's BatchNorm takes flax's E[x²] − E[x]² from all-reduced sums where
# F.batch_norm takes its own variance, so the statistics differ by f32
# rounding at the first step, and by what the bf16 steps make of that
# after. Its losses are held to MESH_LOSS_TOL, as the flagship's.
MESH_STATS_TOL = 1e-2


def _collectives_at_one_rank(mesh):
    """Every function of parallel/collectives.py on every axis (and a tuple
    of two) returns its input bitwise at n = 1."""
    from ray_tpu_torch.parallel import collectives as c
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    x = torch.randn(64, 48, device="cuda")
    checked = 0
    with c.axis_env(mesh):
        for axis in list(AXIS_ORDER) + [("dp", "fsdp")]:
            outs = {"allreduce_sum": c.allreduce_sum(x, axis),
                    "allreduce_mean": c.allreduce_mean(x, axis),
                    "allreduce_max": c.allreduce_max(x, axis),
                    "allreduce_min": c.allreduce_min(x, axis),
                    "allgather": c.allgather(x, axis, concat_dim=1),
                    "allgather_untiled": c.allgather(x, axis,
                                                     tiled=False)[0],
                    "reducescatter": c.reducescatter(x, axis),
                    "alltoall": c.alltoall(x, axis, split_dim=0,
                                           concat_dim=1)}
            if isinstance(axis, str):
                outs["ring_permute"] = c.ring_permute(x, axis)
                outs["broadcast_from"] = c.broadcast_from(x, axis)
            torch.cuda.synchronize()
            for name, out in outs.items():
                check(torch.equal(out, x), f"{name} over {axis} at one rank "
                      "is not the identity")
                checked += 1
            check(c.axis_index(axis) == 0 and c.axis_size(axis) == 1,
                  f"axis {axis}: index {c.axis_index(axis)}, size "
                  f"{c.axis_size(axis)}")
    check(c.broadcast_rounds(4) == [[(0, 1), (0, 2)], [(0, 3)]],
          "broadcast_rounds")
    return checked


def _sp_attention(card, mesh):
    """Ring and Ulysses attention at the flagship's attention shape against
    attention_reference in f32, and their milliseconds beside the flash
    kernel's (CUDA events)."""
    from ray_tpu_torch.ops import (attention_reference, flash_attention,
                                   ring_attention, ulysses_attention)
    gen = torch.Generator(device="cuda").manual_seed(23)
    q32, k32, v32 = (torch.randn(8, 2048, 16, 128, generator=gen,
                                 device="cuda") for _ in range(3))
    want = attention_reference(q32, k32, v32, causal=True)
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        errs = {}
        for dt, args in ((torch.float32, (q32, k32, v32)),
                         (torch.bfloat16, (q, k, v))):
            _reset_launch_counts()
            got = fn(*args, mesh, causal=True).full_tensor()
            torch.cuda.synchronize()
            launches = _launch_counts()
            check(got.dtype == dt and got.shape == q.shape,
                  f"{name}: {got.dtype} {tuple(got.shape)}")
            errs[dt] = (got.float() - want).abs().max().item()
            check(errs[dt] <= SP_ATTN_TOL[dt],
                  f"{name} attention at n = 1, {dt}: max abs err "
                  f"{errs[dt]} against attention_reference in f32, tol "
                  f"{SP_ATTN_TOL[dt]}")
            del got
        ms = cuda_ms(lambda: fn(q, k, v, mesh, causal=True), iters=5,
                     warmup=1)
        out[name] = dict(max_abs_err=errs[torch.bfloat16],
                         max_abs_err_f32=errs[torch.float32], ms=ms,
                         launches=launches)
    out["flash_ms"] = cuda_ms(lambda: flash_attention(q, k, v, causal=True),
                              iters=5, warmup=1)
    out["reference_ms"] = cuda_ms(lambda: attention_reference(
        q, k, v, causal=True), iters=5, warmup=1)
    print(f"[mesh] attention B 8, S 2048, 16 heads of 128, causal, n = 1, "
          f"max abs err against attention_reference in f32: ring f32 "
          f"{out['ring']['max_abs_err_f32']:.3e}, bf16 "
          f"{out['ring']['max_abs_err']:.3e}; ulysses f32 "
          f"{out['ulysses']['max_abs_err_f32']:.3e}, bf16 "
          f"{out['ulysses']['max_abs_err']:.3e} (tol f32 "
          f"{SP_ATTN_TOL[torch.float32]}, bf16 "
          f"{SP_ATTN_TOL[torch.bfloat16]}); bf16 ms (CUDA events): ring "
          f"{out['ring']['ms']:.3f}, ulysses {out['ulysses']['ms']:.3f}, "
          f"the flash kernel {out['flash_ms']:.3f}, attention_reference "
          f"{out['reference_ms']:.3f}; flash launches ring "
          f"{out['ring']['launches']}, ulysses {out['ulysses']['launches']} "
          f"on {card}", flush=True)
    del q, k, v, q32, k32, v32, want
    torch.cuda.empty_cache()
    return out


def _pipeline_at_one_rank(mesh):
    """pipeline_apply at pp = 1 over 2 microbatches of a flagship-width
    stack of 2 layers (bf16) against _stage_apply on each microbatch."""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.ops.pipeline import pipeline_apply
    cfg = dataclasses.replace(flagship_cfg(remat=False), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(24)
    params = tf.transformer_init(gen, cfg)
    stage = tf._map_tree(params["layers"], lambda a: a[None])   # [1, L, ...]
    x = (torch.randn(2, 2, 2048, cfg.d_model, generator=gen, device="cuda")
         .to(cfg.dtype))
    pos = torch.arange(2048, device="cuda")[None]

    def stage_fn(layers, act):
        return tf._stage_apply(cfg, tf._unstack(layers), act, pos)

    with torch.no_grad():
        _reset_launch_counts()
        got = pipeline_apply(stage_fn, stage, x, mesh,
                             num_microbatches=2).full_tensor()
        torch.cuda.synchronize()
        launches = _launch_counts()
        want = torch.stack([tf._stage_apply(cfg, tf.unstack_layers(params),
                                            x[i], pos) for i in range(2)])
    err = (got.float() - want.float()).abs().max().item()
    check(err <= PIPE_TOL, f"pipeline_apply at pp = 1: max abs err {err} "
          f"against _stage_apply, tol {PIPE_TOL}")
    print(f"[mesh] pipeline_apply at pp = 1, 2 microbatches of [2, 2048, "
          f"2048] through 2 flagship layers (bf16): max abs err {err:.3e} "
          f"against _stage_apply (bitwise: {err == 0.0}); flash launches "
          f"{launches} (the stage's attention: 2 layers x 2 microbatches)",
          flush=True)
    return dict(max_abs_err=err, launches=launches)


def _mesh_steps(cfg, mesh, tokens, seed, steps=3, timed=3):
    """``steps`` counted steps and ``timed`` timed ones of
    ``make_lm_train_step(cfg, mesh)`` from a seeded init -> (losses,
    launches a step, step ms)."""
    from ray_tpu_torch.train import make_lm_train_step
    init_fn, step_fn, place = make_lm_train_step(cfg, mesh)
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    data = place({"tokens": tokens})
    losses, per_step = [], []
    for _ in range(steps):
        _reset_launch_counts()
        state, metrics = step_fn(state, data)
        losses.append(metrics["loss"].item())
        per_step.append(_launch_counts())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step_fn(state, data)
    metrics["loss"].item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    del state, data
    torch.cuda.empty_cache()
    return losses, per_step, step_ms


def _first_grad_diffs(cfg, mesh, tokens, seed):
    """The first step's gradient of every leaf with a one-rank mesh against
    mesh=None, from the same seeded init -> {leaf: max abs difference}.
    (The mesh path looks the embedding up with F.embedding, the plain path
    by indexing: their backwards sum the table's rows in another order.)"""
    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel.sharding import shard_pytree
    tokens = torch.as_tensor(tokens, device="cuda")
    grads = []
    for m in (None, mesh):
        params = tf.transformer_init(
            torch.Generator(device="cuda").manual_seed(seed), cfg)
        if m is not None:
            params = shard_pytree(params, m, tf.transformer_logical_axes(cfg))
        named = dict(_named_leaves(params))
        for t in named.values():
            t.requires_grad_(True)
        loss = tf.transformer_loss(params, {"tokens": tokens}, cfg, mesh=m)
        got = torch.autograd.grad(loss, list(named.values()))
        grads.append({k: g.full_tensor() if m is not None else g
                      for k, g in zip(named, got)})
        del params, named, loss, got
    diffs = {k: (grads[1][k] - g).abs().max().item()
             for k, g in grads[0].items()}
    del grads
    torch.cuda.empty_cache()
    return diffs


def phase_parallel(card):
    """Phase 23: the mesh (a one-rank NCCL group), the collectives, ring and
    Ulysses attention, the pipeline, the flagship train step, the PPO
    learner and the ViT and ResNet-50 train steps on a one-rank mesh.
    Destroys its process group."""
    import torch.distributed as dist

    from ray_tpu_torch.models import transformer as tf
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER
    check(not dist.is_initialized(), "a process group exists before phase 23")
    mesh = build_mesh(MeshSpec())
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"backend {dist.get_backend()}, world {dist.get_world_size()}")
        check(mesh.device_type == "cuda"
              and tuple(mesh.mesh_dim_names) == AXIS_ORDER,
              f"mesh on {mesh.device_type} with {mesh.mesh_dim_names}")
        checked = _collectives_at_one_rank(mesh)
        print(f"[mesh] one-rank NCCL mesh {tuple(mesh.mesh_dim_names)} "
              f"shape {tuple(mesh.mesh.shape)}; {checked} collective calls "
              f"over the 7 axes and (dp, fsdp) returned their input "
              f"bitwise", flush=True)
        out = {"collectives_checked": checked,
               "attention": _sp_attention(card, mesh),
               "pipeline": _pipeline_at_one_rank(mesh)}
        cfg = flagship_cfg(remat=True)
        tokens = np.random.default_rng(23).integers(0, cfg.vocab_size,
                                                    (8, cfg.max_seq))
        plain = _mesh_steps(cfg, None, tokens, 23)
        meshed = _mesh_steps(cfg, mesh, tokens, 23)
        L = cfg.n_layers
        want_n = (2 * L, L, L, L)
        check(all(n == want_n for n in meshed[1]),
              f"mesh steps launched {meshed[1]}, want {want_n} a step")
        diffs = [abs(a - b) for a, b in zip(plain[0], meshed[0])]
        check(max(diffs) <= MESH_LOSS_TOL and all(np.isfinite(meshed[0])),
              f"mesh losses {meshed[0]} against {plain[0]}, tol "
              f"{MESH_LOSS_TOL}")
        ratio = meshed[2] / plain[2]
        print(f"[mesh] flagship train step B 8 x 2048 (remat, tied, AdamW, "
              f"bf16): losses mesh=None {[round(x, 5) for x in plain[0]]}, "
              f"one-rank mesh {[round(x, 5) for x in meshed[0]]} (max diff "
              f"{max(diffs):.3e}, tol {MESH_LOSS_TOL}); launches a step "
              f"(fwd, dkv, dq, delta) {meshed[1][0]}; step ms mesh=None "
              f"{plain[2]:.1f}, mesh {meshed[2]:.1f}, ratio {ratio:.4f} "
              f"(DTensor's cost at one rank) on {card}", flush=True)
        gdiff = _first_grad_diffs(cfg, mesh, tokens, 23)
        print(f"[mesh] the first step's gradients, one-rank mesh against "
              f"mesh=None, max abs diff by leaf: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in gdiff.items()), flush=True)
        ring_cfg = dataclasses.replace(cfg, attn_impl="ring")
        params = tf.transformer_init(
            torch.Generator(device="cuda").manual_seed(23), cfg)
        with torch.no_grad():
            _reset_launch_counts()
            ring = tf.transformer_loss(params, {"tokens": tokens}, ring_cfg,
                                       mesh=mesh).full_tensor().item()
            ring_launches = _launch_counts()
            flash = tf.transformer_loss(params, {"tokens": tokens}, cfg,
                                        mesh=mesh).full_tensor().item()
        del params
        torch.cuda.empty_cache()
        check(abs(ring - flash) <= MESH_LOSS_TOL,
              f"ring loss {ring} against the flash loss {flash}")
        print(f"[mesh] loss at the first step's weights, attn_impl ring at "
              f"n = 1 {ring:.6f} against flash {flash:.6f} (diff "
              f"{abs(ring - flash):.3e}, tol {MESH_LOSS_TOL}); ring's flash "
              f"launches {ring_launches}", flush=True)
        out.update(train=dict(losses_plain=plain[0], losses_mesh=meshed[0],
                              launches_per_step=meshed[1][0],
                              launches=tuple(sum(n[i] for n in meshed[1])
                                             for i in range(4)),
                              step_ms_plain=plain[2], step_ms_mesh=meshed[2],
                              ratio=ratio, ring_loss=ring, flash_loss=flash,
                              ring_launches=ring_launches,
                              first_grad_diffs=gdiff))
        out["ppo"] = _ppo_on_mesh(card, mesh)
        out.update(_vision_on_mesh(card, mesh))
        print("[mesh] expert parallelism (the ep axis) is not run here: "
              "NCCL takes one rank a card, and ep 1 shards nothing; the ep "
              "path is held to the JAX package on 4 gloo ranks "
              "(tests/test_torch_mesh_steps.py)", flush=True)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "phase 23 left its process group")
    return out


def _vision_steps(make_step, seed, data, steps=3, timed=3):
    """``steps`` counted steps and ``timed`` timed ones of a vision train
    step ``(init_fn, step_fn, place)`` from a seeded init -> (losses,
    launches a step, step ms, the batch statistics after the counted steps
    or None)."""
    from ray_tpu_torch.train.step import _leaves
    init_fn, step_fn, place = make_step
    state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    batch = place(data)
    losses, per_step = [], []
    for _ in range(steps):
        _reset_launch_counts()
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
        per_step.append(_launch_counts())
    stats = None
    if "batch_stats" in state.params:
        stats = [(t.full_tensor() if hasattr(t, "full_tensor") else t)
                 .clone() for t in _leaves(state.params["batch_stats"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, metrics = step_fn(state, batch)
    metrics["loss"].item()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    del state, batch
    torch.cuda.empty_cache()
    return losses, per_step, step_ms, stats


def _vision_on_mesh(card, mesh):
    """The ViT (``ViTConfig()``, batch 128, phase 9's settings) and
    ResNet-50 (batch 256 at 224², phase 11's) train steps with the one-rank
    mesh against mesh=None, from the same weights and batch."""
    from ray_tpu_torch.models import ViTConfig
    from ray_tpu_torch.train import make_resnet_train_step, make_vit_train_step
    t0 = time.perf_counter()
    out = {}
    cfg = ViTConfig()
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = {"image": torch.randn(128, cfg.image_size, cfg.image_size, 3,
                                 generator=gen, device="cuda"),
            "label": torch.randint(0, cfg.num_classes, (128,),
                                   generator=gen, device="cuda")}
    plain, meshed = (_vision_steps(make_vit_train_step(cfg, m), 12, data)
                     for m in (None, mesh))
    del data
    L = cfg.n_layers
    want_n = (2 * L, L, L, L)
    check(all(n == want_n for n in plain[1] + meshed[1]),
          f"ViT steps launched {plain[1]} (mesh=None), {meshed[1]} (mesh), "
          f"want {want_n} a step")
    diffs = [abs(a - b) for a, b in zip(plain[0], meshed[0])]
    check(max(diffs) <= MESH_LOSS_TOL and all(np.isfinite(meshed[0])),
          f"ViT mesh losses {meshed[0]} against {plain[0]}, tol "
          f"{MESH_LOSS_TOL}")
    print(f"[mesh] ViT train step (ViTConfig(), B 128 at 224², remat, "
          f"AdamW, bf16): losses mesh=None {[round(x, 5) for x in plain[0]]}, "
          f"one-rank mesh {[round(x, 5) for x in meshed[0]]} (max diff "
          f"{max(diffs):.3e}, tol {MESH_LOSS_TOL}); launches a step (fwd, "
          f"dkv, dq, delta) {meshed[1][0]}; step ms mesh=None "
          f"{plain[2]:.1f}, mesh {meshed[2]:.1f}, ratio "
          f"{meshed[2] / plain[2]:.4f} on {card}", flush=True)
    out["vit"] = dict(losses_plain=plain[0], losses_mesh=meshed[0],
                      launches_per_step=meshed[1][0],
                      launches=tuple(sum(n[i] for n in meshed[1])
                                     for i in range(4)),
                      step_ms_plain=plain[2], step_ms_mesh=meshed[2],
                      ratio=meshed[2] / plain[2])
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True     # phase 11's setting
    try:
        rng = np.random.default_rng(0)       # phase 11's data
        host = {"image": rng.normal(size=(256, 224, 224, 3))
                .astype(np.float32),
                "label": rng.integers(0, 1000, (256,))}
        plain, meshed = (_vision_steps(make_resnet_train_step(
            m, num_classes=1000, image_size=224, learning_rate=0.1), 0, host)
            for m in (None, mesh))
        del host
    finally:
        torch.backends.cudnn.benchmark = prior
    check(all(n == (0, 0, 0, 0) for n in plain[1] + meshed[1]),
          f"ResNet steps launched flash kernels {plain[1]}, {meshed[1]}")
    diffs = [abs(a - b) for a, b in zip(plain[0], meshed[0])]
    stats_err = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(meshed[3], plain[3]))
    check(max(diffs) <= MESH_LOSS_TOL and all(np.isfinite(meshed[0])),
          f"ResNet mesh losses {meshed[0]} against {plain[0]}, tol "
          f"{MESH_LOSS_TOL}")
    check(stats_err <= MESH_STATS_TOL,
          f"ResNet mesh batch statistics {stats_err} of their magnitude "
          f"from mesh=None's, tol {MESH_STATS_TOL}")
    print(f"[mesh] ResNet-50 train step (B 256 at 224², SGD Nesterov, bf16 "
          f"channels_last, global BatchNorm): losses mesh=None "
          f"{[round(x, 5) for x in plain[0]]}, one-rank mesh "
          f"{[round(x, 5) for x in meshed[0]]} (max diff {max(diffs):.3e}, "
          f"tol {MESH_LOSS_TOL}); new batch_stats max diff {stats_err:.3e} "
          f"of each leaf's magnitude (tol {MESH_STATS_TOL}); flash launches "
          f"{meshed[1][0]} a step; step ms mesh=None {plain[2]:.1f}, mesh "
          f"{meshed[2]:.1f}, ratio {meshed[2] / plain[2]:.4f} on {card}",
          flush=True)
    out["resnet"] = dict(losses_plain=plain[0], losses_mesh=meshed[0],
                         stats_err=stats_err, launches=(0, 0, 0, 0),
                         step_ms_plain=plain[2], step_ms_mesh=meshed[2],
                         ratio=meshed[2] / plain[2])
    print(f"[mesh] vision steps: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def _ppo_on_mesh(card, mesh):
    """One PPOLearner.update with a one-rank mesh against mesh=None (f32)."""
    from ray_tpu_torch.rl import PPOLearner, SampleBatch
    from ray_tpu_torch.rl import sample_batch as sb
    spec = {"obs_dim": 4, "num_actions": 2, "hiddens": (64, 64)}
    rng = np.random.default_rng(25)
    f32 = lambda x: np.asarray(x, np.float32)
    batch = SampleBatch({
        sb.OBS: f32(rng.standard_normal((2048, 4))),
        sb.ACTIONS: f32(rng.integers(0, 2, 2048)),
        sb.ACTION_LOGP: f32(np.log(0.5) + 0.3 * rng.standard_normal(2048)),
        sb.ADVANTAGES: f32(rng.standard_normal(2048)),
        sb.VF_PREDS: f32(rng.standard_normal(2048)),
        sb.VALUE_TARGETS: f32(rng.standard_normal(2048)),
    })
    results = []
    for m in (None, mesh):
        learner = PPOLearner(spec, mesh=m, num_sgd_iter=8,
                             sgd_minibatch_size=256, seed=0)
        _reset_launch_counts()
        t0 = time.perf_counter()
        stats = learner.update(batch)
        ms = (time.perf_counter() - t0) * 1e3
        results.append((stats, learner.get_weights(), ms, _launch_counts()))
    (s0, w0, ms0, _), (s1, w1, ms1, n1) = results
    leaf = lambda t: ([x for v in (t.values() if isinstance(t, dict) else t)
                       for x in leaf(v)] if isinstance(t, (dict, list, tuple))
                      else [t])
    err = max(float(np.max(np.abs(a - b))) for a, b in zip(leaf(w0),
                                                           leaf(w1)))
    stat_err = max(abs(s0[k] - s1[k]) for k in s0)
    check(err <= MESH_PPO_TOL and stat_err <= MESH_PPO_TOL * max(
        1.0, max(abs(v) for v in s0.values())) and n1 == (0, 0, 0, 0),
        f"PPO with a one-rank mesh: weights err {err}, stats err "
        f"{stat_err}, flash launches {n1}")
    print(f"[mesh] PPOLearner.update (2,048 rows, 8 epochs of 256, f32) with "
          f"a one-rank mesh against none: weights max err {err:.3e}, stats "
          f"max err {stat_err:.3e} (tol {MESH_PPO_TOL}); update ms "
          f"mesh=None {ms0:.1f}, mesh {ms1:.1f} on {card}", flush=True)
    return dict(weights_err=err, stats_err=stat_err, ms_plain=ms0,
                ms_mesh=ms1, launches=n1)


# ---------------------------------------------------------------------------
# phase 24: serve over HTTP
# ---------------------------------------------------------------------------

HTTP_CLIENTS = 8
HTTP_ROUNDS = 2          # one warm round, then the timed one (cut from
                         # 5, then 3: PERF.md §6)
HTTP_BATCH_WAIT_S = 0.1  # the @serve.batch window
# greedy tokens a request, cut from the serve cell's 256 (phases 24 and
# 30): each is a host-bound decode loop, and the whole script must stay
# well inside its time limit (PERF.md, "control-surface")
HTTP_NEW = 64


def _lm_deployment(serve, cfg, seed, new):
    """The flagship behind ``@serve.deployment``: its weights are drawn on
    the card from ``seed`` (``device=None``), and one ``@serve.batch``
    method left-pads the prompts and calls ``generate`` (one at a time on
    the card), recording each batch's prompts in the order it took them."""
    import threading

    from ray_tpu_torch.models import generate, transformer_init

    @serve.deployment(num_replicas=1, route_prefix="/generate")
    class LMServer:
        def __init__(self):
            self.params = transformer_init(
                torch.Generator(device="cuda").manual_seed(seed), cfg)
            self.batches = []
            self.lock = threading.Lock()

        @serve.batch(max_batch_size=HTTP_CLIENTS,
                     batch_wait_timeout_s=HTTP_BATCH_WAIT_S)
        def generate_batch(self, prompts):
            width = max(len(p) for p in prompts)
            arr = np.zeros((len(prompts), width), np.int64)
            for i, p in enumerate(prompts):
                arr[i, width - len(p):] = p
            with self.lock:
                self.batches.append(arr)
                return generate(self.params, torch.from_numpy(arr), cfg,
                                max_new_tokens=new).tolist()

        def __call__(self, prompt=None):
            return {"tokens": self.generate_batch(prompt)}

        def recorded(self):
            return self.batches, self.params

    return LMServer


def _post_json(url, payload, timeout=120):
    """(status, json body or None, seconds) of one POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body = r.code, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, None
    return code, body, time.perf_counter() - t0


def phase_http_serve(card, direct_tokens_per_s):
    """Phase 24: the flagship served over HTTP through ``serve.run``, with
    8 clients posting at once for one warm round and the timed ones
    (``HTTP_ROUNDS`` in all)."""
    import concurrent.futures

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.core import api as core_api
    from ray_tpu_torch.models import generate
    from ray_tpu_torch.serve import http_proxy
    from ray_tpu_torch.serve.controller import Replica
    cfg, prompt_len, new = flagship_cfg(), 128, HTTP_NEW
    prompts = np.random.default_rng(24).integers(
        0, cfg.vocab_size, (HTTP_ROUNDS, HTTP_CLIENTS, prompt_len)).tolist()
    rt.init(local_mode=True)
    try:
        handle = serve.run(_lm_deployment(serve, cfg, 24, new).bind(),
                           http_host="127.0.0.1")
        url = f"http://127.0.0.1:{handle.http_port}/generate"
        answers, latencies, timed_s = {}, [], 0.0
        _reset_launch_counts()
        with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            for r in range(HTTP_ROUNDS):
                t0 = time.perf_counter()
                out = list(pool.map(lambda p: _post_json(
                    url, {"prompt": p}), prompts[r]))
                if r:
                    timed_s += time.perf_counter() - t0
                    latencies += [sec for _, _, sec in out]
                codes = [code for code, _, _ in out]
                check(codes == [200] * HTTP_CLIENTS,
                      f"http-serve round {r}: statuses {codes}")
                answers.update({tuple(p): body["tokens"]
                                for p, (_, body, _) in zip(prompts[r], out)})
        launches = _launch_counts()
        batches, params = core_api.get(handle.options("recorded").remote(),
                                       timeout=60)
        serve.shutdown()
        live = [p for p in http_proxy._live_proxies if not p.closed]
        replicas = [st for st in core_api._runtime._actors.values()
                    if isinstance(st.instance, Replica)]
        check(not live and replicas and all(st.dead for st in replicas),
              f"after serve.shutdown(): {len(live)} proxies open, "
              f"{sum(not st.dead for st in replicas)} replicas alive")
        sizes = [len(b) for b in batches]
        check(launches == (cfg.n_layers * len(batches), 0, 0, 0),
              f"http-serve: kernels launched {launches} times (fwd, dkv, "
              f"dq, delta) for {len(batches)} generate calls, want "
              f"({cfg.n_layers * len(batches)}, 0, 0, 0)")
        seen = [tuple(row) for b in batches for row in b.tolist()]
        check(sorted(seen) == sorted(answers) and len(seen) == len(answers)
              == HTTP_ROUNDS * HTTP_CLIENTS,
              "http-serve: the batches do not hold each prompt once")
        # each answer against a direct generate of the batch it rode in
        mismatched = 0
        for b in batches:
            direct = generate(params, torch.from_numpy(b), cfg,
                              max_new_tokens=new).tolist()
            mismatched += sum(answers[tuple(row)] != want
                              for row, want in zip(b.tolist(), direct))
        check(mismatched == 0,
              f"http-serve: {mismatched} answers differ from a direct "
              f"generate of their batch")
        del params, batches
    finally:
        serve.shutdown()
        rt.shutdown()
    torch.cuda.empty_cache()
    check(not _runtime_threads(), "http-serve: runtime threads left")
    timed = (HTTP_ROUNDS - 1) * HTTP_CLIENTS
    rps = timed / timed_s
    tokens_per_s = rps * new
    p50, p99 = np.percentile(latencies, [50, 99]).tolist()
    print(f"[http-serve] flagship bf16 over HTTP (serve.run, @serve.batch "
          f"max 8, window {HTTP_BATCH_WAIT_S} s): {HTTP_CLIENTS} clients x "
          f"{HTTP_ROUNDS} rounds (1 warm), all 200; {len(sizes)} generate "
          f"calls, batch sizes {sizes}; flash launches {launches[0]} = "
          f"{cfg.n_layers} x {len(sizes)}; every answer equals a direct "
          f"generate of its batch", flush=True)
    print(f"[http-serve] timed rounds: {rps:.3f} requests/s, "
          f"{tokens_per_s:.1f} generated tokens/s, latency p50 "
          f"{p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms; phase 3's direct "
          f"generate {direct_tokens_per_s:.1f} tokens/s, ratio "
          f"{tokens_per_s / direct_tokens_per_s:.4f} on {card}", flush=True)
    return dict(launches=launches, batch_sizes=sizes,
                requests_per_s=rps, tokens_per_s=tokens_per_s,
                p50_ms=p50 * 1e3, p99_ms=p99 * 1e3,
                direct_tokens_per_s=direct_tokens_per_s,
                ratio_to_direct=tokens_per_s / direct_tokens_per_s)


# ---------------------------------------------------------------------------
# phase 25: the cluster runtime, the flagship in a GPU worker process
# ---------------------------------------------------------------------------

# 64 new tokens, cut from the serve cell's 256 (PERF.md §6): the
# phase measures a GPU worker's path, not the decode loop
CLUSTER_BATCH, CLUSTER_PROMPT, CLUSTER_NEW = 8, 128, 64
# The store holds the embedding table on its way in and its double on its
# way out, with this much room left for everything else.
STORE_SLACK = 64 << 20
STORE_MAX = 1 << 30


def _visible_card():
    """A plain task's view of the card (it leases no GPU)."""
    import os

    import torch as torch_
    return (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch_.cuda.is_available(), os.getpid())


class FlagshipWorker:
    """The flagship in a worker process that holds one GPU: phase 3's
    configuration, its weights drawn on the card from ``seed`` as the
    driver draws them."""

    def __init__(self, seed):
        import os

        from ray_tpu_torch.models import transformer_init
        self.cfg = flagship_cfg()
        self.params = transformer_init(
            torch.Generator(device="cuda").manual_seed(seed), self.cfg)
        self.env = (os.environ.get("CUDA_VISIBLE_DEVICES"),
                    torch.cuda.is_available(), torch.cuda.device_count(),
                    os.getpid())

    def card(self):
        return self.env + (torch.cuda.get_device_name(0),)

    def kernel_check(self):
        """The flash forward against its plain version in this process, at
        the serve prefill shape, bf16: (max_abs_err of O, of LSE)."""
        from ray_tpu_torch.ops import flash
        gen = torch.Generator(device="cuda").manual_seed(25)
        q, k, v = _case_inputs("serve_prefill", CASES[0][1], gen)(
            torch.bfloat16)
        out, lse = flash.flash_fwd(q, k, v, causal=True)
        pout, plse = flash.flash_fwd_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        return ((out.float() - pout.float()).abs().max().item(),
                (lse - plse).abs().max().item())

    def serve(self, prompt, new):
        """One warm-up, then the counted, timed ``generate``: (tokens,
        launches, tokens/s inside this process, prefill logits)."""
        from ray_tpu_torch.models import generate
        prompt = torch.from_numpy(np.array(prompt)).cuda()
        generate(self.params, prompt, self.cfg, max_new_tokens=4)
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        tokens = generate(self.params, prompt, self.cfg, max_new_tokens=new)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        logits = _prefill_logits(self.params, prompt, self.cfg,
                                 prompt.shape[1] + new)
        return (tokens.cpu().numpy(), launches,
                prompt.shape[0] * new / seconds,
                logits[:, -1].float().cpu().numpy())

    def double(self, boxed):
        """The array behind ``boxed[0]`` (a ref) from the store to the
        card, doubled, and back to the host: (array, seconds of the get and
        the copy to the card, seconds of the doubling and the copy back)."""
        import warnings

        import ray_tpu_torch as rt
        t0 = time.perf_counter()
        host = rt.get(boxed[0], timeout=120)
        with warnings.catch_warnings():   # a read-only view of the store,
            warnings.simplefilter("ignore")   # only read by the copy
            card = torch.from_numpy(np.asarray(host)).cuda()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = (card * 2).cpu().numpy()
        t2 = time.perf_counter()
        del host, card
        return out, t1 - t0, t2 - t1


def _shm_free():
    out = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    print("[cluster] df -B1 /dev/shm:\n" + out.rstrip(), flush=True)
    return int(out.splitlines()[-1].split()[3])


def _session_processes(marks=("ray_tpu_torch.cluster.worker_main",
                               "ray_tpu_torch.cluster.worker_zygote",
                               "shmstored")):
    """Live (not zombie) processes of the port's cluster on this host (of
    its workers, zygotes and stores unless ``marks`` names others)."""
    import os
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if state not in "ZX" and any(m in cmd for m in marks):
            found.append((int(pid), cmd[:120]))
    return found


def _compute_apps():
    """The card's compute contexts as ``nvidia-smi`` lists them, one
    ``"pid, used_memory"`` string each. In a container the pids are the
    host's, so callers compare how many there are, not which."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def phase_cluster(card, direct_tokens_per_s):
    """Phase 25: a port ``Cluster`` whose head counts the card as
    ``"GPU": 1``; a plain task that sees no card; the flagship generating
    in a ``num_gpus=1`` actor's worker process, held to the driver's direct
    ``generate``; the embedding table through the shm store and back."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.models import generate, transformer_init
    t_phase = time.perf_counter()
    cfg, batch, plen, new = (flagship_cfg(), CLUSTER_BATCH, CLUSTER_PROMPT,
                             CLUSTER_NEW)
    # the driver's own flagship, phase 3's seed and prompts
    params = transformer_init(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (batch, plen))
    embed = params["embed"].float().cpu().numpy()
    rows = embed.shape[0]
    free = _shm_free()
    store_bytes = min(STORE_MAX, int(free * 0.8))
    need = 2 * embed.nbytes + STORE_SLACK
    if store_bytes < need:
        rows = (store_bytes - STORE_SLACK) // (2 * embed.shape[1] * 4)
        check(rows >= 1024,
              f"cluster: /dev/shm has {free} bytes free; a store of "
              f"{store_bytes} bytes cannot hold the embedding table twice "
              f"({need} bytes), nor 1024 of its rows")
        embed = np.ascontiguousarray(embed[:rows])
    print(f"[cluster] /dev/shm free {free} bytes; head store "
          f"{store_bytes} bytes; embedding table through it "
          f"{embed.shape[0]} x {embed.shape[1]} f32 = {embed.nbytes} bytes"
          f"{'' if rows == cfg.vocab_size else ' (rows cut to fit /dev/shm)'}",
          flush=True)
    apps_before = _compute_apps()

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4,
                                "object_store_bytes": store_bytes})
    prefixes = [n.store_prefix for n in c.nodes]
    worker_pids = []
    try:
        rt.init(address=c.address)
        try:
            res = rt.cluster_resources()
            print(f"[cluster] cluster_resources() {res}", flush=True)
            check(res.get("GPU") == 1.0,
                  f"cluster: the head counts {res.get('GPU')} GPUs, want 1")
            visible, avail, pid = rt.get(rt.remote(_visible_card).remote(),
                                         timeout=300)
            worker_pids.append(pid)
            print(f"[cluster] plain task: CUDA_VISIBLE_DEVICES={visible!r} "
                  f"torch.cuda.is_available()={avail}", flush=True)
            check(visible == "" and avail is False,
                  "cluster: a task that leased no GPU sees the card")

            actor = rt.remote(num_gpus=1)(FlagshipWorker).remote(0)
            w_env = rt.get(actor.card.remote(), timeout=600)
            worker_pids.append(w_env[3])
            print(f"[cluster] num_gpus=1 actor: CUDA_VISIBLE_DEVICES="
                  f"{w_env[0]!r} is_available={w_env[1]} device_count="
                  f"{w_env[2]} card {w_env[4]!r} pid {w_env[3]}", flush=True)
            check(w_env[:3] == ("0", True, 1),
                  f"cluster: the GPU actor sees {w_env[:3]}")
            o_err, l_err = rt.get(actor.kernel_check.remote(), timeout=600)
            print(f"[cluster] flash_fwd in the worker against its plain "
                  f"version (serve prefill, bf16): O max_abs_err {o_err:.4e} "
                  f"(tol {TOL[torch.bfloat16]['out']}), LSE {l_err:.4e} "
                  f"(tol {TOL[torch.bfloat16]['lse']})", flush=True)
            check(o_err <= TOL[torch.bfloat16]["out"]
                  and l_err <= TOL[torch.bfloat16]["lse"],
                  "cluster: the flash forward disagrees in the worker")
            tokens, launches, w_tps, w_logits = rt.get(
                actor.serve.remote(prompt, new), timeout=900)

            # the same generate in the driver
            gp = torch.from_numpy(prompt).cuda()
            generate(params, gp, cfg, max_new_tokens=4)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = generate(params, gp, cfg, max_new_tokens=new)
            torch.cuda.synchronize()
            d_tps = batch * new / (time.perf_counter() - t0)
            want_logits = _prefill_logits(params, gp, cfg, plen + new)[
                :, -1].float().cpu().numpy()
            check(launches == (cfg.n_layers, 0, 0, 0),
                  f"cluster: kernels launched {launches} times (fwd, dkv, "
                  f"dq, delta) in the worker's generate, want "
                  f"({cfg.n_layers}, 0, 0, 0)")
            same = np.array_equal(tokens, want.cpu().numpy())
            rows_diff = int((tokens != want.cpu().numpy()).any(1).sum())
            logit_diff = float(np.abs(w_logits - want_logits).max())
            print(f"[cluster] worker generate {batch}x{new}: tokens equal "
                  f"the driver's: {same} ({rows_diff} rows differ); "
                  f"last-position prefill logits max_abs_diff "
                  f"{logit_diff:.4e} (tol {LOGIT_TOL_BF16}); flash launches "
                  f"{launches}", flush=True)
            check(same, "cluster: the worker's tokens differ from the "
                  "driver's direct generate of the same weights")
            print(f"[cluster] tokens/s: worker {w_tps:.1f}, driver's direct "
                  f"generate {d_tps:.1f} (phase 3: "
                  f"{direct_tokens_per_s:.1f}), worker/driver "
                  f"{w_tps / d_tps:.4f} on {card}", flush=True)

            t0 = time.perf_counter()
            ref = rt.put(embed)
            put_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back, in_s, twice_s = rt.get(actor.double.remote([ref]),
                                         timeout=600)
            call_s = time.perf_counter() - t0
            exact = bool(np.array_equal(np.asarray(back), embed * 2))
            back_s = call_s - in_s
            mb = embed.nbytes / 1e6
            print(f"[cluster] object plane: {mb:.1f} MB; to the worker "
                  f"{mb / (put_s + in_s):.1f} MB/s (put {put_s:.4f} s, get "
                  f"and copy to the card {in_s:.4f} s); back "
                  f"{mb / back_s:.1f} MB/s (double, copy to the host, "
                  f"return and get {back_s:.4f} s, of it on the card and "
                  f"the copy back {twice_s:.4f} s); doubled bitwise: {exact}"
                  f" on {card}", flush=True)
            check(exact, "cluster: the doubled table is not 2x the table")
            del back, ref
            apps_during = _compute_apps()
            print(f"[cluster] card contexts with the GPU actor alive: "
                  f"{apps_during} (before the phase: {apps_before})",
                  flush=True)
            check(len(apps_during) > len(apps_before),
                  "cluster: nvidia-smi lists no context for the GPU worker, "
                  "so it cannot show that teardown releases it")
            rt.kill(actor)
        finally:
            rt.shutdown()
    finally:
        c.shutdown()
    deadline = time.monotonic() + 30
    left = _session_processes()
    segs = [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]
    while (left or segs) and time.monotonic() < deadline:
        time.sleep(0.2)
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
    apps = _compute_apps()
    deadline = time.monotonic() + 30
    while len(apps) > len(apps_before) and time.monotonic() < deadline:
        time.sleep(0.2)
        apps = _compute_apps()
    print(f"[cluster] after shutdown: session processes {left}, segments "
          f"{segs}, card contexts {apps} (before the phase {apps_before}; "
          f"workers were pids {worker_pids})", flush=True)
    check(not left, f"cluster: processes left after shutdown: {left}")
    check(not segs, f"cluster: store segments left: {segs}")
    check(len(apps) <= len(apps_before),
          f"cluster: a worker still holds a context on the card: {apps} "
          f"(before the phase {apps_before})")
    del params
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[cluster] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=launches, worker_tokens_per_s=w_tps,
                driver_tokens_per_s=d_tps, ratio=w_tps / d_tps,
                tokens_equal=same, prefill_logit_diff=logit_diff,
                shm_free=free, store_bytes=store_bytes,
                table_bytes=embed.nbytes, to_worker_mb_s=mb / (put_s + in_s),
                back_mb_s=mb / back_s, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 26: a compiled graph on the card
# ---------------------------------------------------------------------------

CG_SHAPE = (8, 128, 2048)       # the serve cell's activations
CG_CALLS = 10                   # cut from 40, then 20 (PERF.md §6)
CG_BIG_SLOT = 6 << 20           # holds the 4 MiB bf16 tensor and its pickle


class ActivationSource:
    """A GPU actor: the flagship's activation shape in bf16 on its card,
    drawn from the call's seed."""

    def make(self, seed):
        gen = torch.Generator(device="cuda").manual_seed(int(seed))
        return torch.randn(CG_SHAPE, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def visible(self):
        import os
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def launches(self, reset=False):
        """This process's flash launches (forward, dK/dV, dQ, Δ); with
        ``reset`` they start again from 0."""
        from ray_tpu_torch.ops import flash
        out = (flash.launches, flash.bwd_dkv_launches,
               flash.bwd_dq_launches, flash.bwd_delta_launches)
        if reset:
            flash.launches = flash.bwd_dkv_launches = 0
            flash.bwd_dq_launches = flash.bwd_delta_launches = 0
        return out


class Reducer:
    """A CPU actor: what arrived, as plain numbers."""

    def reduce(self, x):
        return (str(x.dtype), tuple(x.shape), str(x.device),
                float(x.float().sum()), x.flatten()[:4].float().tolist())


def _round_trips(fn, calls):
    """(results, round trips/s) of ``calls`` sequential calls."""
    fn(0)
    t0 = time.perf_counter()
    out = [fn(i) for i in range(1, calls + 1)]
    return out, calls / (time.perf_counter() - t0)


def phase_compiled_graph(card):
    """Phase 26: the GPU actor's activations to a CPU actor through a
    compiled graph, at two slot sizes, against the classic chain."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import config
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.cluster.protocol import get_client
    from ray_tpu_torch.dag import InputNode, channel, compiled
    t_phase = time.perf_counter()
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4,
                                "object_store_bytes": 1 << 30})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        rt.init(address=c.address)
        try:
            gpu = rt.remote(num_gpus=1)(ActivationSource).remote()
            cpu = rt.remote(Reducer).remote()
            check(rt.get(gpu.visible.remote(), timeout=300) == "0",
                  "compiled graph: the GPU actor sees no card")
            classic, classic_rps = _round_trips(
                lambda i: rt.get(cpu.reduce.remote(gpu.make.remote(i)),
                                 timeout=120), CG_CALLS)
            rt.get(gpu.launches.remote(reset=True), timeout=60)
            rates = {}
            for label, slot in (("default slot", None),
                                ("6 MiB slot", CG_BIG_SLOT)):
                if slot is not None:
                    config.set_override("cgraph_slot_bytes", slot)
                try:
                    with InputNode() as inp:
                        dag = _actor_node(cpu).reduce.bind(
                            _actor_node(gpu).make.bind(inp))
                    cg = dag.experimental_compile(max_in_flight=4)
                finally:
                    config.clear_override("cgraph_slot_bytes")
                try:
                    got, rps = _round_trips(
                        lambda i: rt.get(cg.execute(i), timeout=120),
                        CG_CALLS)
                    addrs = [p.address for p in cg._installed]
                finally:
                    cg.teardown()
                check(got == classic,
                      f"compiled graph ({label}): results differ from the "
                      f"classic chain's")
                rates[label] = rps
                loops = [lp for a in addrs for lp in
                         get_client(a).call("debug_state")["cgraph_loops"]]
                deadline = time.monotonic() + 5
                leaked = channel.leaked_segments(prefixes)
                while leaked and time.monotonic() < deadline:
                    time.sleep(0.05)
                    leaked = channel.leaked_segments(prefixes)
                print(f"[cgraph] {label}: {rps:.1f} round trips/s "
                      f"({CG_CALLS} sequential execute + get of a "
                      f"{CG_SHAPE} bf16 tensor, GPU actor to CPU actor); "
                      f"after teardown: live graphs "
                      f"{len(compiled._live_graphs)}, loops {loops}, "
                      f"segments {leaked}", flush=True)
                check(not compiled._live_graphs and not loops and not leaked,
                      f"compiled graph ({label}): teardown left graphs "
                      f"{compiled._live_graphs}, loops {loops}, segments "
                      f"{leaked}")
            print(f"[cgraph] classic .remote() chain: {classic_rps:.1f} "
                  f"round trips/s; compiled/classic: "
                  + ", ".join(f"{k} {v / classic_rps:.3f}"
                              for k, v in rates.items())
                  + f"; results equal the classic chain's ({classic[1][3]} "
                  f"is call 2's sum) on {card}", flush=True)
            launches = tuple(rt.get(gpu.launches.remote(), timeout=60))
            print(f"[cgraph] flash launches in the GPU actor over the "
                  f"compiled runs {launches}", flush=True)
            rt.kill(gpu)
            rt.kill(cpu)
        finally:
            rt.shutdown()
    finally:
        c.shutdown()
    seconds = time.perf_counter() - t_phase
    print(f"[cgraph] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=launches, classic_rps=classic_rps,
                compiled_rps=rates, seconds=seconds)


def _actor_node(handle):
    """A ``ClassNode`` over an existing actor, as ``compile_actor_method``
    builds one."""
    from ray_tpu_torch.dag.nodes import ClassNode
    node = ClassNode(None, (), {})
    node._actor_handle = handle
    return node


# ---------------------------------------------------------------------------
# phase 27: MPMD pipeline training of the flagship in two stage actors
# ---------------------------------------------------------------------------

PIPE_STEPS = 4
PIPE_LR = 3e-4
PIPE_SEED = 27
# The pipeline against make_lm_train_step from the same weights and
# batches, both bf16 with the same kernels: the products run on
# microbatches of 2 rows instead of 8, so cuBLAS may sum in another order.
# Read on the H100 (700 W): the first loss 2.4e-7 off, the next three at
# most 3.0e-4, the same in every run. At random init the losses sit near
# ln(vocab) and the reference's own move by about 2e-3 over four steps, so
# the losses alone cannot show that the pipeline updates its weights: the
# parameters are held too. PIPE_PARAM_TOL bounds, over every leaf of both
# partitions, |Δ_pipe - Δ_ref| / |Δ_ref| with Δ the change from the
# initial weights after the four steps; a pipeline that does not update a
# leaf reads 1.0 there. AdamW moves every element by about lr whatever its
# gradient's size, so elements whose gradient is within bf16 rounding of 0
# may move the other way: that is what a sound run reads (0.0949, on the
# embedding, on the H100 at 700 W).
PIPE_LOSS_TOL = 1e-4
PIPE_LATER_TOL = 1e-3
PIPE_PARAM_TOL = 0.25
PIPE_BIG_SLOT = 17 << 20        # a 2 x 2048 x 2048 bf16 microbatch + pickle


def _pipe_batches(cfg):
    rng = np.random.default_rng(PIPE_SEED)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (8, cfg.max_seq))}
            for _ in range(PIPE_STEPS)]


def _as_partitions(params, cfg, stages=2):
    """{(part, path): f32 tensor on the card} of a pp_stages=1 tree, cut as
    the pipeline's ``stages`` partitions hold it (kept on the card: the
    update check's arithmetic over 0.8 B parameters is the card's work, not
    the host's)."""
    from ray_tpu_torch.models.transformer import transformer_partition_params
    from ray_tpu_torch.train.pipeline import _flatten, _unflatten
    cfg_p = dataclasses.replace(cfg, pp_stages=stages)
    tree = _unflatten(
        (k, v.reshape((stages, -1) + tuple(v.shape[1:]))
         if k.startswith("layers/") else v) for k, v in _flatten(params))
    return {(p, k): v.detach().float().clone() for p in range(stages)
            for k, v in _flatten(transformer_partition_params(tree, cfg_p, p))}


def _reference_losses(cfg, batches):
    """``make_lm_train_step``'s losses from the pipeline's weights, the
    initial weights and the steps' change to them (``_as_partitions``)."""
    from ray_tpu_torch.models import transformer_init
    from ray_tpu_torch.train import make_lm_train_step
    init_fn, step_fn, place = make_lm_train_step(cfg,
                                                 learning_rate=PIPE_LR)
    params = transformer_init(
        torch.Generator(device="cuda").manual_seed(PIPE_SEED), cfg)
    init = _as_partitions(params, cfg)
    state = init_fn(params)
    losses = []
    for b in batches:
        state, metrics = step_fn(state, place(b))
        losses.append(metrics["loss"].item())
    delta = {k: v - init[k]
             for k, v in _as_partitions(state.params, cfg).items()}
    del state, params
    torch.cuda.empty_cache()
    return losses, init, delta


def _update_error(final, init, delta_ref):
    """(worst leaf, |Δ - Δ_ref| / |Δ_ref| there) of the change from
    ``init`` to ``final`` (numpy from the stages, or card tensors) against
    the reference's change, in f32 on the card."""
    errs = {}
    for k, d in delta_ref.items():
        f = torch.as_tensor(final[k], dtype=torch.float32, device=d.device)
        errs[k] = ((f - init[k]) - d).norm().item() / d.norm().item()
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _pipeline_run(cfg, batches, label, slot_bytes=None, fetch=False):
    """One PipelineTrainer on the running cluster: (losses, timed-step
    metrics, stage actors' device stats); with ``fetch`` the metrics hold
    the partitions' weights after the steps (``_as_partitions``' keys)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import config
    from ray_tpu_torch.train.pipeline import PipelineTrainer
    if slot_bytes is not None:
        config.set_override("pipeline_slot_bytes", slot_bytes)
    try:
        t0 = time.perf_counter()
        tr = PipelineTrainer(cfg, num_stages=2, num_microbatches=4,
                             schedule="1f1b", learning_rate=PIPE_LR,
                             seed=PIPE_SEED).start()
        start_s = time.perf_counter() - t0
    finally:
        config.clear_override("pipeline_slot_bytes")
    try:
        stages = tr._groups[0]
        first = tr.step(batches[0])
        rt.get([h.device_stats.remote(reset=True) for h in stages],
               timeout=120)
        t0 = time.perf_counter()
        timed = [tr.step(b) for b in batches[1:]]
        seconds = time.perf_counter() - t0
        stats = rt.get([h.device_stats.remote() for h in stages],
                       timeout=120)
        contexts = len(_compute_apps())
        weights = {}
        if fetch:
            from ray_tpu_torch.train.pipeline import _flatten
            for a, h in enumerate(stages):
                tree = rt.get(h.get_partition.remote(a), timeout=300)
                weights.update(((a, k), np.asarray(v, np.float32))
                               for k, v in _flatten(tree))
    finally:
        tr.shutdown()
    n = len(timed)
    launches = tuple(sum(st["launches"][i] for st in stats)
                     for i in range(4))
    step_ms = seconds / n * 1e3
    tokens_s = n * 8 * cfg.max_seq / seconds
    walls = [m["wall_s"] for m in timed]
    busy = [sum(m["busy_s"][a] for m in timed) for a in range(2)]
    codec = [sum(m["codec_s"][a] for m in timed) for a in range(2)]
    effs = [m["efficiency"] for m in timed]
    print(f"[pipeline] {label}: start {start_s:.1f} s; {n} timed steps "
          f"{step_ms:.1f} ms/step, {tokens_s:.0f} tokens/s; per stage over "
          f"the timed steps busy {[round(b, 4) for b in busy]} s, codec "
          f"{[round(x, 4) for x in codec]} s (share of the wall "
          f"{[round(x / sum(walls), 4) for x in codec]}); efficiency "
          f"{[round(e, 4) for e in effs]} against bubble_bound "
          f"{timed[0]['bound']:.4f}; peak card memory by actor "
          f"{[round(st['peak_bytes'] / 1e9, 3) for st in stats]} GB; flash "
          f"launches in the stage actors {launches}", flush=True)
    losses = [first["loss"]] + [m["loss"] for m in timed]
    return losses, dict(step_ms=step_ms, tokens_per_s=tokens_s,
                        busy_s=busy, codec_s=codec, wall_s=sum(walls),
                        efficiency=effs, bound=timed[0]["bound"],
                        peak_gb=[st["peak_bytes"] / 1e9 for st in stats],
                        launches=launches, start_s=start_s,
                        contexts=contexts, weights=weights)


def phase_pipeline(card):
    """Phase 27: the flagship (untied) trained by a 2-stage 1F1B pipeline
    whose stage actors share the card, held to make_lm_train_step."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.models import transformer_num_params
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(flagship_cfg(remat=True),
                              tied_embeddings=False)
    batches = _pipe_batches(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want, init, delta_ref = _reference_losses(cfg, batches)
    print(f"[pipeline] flagship untied, {transformer_num_params(cfg)} "
          f"parameters, remat; make_lm_train_step losses {want} "
          f"({time.perf_counter() - t0:.1f} s with the partitions' copies)",
          flush=True)
    free = _shm_free()
    store_bytes = min(8 << 30, int(free * 0.8))
    apps_before = _compute_apps()
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4,
                                "object_store_bytes": store_bytes})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        rt.init(address=c.address)
        try:
            losses, spill = _pipeline_run(cfg, batches, "default slot "
                                          "(activations spill)", fetch=True)
            big_losses, ring = _pipeline_run(cfg, batches, "17 MiB slot "
                                             "(activations in the ring)",
                                             PIPE_BIG_SLOT)
        finally:
            rt.shutdown()
    finally:
        c.shutdown()
    diffs = [abs(a - b) for a, b in zip(losses, want)]
    print(f"[pipeline] losses {losses} (17 MiB slot: {big_losses}) against "
          f"make_lm_train_step {want}: diffs {[f'{d:.3e}' for d in diffs]} "
          f"(tol {PIPE_LOSS_TOL} first, {PIPE_LATER_TOL} after) on {card}",
          flush=True)
    check(all(np.isfinite(losses)) and diffs[0] <= PIPE_LOSS_TOL
          and max(diffs[1:]) <= PIPE_LATER_TOL,
          f"pipeline: losses {losses} against make_lm_train_step {want}")
    t0 = time.perf_counter()
    weights = spill.pop("weights")
    check(weights.keys() == delta_ref.keys(),
          f"pipeline: the stages hold {sorted(weights)}, the reference "
          f"{sorted(delta_ref)}")
    worst, param_err = _update_error(weights, init, delta_ref)
    _, control = _update_error(init, init, delta_ref)
    del weights, init, delta_ref
    torch.cuda.empty_cache()
    print(f"[pipeline] the weights' change over {PIPE_STEPS} steps against "
          f"make_lm_train_step's: |Δ - Δ_ref| / |Δ_ref| at most "
          f"{param_err:.4f} (leaf {worst}; tol {PIPE_PARAM_TOL}); the "
          f"initial weights in its place read {control:.4f} (both on the "
          f"card, {time.perf_counter() - t0:.1f} s)", flush=True)
    check(param_err <= PIPE_PARAM_TOL,
          f"pipeline: the stages' update of {worst} is {param_err:.4f} off "
          f"make_lm_train_step's (tol {PIPE_PARAM_TOL})")
    check(big_losses == losses,
          f"pipeline: the 17 MiB slot's losses {big_losses} differ from "
          f"the default slot's {losses}")
    # a step: stage 0 runs its 5 layers' forward 3 times a microbatch (the
    # forward, its replay in the backward, remat's recompute), stage 1
    # twice (its forward runs in the backward op); each backward once
    want_launches = tuple((PIPE_STEPS - 1) * 4 * n for n in (25, 10, 10, 10))
    for r in (spill, ring):
        check(r["launches"] == want_launches,
              f"pipeline: the stage actors launched {r['launches']} "
              f"(fwd, dkv, dq, delta) in {PIPE_STEPS - 1} steps, want "
              f"{want_launches}")
    deadline = time.monotonic() + 30
    left = _session_processes()
    segs = [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]
    apps = _compute_apps()
    while (left or segs or len(apps) > len(apps_before)) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
        apps = _compute_apps()
    during = (spill["contexts"], ring["contexts"])
    print(f"[pipeline] after shutdown: session processes {left}, segments "
          f"{segs}, card contexts {len(apps)} (before the phase "
          f"{len(apps_before)}, with each trainer's stage actors {during})",
          flush=True)
    check(min(during) > len(apps_before),
          "pipeline: nvidia-smi lists no context for the stage workers, so "
          "it cannot show that teardown releases them")
    check(not left and not segs and len(apps) <= len(apps_before),
          f"pipeline: left processes {left}, segments {segs}, contexts "
          f"{apps}")
    seconds = time.perf_counter() - t_phase
    print(f"[pipeline] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=spill["launches"], losses=losses,
                reference_losses=want, loss_diffs=diffs,
                update_error=param_err, update_error_leaf=str(worst),
                no_update_error=control, spill=spill,
                ring=ring, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 28: the trainer on the card (a one-rank NCCL gang)
# ---------------------------------------------------------------------------

GANG_SEED = 3             # phase 5's weights and batch
GANG_TIMED = 2            # after one settling step (cut from 3, PERF.md §6)
# The gang worker against the driver, the same program on the same card:
# the same kernels and cuBLAS calls from the same weights and batch, so the
# losses differ only where a reduction's order is not fixed (atomics in
# the embedding's backward); phase 23 holds its one-rank mesh step to the
# same bound.
GANG_LOSS_TOL = 2e-3
# timed steps cut from 10 to 5, then 3 (PERF.md §6)
RESNET_GANG_WARM, RESNET_GANG_TIMED = 3, 3
# the first ResNet-50 loss (bf16 convolutions, cudnn.benchmark on) in the
# gang against phase 11's from the same seeded weights and images: cuDNN
# may time its way to other algorithms in another process
RESNET_FIRST_LOSS_TOL = 2e-2


def _gang_lm(session, dev):
    """Phase 5's flagship train step in the gang worker: 1 settling step,
    then GANG_TIMED timed steps, the flash launches counted from 0 before
    them; a report each step."""
    from ray_tpu_torch.train import make_lm_train_step
    cfg = flagship_cfg(remat=True)
    tokens = np.random.default_rng(GANG_SEED).integers(
        0, cfg.vocab_size, (8, cfg.max_seq))
    torch.cuda.reset_peak_memory_stats(dev)
    init_fn, step_fn, place = make_lm_train_step(cfg, device=dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(GANG_SEED))
    data = place({"tokens": tokens})
    for i in range(1 + GANG_TIMED):
        if i == 1:
            _reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step_fn(state, data)
        loss = m["loss"].item()     # waits for the step
        torch.cuda.synchronize(dev)
        report = {"part": "lm", "step": i, "loss": loss,
                  "step_ms": (time.perf_counter() - t0) * 1e3,
                  "t": time.time()}
        if i == GANG_TIMED:
            report.update(launches=list(_launch_counts()),
                          peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                          contexts=len(_compute_apps()))
        session.report(report)
    del state, data
    torch.cuda.empty_cache()


def _gang_resnet(session, dev):
    """Phase 11's ResNet-50 step in the gang worker: RESNET_GANG_WARM
    warm-up steps, then RESNET_GANG_TIMED timed ones in one window."""
    from ray_tpu_torch.train import make_resnet_train_step
    batch, size = 256, 224
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        rng = np.random.default_rng(0)       # bench_resnet's data
        host = {"image": rng.normal(size=(batch, size, size, 3))
                .astype(np.float32),
                "label": rng.integers(0, 1000, (batch,))}
        torch.cuda.reset_peak_memory_stats(dev)
        init_fn, step_fn, place = make_resnet_train_step(
            num_classes=1000, image_size=size, learning_rate=0.1,
            device=dev)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        data = place(host)
        del host
        losses = []
        for _ in range(RESNET_GANG_WARM):
            state, m = step_fn(state, data)
            losses.append(m["loss"].item())
        _reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(RESNET_GANG_TIMED):
            state, m = step_fn(state, data)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        losses.append(m["loss"].item())
        session.report({
            "part": "resnet", "first_loss": losses[0],
            "last_loss": losses[-1], "finite": bool(np.isfinite(losses)
                                                    .all()),
            "step_ms": seconds / RESNET_GANG_TIMED * 1e3,
            "images_per_s": RESNET_GANG_TIMED * batch / seconds,
            "launches": list(_launch_counts()),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "t": time.time()})
        del state, data
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()


def gang_loop(config):
    """Phase 28's loop in the one-rank gang's worker: the flagship, then
    ResNet-50, each on the worker's card (``torch_utils.get_device()``)."""
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import torch_utils
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1,
          f"trainer-gang: the worker's group is "
          f"{dist.get_backend() if dist.is_initialized() else None} of "
          f"{dist.get_world_size() if dist.is_initialized() else 0}, want "
          f"nccl of 1")
    torch.backends.cuda.matmul.allow_tf32 = False    # as phase 1 sets them
    torch.backends.cudnn.allow_tf32 = False
    dev = torch_utils.get_device()
    check(dev == torch.device("cuda:0") and torch.cuda.device_count() == 1,
          f"trainer-gang: the worker's device is {dev} of "
          f"{torch.cuda.device_count()} visible cards")
    _gang_lm(session, dev)
    _gang_resnet(session, dev)


def _driver_lm_steps(cfg):
    """The gang's flagship program in the driver: (losses, timed step
    ms), with the same per-step synchronize."""
    from ray_tpu_torch.train import make_lm_train_step
    tokens = np.random.default_rng(GANG_SEED).integers(
        0, cfg.vocab_size, (8, cfg.max_seq))
    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(GANG_SEED))
    data = place({"tokens": tokens})
    losses, ms = [], []
    for _ in range(1 + GANG_TIMED):
        t0 = time.perf_counter()
        state, m = step_fn(state, data)
        losses.append(m["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    del state, data
    torch.cuda.empty_cache()
    return losses, ms[1:]


def phase_trainer_gang(card, resnet_run):
    """Phase 28: TorchTrainer over a one-rank NCCL gang on a port Cluster
    that counts the card, training the flagship and ResNet-50 in the gang's
    worker process, held to the driver's steps."""
    import os
    import tempfile

    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.cluster.protocol import get_client
    from ray_tpu_torch.models import transformer_num_params
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    t_phase = time.perf_counter()
    cfg = flagship_cfg(remat=True)
    want, driver_ms = _driver_lm_steps(cfg)
    driver_step_ms = float(np.mean(driver_ms))
    print(f"[trainer-gang] the driver's make_lm_train_step (phase 5's "
          f"weights and batch, seed {GANG_SEED}): losses {want}, timed step "
          f"ms {[round(x, 2) for x in driver_ms]}", flush=True)
    apps_before = _compute_apps()
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "object_store_bytes": 1 << 30})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        rt.init(address=c.address)
        try:
            res = rt.cluster_resources()
            check(res.get("GPU") == 1.0,
                  f"trainer-gang: the head counts {res.get('GPU')} GPUs, "
                  f"want 1")
            # the gang goes through SLICE on the head's NVLink domain
            domain = c.nodes[0].gpu_domain
            check(domain is not None, "trainer-gang: the head reports no "
                  "NVLink domain")
            scaling = ScalingConfig(topology=domain["accelerator_type"])
            check(scaling.num_workers == 1, f"trainer-gang: topology "
                  f"{domain['accelerator_type']} gives "
                  f"{scaling.num_workers} workers, want 1")
            placed, done = [], threading.Event()

            def watch(cli=get_client(c.address)):
                while not done.is_set():
                    placed.extend(
                        (g["strategy"], g["slice_id"])
                        for g in cli.call("list_placement_groups")
                        if g["state"] == "CREATED")
                    done.wait(0.2)

            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            with tempfile.TemporaryDirectory() as tmp:
                t_fit = time.time()
                try:
                    result = TorchTrainer(
                        gang_loop, scaling_config=scaling,
                        run_config=RunConfig(storage_path=tmp,
                                             name="trainer-gang")).fit()
                finally:
                    done.set()
                    watcher.join()
                fit_s = time.time() - t_fit
        finally:
            rt.shutdown()
    finally:
        c.shutdown()
    print(f"[trainer-gang] ScalingConfig(topology="
          f"{domain['accelerator_type']!r}): the gang's placement groups "
          f"(strategy, domain) {sorted(set(placed))}; the head's domain "
          f"{domain['slice_id']}", flush=True)
    check(sorted(set(placed)) == [("SLICE", domain["slice_id"])],
          f"trainer-gang: the gang was placed as {sorted(set(placed))}, "
          f"want SLICE on {domain['slice_id']}")
    check(result.error is None, f"trainer-gang: the gang failed: "
                                f"{result.error}")
    hist = result.metrics_history
    lm = [m for m in hist if m["part"] == "lm"]
    resnet = [m for m in hist if m["part"] == "resnet"]
    check(len(lm) == 1 + GANG_TIMED and len(resnet) == 1,
          f"trainer-gang: {len(lm)} flagship and {len(resnet)} ResNet "
          f"reports")
    losses = [m["loss"] for m in lm]
    diffs = [abs(a - b) for a, b in zip(losses, want)]
    gang_ms = [m["step_ms"] for m in lm[1:]]
    step_ms = float(np.mean(gang_ms))
    launches = tuple(lm[-1]["launches"])
    want_launches = tuple(GANG_TIMED * n for n in
                          (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers,
                           cfg.n_layers))
    tokens_per_s = 8 * cfg.max_seq / (step_ms / 1e3)
    n_params = transformer_num_params(cfg)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * \
        cfg.max_seq
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    first_report_s = lm[0]["t"] - t_fit
    print(f"[trainer-gang] flagship in the gang worker: losses {losses} "
          f"against the driver's {want}: diffs "
          f"{[f'{d:.3e}' for d in diffs]}, largest {max(diffs):.3e} (tol "
          f"{GANG_LOSS_TOL})", flush=True)
    print(f"[trainer-gang] {GANG_TIMED} timed steps in the worker: "
          f"{[round(x, 2) for x in gang_ms]} ms, mean {step_ms:.2f} ms/step,"
          f" {tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} (6N + 12LdS = "
          f"{flops_per_token:.4e} flop/token against 989 TFLOP/s); the "
          f"driver's {driver_step_ms:.2f} ms/step, gang/driver "
          f"{step_ms / driver_step_ms:.4f}; peak card memory in the worker "
          f"{lm[-1]['peak_gb']:.2f} GB; flash launches (fwd, dkv, dq, "
          f"delta) {launches} in the worker; fit() to the first report "
          f"{first_report_s:.1f} s, fit() {fit_s:.1f} s on {card}",
          flush=True)
    check(all(np.isfinite(losses)) and max(diffs) <= GANG_LOSS_TOL,
          f"trainer-gang: the gang's losses {losses} against the driver's "
          f"{want}")
    check(launches == want_launches,
          f"trainer-gang: the worker launched {launches} in {GANG_TIMED} "
          f"steps, want {want_launches}")
    r = resnet[0]
    loss_diff = abs(r["first_loss"] - resnet_run["losses"][0])
    print(f"[trainer-gang] ResNet-50 in the gang worker (batch 256 at 224², "
          f"SGD 0.1 Nesterov, bf16 channels_last): {RESNET_GANG_TIMED} "
          f"timed steps after {RESNET_GANG_WARM} warm-up, {r['step_ms']:.2f}"
          f" ms/step, {r['images_per_s']:.1f} images/s beside phase 11's "
          f"driver {resnet_run['images_per_s']:.1f} images/s (gang/driver "
          f"{r['images_per_s'] / resnet_run['images_per_s']:.4f}); first "
          f"loss {r['first_loss']:.5f} against phase 11's "
          f"{resnet_run['losses'][0]:.5f} (diff {loss_diff:.3e}, tol "
          f"{RESNET_FIRST_LOSS_TOL}); last {r['last_loss']:.5f}; peak "
          f"{r['peak_gb']:.2f} GB; flash launches {tuple(r['launches'])} on "
          f"{card}", flush=True)
    check(r["finite"] and loss_diff <= RESNET_FIRST_LOSS_TOL
          and r["last_loss"] < r["first_loss"],
          f"trainer-gang: ResNet losses first {r['first_loss']} (phase 11 "
          f"{resnet_run['losses'][0]}), last {r['last_loss']}")
    check(tuple(r["launches"]) == (0, 0, 0, 0),
          f"trainer-gang: the ResNet step launched {r['launches']}")
    deadline = time.monotonic() + 30
    left = _session_processes()
    segs = [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]
    apps = _compute_apps()
    while (left or segs or len(apps) > len(apps_before)) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
        apps = _compute_apps()
    during = lm[-1]["contexts"]
    print(f"[trainer-gang] after shutdown: session processes {left}, "
          f"segments {segs}, card contexts {len(apps)} (before the phase "
          f"{len(apps_before)}, with the gang worker {during})", flush=True)
    check(during > len(apps_before),
          "trainer-gang: nvidia-smi lists no context for the gang worker, "
          "so it cannot show that teardown releases it")
    check(not left and not segs and len(apps) <= len(apps_before),
          f"trainer-gang: left processes {left}, segments {segs}, contexts "
          f"{apps}")
    seconds = time.perf_counter() - t_phase
    print(f"[trainer-gang] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=launches, losses=losses, driver_losses=want,
                loss_diffs=diffs, step_ms=step_ms,
                driver_step_ms=driver_step_ms,
                ratio=step_ms / driver_step_ms, tokens_per_s=tokens_per_s,
                mfu=mfu, peak_gb=lm[-1]["peak_gb"],
                first_report_s=first_report_s, fit_s=fit_s,
                resnet={k: r[k] for k in ("step_ms", "images_per_s",
                                          "first_loss", "last_loss",
                                          "peak_gb")},
                resnet_driver_images_per_s=resnet_run["images_per_s"],
                seconds=seconds)


# ---------------------------------------------------------------------------
# phase 29: the data library feeding the trainer's gang
# ---------------------------------------------------------------------------

DATA_TEXT_BYTES = 2 << 20       # the synthetic corpus, at least (cut
                                # from 16 MiB, then 4, PERF.md §6)
DATA_BLOCKS = 16                # from_items' parallelism
DATA_BATCH = 8                  # the train cell's batch of 8 x 2048
IMAGE_BLOCKS = RESNET_GANG_WARM + RESNET_GANG_TIMED   # one batch a step
IMAGE_BATCH, IMAGE_SIZE = 256, 224
OPTIONAL_FORMATS = ("pyarrow", "pandas", "PIL")
# The corpus' words (the phase draws documents of them with numpy).
DATA_WORDS = tuple("""
the of and to in is was for on that with as by at from his her it an
were are which this be has had not but or have first one their its new
after who they two been more also than other time into only most some
made such when out may over during would about all there him up many
can year city these then later world under between both before while
where since three years second used part through however state high
number found school known small large called early each place because
system group water river north south east west during house model train
data block batch token stream shard worker cluster store tensor kernel
graph layer value queue actor task memory device card model step loss
""".split())


def _loaded_formats():
    return [m for m in OPTIONAL_FORMATS if sys.modules.get(m) is not None]


def _corpus(seed, nbytes):
    """Seeded documents of words from ``DATA_WORDS``: at least ``nbytes``
    of ASCII text in documents of 100-3000 words."""
    rng = np.random.default_rng(seed)
    words = np.array(DATA_WORDS, dtype=object)
    mean_len = np.mean([len(w) + 1 for w in DATA_WORDS])
    idx = rng.integers(0, len(words), int(nbytes / mean_len * 1.05))
    docs, total, at = [], 0, 0
    while total < nbytes:
        n = int(rng.integers(100, 3001))
        if at + n > len(idx):
            idx = np.concatenate([idx, rng.integers(0, len(words), n)])
        text = " ".join(words[idx[at:at + n]].tolist())
        at += n
        docs.append({"text": text})
        total += len(text)
    return docs, total


def data_images(batch):
    """``map_batches`` over ``range``'s ids: seeded uint8 NHWC images of
    ``IMAGE_SIZE``² and int64 labels, one draw a block (runs in the
    cluster's CPU workers)."""
    ids = np.asarray(batch["id"])
    rng = np.random.default_rng((GANG_SEED, int(ids[0])))
    return {"image": rng.integers(0, 256, (len(ids), IMAGE_SIZE,
                                           IMAGE_SIZE, 3), dtype=np.uint8),
            "label": (ids * 7919 % 1000).astype(np.int64)}


def _resnet_input(images):
    """uint8 NHWC on the card -> the step's float input in [-1, 1]."""
    return images.to(torch.float32).div_(127.5).sub_(1.0)


def _data_gang_lm(session, dev):
    """The flagship's train cell fed from the ``train`` shard: 1 settling
    step, then GANG_TIMED timed ones (each batch fetched, copied to the
    card and stepped), the flash launches counted from 0 before them; then
    the rest of the shard through the copy to the card alone."""
    from ray_tpu_torch.train import make_lm_train_step
    cfg = flagship_cfg(remat=True)
    torch.cuda.reset_peak_memory_stats(dev)
    init_fn, step_fn, place = make_lm_train_step(cfg, device=dev)
    state = init_fn(torch.Generator(device=dev).manual_seed(GANG_SEED))
    batches = iter(session.get_dataset_shard("train").iter_torch_batches(
        batch_size=DATA_BATCH, drop_last=True))
    for i in range(1 + GANG_TIMED):
        if i == 1:
            _reset_launch_counts()
        t0 = time.perf_counter()
        batch = next(batches)
        data = place({"tokens": batch["tokens"].to(dev)})
        wait_ms = (time.perf_counter() - t0) * 1e3
        state, m = step_fn(state, data)
        loss = m["loss"].item()     # waits for the step
        torch.cuda.synchronize(dev)
        report = {"part": "lm", "step": i, "loss": loss, "wait_ms": wait_ms,
                  "step_ms": (time.perf_counter() - t0) * 1e3,
                  "t": time.time()}
        if i == GANG_TIMED:
            report.update(launches=list(_launch_counts()),
                          peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                          contexts=len(_compute_apps()))
        session.report(report)
    del state, data
    torch.cuda.empty_cache()
    rows, nbytes = 0, 0
    t0 = time.perf_counter()
    for batch in batches:
        on_card = batch["tokens"].to(dev)
        rows += on_card.shape[0]
        nbytes += on_card.numel() * on_card.element_size()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    session.report({"part": "drain", "rows": rows, "seconds": seconds,
                    "rows_per_s": rows / seconds,
                    "mb_per_s": nbytes / seconds / 1e6, "t": time.time()})


def _data_gang_resnet(session, dev):
    """Phase 28's ResNet-50 step fed from the ``images`` shard: each
    batch's uint8 images fetched, copied to the card and converted there;
    RESNET_GANG_WARM warm-up steps (their copies split with the card
    idle), then RESNET_GANG_TIMED timed ones."""
    from ray_tpu_torch.train import make_resnet_train_step
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        init_fn, step_fn, place = make_resnet_train_step(
            num_classes=1000, image_size=IMAGE_SIZE, learning_rate=0.1,
            device=dev)
        state = init_fn(torch.Generator(device=dev).manual_seed(0))
        batches = iter(session.get_dataset_shard("images")
                       .iter_torch_batches(batch_size=IMAGE_BATCH))

        def fetch(waits):
            t0 = time.perf_counter()
            b = next(batches)
            t1 = time.perf_counter()
            data = {"image": _resnet_input(b["image"].to(dev)),
                    "label": b["label"].to(dev)}
            waits.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
            return data

        def split_copy():
            """A warm-up batch's copy with the card idle: from the store's
            mapping, then the same bytes from private host memory (and the
            host copy into it), each ending in a synchronize."""
            torch.cuda.synchronize(dev)
            b = next(batches)
            t0 = time.perf_counter()
            image = b["image"].to(dev)
            torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            private = b["image"].clone()
            t2 = time.perf_counter()
            private.to(dev)
            torch.cuda.synchronize(dev)
            t3 = time.perf_counter()
            copies.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (t3 - t2) * 1e3))
            return {"image": _resnet_input(image),
                    "label": b["label"].to(dev)}

        timed, copies, losses = [], [], []
        for _ in range(RESNET_GANG_WARM):
            state, m = step_fn(state, split_copy())
            losses.append(m["loss"].item())
        _reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(RESNET_GANG_TIMED):
            state, m = step_fn(state, fetch(timed))
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        losses.append(m["loss"].item())
        session.report({
            "part": "resnet", "first_loss": losses[0],
            "last_loss": losses[-1],
            "finite": bool(np.isfinite(losses).all()),
            "step_ms": seconds / RESNET_GANG_TIMED * 1e3,
            "images_per_s": RESNET_GANG_TIMED * IMAGE_BATCH / seconds,
            "fetch_ms": [w[0] for w in timed], "copy_ms": [w[1] for w in timed],
            "idle_copies_ms": copies, "batch_mb": IMAGE_BATCH * IMAGE_SIZE
            * IMAGE_SIZE * 3 / 1e6,
            "launches": list(_launch_counts()),
            "left": sum(1 for _ in batches), "t": time.time()})
        del state
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()


def data_gang_loop(config):
    """Phase 29's loop in the one-rank gang's worker: the flagship fed from
    the ``train`` shard, then ResNet-50 from the ``images`` shard."""
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import torch_utils
    check(dist.is_initialized() and dist.get_backend() == "nccl"
          and dist.get_world_size() == 1,
          f"data-train: the worker's group is "
          f"{dist.get_backend() if dist.is_initialized() else None} of "
          f"{dist.get_world_size() if dist.is_initialized() else 0}, want "
          f"nccl of 1")
    torch.backends.cuda.matmul.allow_tf32 = False    # as phase 1 sets them
    torch.backends.cudnn.allow_tf32 = False
    dev = torch_utils.get_device()
    check(dev == torch.device("cuda:0"), f"data-train: the worker's device "
                                         f"is {dev}")
    before = _loaded_formats()
    _data_gang_lm(session, dev)
    _data_gang_resnet(session, dev)
    session.report({"part": "end", "loaded_before": before,
                    "loaded_after": _loaded_formats(), "t": time.time()})


def _driver_data_steps(cfg, tokens, first_images):
    """The gang's programs in the driver on the same rows: the flagship's
    losses over the first (1 + GANG_TIMED) batches of ``tokens``, and
    ResNet-50's first loss on the first image batch."""
    from ray_tpu_torch.train import (make_lm_train_step,
                                     make_resnet_train_step)
    init_fn, step_fn, place = make_lm_train_step(cfg)
    state = init_fn(torch.Generator(device="cuda").manual_seed(GANG_SEED))
    losses = []
    for i in range(1 + GANG_TIMED):
        rows = tokens[i * DATA_BATCH:(i + 1) * DATA_BATCH]
        state, m = step_fn(state, place({"tokens": rows}))
        losses.append(m["loss"].item())
    del state
    torch.cuda.empty_cache()
    prior = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        init_fn, step_fn, place = make_resnet_train_step(
            num_classes=1000, image_size=IMAGE_SIZE, learning_rate=0.1)
        state = init_fn(torch.Generator(device="cuda").manual_seed(0))
        data = {"image": _resnet_input(torch.from_numpy(np.array(
                    first_images["image"])).to("cuda")),
                "label": torch.as_tensor(first_images["label"]).to("cuda")}
        state, m = step_fn(state, data)
        resnet_loss = m["loss"].item()
        del state, data
    finally:
        torch.backends.cudnn.benchmark = prior
    torch.cuda.empty_cache()
    return losses, resnet_loss


def phase_data_train(card, gang):
    """Phase 29: ``ray_tpu_torch.data`` on a port Cluster that counts the
    card, feeding ``TorchTrainer(datasets=...)``: the flagship trained from
    a packed, shuffled text dataset and ResNet-50 from a uint8 image
    dataset in a one-rank NCCL gang's worker, held to the driver's steps on
    the same rows. ``gang`` is phase 28's result from this run."""
    import os
    import tempfile

    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.models import transformer_num_params
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    t_phase = time.perf_counter()
    cfg = flagship_cfg(remat=True)
    loaded = _loaded_formats()
    check(not loaded, f"data-train: {loaded} loaded in the driver before "
                      f"the phase")
    apps_before = _compute_apps()
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "object_store_bytes": 2 << 30})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        rt.init(address=c.address)
        try:
            res = rt.cluster_resources()
            check(res.get("GPU") == 1.0 and res.get("CPU") == 4.0,
                  f"data-train: the head counts {res}, want 1 GPU, 4 CPUs")
            t0 = time.perf_counter()
            docs, text_bytes = _corpus(GANG_SEED, DATA_TEXT_BYTES)
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            packed = rd.tokenize_and_pack(
                rd.from_items(docs, parallelism=DATA_BLOCKS),
                seq_len=cfg.max_seq).random_shuffle(seed=GANG_SEED) \
                .materialize()
            pipe_s = time.perf_counter() - t0
            n_rows = packed.count()
            in_tokens = text_bytes + 2 * len(docs)   # ASCII: a byte a token
            print(f"[data-train] corpus: {len(docs)} documents, "
                  f"{text_bytes} bytes ({gen_s:.2f} s to draw); from_items "
                  f"(parallelism {DATA_BLOCKS}) -> tokenize_and_pack(seq_len "
                  f"{cfg.max_seq}) -> random_shuffle(seed {GANG_SEED}) -> "
                  f"materialize on the cluster's 4 CPU workers: {n_rows} "
                  f"packed rows in {packed.num_blocks()} blocks, "
                  f"{pipe_s:.2f} s, {in_tokens / pipe_s:.0f} input tokens/s,"
                  f" {n_rows * cfg.max_seq / pipe_s:.0f} packed tokens/s",
                  flush=True)
            t0 = time.perf_counter()
            images = rd.range(IMAGE_BLOCKS * IMAGE_BATCH,
                              parallelism=IMAGE_BLOCKS) \
                .map_batches(data_images).materialize()
            images_s = time.perf_counter() - t0
            image_bytes = images.size_bytes()
            first = next(images.iter_batches(batch_size=IMAGE_BATCH))
            check(first["image"].dtype == np.uint8 and
                  first["image"].shape == (IMAGE_BATCH, IMAGE_SIZE,
                                           IMAGE_SIZE, 3),
                  f"data-train: the first image batch is "
                  f"{first['image'].dtype} {first['image'].shape}")
            print(f"[data-train] images: range({IMAGE_BLOCKS * IMAGE_BATCH},"
                  f" parallelism={IMAGE_BLOCKS}).map_batches(data_images): "
                  f"{images.num_blocks()} blocks, {image_bytes / 1e6:.1f} MB "
                  f"in {images_s:.2f} s", flush=True)
            head = np.array(next(packed.iter_batches(   # a writable copy
                batch_size=(1 + GANG_TIMED) * DATA_BATCH))["tokens"])
            want, resnet_want = _driver_data_steps(cfg, head, first)
            del first
            print(f"[data-train] the driver's steps on the same rows: "
                  f"flagship losses {want}, ResNet-50 first loss "
                  f"{resnet_want:.5f}", flush=True)
            with tempfile.TemporaryDirectory() as tmp:
                t_fit = time.time()
                result = TorchTrainer(
                    data_gang_loop,
                    datasets={"train": packed, "images": images},
                    scaling_config=ScalingConfig(num_workers=1),
                    run_config=RunConfig(storage_path=tmp,
                                         name="data-train")).fit()
                fit_s = time.time() - t_fit
            del packed, images
        finally:
            rt.shutdown()
    finally:
        c.shutdown()
    check(result.error is None, f"data-train: the gang failed: "
                                f"{result.error}")
    hist = result.metrics_history
    parts = {p: [m for m in hist if m["part"] == p]
             for p in ("lm", "drain", "resnet", "end")}
    check(len(parts["lm"]) == 1 + GANG_TIMED and
          all(len(parts[p]) == 1 for p in ("drain", "resnet", "end")),
          f"data-train: reports {[(p, len(v)) for p, v in parts.items()]}")
    lm, drain = parts["lm"], parts["drain"][0]
    r, end = parts["resnet"][0], parts["end"][0]
    losses = [m["loss"] for m in lm]
    diffs = [abs(a - b) for a, b in zip(losses, want)]
    gang_ms = [m["step_ms"] for m in lm[1:]]
    waits = [m["wait_ms"] for m in lm[1:]]
    step_ms = float(np.mean(gang_ms))
    launches = tuple(lm[-1]["launches"])
    want_launches = tuple(GANG_TIMED * n for n in
                          (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers,
                           cfg.n_layers))
    tokens_per_s = DATA_BATCH * cfg.max_seq / (step_ms / 1e3)
    flops_per_token = 6 * transformer_num_params(cfg) + \
        12 * cfg.n_layers * cfg.d_model * cfg.max_seq
    mfu = tokens_per_s * flops_per_token / PEAK_BF16_FLOPS
    first_report_s = lm[0]["t"] - t_fit
    print(f"[data-train] flagship in the gang worker from the packed "
          f"dataset: losses {losses} against the driver's {want}: diffs "
          f"{[f'{d:.3e}' for d in diffs]}, largest {max(diffs):.3e} (tol "
          f"{GANG_LOSS_TOL})", flush=True)
    print(f"[data-train] {GANG_TIMED} timed steps (fetch, copy to the card, "
          f"step): {[round(x, 2) for x in gang_ms]} ms, mean {step_ms:.2f} "
          f"ms/step beside phase 28's gang step {gang['step_ms']:.2f} ms "
          f"(ratio {step_ms / gang['step_ms']:.4f}), {tokens_per_s:.0f} "
          f"tokens/s, MFU {mfu:.4f}; data wait a step "
          f"{[round(x, 3) for x in waits]} ms; flash launches (fwd, dkv, "
          f"dq, delta) {launches} in the worker; peak card memory "
          f"{lm[-1]['peak_gb']:.2f} GB; fit() to the first report "
          f"{first_report_s:.1f} s, fit() {fit_s:.1f} s on {card}",
          flush=True)
    print(f"[data-train] the feed: the shard's other {drain['rows']} rows "
          f"through iter_torch_batches and the copy to the card in "
          f"{drain['seconds']:.3f} s: {drain['rows_per_s']:.0f} rows/s, "
          f"{drain['mb_per_s']:.1f} MB/s", flush=True)
    check(all(np.isfinite(losses)) and max(diffs) <= GANG_LOSS_TOL,
          f"data-train: the gang's losses {losses} against the driver's "
          f"{want}")
    check(launches == want_launches,
          f"data-train: the worker launched {launches} in {GANG_TIMED} "
          f"steps, want {want_launches}")
    check(drain["rows"] == n_rows - (1 + GANG_TIMED) * DATA_BATCH -
          n_rows % DATA_BATCH,
          f"data-train: drained {drain['rows']} of {n_rows} rows")
    loss_diff = abs(r["first_loss"] - resnet_want)
    ratio = r["images_per_s"] / gang["resnet"]["images_per_s"]
    print(f"[data-train] ResNet-50 in the gang worker from the uint8 "
          f"dataset (batch {IMAGE_BATCH} at {IMAGE_SIZE}², converted on the "
          f"card): {RESNET_GANG_TIMED} timed steps after {RESNET_GANG_WARM} "
          f"warm-up, {r['step_ms']:.2f} ms/step, {r['images_per_s']:.1f} "
          f"images/s beside phase 28's gang {gang['resnet']['images_per_s']:.1f}"
          f" (ratio {ratio:.4f}); a step's fetch from the store "
          f"{[round(x, 2) for x in r['fetch_ms']]} ms and copy to the card "
          f"{[round(x, 2) for x in r['copy_ms']]} ms (the copy waits for "
          f"the step before it: a pageable copy is ordered on the stream); "
          f"with the card idle, a batch's {r['batch_mb']:.1f} MB copied from "
          f"the store's mapping, host-copied to private memory, and copied "
          f"from there: {[[round(x, 2) for x in c] for c in r['idle_copies_ms']]}"
          f" ms; first loss "
          f"{r['first_loss']:.5f} against the driver's {resnet_want:.5f} "
          f"(diff {loss_diff:.3e}, tol {RESNET_FIRST_LOSS_TOL}); last "
          f"{r['last_loss']:.5f}; flash launches {tuple(r['launches'])}",
          flush=True)
    check(r["finite"] and loss_diff <= RESNET_FIRST_LOSS_TOL
          and r["left"] == 0,
          f"data-train: ResNet first loss {r['first_loss']} (driver "
          f"{resnet_want}), {r['left']} batches left")
    check(tuple(r["launches"]) == (0, 0, 0, 0),
          f"data-train: the ResNet step launched {r['launches']}")
    after = _loaded_formats()
    print(f"[data-train] pyarrow, pandas, PIL loaded: driver before "
          f"{loaded}, after {after}; gang worker before "
          f"{end['loaded_before']}, after {end['loaded_after']}", flush=True)
    check(not after and not end["loaded_before"] and
          not end["loaded_after"],
          f"data-train: optional formats loaded: driver {after}, worker "
          f"{end['loaded_after']}")
    deadline = time.monotonic() + 30
    left = _session_processes()
    segs = [f for f in os.listdir("/dev/shm")
            if any(f.startswith(p) for p in prefixes)]
    apps = _compute_apps()
    while (left or segs or len(apps) > len(apps_before)) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
        apps = _compute_apps()
    during = lm[-1]["contexts"]
    print(f"[data-train] after shutdown: session processes {left}, "
          f"segments {segs}, card contexts {len(apps)} (before the phase "
          f"{len(apps_before)}, with the gang worker {during})", flush=True)
    check(during > len(apps_before),
          "data-train: nvidia-smi lists no context for the gang worker")
    check(not left and not segs and len(apps) <= len(apps_before),
          f"data-train: left processes {left}, segments {segs}, contexts "
          f"{apps}")
    seconds = time.perf_counter() - t_phase
    print(f"[data-train] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=launches, losses=losses, driver_losses=want,
                loss_diffs=diffs, step_ms=step_ms,
                gang_step_ms=gang["step_ms"],
                ratio=step_ms / gang["step_ms"], tokens_per_s=tokens_per_s,
                mfu=mfu, wait_ms=waits, first_report_s=first_report_s,
                fit_s=fit_s, pipeline={
                    "documents": len(docs), "bytes": text_bytes,
                    "rows": n_rows, "seconds": pipe_s,
                    "input_tokens_per_s": in_tokens / pipe_s},
                feed={k: drain[k] for k in ("rows", "seconds", "rows_per_s",
                                            "mb_per_s")},
                resnet={k: r[k] for k in ("step_ms", "images_per_s",
                                          "first_loss", "last_loss",
                                          "fetch_ms", "copy_ms",
                                          "idle_copies_ms")},
                resnet_driver_first_loss=resnet_want,
                resnet_gang_images_per_s=gang["resnet"]["images_per_s"],
                resnet_ratio=ratio, image_mb=image_bytes / 1e6,
                seconds=seconds)


# ---------------------------------------------------------------------------
# phase 30: serve on the cluster runtime, the flagship in a GPU replica
# ---------------------------------------------------------------------------

SC_SEED = 24               # phase 24's prompts and weights
SC_COMPILED_CALLS = 1      # LM calls through each handle
SC_DOUBLER_CALLS = 100     # round trips a handle, in 4 turns (cut from
                           # 200, PERF.md §6)
SC_RECOVERY_S = 300


def _weights_digest(params):
    """(sum, sum of squares) of every weight, in f64 on its device."""
    leaves = [v.double() for _, v in _named_leaves(params)]
    return (torch.stack([t.sum() for t in leaves]).sum().item(),
            torch.stack([t.square().sum() for t in leaves]).sum().item())


@serve.deployment(name="lm", num_replicas=1, route_prefix="/generate",
                  ray_actor_options={"num_gpus": 1}, init_grace_s=300.0)
class ServeLM:
    """Phase 24's deployment in a replica process that leases the card:
    the flagship's weights drawn on the replica's card from ``seed``, one
    ``@serve.batch`` method that left-pads the prompts and calls
    ``generate``, recording each batch."""

    def __init__(self, seed, new):
        import os
        import threading

        from ray_tpu_torch.models import transformer_init
        t_init = time.time()
        t0 = time.perf_counter()
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.cfg, self.new = flagship_cfg(), new
        self.params = transformer_init(
            torch.Generator(device="cuda").manual_seed(seed), self.cfg)
        torch.cuda.synchronize()
        self.start = {"pid": os.getpid(), "t_init": t_init,
                      "cuda_s": t1 - t0,
                      "weights_s": time.perf_counter() - t1,
                      "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
        self.batches = []
        self.lock = threading.Lock()

    @serve.batch(max_batch_size=HTTP_CLIENTS,
                 batch_wait_timeout_s=HTTP_BATCH_WAIT_S)
    def generate_batch(self, prompts):
        from ray_tpu_torch.models import generate
        width = max(len(p) for p in prompts)
        arr = np.zeros((len(prompts), width), np.int64)
        for i, p in enumerate(prompts):
            arr[i, width - len(p):] = p
        with self.lock:
            self.batches.append(arr)
            return generate(self.params, torch.from_numpy(arr), self.cfg,
                            max_new_tokens=self.new).tolist()

    def __call__(self, prompt=None):
        return {"tokens": self.generate_batch(prompt)}

    def info(self):
        return self.start

    def recorded(self, reset=False):
        """(batches, flash launches (fwd, dkv, dq, delta), weight digest);
        with ``reset`` both start again from nothing."""
        from ray_tpu_torch.ops import flash
        with self.lock:
            out = (self.batches, (flash.launches, flash.bwd_dkv_launches,
                                  flash.bwd_dq_launches,
                                  flash.bwd_delta_launches),
                   _weights_digest(self.params))
            if reset:
                self.batches = []
                _reset_launch_counts()
        return out

    def die(self):
        import os
        os._exit(1)


@serve.deployment(name="doubler", num_replicas=1)
class SmokeDoubler:
    def __call__(self, x):
        return x * 2


def _direct_mismatches(params, cfg, new, batches, answers, direct=None):
    """Answers that differ from a direct ``generate`` of their batch (one
    ``generate`` for each distinct batch, kept in ``direct``)."""
    from ray_tpu_torch.models import generate
    bad, direct = 0, {} if direct is None else direct
    for b in batches:
        key = (b.shape, b.tobytes())
        if key not in direct:   # a read-only view of the store: copy it
            direct[key] = generate(params, torch.from_numpy(np.array(b)),
                                   cfg, max_new_tokens=new).tolist()
        bad += sum(answers[tuple(row)] != w
                   for row, w in zip(b.tolist(), direct[key]))
    return bad


def _until_200(url, prompt, limit_s):
    """POST ``prompt`` until it answers 200: (body, seconds, failures).
    At the limit, print the last answer's status and body, the serve
    controller's status and the conductor's actor and node tables, and
    return a body of None."""
    t0 = time.perf_counter()
    failures, last = 0, None
    while time.perf_counter() - t0 < limit_s:
        code, body, _ = _post_json(url, {"prompt": prompt}, timeout=600)
        if code == 200:
            return body, time.perf_counter() - t0, failures
        failures, last = failures + 1, (code, body)
        time.sleep(0.25)
    _print_serve_state("serve-cluster", f"no 200 in {limit_s} s "
                       f"({failures} answers, the last {last!r:.300})")
    return None, time.perf_counter() - t0, failures


def _print_serve_state(tag, why):
    """What the cluster holds when a replica does not come back: the
    controller's status and the conductor's actors and nodes (each part
    that cannot be read is printed as its error)."""
    from ray_tpu_torch import state

    def read(fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - printing what can be read
            return f"unreadable: {type(e).__name__}: {e}"

    print(f"[{tag}] {why}; serve.status() {read(serve.status)}", flush=True)
    actors = read(state.list_actors)
    for a in actors if isinstance(actors, list) else [actors]:
        print(f"[{tag}]   actor {a}", flush=True)
    nodes = read(state.list_nodes)
    for n in nodes if isinstance(nodes, list) else [nodes]:
        print(f"[{tag}]   node {n}", flush=True)


def phase_serve_cluster(card, http_run, cgraph_run):
    """Phase 30: serve's controller, proxy and replicas in worker
    processes, the flagship in a ``num_gpus=1`` replica, over HTTP, through
    the compiled handle, and replaced after its process dies."""
    import concurrent.futures
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.dag import channel
    from ray_tpu_torch.models import transformer_init
    t_phase = time.perf_counter()
    cfg, prompt_len, new = flagship_cfg(), 128, HTTP_NEW
    prompts = np.random.default_rng(SC_SEED).integers(
        0, cfg.vocab_size, (HTTP_ROUNDS, HTTP_CLIENTS, prompt_len)).tolist()
    params = transformer_init(
        torch.Generator(device="cuda").manual_seed(SC_SEED), cfg)
    digest = _weights_digest(params)
    apps_before = _compute_apps()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    prefixes = [n.store_prefix for n in c.nodes]
    try:
        rt.init(address=c.address)
        try:
            res = rt.cluster_resources()
            check(res.get("GPU") == 1.0,
                  f"serve-cluster: the head counts {res.get('GPU')} GPUs")
            # (a) the flagship over HTTP from the GPU replica
            t_run, wall_run = time.perf_counter(), time.time()
            handle = serve.run(ServeLM.bind(SC_SEED, new),
                               http_host="127.0.0.1")
            # the CPU deployment of (b) starts while the LM replica does
            dh = serve.run(SmokeDoubler.bind())
            start = rt.get(handle.options("info").remote(), timeout=600)
            start_s = time.perf_counter() - t_run
            spawn_s = start["t_init"] - wall_run
            check(start["visible"] == "0" and start["pid"] != os.getpid(),
                  f"serve-cluster: the replica runs in pid {start['pid']} "
                  f"with CUDA_VISIBLE_DEVICES={start['visible']!r}")
            url = f"http://127.0.0.1:{handle.http_port}/generate"
            answers, latencies, timed_s = {}, [], 0.0
            with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
                for r in range(HTTP_ROUNDS):
                    t0 = time.perf_counter()
                    out = list(pool.map(lambda p: _post_json(
                        url, {"prompt": p}), prompts[r]))
                    if r:
                        timed_s += time.perf_counter() - t0
                        latencies += [sec for _, _, sec in out]
                    codes = [code for code, _, _ in out]
                    check(codes == [200] * HTTP_CLIENTS,
                          f"serve-cluster round {r}: statuses {codes}")
                    answers.update({tuple(p): body["tokens"] for p, (
                        _, body, _) in zip(prompts[r], out)})
            apps_serving = _compute_apps()
            batches, launches_a, r_digest = rt.get(
                handle.options("recorded").remote(True), timeout=120)
            sizes = [len(b) for b in batches]
            check(r_digest == digest,
                  f"serve-cluster: the replica's weights digest {r_digest} "
                  f"is not the driver's {digest}")
            check(launches_a == (cfg.n_layers * len(batches), 0, 0, 0),
                  f"serve-cluster: the replica launched {launches_a} (fwd, "
                  f"dkv, dq, delta) for {len(batches)} generate calls, want "
                  f"({cfg.n_layers * len(batches)}, 0, 0, 0)")
            seen = [tuple(row) for b in batches for row in b.tolist()]
            check(sorted(seen) == sorted(answers) and len(seen) ==
                  len(answers) == HTTP_ROUNDS * HTTP_CLIENTS,
                  "serve-cluster: the batches do not hold each prompt once")
            bad = _direct_mismatches(params, cfg, new, batches, answers)
            check(bad == 0, f"serve-cluster: {bad} answers differ from the "
                  f"driver's direct generate of their batch")
            check(len(apps_serving) == len(apps_before) + 1,
                  f"serve-cluster: card contexts while serving "
                  f"{apps_serving}, want the driver's and the replica's "
                  f"(before the phase {apps_before})")
            timed = (HTTP_ROUNDS - 1) * HTTP_CLIENTS
            rps = timed / timed_s
            tokens_per_s = rps * new
            p50, p99 = np.percentile(latencies, [50, 99]).tolist()
            print(f"[serve-cluster] flagship bf16 from a num_gpus=1 replica "
                  f"process (pid {start['pid']}, CUDA_VISIBLE_DEVICES "
                  f"{start['visible']!r}): {HTTP_CLIENTS} clients x "
                  f"{HTTP_ROUNDS} rounds (1 warm), all 200; {len(sizes)} "
                  f"generate calls, batch sizes {sizes}; flash launches in "
                  f"the replica {launches_a}; weights digest equal to the "
                  f"driver's; every answer equals a direct generate of its "
                  f"batch", flush=True)
            print(f"[serve-cluster] timed rounds: {rps:.3f} requests/s, "
                  f"{tokens_per_s:.1f} generated tokens/s, latency p50 "
                  f"{p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms; phase 24 "
                  f"in-process {http_run['tokens_per_s']:.1f} tokens/s, "
                  f"ratio {tokens_per_s / http_run['tokens_per_s']:.4f} on "
                  f"{card}", flush=True)
            print(f"[serve-cluster] replica start {start_s:.2f} s from "
                  f"serve.run to its first answer: spawn {spawn_s:.2f} s, "
                  f"CUDA context {start['cuda_s']:.2f} s, weights "
                  f"{start['weights_s']:.2f} s; card contexts while serving "
                  f"{len(apps_serving)} (before the phase "
                  f"{len(apps_before)})", flush=True)

            # (b) the compiled handle, then a CPU deployment's round trips
            chandle = serve.run(ServeLM.bind(SC_SEED, new), compile=True)
            calls = [p for p in prompts[0][:SC_COMPILED_CALLS]]
            t0 = time.perf_counter()
            compiled_toks = [
                rt.get(chandle.remote(p), timeout=600)["tokens"]
                for p in calls]
            compiled_s = (time.perf_counter() - t0) / len(calls)
            executions = sum(cg._next_seq for cg in chandle._cgraphs.values())
            check(chandle._cgraphs and executions == len(calls),
                  f"serve-cluster: the compiled path was not taken "
                  f"({len(chandle._cgraphs)} graphs, {executions} "
                  f"executions for {len(calls)} calls)")
            t0 = time.perf_counter()
            classic_toks = [rt.get(handle.remote(p), timeout=600)["tokens"]
                            for p in calls]
            classic_s = (time.perf_counter() - t0) / len(calls)
            check(compiled_toks == classic_toks,
                  "serve-cluster: the compiled handle's tokens differ from "
                  "the classic handle's")
            chandle.teardown_compiled()
            after = rt.get(chandle.remote(calls[0]), timeout=600)["tokens"]
            check(not chandle._cgraphs and after == classic_toks[0],
                  "serve-cluster: after teardown_compiled() the classic path "
                  "answers otherwise")
            batches_b, launches_b, _ = rt.get(
                handle.options("recorded").remote(True), timeout=120)
            check(launches_b == (cfg.n_layers * len(batches_b), 0, 0, 0)
                  and len(batches_b) == 2 * len(calls) + 1,
                  f"serve-cluster: {len(batches_b)} batches and launches "
                  f"{launches_b} for the handles' {2 * len(calls) + 1} calls")
            single = {}   # (c) sends calls[0] alone again
            bad = _direct_mismatches(
                params, cfg, new, batches_b,
                {tuple(p): t for p, t in zip(calls, classic_toks)}, single)
            check(bad == 0, f"serve-cluster: {bad} handle answers differ "
                  f"from the driver's direct generate")
            dch = serve.run(SmokeDoubler.bind(), compile=True)
            rt.get(dh.remote(0), timeout=60)
            rt.get(dch.remote(0), timeout=60)
            turn = SC_DOUBLER_CALLS // 4
            spent = {"classic": 0.0, "compiled": 0.0}
            wrong = 0
            for k in range(4):
                for label, h in (("classic", dh), ("compiled", dch)):
                    t0 = time.perf_counter()
                    got = [rt.get(h.remote(i), timeout=60)
                           for i in range(k * turn, (k + 1) * turn)]
                    spent[label] += time.perf_counter() - t0
                    wrong += sum(g != 2 * i for g, i in zip(
                        got, range(k * turn, (k + 1) * turn)))
            d_execs = sum(cg._next_seq for cg in dch._cgraphs.values())
            check(wrong == 0 and d_execs == SC_DOUBLER_CALLS + 1,
                  f"serve-cluster: doubler {wrong} wrong answers, "
                  f"{d_execs} compiled executions")
            dch.teardown_compiled()
            serve.delete("doubler")
            d_rates = {k: SC_DOUBLER_CALLS / v for k, v in spent.items()}
            d_ratio = d_rates["compiled"] / d_rates["classic"]
            cg_ratio = cgraph_run["compiled_rps"]["default slot"] / \
                cgraph_run["classic_rps"]
            print(f"[serve-cluster] compiled handle: LM calls through the "
                  f"replica's graph {len(calls)} ({executions} executions), "
                  f"tokens equal the classic handle's and, after "
                  f"teardown_compiled(), the classic path's; seconds a call "
                  f"{compiled_s:.3f} compiled, {classic_s:.3f} classic (each "
                  f"alone in its @serve.batch window of {HTTP_BATCH_WAIT_S} "
                  f"s)", flush=True)
            print(f"[serve-cluster] doubler (CPU replica) {SC_DOUBLER_CALLS} "
                  f"sequential round trips a handle in 4 turns: classic "
                  f"{d_rates['classic']:.1f}/s, compiled "
                  f"{d_rates['compiled']:.1f}/s, compiled/classic "
                  f"{d_ratio:.3f}; phase 26's graph compiled/classic "
                  f"{cg_ratio:.3f} on {card}", flush=True)

            # (c) the replica's death
            t_kill = time.perf_counter()
            try:
                rt.get(handle.options("die").remote(), timeout=60)
            except Exception:
                pass   # the call dies with the process
            body, recovery_s, failures = _until_200(url, calls[0],
                                                    SC_RECOVERY_S)
            check(body is not None, f"serve-cluster: no 200 within "
                  f"{SC_RECOVERY_S} s of the replica's death")
            recovery_s = time.perf_counter() - t_kill
            start_c = rt.get(handle.options("info").remote(), timeout=120)
            batches_c, launches_c, digest_c = rt.get(
                handle.options("recorded").remote(), timeout=120)
            check(start_c["pid"] != start["pid"] and digest_c == digest
                  and start_c["visible"] == "0",
                  f"serve-cluster: the new replica (pid {start_c['pid']}, "
                  f"old {start['pid']}) has digest {digest_c}")
            check(launches_c == (cfg.n_layers * len(batches_c), 0, 0, 0),
                  f"serve-cluster: the new replica launched {launches_c}")
            bad = _direct_mismatches(params, cfg, new, batches_c,
                                     {tuple(calls[0]): body["tokens"]},
                                     single)
            check(bad == 0, "serve-cluster: the recovered answer differs "
                  "from the driver's direct generate")
            apps_after = _compute_apps()
            deadline = time.monotonic() + 30
            while len(apps_after) != len(apps_before) + 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.2)
                apps_after = _compute_apps()
            check(len(apps_after) == len(apps_before) + 1,
                  f"serve-cluster: card contexts after the recovery "
                  f"{apps_after} (before the phase {apps_before})")
            print(f"[serve-cluster] replica death (os._exit in pid "
                  f"{start['pid']}): first 200 {recovery_s:.2f} s after the "
                  f"kill ({failures} non-200 answers meanwhile) from the new "
                  f"replica pid {start_c['pid']} (CUDA context "
                  f"{start_c['cuda_s']:.2f} s, weights "
                  f"{start_c['weights_s']:.2f} s); the answer equals the "
                  f"driver's; card contexts {len(apps_after)}", flush=True)
        finally:
            serve.shutdown()
            rt.shutdown()
    finally:
        c.shutdown()
    deadline = time.monotonic() + 30
    while True:
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
        rings = channel.leaked_segments(prefixes)
        apps = _compute_apps()
        if not (left or segs or rings or len(apps) > len(apps_before)) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    print(f"[serve-cluster] after shutdown: session processes {left}, "
          f"segments {segs}, channel segments {rings}, card contexts "
          f"{len(apps)} (before the phase {len(apps_before)})", flush=True)
    check(not left and not segs and not rings
          and len(apps) <= len(apps_before),
          f"serve-cluster: left processes {left}, segments {segs}, rings "
          f"{rings}, contexts {apps}")
    del params
    torch.cuda.empty_cache()
    launches = tuple(a + b + c_ for a, b, c_ in zip(launches_a, launches_b,
                                                     launches_c))
    seconds = time.perf_counter() - t_phase
    print(f"[serve-cluster] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=launches, batch_sizes=sizes, requests_per_s=rps,
                tokens_per_s=tokens_per_s, p50_ms=p50 * 1e3,
                p99_ms=p99 * 1e3,
                ratio_to_http_serve=tokens_per_s / http_run["tokens_per_s"],
                start_s=start_s, spawn_s=spawn_s, cuda_s=start["cuda_s"],
                weights_s=start["weights_s"],
                contexts_serving=len(apps_serving),
                contexts_before=len(apps_before),
                compiled_call_s=compiled_s, classic_call_s=classic_s,
                doubler_rps=d_rates, doubler_ratio=d_ratio,
                cgraph_ratio=cg_ratio, recovery_s=recovery_s,
                recovery_failures=failures, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 31: the RL drivers on the port's cluster runtime
# ---------------------------------------------------------------------------

RLC_ASYNC_ITERS = 2       # IMPALA and APPO iterations on the cluster
                          # (cut from 3, PERF.md §6)


class SlowCartPole(CartPoleVectorEnv):
    """CartPole at 100 ms a step: a worker's first sample is still in flight
    when phase 31 stops the driver (module level: the workers import it by
    path)."""

    def vector_step(self, actions):
        time.sleep(0.1)
        return super().vector_step(actions)


def _sampler_wheres(rt, actors, tag):
    """``where()`` of each sampling actor; each must be a worker process of
    its own that sees no card, made no CUDA context and samples on the CPU
    with one torch thread."""
    import os
    infos = rt.get([a.where.remote() for a in actors], timeout=300)
    pids = {i["pid"] for i in infos}
    check(len(pids) == len(infos) and os.getpid() not in pids
          and all((i["visible"], i["cuda_initialized"], i["device"],
                   i["threads"]) == ("", False, "cpu", 1) for i in infos),
          f"[{tag}] the samplers are not CPU worker processes: {infos}")
    return infos


def _alive_of(c, ids):
    return [a["actor_id"] for a in c.conductor.rpc_list_actors()
            if a["state"] == "ALIVE" and a["actor_id"] in ids]


def _until_empty(probe, limit_s=30.0):
    deadline = time.monotonic() + limit_s
    got = probe()
    while got and time.monotonic() < deadline:
        time.sleep(0.1)
        got = probe()
    return got


def _ppo_on_cluster(rt, algo, tag, card):
    """PPO to phase 13's gate on the cluster -> its rate, iteration and
    sample/update medians, with the samplers' placement checked."""
    spent = _time_driver_parts(algo)
    results, best, rewards = _train_to(algo, PPO_GATE, PPO_ITERS, tag)
    _sampler_wheres(rt, algo.workers.workers, tag)
    for r in results:
        _check_finite_info(r, tag)
    steps, rate = _rate(results, "num_env_steps_sampled")
    _, later_rate = _rate(results[1:], "num_env_steps_sampled")
    out = dict(iterations=len(results), env_steps=steps,
               env_steps_per_s=rate, later_env_steps_per_s=later_rate,
               first_iteration_s=results[0]["time_this_iter_s"],
               iteration_ms=1e3 * float(np.median(
                   [r["time_this_iter_s"] for r in results])),
               sample_ms=1e3 * float(np.median(spent["sample"])),
               update_ms=1e3 * float(np.median(spent["update"])),
               best_reward=best, rewards=rewards)
    print(f"[{tag}] gate met at iteration {out['iterations']} (best "
          f"{best:.2f}); {steps} env steps, {rate:.1f} env steps/s "
          f"({later_rate:.1f} after the first iteration, which took "
          f"{out['first_iteration_s']:.2f} s); median iteration "
          f"{out['iteration_ms']:.1f} ms (sample {out['sample_ms']:.1f}, "
          f"update {out['update_ms']:.1f}); rewards {rewards} on {card}",
          flush=True)
    return out


def phase_rl_cluster(card, drivers_run, cpu_workers_run):
    """Phase 31: the RL drivers on a port ``Cluster`` whose head counts the
    card: rollout workers, collectors and ES workers as CPU worker
    processes, the learner on the card in the driver or in a GPU worker
    process."""
    import os

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster.cluster_utils import Cluster
    from ray_tpu_torch.dag import channel
    from ray_tpu_torch.rl.algorithms import (APPOConfig, DQNConfig,
                                             ESConfig, ImpalaConfig,
                                             TD3Config)
    from ray_tpu_torch.rl.learner import _named_leaves
    t_phase = time.perf_counter()
    tag = "rl-cluster"
    out = {}
    apps_before = _compute_apps()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    prefixes = [n.store_prefix for n in c.nodes]
    _reset_launch_counts()
    try:
        rt.init(address=c.address)
        try:
            res = rt.cluster_resources()
            check(res.get("GPU") == 1.0 and res.get("CPU") == 4.0,
                  f"[{tag}] the head counts {res}")
            # (a) the learner on the card in the driver
            algo = _gate_config().build()
            check(str(algo.learner_group.local.device).startswith("cuda"),
                  f"[{tag}] the driver's learner is on "
                  f"{algo.learner_group.local.device}")
            out["local"] = _ppo_on_cluster(rt, algo, tag + " local", card)
            algo.stop()
            n, local = out["local"]["iterations"], out["local"]
            hand = _hand_over(cpu_workers_run, n)
            local["vs_drivers"] = (local["env_steps_per_s"]
                                   / drivers_run["env_steps_per_s"])
            local["vs_cpu_hand_loop"] = (local["env_steps_per_s"]
                                         / hand["env_steps_per_s"])
            local["median_vs_drivers"] = (drivers_run["iteration_ms"]
                                          / local["iteration_ms"])
            local["median_vs_cpu_hand_loop"] = (hand["iteration_ms"]
                                                / local["iteration_ms"])
            print(f"[{tag}] same call: phase 16's in-process drivers "
                  f"{drivers_run['env_steps_per_s']:.1f} env steps/s "
                  f"(median iteration {drivers_run['iteration_ms']:.1f} ms: "
                  f"sample {drivers_run['sample_ms']:.1f}, update "
                  f"{drivers_run['update_ms']:.1f}); phase 13's hand loop "
                  f"with CPU workers over its first {n} iterations "
                  f"{hand['env_steps_per_s']:.1f} env steps/s (median "
                  f"iteration {hand['iteration_ms']:.1f} ms: sample "
                  f"{hand['sample_ms']:.1f}, update {hand['update_ms']:.1f})"
                  f". Cluster / in-process drivers: env steps/s "
                  f"{local['vs_drivers']:.4f}, by median iteration "
                  f"{local['median_vs_drivers']:.4f}; cluster / CPU hand "
                  f"loop: {local['vs_cpu_hand_loop']:.4f}, by median "
                  f"iteration {local['median_vs_cpu_hand_loop']:.4f}",
                  flush=True)

            # (b) the learner in a num_gpus=1 worker process
            config = _gate_config(learner_remote=True, learner_num_gpus=1)
            t0 = time.perf_counter()
            algo = config.build()     # waits for the learner's first weights
            build_s = time.perf_counter() - t0
            learner_id = algo.learner_group.actor.actor_id.hex()
            out["remote"] = _ppo_on_cluster(rt, algo, tag + " remote", card)
            out["remote"]["build_s"] = build_s
            apps_training = _compute_apps()
            check(len(apps_training) == len(apps_before) + 1,
                  f"[{tag}] card contexts with the remote learner "
                  f"{apps_training}, want the driver's and the learner's "
                  f"(before the phase {apps_before})")
            check(learner_id in _alive_of(c, {learner_id}),
                  f"[{tag}] the remote learner is not an ALIVE actor")
            out["remote"]["vs_local"] = (out["remote"]["env_steps_per_s"]
                                         / out["local"]["env_steps_per_s"])
            out["remote"]["median_vs_local"] = (
                out["local"]["iteration_ms"] / out["remote"]["iteration_ms"])
            out["remote"]["contexts"] = len(apps_training)
            import tempfile
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = algo.save(tmp)
                want = _named_leaves(algo.get_state()["weights"])
                iteration = algo.iteration
                algo.stop()
                fresh = _gate_config().build()
                fresh.restore(ckpt)
            got = _named_leaves(fresh.get_state()["weights"])
            same = [k in got and got[k].tobytes() == v.tobytes()
                    for k, v in want.items()]
            check(len(same) == 12 and all(same)
                  and fresh.iteration == iteration,
                  f"[{tag}] restore from the remote learner: {sum(same)} of "
                  f"{len(same)} leaves equal, iteration {fresh.iteration} "
                  f"(saved {iteration})")
            fresh.stop()
            print(f"[{tag}] learner in a num_gpus=1 worker process: card "
                  f"contexts while training {len(apps_training)} (before "
                  f"the phase {len(apps_before)}); remote / driver learner: "
                  f"env steps/s {out['remote']['vs_local']:.4f}, by median "
                  f"iteration {out['remote']['median_vs_local']:.4f}; "
                  f"build() {build_s:.2f} "
                  f"s (the learner's worker spawned); save -> a fresh "
                  f"build() with the learner in the driver -> restore: 12 "
                  f"of 12 leaves bitwise equal at iteration {iteration}",
                  flush=True)

            # (c) IMPALA and APPO, then stop() with samples in flight
            for name, config in (
                    ("impala", _async_config(ImpalaConfig,
                                             train_batch_size=512)),
                    ("appo", _async_config(APPOConfig, train_batch_size=1024,
                                           lr=5e-4))):
                algo = config.build()
                # the workers are up (where() waits behind the first sample)
                _sampler_wheres(rt, algo.workers.workers, f"{tag} {name}")
                waits = []
                with _timed_calls(rt, "wait", waits):
                    results = [algo.train() for _ in range(RLC_ASYNC_ITERS)]
                for r in results:
                    _check_finite_info(r, f"{tag} {name}")
                algo.stop()
                steps, rate = _rate(results, "num_env_steps_sampled")
                secs = sum(r["time_this_iter_s"] for r in results)
                out[name] = dict(iterations=RLC_ASYNC_ITERS, env_steps=steps,
                                 env_steps_per_s=rate,
                                 wait_share=sum(waits) / secs)
                # a fresh build's first samples are in flight at once
                slow = config.copy()
                slow.env = SlowCartPole
                algo = slow.build()
                ids = {w.actor_id.hex() for w in algo.workers.workers}
                refs = list(algo._inflight)
                algo.stop()
                died = []
                for ref in refs:
                    try:
                        rt.get(ref, timeout=120)
                        died.append(False)
                    except rt.ActorDiedError:
                        died.append(True)
                    except rt.TaskError as e:
                        died.append(isinstance(e.cause, rt.ActorDiedError))
                left = _until_empty(lambda: _alive_of(c, ids))
                check(len(refs) == 2 and all(died) and not left,
                      f"[{tag} {name}] stop() with samples in flight: refs "
                      f"died {died}, ALIVE left {left}")
                print(f"[{tag} {name}] {RLC_ASYNC_ITERS} iterations, {steps} "
                      f"env steps, {rate:.1f} env steps/s, share of the "
                      f"driver's time in rt.wait "
                      f"{out[name]['wait_share']:.4f}; stop() with 2 samples "
                      f"in flight: both refs fail as dead-actor errors, no "
                      f"actor ALIVE", flush=True)

            # (d) DQN, TD3 and ES: one iteration each
            dqn = (DQNConfig().environment("CartPole-v1")
                   .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                             rollout_fragment_length=32))
            dqn.learning_starts = 128
            td3 = (TD3Config().environment("Pendulum-v1")
                   .rollouts(num_rollout_workers=1, num_envs_per_worker=8,
                             rollout_fragment_length=64))
            td3.learning_starts = 256
            es = ESConfig().rollouts(num_rollout_workers=2)
            es.num_perturbations, es.episode_horizon = 4, 50
            for name, config, samplers, keys in (
                    ("dqn", dqn, lambda a: a.collectors,
                     ("info/td_loss", "epsilon")),
                    ("td3", td3, lambda a: a.collectors,
                     ("critic_loss", "actor_loss")),
                    ("es", es, lambda a: a.workers,
                     ("episode_reward_mean", "info/grad_norm"))):
                algo = config.build()
                t0 = time.perf_counter()
                result = algo.train()
                secs = time.perf_counter() - t0
                _sampler_wheres(rt, samplers(algo), f"{tag} {name}")
                algo.stop()
                nums = {k: float(result.get(k, float("nan"))) for k in keys}
                check(all(np.isfinite(v) for v in nums.values()),
                      f"[{tag} {name}] non-finite result {nums}")
                out[name] = dict(seconds=secs, result=nums)
                print(f"[{tag} {name}] one train() on the cluster in "
                      f"{secs:.2f} s: {nums}", flush=True)
            left = _until_empty(lambda: [
                a["class_name"] for a in c.conductor.rpc_list_actors()
                if a["state"] == "ALIVE"])
            check(not left, f"[{tag}] actors ALIVE after every stop(): "
                            f"{left}")
        finally:
            rt.shutdown()
    finally:
        c.shutdown()
    deadline = time.monotonic() + 30
    while True:
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
        rings = channel.leaked_segments(prefixes)
        apps = _compute_apps()
        if not (left or segs or rings or len(apps) > len(apps_before)) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    print(f"[{tag}] after shutdown: session processes {left}, segments "
          f"{segs}, channel segments {rings}, card contexts {len(apps)} "
          f"(before the phase {len(apps_before)})", flush=True)
    check(not left and not segs and not rings
          and len(apps) <= len(apps_before),
          f"[{tag}] left processes {left}, segments {segs}, rings {rings}, "
          f"contexts {apps}")
    out["launches"] = _launch_counts()
    check(out["launches"] == (0, 0, 0, 0),
          f"[{tag}] the RL drivers launched flash kernels {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] flash launches {out['launches']}; phase seconds "
          f"{out['seconds']:.1f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 32: the head's control surface
# ---------------------------------------------------------------------------

CS_SEED = 32              # the weights and the prompts
CS_BATCH, CS_PROMPT = 8, 128
CS_NEW = 32               # new tokens, cut from phase 3's 256 (PERF.md)
CS_ROUND_TRIPS = 100      # trivial tasks through the client, one at a
                          # time (cut from 200, PERF.md §6)
CS_LIMIT_S = 600          # any one CLI command, client or job


def token_digest(tokens):
    """A short hash of greedy tokens (int64, C order)."""
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(tokens), dtype=np.int64).tobytes()).hexdigest()[:16]


def _control_generate(params, cfg, prompt, new):
    """One warm-up, then the counted, timed ``generate``: (tokens, flash
    launches (fwd, dkv, dq, delta), tokens/s in this process)."""
    from ray_tpu_torch.models import generate
    prompt = torch.from_numpy(np.array(prompt)).cuda()
    generate(params, prompt, cfg, max_new_tokens=4)
    torch.cuda.synchronize()
    _reset_launch_counts()
    t0 = time.perf_counter()
    tokens = generate(params, prompt, cfg, max_new_tokens=new)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (tokens.cpu().numpy(), _launch_counts(),
            prompt.shape[0] * new / seconds)


def _control_weights(seed):
    """Phase 3's flagship drawn on this process's card from ``seed``, and
    the wall clock at the start and the seconds of CUDA and the weights."""
    import os

    from ray_tpu_torch.models import transformer_init
    started = time.time()
    t0 = time.perf_counter()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    cfg = flagship_cfg()
    params = transformer_init(torch.Generator(device="cuda").manual_seed(seed),
                              cfg)
    torch.cuda.synchronize()
    return cfg, params, {"started": started, "pid": os.getpid(),
                         "cuda_and_weights_s": time.perf_counter() - t0}


class ControlLM:
    """The flagship in a ``num_gpus=1`` actor that a ``client://`` driver
    creates (the client imports this module as ``chip_smoke``)."""

    def __init__(self, seed):
        self.cfg, self.params, self.start = _control_weights(seed)

    def generate(self, prompt, new):
        return _control_generate(self.params, self.cfg, prompt, new) + (
            self.start,)


def control_generate_task(seed, prompt, new):
    """A submitted job's ``num_gpus=1`` task: the weights, then the same
    ``generate``."""
    cfg, params, start = _control_weights(seed)
    return _control_generate(params, cfg, prompt, new) + (start,)


def control_echo(x):
    return x


_CS_CLIENT = """
import json
import pickle
import sys
import time

import numpy as np

import chip_smoke as cs
import ray_tpu_torch as rt
from ray_tpu_torch.client import common
from ray_tpu_torch.cluster.protocol import get_client

if __name__ == "__main__":
    t0 = time.perf_counter()
    rt.init(address="client://" + sys.argv[1])
    connect_s = time.perf_counter() - t0
    prompt = np.load(sys.argv[2])
    # first a num_gpus=1 task named by import path, as a client in another
    # language sends it: its own session on the proxy's wire, no function
    # blob; the proxy imports the function and pickles it for the workers.
    # Its GPU worker goes back to the pool, where the actor below finds it.
    wire = get_client(sys.argv[1])
    sess = wire.call("cp_connect", meta={"client": "import_path"})["session"]
    submitted = time.time()
    t0 = time.perf_counter()
    resp = wire.call("cp_task", session=sess, desc=None, blob=None,
                     args_blob=pickle.dumps(
                         ([cs.CS_SEED, prompt, cs.CS_NEW], {})),
                     opts={"num_gpus": 1},
                     import_path="chip_smoke:control_generate_task")
    assert resp["ok"], resp["error"]
    oids = [m[1] for m in common.loads(resp["refs"], tuple)]
    got = wire.call("cp_get", session=sess, oids=oids,
                    timeout=cs.CS_LIMIT_S, _timeout=cs.CS_LIMIT_S + 30)
    assert got["ok"], got["error"]
    ip_tokens, ip_launches, ip_tps, ip_start = common.loads(
        got["values"][0], tuple)
    import_s = time.perf_counter() - t0
    wire.call("cp_disconnect", session=sess)
    np.save(sys.argv[4], ip_tokens)
    created = time.time()
    t0 = time.perf_counter()
    actor = rt.remote(num_gpus=1)(cs.ControlLM).remote(cs.CS_SEED)
    tokens, launches, tps, start = rt.get(
        actor.generate.remote(prompt, cs.CS_NEW), timeout=cs.CS_LIMIT_S)
    first_s = time.perf_counter() - t0
    echo = rt.remote(cs.control_echo)
    rt.get(echo.remote(0), timeout=120)
    t0 = time.perf_counter()
    for i in range(cs.CS_ROUND_TRIPS):
        assert rt.get(echo.remote(i), timeout=120) == i
    trips = cs.CS_ROUND_TRIPS / (time.perf_counter() - t0)
    np.save(sys.argv[3], tokens)
    print("CLIENT " + json.dumps({
        "actor_id": actor.actor_id.hex(), "launches": list(launches),
        "tokens_per_s": tps, "connect_s": connect_s, "first_call_s": first_s,
        "spawn_s": start["started"] - created,
        "cuda_and_weights_s": start["cuda_and_weights_s"],
        "pid": start["pid"], "round_trips_per_s": trips,
        "import_path": {
            "launches": list(ip_launches), "tokens_per_s": ip_tps,
            "call_s": import_s, "spawn_s": ip_start["started"] - submitted,
            "cuda_and_weights_s": ip_start["cuda_and_weights_s"],
            "pid": ip_start["pid"]}}), flush=True)
    rt.kill(actor)
    rt.shutdown()
"""

_CS_JOB = """
import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs
import ray_tpu_torch as rt

if __name__ == "__main__":
    rt.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])
    prompt = np.load(sys.argv[1])
    submitted = time.time()
    t0 = time.perf_counter()
    tokens, launches, tps, start = rt.get(
        rt.remote(num_gpus=1)(cs.control_generate_task).remote(
            cs.CS_SEED, prompt, cs.CS_NEW), timeout=cs.CS_LIMIT_S)
    print("JOB " + json.dumps({
        "digest": cs.token_digest(tokens), "launches": list(launches),
        "tokens_per_s": tps, "first_call_s": time.perf_counter() - t0,
        "spawn_s": start["started"] - submitted,
        "cuda_and_weights_s": start["cuda_and_weights_s"],
        "pid": start["pid"]}), flush=True)
    rt.shutdown()
"""


def _cli(env, *argv):
    """``python -m ray_tpu_torch <argv>``, which must exit 0: its stdout."""
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *argv],
                         env=env, capture_output=True, text=True,
                         timeout=CS_LIMIT_S, cwd=env["CS_REPO"])
    check(out.returncode == 0, f"control: `{' '.join(argv)}` exited "
          f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return out.stdout


def _cli_start(env, want, *argv):
    """A long-running ``python -m ray_tpu_torch <argv>``, its output up to
    the line that holds ``want``, and the seconds until that line."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "ray_tpu_torch", *argv],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=env["CS_REPO"])
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line or time.perf_counter() - t0 > CS_LIMIT_S:
            proc.kill()
            proc.wait()
            check(False, f"control: `{' '.join(argv)}` printed no "
                  f"{want!r}:\n{''.join(lines)[-3000:]}")
        lines.append(line)
        if want in line:
            return proc, lines, time.perf_counter() - t0


def _tagged(text, tag):
    """The JSON object of the line that starts with ``tag``."""
    for line in text.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    check(False, f"control: no {tag} line in:\n{text[-3000:]}")


def _until_clean(prefixes, apps_before, limit_s=30.0):
    """Wait until no process of the port's clusters, no store segment of
    ``prefixes`` and no extra card context is left."""
    import os
    deadline = time.monotonic() + limit_s
    while True:
        left = _session_processes()
        segs = [f for f in os.listdir("/dev/shm")
                if any(f.startswith(p) for p in prefixes)]
        apps = _compute_apps()
        if not (left or segs or len(apps) > len(apps_before)) \
                or time.monotonic() > deadline:
            return left, segs, apps
        time.sleep(0.2)


def domain_view(card, daemon, conductor, tag):
    """The card's NVLink domain as the head's daemon detected it
    (``gpu/topology.py:detect_domain``) and the conductor's domain view
    (``get_slices``): the domain's type must name the card's generation and
    count the visible cards, and the view must hold it, complete, with the
    head as its one host."""
    from ray_tpu_torch.gpu import topology
    from ray_tpu_torch.gpu.topology import DomainSpec
    t0 = time.perf_counter()
    texts = [topology._smi(*args) for args in (
        ("--query-gpu=index,uuid,name", "--format=csv,noheader"),
        ("topo", "-m"), ("-q",))]
    smi_s = time.perf_counter() - t0
    dom = daemon.gpu_domain
    slices = conductor.call("get_slices")
    shown = [{**s, "node_ids": [n.hex()[:8] for n in s["node_ids"]]}
             for s in slices]
    print(f"[{tag}] the head's NVLink domain (detect_domain, in the "
          f"daemon's start): {dom}; the conductor's get_slices(): {shown}"
          f"; what a detection costs a daemon's start: nvidia-smi's list, "
          f"topo -m and -q {smi_s:.2f} s ({[len(t) for t in texts]} bytes) "
          f"on {card}", flush=True)
    check(dom is not None, f"[{tag}] the head reports no NVLink domain")
    spec = DomainSpec.parse(dom["accelerator_type"])
    name = torch.cuda.get_device_name(0).lower()
    check(spec.generation in name
          and spec.num_gpus == torch.cuda.device_count(),
          f"[{tag}] domain {dom['accelerator_type']} against the card "
          f"{name!r} and {torch.cuda.device_count()} visible")
    check([(s["slice_id"], s["accelerator_type"], s["complete"],
            s["node_ids"]) for s in slices]
          == [(dom["slice_id"], dom["accelerator_type"], True,
               [daemon.node_id])],
          f"[{tag}] get_slices() {slices} against the head's {dom}")
    return dom, smi_s


def phase_control_surface(card):
    """Phase 32: ``init()`` starts a head; then a head from the CLI drives
    the flagship on the card through a ``client://`` driver and a submitted
    job, read back through the state API, the dashboard and the CLI."""
    import os
    import shutil
    import tempfile
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.models import generate, transformer_init
    tag, steps = "control", {}
    t_phase = time.perf_counter()
    apps_before = _compute_apps()

    # 1. init() without an address starts a head in this process
    t0 = time.perf_counter()
    head = rt.init()
    try:
        steps["init_head_s"] = time.perf_counter() - t0
        res = rt.cluster_resources()
        nodes = state.list_nodes()
        prefix = head._owned_daemon.store_prefix
        print(f"[{tag}] init() started a head in {steps['init_head_s']:.2f} "
              f"s: cluster_resources() {res}; list_nodes() "
              f"{[(n['state'], n['is_head_node'], n['resources_total']) for n in nodes]}"
              f" on {card}", flush=True)
        check(type(head).__name__ == "ClusterRuntime"
              and res.get("GPU") == 1.0, f"[{tag}] init() gave "
              f"{type(head).__name__} counting {res.get('GPU')} GPUs")
        check(len(nodes) == 1 and nodes[0]["is_head_node"]
              and nodes[0]["state"] == "ALIVE",
              f"[{tag}] list_nodes() after init(): {nodes}")
        domain, steps["detect_domain_s"] = domain_view(
            card, head._owned_daemon, head.conductor, tag)
    finally:
        rt.shutdown()
    left, segs, apps = _until_clean([prefix], apps_before)
    print(f"[{tag}] after shutdown(): session processes {left}, segments "
          f"{segs}", flush=True)
    check(not left and not segs, f"[{tag}] shutdown() of the init() head "
          f"left processes {left}, segments {segs}")

    # the driver's own flagship, prompts and direct generate
    cfg = flagship_cfg()
    params = transformer_init(
        torch.Generator(device="cuda").manual_seed(CS_SEED), cfg)
    prompt = np.random.default_rng(CS_SEED).integers(
        0, cfg.vocab_size, (CS_BATCH, CS_PROMPT))
    gp = torch.from_numpy(prompt).cuda()
    generate(params, gp, cfg, max_new_tokens=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = generate(params, gp, cfg, max_new_tokens=CS_NEW).cpu().numpy()
    d_tps = CS_BATCH * CS_NEW / (time.perf_counter() - t0)
    del params, gp
    torch.cuda.empty_cache()

    repo = os.path.dirname(os.path.abspath(__file__))
    # the CLI's own TMPDIR, short: its sessions' socket paths must fit
    # AF_UNIX's 108 bytes
    work = tempfile.mkdtemp(prefix="cs32")
    env = dict(os.environ, TMPDIR=work, CS_REPO=repo,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    paths = {name: os.path.join(work, name) for name in (
        "client.py", "job.py", "prompt.npy", "client_tokens.npy",
        "import_path_tokens.npy")}
    with open(paths["client.py"], "w") as f:
        f.write(_CS_CLIENT)
    with open(paths["job.py"], "w") as f:
        f.write(_CS_JOB)
    np.save(paths["prompt.npy"], prompt)
    head_proc = proxy_proc = None
    connected = False
    try:
        # 2. a head from the CLI, its client proxy and a client:// driver
        head_proc, lines, steps["cli_head_s"] = _cli_start(
            env, "Dashboard:", "start", "--head", "--port", "0",
            "--dashboard-port", "0")
        address = next(ln.split("Address:")[1].strip() for ln in lines
                       if "Address:" in ln)
        dash_url = lines[-1].split("Dashboard:")[1].strip()
        print(f"[{tag}] `python -m ray_tpu_torch start --head` up in "
              f"{steps['cli_head_s']:.2f} s at {address}, dashboard "
              f"{dash_url} on {card}", flush=True)
        proxy_proc, lines, steps["client_server_s"] = _cli_start(
            env, "listening on", "client-server", "--port", "0")
        proxy = lines[-1].split("client://")[1].strip()
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, paths["client.py"], proxy, paths["prompt.npy"],
             paths["client_tokens.npy"], paths["import_path_tokens.npy"]],
            env=env, capture_output=True,
            text=True, timeout=CS_LIMIT_S, cwd=work)
        steps["client_s"] = time.perf_counter() - t0
        check(out.returncode == 0, f"[{tag}] the client driver exited "
              f"{out.returncode}:\n{out.stdout[-3000:]}\n"
              f"{out.stderr[-3000:]}")
        client = _tagged(out.stdout, "CLIENT")
        tokens = np.load(paths["client_tokens.npy"])
        rows = int((tokens != want).any(1).sum())
        print(f"[{tag}] client:// driver: num_gpus=1 actor (pid "
              f"{client['pid']}) generate {CS_BATCH}x{CS_NEW}: {rows} rows "
              f"differ from the driver's direct generate; flash launches "
              f"{tuple(client['launches'])}; {client['tokens_per_s']:.1f} "
              f"tokens/s in the worker (driver's direct generate "
              f"{d_tps:.1f}); the actor's worker behind the client: "
              f"start {client['spawn_s']:.2f} s after its creation, CUDA "
              f"and weights {client['cuda_and_weights_s']:.2f} s, first call "
              f"{client['first_call_s']:.2f} s; connect "
              f"{client['connect_s']:.3f} s; {client['round_trips_per_s']:.1f}"
              f" round trips/s of a trivial task through the client on "
              f"{card}", flush=True)
        check(tokens.shape == want.shape and rows == 0,
              f"[{tag}] the client's tokens differ from the driver's direct "
              f"generate in {rows} rows")
        check(tuple(client["launches"]) == (cfg.n_layers, 0, 0, 0),
              f"[{tag}] the client's worker launched {client['launches']}, "
              f"want ({cfg.n_layers}, 0, 0, 0)")
        ip = client["import_path"]
        ip_tokens = np.load(paths["import_path_tokens.npy"])
        ip_rows = int((ip_tokens != want).any(1).sum()) \
            if ip_tokens.shape == want.shape else -1
        ip["reused_by_the_actor"] = ip["pid"] == client["pid"]
        print(f"[{tag}] import_path task (chip_smoke:control_generate_task, "
              f"num_gpus=1, sent before the actor with no function blob on "
              f"the proxy's wire; pid {ip['pid']}, a fresh GPU worker, "
              + ("which the actor then took from the pool" if
                 ip["reused_by_the_actor"] else "which the actor did not "
                 "reuse")
              + f"): {ip_rows} rows differ from the driver's direct "
              f"generate; flash launches {tuple(ip['launches'])}; "
              f"{ip['tokens_per_s']:.1f} tokens/s in the worker; submit to "
              f"the worker's start {ip['spawn_s']:.2f} s (the proxy's import "
              f"of chip_smoke and the spawn), CUDA and weights "
              f"{ip['cuda_and_weights_s']:.2f} s, the call "
              f"{ip['call_s']:.2f} s on {card}", flush=True)
        check(ip_rows == 0, f"[{tag}] the import_path task's tokens "
              f"{ip_tokens.shape} differ from the driver's direct generate "
              f"in {ip_rows} rows")
        check(tuple(ip["launches"]) == (cfg.n_layers, 0, 0, 0),
              f"[{tag}] the import_path task's worker launched "
              f"{ip['launches']}, want ({cfg.n_layers}, 0, 0, 0)")

        # 3. a submitted job runs the same generate in a num_gpus=1 task
        t0 = time.perf_counter()
        out = _cli(env, "job", "submit", "--follow", "--", sys.executable,
                   paths["job.py"], paths["prompt.npy"])
        steps["job_s"] = time.perf_counter() - t0
        job = _tagged(out, "JOB")
        sid = out.split("submitted job ")[1].split()[0]
        jobs = JobSubmissionClient(address)
        status, logs = jobs.get_job_status(sid), jobs.get_job_logs(sid)
        print(f"[{tag}] job {sid}: {status}; its task (pid {job['pid']}) "
              f"printed digest {job['digest']} (the driver's "
              f"{token_digest(want)}); flash launches "
              f"{tuple(job['launches'])}; {job['tokens_per_s']:.1f} tokens/s "
              f"in the worker; the GPU worker's start behind the job: spawn "
              f"{job['spawn_s']:.2f} s, CUDA and weights "
              f"{job['cuda_and_weights_s']:.2f} s, first call "
              f"{job['first_call_s']:.2f} s; `job submit --follow` "
              f"{steps['job_s']:.2f} s on {card}", flush=True)
        check(status == "SUCCEEDED" and job["digest"] == token_digest(want)
              and job["digest"] in logs,
              f"[{tag}] job {sid} {status}, digest {job['digest']} (want "
              f"{token_digest(want)}), in its logs: {job['digest'] in logs}")
        check(tuple(job["launches"]) == (cfg.n_layers, 0, 0, 0),
              f"[{tag}] the job's worker launched {job['launches']}, want "
              f"({cfg.n_layers}, 0, 0, 0)")

        # 4. the state API, the dashboard and the CLI
        t0 = time.perf_counter()
        rt.init(address=address)
        connected = True
        actors = {a["actor_id"]: a for a in state.list_actors()}
        listed = [j.submission_id for j in jobs.list_jobs()]
        with urllib.request.urlopen(dash_url + "/api/cluster",
                                    timeout=60) as r:
            total = json.loads(r.read())["total"]
        rt.shutdown()
        connected = False
        status_out = _cli(env, "status")
        steps["reads_s"] = time.perf_counter() - t0
        mine = actors.get(client["actor_id"], {})
        print(f"[{tag}] state.list_actors(): the client's actor "
              f"{mine.get('class_name')} {mine.get('state')}; list_jobs() "
              f"{listed}; dashboard /api/cluster total {total}; `status`:\n"
              + status_out.rstrip(), flush=True)
        check(mine.get("state") == "DEAD", f"[{tag}] the client's actor is "
              f"{mine.get('state')} after its kill")
        check(sid in listed and total.get("GPU") == 1.0
              and "GPU: " in status_out and "/ 1" in status_out.split(
                  "GPU: ")[1].splitlines()[0],
              f"[{tag}] list_jobs {listed}, dashboard {total}, status "
              f"{status_out!r}")
    finally:
        if connected:
            rt.shutdown()
        t0 = time.perf_counter()
        if proxy_proc is not None:
            proxy_proc.terminate()
            proxy_proc.wait(timeout=60)
        if head_proc is not None:
            # 5. stop: the head, its daemon, workers and store
            stop_out = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", "stop"], env=env,
                capture_output=True, text=True, timeout=CS_LIMIT_S,
                cwd=repo)
            try:
                head_proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                head_proc.kill()
                head_proc.wait()
            print(f"[{tag}] `python -m ray_tpu_torch stop`: "
                  f"{stop_out.stdout.strip()} (exit {stop_out.returncode})",
                  flush=True)
    left, segs, apps = _until_clean(["rtpt-"], apps_before)
    steps["stop_s"] = time.perf_counter() - t0
    shutil.rmtree(work, ignore_errors=True)
    print(f"[{tag}] after stop: session processes {left}, segments {segs}, "
          f"card contexts {len(apps)} (before the phase {len(apps_before)})",
          flush=True)
    check(stop_out.returncode == 0 and not left and not segs
          and len(apps) <= len(apps_before),
          f"[{tag}] stop left processes {left}, segments {segs}, contexts "
          f"{apps}")
    seconds = time.perf_counter() - t_phase
    print(f"[{tag}] step seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
          + f"; phase seconds {seconds:.1f} on {card}", flush=True)
    launches = tuple(a + b + c for a, b, c in zip(
        client["launches"], client["import_path"]["launches"],
        job["launches"]))
    return dict(launches=launches, steps=steps, seconds=seconds,
                client=client, job=job, direct_tokens_per_s=d_tps,
                new_tokens=CS_NEW, domain=domain)


# ---------------------------------------------------------------------------
# phase 33: the elastic and durable runtime
# ---------------------------------------------------------------------------

ED_IDLE_MINUTES = 0.05    # the spec's idle_timeout_minutes: 3 s
ED_GPU_NODE = {"CPU": 1, "GPU": 1}


# The workflow's job. Its two CPU steps live in the job's own file, which
# imports nothing heavy at its top: a CPU worker that runs them imports it
# (as ``__rt_main__``) without torch. Only the card step is chip_smoke's.
_ED_JOB = """
import hashlib
import json
import os
import sys
import time

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch import workflow


def digest_step(result):
    \"\"\"The tokens' digest (chip_smoke.token_digest's), the card step's
    launches and tokens/s, and when this step started.\"\"\"
    tokens, launches, tps, start = result
    digest = hashlib.sha256(np.ascontiguousarray(
        np.asarray(tokens), dtype=np.int64).tobytes()).hexdigest()[:16]
    return {"digest": digest, "launches": list(launches),
            "tokens_per_s": tps, "start": start, "at": time.time()}


def flaky_step(summary, marker):
    \"\"\"Fails on its first run (it leaves the marker file), then returns
    the digest.\"\"\"
    if not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("the first run of the last step fails, by design")
    return summary["digest"]


if __name__ == "__main__":
    rt.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])
    root, wf_id, prompt_path, marker, mode = sys.argv[1:6]
    workflow.set_storage(root)
    out, error = None, None
    t0 = time.perf_counter()
    try:
        if mode == "run":
            import chip_smoke as cs
            gen = rt.remote(num_gpus=1)(cs.control_generate_task).bind(
                cs.CS_SEED, np.load(prompt_path), cs.CS_NEW)
            digest = rt.remote(digest_step).bind(gen)
            out = workflow.run(rt.remote(flaky_step).bind(digest, marker),
                               workflow_id=wf_id)
        else:
            out = workflow.resume(wf_id)
    except Exception as e:
        error = repr(e)[:500]
    print("ED " + json.dumps({
        "mode": mode, "output": out, "error": error,
        "workflow_s": time.perf_counter() - t0,
        "status": workflow.get_status(wf_id),
        "gpu_total": rt.cluster_resources().get("GPU", 0.0)}), flush=True)
    rt.shutdown()
    sys.exit(0 if error is None else 1)
"""


def _ed_gpu_nodes(cli):
    """(alive, ever) GPU nodes in the conductor's node table."""
    nodes = [n for n in cli.call("get_nodes")
             if n["resources_total"].get("GPU")]
    return [n for n in nodes if n["alive"]], nodes


def phase_elastic_durable(card, control_run):
    """Phase 33: a head launched with no card (``python -m ray_tpu_torch
    up``); a submitted workflow's card step makes the autoscaler bring up
    a GPU node, the node goes when idle, and a second job resumes the
    workflow from its checkpoints without the card."""
    import os
    import pickle
    import shutil
    import tempfile
    import threading

    import ray_tpu_torch as rt
    from ray_tpu_torch import state
    from ray_tpu_torch.cluster.protocol import get_client
    from ray_tpu_torch.gpu.topology import generation_from_name
    from ray_tpu_torch.job_submission import JobSubmissionClient
    from ray_tpu_torch.workflow.storage import storage_for
    tag, steps = "elastic", {}
    t_phase = time.perf_counter()
    apps_before = _compute_apps()
    want = control_run["job"]["digest"]
    cfg = flagship_cfg()
    prompt = np.random.default_rng(CS_SEED).integers(
        0, cfg.vocab_size, (CS_BATCH, CS_PROMPT))

    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="ed33")
    env = dict(os.environ, TMPDIR=work, CS_REPO=repo,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    paths = {name: os.path.join(work, name) for name in (
        "spec.json", "job.py", "prompt.npy", "marker", "wf")}
    spec = {"cluster_name": "elastic33", "provider": {"type": "fake"},
            "head": {"port": 0, "resources": {"CPU": 2}},
            "node_types": {"gpu_worker": {"resources": ED_GPU_NODE,
                                          "min_workers": 0,
                                          "max_workers": 1}},
            "max_workers": 1, "idle_timeout_minutes": ED_IDLE_MINUTES}
    with open(paths["spec.json"], "w") as f:
        json.dump(spec, f)
    with open(paths["job.py"], "w") as f:
        f.write(_ED_JOB)
    np.save(paths["prompt.npy"], prompt)
    wf_id = "wf-elastic33"
    job_args = [sys.executable, paths["job.py"], paths["wf"], wf_id,
                paths["prompt.npy"], paths["marker"]]
    up = connected = False
    down = None
    try:
        # 1. `up`: a head with no card, the autoscaler beside it
        t0 = time.perf_counter()
        out = _cli(env, "up", paths["spec.json"])
        up = True
        steps["up_s"] = time.perf_counter() - t0
        address = out.split(" up at ")[1].split()[0]
        cli = get_client(address)
        rt.init(address=address)
        connected = True
        nodes = state.list_nodes()
        gpus = sum(n["resources_total"].get("GPU", 0.0) for n in nodes
                   if n["state"] == "ALIVE")
        print(f"[{tag}] `python -m ray_tpu_torch up` in {steps['up_s']:.2f}"
              f" s at {address}: state.list_nodes() "
              f"{[(n['state'], n['is_head_node'], n['resources_total']) for n in nodes]}"
              f", GPU {gpus:g} on {card}", flush=True)
        check(len(nodes) == 1 and nodes[0]["is_head_node"] and gpus == 0,
              f"[{tag}] the launched head is not one node at GPU 0: {nodes}")

        # 2. a job runs the workflow; its card step scales a GPU node up
        seen = {}

        def watch():
            while "registered" not in seen and "done" not in seen:
                alive, _ = _ed_gpu_nodes(cli)
                if alive:
                    seen["registered"] = time.time()
                time.sleep(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        submitted = time.time()
        watcher.start()
        t0 = time.perf_counter()
        out = _cli(env, "submit", paths["spec.json"], "--", *job_args, "run")
        steps["run_job_s"] = time.perf_counter() - t0
        seen["done"] = True
        watcher.join()
        ran = _tagged(out, "ED")
        sid = out.split("submitted job ")[1].split()[0]
        jobs = JobSubmissionClient(address)
        info = jobs.get_job_info(sid)
        store = storage_for(paths["wf"])
        steps_keys = store.list_prefix(f"{wf_id}/steps")
        summary = pickle.loads(store.get_bytes(
            f"{wf_id}/steps/0001_digest_step.pkl"))
        card_out = pickle.loads(store.get_bytes(
            f"{wf_id}/steps/0000_control_generate_task.pkl"))
        _, ever = _ed_gpu_nodes(cli)
        start = summary["start"]
        registered = seen.get("registered", float("nan"))
        steps["to_gpu_node_s"] = registered - submitted
        steps["to_card_answer_s"] = summary["at"] - submitted
        steps["gpu_worker_spawn_s"] = start["started"] - registered
        print(f"[{tag}] job {sid} (run): {info.status}, the workflow "
              f"{ran['status']} with {ran['error']}; checkpoints "
              f"{steps_keys}; GPU nodes launched {len(ever)} "
              f"({[n['resources_total'] for n in ever]}); the card step "
              f"(pid {start['pid']}) digest {summary['digest']} (phase 32's "
              f"{want}), flash launches {tuple(summary['launches'])}, "
              f"{summary['tokens_per_s']:.1f} tokens/s in the worker; "
              f"seconds from submit: to the GPU node's registration "
              f"{steps['to_gpu_node_s']:.2f}, to the card step's answer "
              f"{steps['to_card_answer_s']:.2f}; the GPU worker's spawn "
              f"{steps['gpu_worker_spawn_s']:.2f} s after the node "
              f"registered, CUDA and weights "
              f"{start['cuda_and_weights_s']:.2f} s on {card}", flush=True)
        check(info.status == "FAILED" and ran["status"] == "FAILED"
              and "by design" in (ran["error"] or "")
              and store.exists(f"{wf_id}/dag.pkl"),
              f"[{tag}] the first job {info.status}, workflow "
              f"{ran['status']}, error {ran['error']}")
        # the node type's resources, and the "GPU-<gen>" its daemon adds
        # beside "GPU" for the card's NVLink domain (gpu/topology.py)
        gen = generation_from_name(torch.cuda.get_device_name(0))
        want_total = {**ED_GPU_NODE, f"GPU-{gen}": ED_GPU_NODE["GPU"]}
        check(len(ever) == 1 and ever[0]["resources_total"] == want_total,
              f"[{tag}] the autoscaler launched {len(ever)} GPU nodes: "
              f"{[n['resources_total'] for n in ever]}")
        card_digest = token_digest(card_out[0])
        check(summary["digest"] == want and card_digest == want,
              f"[{tag}] the digest step's checkpoint {summary['digest']} "
              f"(the card step's tokens {card_digest}) differs from phase "
              f"32's {want}")
        check(tuple(summary["launches"]) == (cfg.n_layers, 0, 0, 0),
              f"[{tag}] the card step's worker launched "
              f"{summary['launches']}, want ({cfg.n_layers}, 0, 0, 0)")

        # 3. the idle GPU node goes
        deadline = time.monotonic() + CS_LIMIT_S
        while True:
            alive, _ = _ed_gpu_nodes(cli)
            apps = _compute_apps()
            if (not alive and len(apps) <= len(apps_before)) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        gone_at = time.time()
        # the node idles once the card step's lease is back: from the card
        # step's answer, and from the job's end
        steps["answer_to_gone_s"] = gone_at - summary["at"]
        steps["job_end_to_gone_s"] = gone_at - info.end_time
        gpus = sum(n["resources_total"].get("GPU", 0.0)
                   for n in state.list_nodes() if n["state"] == "ALIVE")
        print(f"[{tag}] the idle GPU node terminated "
              f"{steps['answer_to_gone_s']:.2f} s after the card step's "
              f"answer, {steps['job_end_to_gone_s']:.2f} s after the job "
              f"ended (idle timeout {ED_IDLE_MINUTES * 60:g} s): state API GPU "
              f"{gpus:g}, card contexts {len(apps)} (before the phase "
              f"{len(apps_before)}) on {card}", flush=True)
        check(not alive and gpus == 0 and len(apps) <= len(apps_before),
              f"[{tag}] after the idle timeout: GPU nodes alive {alive}, "
              f"GPU {gpus}, card contexts {apps}")

        # 4. a second job resumes the workflow without the card
        t0 = time.perf_counter()
        out = _cli(env, "submit", paths["spec.json"], "--", *job_args,
                   "resume")
        steps["resume_job_s"] = time.perf_counter() - t0
        resumed = _tagged(out, "ED")
        sid2 = out.split("submitted job ")[1].split()[0]
        status2 = jobs.get_job_status(sid2)
        _, ever2 = _ed_gpu_nodes(cli)
        steps["resume_workflow_s"] = resumed["workflow_s"]
        print(f"[{tag}] job {sid2} (resume): {status2}, the workflow "
              f"{resumed['status']} with output {resumed['output']}; GPU "
              f"nodes ever launched {len(ever2)}; resume() "
              f"{resumed['workflow_s']:.2f} s, `submit` "
              f"{steps['resume_job_s']:.2f} s on {card}", flush=True)
        check(status2 == "SUCCEEDED" and resumed["status"] == "SUCCESSFUL"
              and resumed["output"] == want and resumed["gpu_total"] == 0,
              f"[{tag}] the resume job {status2}, workflow "
              f"{resumed['status']}, output {resumed['output']} (want "
              f"{want}), GPU {resumed['gpu_total']}")
        check(len(ever2) == 1, f"[{tag}] the resume launched a GPU node: "
              f"{len(ever2)} GPU nodes in all")
    finally:
        if connected:
            rt.shutdown()
        t0 = time.perf_counter()
        if up:
            # 5. `down`: the head session, its nodes, workers and store
            down = subprocess.run(
                [sys.executable, "-m", "ray_tpu_torch", "down",
                 paths["spec.json"]], env=env, capture_output=True,
                text=True, timeout=CS_LIMIT_S, cwd=repo)
            print(f"[{tag}] `python -m ray_tpu_torch down`: "
                  f"{down.stdout.strip()} (exit {down.returncode})",
                  flush=True)
    left, segs, apps = _until_clean(["rtpt-"], apps_before)
    heads = _session_processes(("ray_tpu_torch.cluster_launcher",))
    state_file = os.path.join(work, "rtpt-launcher-elastic33.json")
    steps["down_s"] = time.perf_counter() - t0
    print(f"[{tag}] after down: session processes {left}, head sessions "
          f"{heads}, segments {segs}, state file left "
          f"{os.path.exists(state_file)}, card contexts {len(apps)} (before "
          f"the phase {len(apps_before)})", flush=True)
    check(down is not None and down.returncode == 0 and not left
          and not heads and not segs
          and not os.path.exists(state_file)
          and len(apps) <= len(apps_before),
          f"[{tag}] down left processes {left + heads}, segments {segs}, "
          f"contexts {apps}")
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[{tag}] step seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in steps.items())
          + f"; phase seconds {seconds:.1f} on {card}", flush=True)
    launches = tuple(summary["launches"])
    return dict(launches=launches, steps=steps, seconds=seconds,
                digest=summary["digest"],
                tokens_per_s=summary["tokens_per_s"],
                cuda_and_weights_s=start["cuda_and_weights_s"])


# ---------------------------------------------------------------------------
# phase 34: the control plane's microbenchmarks and rtcheck over the port
# ---------------------------------------------------------------------------

MB_LIMIT_S = 600          # the quick suite, any one command


def phase_microbench(card):
    """Phase 34: the port's microbenchmark suite (``--quick``) in a
    subprocess on the card's host, on a cluster of its own with no card;
    rtcheck over the port; the CLI's ``microbenchmark`` refusing an
    address. Host numbers: the card only says which machine ran them."""
    import os
    import shutil
    import tempfile

    from ray_tpu_torch.cluster import microbench
    tag = "microbench"
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    apps_before = _compute_apps()
    work = tempfile.mkdtemp(prefix="rtpt-mb-")
    env = dict(os.environ, TMPDIR=work)
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.cluster.microbench", "--quick"],
        env=env, cwd=repo, capture_output=True, text=True,
        timeout=MB_LIMIT_S)
    suite_s = time.perf_counter() - t0
    check(out.returncode == 0 and "{" in out.stdout,
          f"[{tag}] the suite exited {out.returncode}:\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    doc = json.loads(out.stdout[out.stdout.index("{"):])
    results, seconds = doc["results"], doc["seconds"]
    print(f"[{tag}] `python -m ray_tpu_torch.cluster.microbench --quick` "
          f"{suite_s:.1f} s (host numbers, on the host of {card}): result, "
          f"value, wall seconds of its family", flush=True)
    missing, bad = [], []
    for name in microbench.RESULT_NAMES:
        if name in microbench.DIVERGENCES:
            print(f"[{tag}]   {name}: not written "
                  f"({microbench.DIVERGENCES[name]})", flush=True)
            continue
        if name not in results:
            missing.append(name)
            continue
        value = results[name]
        print(f"[{tag}]   {name} {value} ({seconds[name]:.3f} s)",
              flush=True)
        if not (isinstance(value, (int, float)) and math.isfinite(value)
                and value > 0):
            bad.append((name, value))
    extra = sorted(set(results) - set(microbench.RESULT_NAMES))
    check(not missing and not bad and not extra,
          f"[{tag}] missing results {missing}, not finite and positive "
          f"{bad}, names the JAX suite lacks {extra}")

    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.devtools.rtcheck"], cwd=repo,
        capture_output=True, text=True, timeout=MB_LIMIT_S)
    scan_s = time.perf_counter() - t0
    last = cli.stdout.strip().splitlines()[-1] if cli.stdout.strip() else ""
    print(f"[{tag}] `python -m ray_tpu_torch.devtools.rtcheck` (scans "
          f"ray_tpu_torch/): exit {cli.returncode} in {scan_s:.2f} s: "
          f"{last}", flush=True)
    check(cli.returncode == 0
          and last == "rtcheck: 0 finding(s) over 1 path(s)",
          f"[{tag}] rtcheck findings:\n{cli.stdout[-3000:]}"
          f"{cli.stderr[-2000:]}")

    refused = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "microbenchmark",
         "--address", "127.0.0.1:6380"], env=env, cwd=repo,
        capture_output=True, text=True, timeout=MB_LIMIT_S)
    print(f"[{tag}] `python -m ray_tpu_torch microbenchmark --address "
          f"127.0.0.1:6380`: exit {refused.returncode}, "
          f"{refused.stderr.strip()[-200:]!r}", flush=True)
    check(refused.returncode != 0 and "drop --address" in refused.stderr,
          f"[{tag}] the CLI's microbenchmark with an address exited "
          f"{refused.returncode}: {refused.stderr[-2000:]}")
    left, segs, apps = _until_clean(["rtpt-"], apps_before)
    print(f"[{tag}] after the suite: session processes {left}, segments "
          f"{segs}, card contexts {len(apps)} (before the phase "
          f"{len(apps_before)})", flush=True)
    check(not left and not segs and len(apps) <= len(apps_before),
          f"[{tag}] the suite left processes {left}, segments {segs}, "
          f"card contexts {apps}")
    shutil.rmtree(work, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[{tag}] phase seconds {phase_s:.1f} on the host of {card}",
          flush=True)
    return dict(results=results, family_seconds=seconds, suite_s=suite_s,
                rtcheck_s=scan_s, seconds=phase_s)


# ---------------------------------------------------------------------------
# phase 35: Tune trials that train the flagship on the card
# ---------------------------------------------------------------------------

TUNE_SEED = 35            # the trials' weights and batch, and the driver's
TUNE_BATCH = 4            # 4 x 2048 tokens a step: two trials share the card
# Launched in this order, two at a time. The last is far too small to
# move the loss in one step as the others do (on the H100 at 700 W, 1e-5
# read 10.2591 at its second step, against 10.0639, 9.3230 and 8.2405 for
# the other three), so it is the worst of rung 2 whatever the order in
# which the trials report, and ASHA stops it there. Whether ASHA also stops
# 1e-3 at rung 2 depends on whether 3e-4 reported its second step first.
TUNE_LRS = (1e-3, 3e-4, 1e-4, 1e-5)
TUNE_MAX_T = 6
TUNE_PER_STEP = (20, 10, 10, 10)   # forward (+ remat), dK/dV, dQ, Δ


def _tune_tokens(cfg):
    return np.random.default_rng(TUNE_SEED).integers(
        0, cfg.vocab_size, (TUNE_BATCH, cfg.max_seq))


def tune_flagship_trial(config):
    """A Tune trial: the flagship (phase 5's configuration) trained from
    ``TUNE_SEED``'s weights on the card this trial's lease gave it, one
    step a report. Each report carries the loss, this worker's flash
    launches of the step, and the history so far (a ResultGrid keeps a
    trial's last report)."""
    import os

    from ray_tpu_torch.air import session
    from ray_tpu_torch.train import make_lm_train_step
    from ray_tpu_torch.train.torch_utils import get_device
    t_start = time.time()
    cfg = flagship_cfg(remat=True)
    dev = get_device()
    init_fn, step_fn, place = make_lm_train_step(
        cfg, learning_rate=config["lr"], device=dev)
    torch.cuda.init()
    t_cuda = time.time()
    state = init_fn(torch.Generator(device=dev).manual_seed(TUNE_SEED))
    data = place({"tokens": _tune_tokens(cfg)})
    torch.cuda.synchronize()
    t_ready = time.time()
    torch.cuda.reset_peak_memory_stats()
    losses, launches, step_ms = [], [], []
    where = (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"), str(dev))
    t_first = None
    try:
        for _ in range(10 * TUNE_MAX_T):   # ASHA ends it by max_t
            _reset_launch_counts()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, data)
            losses.append(metrics["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(_launch_counts())
            t_first = t_first or time.time()
            session.report({
                "loss": losses[-1], "losses": list(losses),
                "launches": list(launches), "step_ms": list(step_ms),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "where": where, "t_start": t_start, "t_cuda": t_cuda,
                "t_ready": t_ready, "t_first": t_first})
    finally:
        del state, data
        torch.cuda.empty_cache()


def phase_tune(card, train_run):
    """Phase 35: a Tuner on a port head whose ``"GPU"`` is the card runs
    ``tune_flagship_trial`` over 4 learning rates, two half-card trials at
    a time under ASHA; each trial's first loss is held to the driver's
    first step on the same weights and batch."""
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.air.config import RunConfig
    tag = "tune"
    t_phase = time.perf_counter()
    cfg = flagship_cfg(remat=True)
    tokens = _tune_tokens(cfg)
    t0 = time.perf_counter()
    driver_loss = _first_step(cfg, tokens, TUNE_SEED)[0]
    torch.cuda.empty_cache()
    print(f"[{tag}] the driver's first step at batch {TUNE_BATCH} x "
          f"{cfg.max_seq}, seed {TUNE_SEED}: loss {driver_loss:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    apps_before = _compute_apps()
    work = tempfile.mkdtemp(prefix="rtpt-tune-")
    head = rt.init(num_cpus=4)
    prefix = head._owned_daemon.store_prefix
    try:
        res = rt.cluster_resources()
        check(res.get("GPU") == 1.0,
              f"[{tag}] the head counts {res.get('GPU')} GPUs, want 1")
        sched = tune.AsyncHyperBandScheduler(
            metric="loss", mode="min", max_t=TUNE_MAX_T, grace_period=2,
            reduction_factor=2)
        t_fit = time.time()
        grid = tune.Tuner(
            tune_flagship_trial,
            param_space={"lr": tune.grid_search(list(TUNE_LRS))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", scheduler=sched,
                max_concurrent_trials=2,
                resources_per_trial={"CPU": 1, "GPU": 0.5}),
            run_config=RunConfig(storage_path=work, name="flagship"),
        ).fit()
        fit_s = time.time() - t_fit
        deadline = time.monotonic() + 30
        gpu = rt.available_resources().get("GPU", 0.0)
        while gpu != 1.0 and time.monotonic() < deadline:
            time.sleep(0.2)
            gpu = rt.available_resources().get("GPU", 0.0)
        print(f"[{tag}] after fit(): GPU {gpu:g} / "
              f"{rt.cluster_resources().get('GPU', 0.0):g} available",
              flush=True)
        check(gpu == 1.0, f"[{tag}] GPU {gpu} available after fit(), want 1")
    finally:
        rt.shutdown()
    left, segs, apps = _until_clean([prefix], apps_before)
    rows = sorted(grid, key=lambda r: r.config["lr"], reverse=True)
    check(len(rows) == len(TUNE_LRS) and not grid.errors,
          f"[{tag}] {len(rows)} trials, errors {grid.errors}")
    total = [0, 0, 0, 0]
    stopped, firsts = 0, []
    for r in rows:
        m = r.metrics
        n = len(m["losses"])
        stopped += n < TUNE_MAX_T
        firsts.append(m["losses"][0])
        for launch in m["launches"]:
            total = [a + b for a, b in zip(total, launch)]
        timed = m["step_ms"][1:] or m["step_ms"]
        print(f"[{tag}] lr {r.config['lr']:g}: {n} steps "
              f"({'stopped by ASHA' if n < TUNE_MAX_T else 'to max_t'}), "
              f"losses {[round(x, 4) for x in m['losses']]}; worker "
              f"(pid, CUDA_VISIBLE_DEVICES, device) {m['where']}: trial "
              f"start {m['t_start'] - t_fit:.2f} s after fit() began, "
              f"the step built and CUDA up {m['t_cuda'] - m['t_start']:.2f}"
              f" s later, weights on the card after "
              f"{m['t_ready'] - m['t_cuda']:.2f} s more, first report "
              f"{m['t_first'] - t_fit:.2f} s after fit() began; step ms "
              f"{[round(x, 1) for x in m['step_ms']]} "
              f"(median after the first {np.median(timed):.1f}, phase 5 "
              f"{train_run['step_ms']:.1f} at batch 8 alone on the card); "
              f"peak memory {m['peak_gb']:.2f} GB", flush=True)
        check(all(tuple(x) == TUNE_PER_STEP for x in m["launches"]),
              f"[{tag}] lr {r.config['lr']}: launches a step "
              f"{m['launches']}, want {TUNE_PER_STEP} (fwd, dkv, dq, delta)")
    diffs = [abs(f - driver_loss) for f in firsts]
    best = grid.get_best_result()
    print(f"[{tag}] {len(rows)} trials in {fit_s:.1f} s; stopped by ASHA "
          f"before max_t {TUNE_MAX_T}: {stopped}; first losses {firsts} "
          f"against the driver's {driver_loss:.6f} (diffs "
          f"{[f'{d:.2e}' for d in diffs]}, tol {TRAIN_LOSS_TOL}); best lr "
          f"{best.config['lr']:g}, losses {best.metrics['losses']}; flash "
          f"launches in the trial workers {tuple(total)}; after shutdown: "
          f"session processes {left}, segments {segs}, card contexts "
          f"{len(apps)} (before the phase {len(apps_before)}) on {card}",
          flush=True)
    check(stopped >= 1, f"[{tag}] ASHA stopped no trial before max_t")
    check(max(diffs) <= TRAIN_LOSS_TOL,
          f"[{tag}] first losses {firsts} against the driver's "
          f"{driver_loss} (tol {TRAIN_LOSS_TOL})")
    check(best.metrics["losses"][-1] < best.metrics["losses"][0],
          f"[{tag}] the best trial's loss did not fall: "
          f"{best.metrics['losses']}")
    check(not left and not segs and len(apps) <= len(apps_before),
          f"[{tag}] left processes {left}, segments {segs}, card contexts "
          f"{apps}")
    shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"[{tag}] phase seconds {seconds:.1f}", flush=True)
    return dict(launches=tuple(total), fit_s=fit_s, stopped=stopped,
                driver_loss=driver_loss, first_losses=firsts,
                trials={r.config["lr"]: {k: r.metrics[k] for k in (
                    "losses", "step_ms", "peak_gb", "where", "t_start",
                    "t_cuda", "t_ready", "t_first")} for r in rows},
                t_fit=t_fit, seconds=seconds)


# ---------------------------------------------------------------------------
# phase 36: the port's examples on the card
# ---------------------------------------------------------------------------

# (file, arguments, flash launches (fwd, dkv, dq, delta) it must make)
EXAMPLES = (
    # 5 steps of 2 layers, remat: the forward twice a layer, each backward
    # kernel once
    ("02_train_lm_multichip.py", (), (20, 10, 10, 10)),
    # one generate: the prefill, a forward a layer; the decode runs no kernel
    ("03_serve_lm.py", ("--local-mode",), (2, 0, 0, 0)),
    # RL reaches no Pallas kernel in the JAX package, nor a flash one here
    ("05_rl_cartpole.py", ("--local-mode",), (0, 0, 0, 0)))


def _run_example(path, argv):
    """``path`` run as ``__main__`` with ``argv`` in this process: (its
    standard output, its flash launches, its seconds)."""
    import contextlib
    import io
    import runpy
    _reset_launch_counts()
    buf, saved = io.StringIO(), sys.argv
    sys.argv = argv
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue(), _launch_counts(), time.perf_counter() - t0


def phase_examples(card):
    """Phase 36: ``examples_torch/02``, ``03`` and ``05``, the examples that
    touch a device, on the card through ``runpy`` in this process, so that
    neither ``import torch`` nor torch._dynamo's is paid again: their
    lines, and the flash launches each made (``02``'s one-rank gang and
    ``03``'s replica are threads of this process)."""
    import os
    tag = "examples"
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    apps_before = _compute_apps()
    got = {}
    for name, args, want in EXAMPLES:
        out, launches, seconds = _run_example(
            os.path.join(repo, "examples_torch", name), [name, *args])
        got[name] = {"stdout": out, "launches": launches,
                     "seconds": seconds}
        print(f"[{tag}] {name}: {seconds:.1f} s, flash launches "
              f"{launches} (want {want}) on {card}; its lines:\n"
              + out.rstrip(), flush=True)
        check(launches == want, f"[{tag}] {name} launched {launches}, want "
              f"{want}")
    lm = got["02_train_lm_multichip.py"]["stdout"]
    losses = [float(ln.split("loss=")[1]) for ln in lm.splitlines()
              if ln.startswith("step ")]
    check(len(losses) == 5 and all(np.isfinite(losses))
          and losses[-1] < losses[0]
          and f"ranks: 1, mesh: {{'dp': {torch.cuda.device_count()}}}" in lm
          and "param sharding example:" in lm,
          f"[{tag}] 02's lines:\n{lm}")
    served = got["03_serve_lm.py"]["stdout"]
    check(served.count("'generated_tokens': [") == 1
          and len(served.split("'generated_tokens': [")[1].split("]")[0]
                  .split(",")) == 16 and "'prompt': 'gpu'" in served,
          f"[{tag}] 03's lines:\n{served}")
    rl = got["05_rl_cartpole.py"]["stdout"]
    steps = [int(ln.split("steps=")[1]) for ln in rl.splitlines()
             if ln.startswith("iter ")]
    check(steps == [1024 * i for i in range(1, 6)] and "checkpoint:" in rl,
          f"[{tag}] 05's lines:\n{rl}")
    deadline = time.monotonic() + 30
    apps = _compute_apps()
    while len(apps) > len(apps_before) and time.monotonic() < deadline:
        time.sleep(0.2)
        apps = _compute_apps()
    check(len(apps) <= len(apps_before), f"[{tag}] card contexts left: "
          f"{apps} (before the phase {apps_before})")
    seconds = time.perf_counter() - t_phase
    print(f"[{tag}] phase seconds {seconds:.1f} (the examples "
          + ", ".join(f"{n} {got[n]['seconds']:.1f}" for n, _, _ in EXAMPLES)
          + ")", flush=True)
    launches = tuple(sum(got[n]["launches"][i] for n, _, _ in EXAMPLES)
                     for i in range(4))
    return dict(launches=launches, seconds=seconds,
                by_example={n: dict(launches=tuple(got[n]["launches"]),
                                    seconds=got[n]["seconds"])
                            for n, _, _ in EXAMPLES})


def _paths(runs, part):
    """Launches of one kernel (index ``part`` of the counts) by path."""
    return {path: (r["launches"][part] if isinstance(r["launches"], tuple)
                   else (r["launches"] if part == 0 else 0))
            for path, r in runs.items()}


def _keep_bytecode():
    """Keep the bytecode of what this process and every process it starts
    imports under ``build/pycache``. Where the interpreter is told to write
    none (``PYTHONDONTWRITEBYTECODE``) and the installed packages ship none,
    every process compiles torch's sources again when it imports torch,
    and torch._dynamo's when it first makes a torch.optim optimizer:
    seconds each, paid by every worker, head and CLI command the phases
    start. The first import of a module writes its bytecode, the rest read
    it. Returns (the cache's path, whether writing had been off)."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "pycache")
    os.makedirs(path, exist_ok=True)
    was_off = sys.dont_write_bytecode
    os.environ["PYTHONPYCACHEPREFIX"] = path
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = path
    sys.dont_write_bytecode = False
    return path, was_off


def _timed(name, phase, *args):
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on an NVIDIA card",
              file=sys.stderr)
        return 1
    cache, was_off = _keep_bytecode()
    print(f"[setup] bytecode of every import kept under {cache} (writing it "
          f"had been off: {was_off})", flush=True)
    card, build = _timed("card and build", phase_card_and_build)
    results = _timed("kernel checks", phase_kernel_checks)
    bwd = _timed("backward checks", phase_backward_checks)
    runs = {"serve": _timed("serve", phase_serving, card, flagship_cfg(),
                            "serve", 0)}
    _timed("small reference", phase_small_reference)
    _timed("long prefill", phase_long_prefill)
    runs["train"] = _timed("train", phase_training, card,
                           flagship_cfg(remat=True), "train", 3)
    _timed("small training", phase_small_training)
    runs["moe_serve"] = _timed("moe serve", phase_serving, card, moe_cfg(),
                               "moe-serve", 10)
    runs["moe_train"] = _timed("moe train", phase_training, card,
                               moe_cfg(remat=True), "moe-train", 15)
    runs["vit_train"] = _timed("vit train", phase_vit_training, card)
    _timed("small moe and vit", phase_small_moe_and_vit)
    runs["resnet_train"] = _timed("resnet train", phase_resnet_training,
                                  card)
    runs["resnet_train"]["small_f32_vs_cpu"] = _timed(
        "small resnet", phase_small_resnet)
    runs["ppo_cartpole"], runs["ppo_cartpole_cpu_workers"] = _timed(
        "ppo cartpole", phase_ppo_cartpole, card)
    runs["ppo_atari_learner"] = _timed("ppo atari learner",
                                       phase_ppo_atari_learner, card)
    runs["ppo_cartpole"]["small_f32_vs_cpu"] = _timed("small rl",
                                                      phase_small_rl)
    runs["ppo_drivers"] = _timed("ppo drivers", phase_ppo_drivers, card,
                                 runs["ppo_cartpole"])
    for name, phase in (("async", phase_async_drivers),
                        ("atari", phase_appo_atari_learner),
                        ("offpolicy", phase_offpolicy),
                        ("offline", phase_offline)):
        out = _timed(name, phase, card)
        if name == "atari":
            runs["appo_atari_learner"] = out
        elif name == "offline":
            runs["offline_cartpole"] = {"launches": out["cql"]["launches"],
                                        **out}
        else:
            runs.update({k + ("_pendulum" if k in ("td3", "ddpg")
                              else "_cartpole"): v for k, v in out.items()})
    runs["appo_cartpole"]["small_learners_f32_vs_cpu"] = _timed(
        "small learners", phase_small_offpolicy)
    rest = _timed("rest of RL", phase_rest_of_rl, card)
    runs.update({"qmix_coop": rest["qmix"], "maddpg_spread": rest["maddpg"],
                 "es_cartpole": rest["es"],
                 "shared_policy_coop": rest["coop"],
                 "bandit_ucb": rest["bandit_ucb"],
                 "bandit_ts": rest["bandit_ts"]})
    par = _timed("parallel", phase_parallel, card)
    runs.update({"mesh_train": par["train"],
                 "ring_n1": par["attention"]["ring"],
                 "ulysses_n1": par["attention"]["ulysses"],
                 "pipeline_n1": par["pipeline"],
                 "ppo_mesh": par["ppo"],
                 "mesh_vit": par["vit"], "mesh_resnet": par["resnet"]})
    runs["http-serve"] = _timed("http serve", phase_http_serve, card,
                                runs["serve"]["tokens_per_s"])
    runs["cluster-gpu-worker"] = _timed("cluster", phase_cluster, card,
                                        runs["serve"]["tokens_per_s"])
    runs["compiled-graph"] = _timed("compiled graph", phase_compiled_graph,
                                    card)
    runs["pipeline-mpmd"] = _timed("pipeline", phase_pipeline, card)
    runs["trainer-gang"] = _timed("trainer gang", phase_trainer_gang, card,
                                  runs["resnet_train"])
    runs["data-train"] = _timed("data train", phase_data_train, card,
                                runs["trainer-gang"])
    runs["serve-cluster"] = _timed("serve cluster", phase_serve_cluster,
                                   card, runs["http-serve"],
                                   runs["compiled-graph"])
    runs["rl-cluster"] = _timed("rl cluster", phase_rl_cluster, card,
                                runs["ppo_drivers"],
                                runs["ppo_cartpole_cpu_workers"])
    runs["control-surface"] = _timed("control surface",
                                     phase_control_surface, card)
    runs["elastic-durable"] = _timed("elastic and durable",
                                     phase_elastic_durable, card,
                                     runs["control-surface"])
    micro = _timed("microbench", phase_microbench, card)
    runs["tune"] = _timed("tune", phase_tune, card, runs["train"])
    runs["examples"] = _timed("examples", phase_examples, card)
    fwd_main = results[("serve_prefill", "bf16")]

    def at(result, keys):
        return {k: result[k] for k in keys}

    fwd_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "shape")
    fwd_launches = _paths(runs, 0)
    kernels = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash.py:45",
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": fwd_main["max_abs_err"],
        "tol": TOL[torch.bfloat16]["out"],
        "cases_passed": len(results),
        **at(fwd_main, fwd_keys),
        "train_shape": at(results[("max_seq_causal", "bf16")], fwd_keys),
        "vit_shape": at(results[("vit_train", "bf16")], fwd_keys),
        "build": build,
        "dtype": "bfloat16",
        "card": card,
    }]
    bwd_main = bwd[("train_causal", "bf16")]
    source = "ray_tpu_torch/ops/csrc/flash_bwd.cu"
    for name, replaces, part, index, errs in (
            ("flash_bwd_dkv", "ray_tpu/ops/flash.py:134", "dkv", 1,
             slice(1, 3)),
            ("flash_bwd_dq", "ray_tpu/ops/flash.py:176", "dq", 2,
             slice(0, 1)),
            ("flash_bwd_delta", "ray_tpu/ops/flash.py:219", "delta", 3,
             None)):
        ms, dev_ms = bwd_main["times"][part]
        launched = _paths(runs, index)

        def other(case):
            r = bwd[(case, "bf16")]
            plain = {"plain_ms": r["delta_plain_ms"], "library_ms": None} \
                if errs is None else {"plain_ms": r["plain_ms"],
                                      "library_ms": r["library_ms"]}
            return {"ms": r["times"][part][0],
                    "device_ms": r["times"][part][1],
                    "bound_ms": r["bounds"][part][0],
                    "bound_by": r["bounds"][part][1],
                    "wrapper_ms": r["times"]["wrapper"][0],
                    "shape": r["shape"], **plain}

        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(launched.values()),
            "launches_by_path": launched,
            "cases_passed": len(bwd),
            "ms": ms,
            "device_ms": dev_ms,
            "bound_ms": bwd_main["bounds"][part][0],
            "bound_by": bwd_main["bounds"][part][1],
            "share_of_bound": _share(bwd_main["bounds"][part][0],
                                     bwd_main["times"][part]),
            "full_shape": other("full"),
            "vit_shape": other("vit_train"),
            "shape": bwd_main["shape"],
            "dtype": "bfloat16",
            "card": card,
        }
        if errs is None:
            row.update({
                "replaces_what": "XLA's reduction for Delta in _flash_bwd",
                "max_abs_err": bwd_main["delta_abs"],
                "max_rel_err": bwd_main["delta_err"],
                "tol": 1e-5,
                "tol_on": "max_rel_err, relative to Delta's max magnitude",
                "plain_ms": bwd_main["delta_plain_ms"],
                "library_ms": None,
            })
        else:
            row.update({
                "max_abs_err": max(bwd_main["abs"][errs]),
                "max_rel_err": max(bwd_main["rel"][errs]),
                "tol": BWD_TOL[torch.bfloat16],
                "tol_on": "max_rel_err, relative to the gradient's max "
                          "magnitude",
                "plain_ms": bwd_main["plain_ms"],
                "plain_computes": "dq, dk and dv together",
                "library_ms": bwd_main["library_ms"],
                "library_computes": "scaled_dot_product_attention backward "
                                    "(dq, dk and dv)",
                "wrapper_ms": bwd_main["times"]["wrapper"][0],
                "wrapper_device_ms": bwd_main["times"]["wrapper"][1],
            })
        kernels.append(row)
    print(json.dumps({"paths": runs}))
    print(json.dumps({"microbench": micro}))
    print(json.dumps({"kernels": kernels}))
    from ray_tpu_torch import device_name
    # the run used one card, whatever else the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
