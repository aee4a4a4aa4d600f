#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and hold it to its plain
versions.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each of which must pass (any failure exits non-zero):

  1. build    — compile every CUDA kernel library of the port from
                ``ray_memory_management_tpu_torch/csrc`` with nvcc, one
                nvcc per source, all started together.
  2. kernels  — the flash attention forward kernel against its plain
                version (``reference_attention``, and ``logsumexp`` of the
                plain scores for its lse output) at the serving path's
                shapes (BH = 12, D = 64, S in {64, 992, 1024}, causal and
                not, S != Skv, fp32 and bf16; bf16 D = 128 at S = 992 and
                a ragged S = 1000) and at the training shape (BH = 96,
                S = 1024), each case checked for the design it took
                (bf16 with D = 64 or 128: wgmma; fp32: SIMT); then the
                backward kernels (dq, dk/dv) against
                ``reference_flash_bwd`` at the training shape in bf16 and
                fp32, non-causal, S != Skv, odd lengths, a ragged S =
                1000 and one query row, each case checked for the design
                it took (the forward's rule). Each kernel's
                device time (``device_ms``: the kernels of a
                ``torch.profiler`` trace) is printed beside its plain
                version's, a PyTorch yardstick the port never calls (SDPA
                forward; the SDPA backward for the dq + dk/dv pair, only
                its ``autograd.grad`` traced) and the card's bound; the
                CUDA-event figures, which take in host time, stand beside
                them under ``*_event_ms``. At the serving main case and the
                training shape the forward's previous (SIMT) design is
                timed in turns with the wgmma one (prev, new, new, prev),
                and so are the backward kernels' at the training shape.
  3. forward  — ``gpt.forward`` of gpt2-small at B = 8, S = 1024 with the
                kernel against ``attention="ref"``.
  4. grad     — gradients of ``gpt.loss_fn`` for gpt2-small at B = 8,
                S = 1024 with the kernels against ``attention="ref"``;
                every kernel launch of the bf16 gradient must be wgmma.
  5. serve    — a main path: ``LLMServer`` (gpt2-small, paged
                continuous batching) answers a burst of concurrent
                requests; kernel launch counts are zeroed just before and
                read just after, and every forward launch must be wgmma.
                Two more bursts are timed (median reported). Then a fp32
                engine's greedy tokens are held against ``gpt.generate``.
  6. train    — the other main path: ``train_step_mfu`` takes 8 AdamW
                steps of gpt2-small at B = 8, S = 1024 with the launch
                counts zeroed just before and read just after; every
                kernel must launch once per layer per step, all through
                the wgmma design.
  7. runtime  — the runtime core with the card as its ``GPU`` resource:
                ``rmt.init`` counts one GPU; the driver's device tier
                hands back the pinned tensor (same ``data_ptr``),
                ``consume`` kills the ref, and a tier bounded at three
                tensors demotes the least recently used one to the shm
                store when a fourth is pinned (``memory_allocated``
                falls by its bytes; the next get re-promotes it onto
                the card bit-equal); 256 MiB fp32 and bf16 CUDA tensors
                go through ``put``/``get`` bit-exact; a ``num_gpus=1``
                task runs the forward kernel on q, k, v passed as
                ObjectRefs (output bit-equal to the driver's own call,
                wgmma launches, ``CUDA_VISIBLE_DEVICES`` set to the
                driver's first visible device, "0" when the driver's is
                unset, and the worker's card the driver's by UUID); a
                GPU actor (``LLMServer`` with ``num_gpus=1``, on the
                driver's card by the same checks) serves
                ``phase_serve``'s burst with its launch counts zeroed
                just before and read just after, and its greedy tokens
                equal an in-process ``LLMServer``'s; after
                ``rmt.shutdown()`` no shm segment of this driver and no
                worker or zygote of the port is left.
  8. serve plane — the main path behind the serve API: in-process
                ``LLMServer``s of seed 0 (drawn, and from a bf16
                ``pack_weights`` payload of the same params) give the
                reference tokens and the cold starts; then ``rmt.init``
                with a 4 GiB shm store, ``serve.start`` and the HTTP
                proxy, and ``serve.run`` of ``llm_deployment("gpt2-small",
                ray_actor_options={"num_gpus": 1}, ship_weights="bf16")``
                with ``utils/runtime_smoke.ServedLLM`` in place of
                ``LLMServer`` (the same arguments and payload, plus reads
                of the replica's process). Held: one live replica on the
                driver's card by UUID; the payload equal to the
                in-process one; ``phase_serve``'s burst through
                ``handle.remote`` complete, KV pages at 0, the replica's
                forward launches (counts zeroed just before) >= 12 per
                request and all wgmma; greedy tokens of three prompts
                through the handle and through HTTP equal the in-process
                shipped server's; redeploying the same application keeps
                the replica (same pid, no second cold start); a
                deployment without ``ship_weights`` gives the in-process
                seed-0 server's tokens; nothing left behind after
                ``serve.shutdown()`` and ``rmt.shutdown()``.
  9. multinode — the multi-node runtime with the card on a node agent:
                ``rmt.init(num_gpus=0)`` (the head holds no card) and
                ``add_remote_node_process(num_gpus=1)``, an agent process
                on this host that holds it (cluster GPU 1, all on the
                agent). A ``num_gpus=1`` task runs the forward kernel on
                the agent, on q, k, v the driver put: it must run on the
                agent's node, with the lease the agent reported, on the
                driver's card by UUID, bit-equal to the driver's own call,
                every launch wgmma (first call and the warm median of ten
                timed). 256 MiB fp32 and bf16 CUDA tensors go driver →
                a GPU task on the agent → driver bit-equal, timed each
                way. A ``num_gpus=1`` actor pinned to the agent serves
                ``phase_serve``'s burst (KV pages back to 0, >= 12
                forward launches per request, all wgmma, greedy tokens
                equal to an in-process server's). Then the agent process
                is SIGKILLed: the actor's next call raises
                ``ActorDiedError`` and the cluster's GPU total reads 0;
                after ``rmt.shutdown()`` no ``rmtA_`` segment and no
                agent, worker or zygote process of the port is left.
  10. train plane — collectives, parallel strategies and Train on the
                card: ``rmt.init`` with a 6 GiB shm store (the
                checkpoint crosses it). (a) A ``num_gpus=1`` actor
                (``runtime_smoke.CollectiveProbe``, with
                ``CollectiveGroupMixin``) joins a world-1 ``dist`` group
                through ``create_collective_group``: NCCL, on the
                driver's card by UUID with the driver's lease. Every
                collective (allreduce sum/max/min/product, reducescatter,
                reduce in f32, bf16 and int8; allgather, broadcast,
                ppermute) runs on a 4 Mi-element CUDA tensor: f32
                bit-equal to the plain expectation, bf16 and int8 within
                the JAX test's envelopes (absmax x 2^-7 and absmax x
                0.75/127), each quantized call counted once in
                ``rmt_collective_quantized_ops_total``. (b) ``TorchTrainer``
                (``ScalingConfig(num_workers=1, use_gpu=True,
                gpus_per_worker=1, collective_backend="dist")``) runs
                ``runtime_smoke.train_loop``: ``make_mesh({"dp": 1})`` on
                cuda, ``param_pspecs``, ``shard_pytree``,
                ``make_train_step`` with AdamW, 8 steps of gpt2-small at
                B = 8, S = 1024 from phase 6's seed, launch counts zeroed
                just before the steps and read just after in the worker.
                Held: the worker's lease and card are the driver's; NCCL;
                each kernel launched 12 x 8 times, all wgmma; the losses
                finite and falling, the first equal to phase 6's to
                1e-5 relative and the eighth to 1e-3. The loop reports a
                checkpoint (parameters and AdamW state) at step 4. (c) A
                second ``fit(resume_from_checkpoint=...)`` runs steps
                4-7: its losses equal the first run's within the same
                tolerances. (d) After ``rmt.shutdown()`` no shm segment,
                worker or zygote of the port is left. Printed: the
                worker's cold start, step time, tokens/s and MFU beside
                phase 6's, ``fit()`` wall, the checkpoint's save seconds
                and bytes, and ``phase_s``.
  11. moe      — mixtral-tiny at full width (32k vocab, d_model 1024, 8
                layers, 16 heads of 64 over 4 kv heads, 8 experts top-2,
                capacity 1.25, groups of 256; random weights from a
                seed): (a) ``phase_serve``'s burst from a bf16
                ``LLMServer`` of 8 slots, the MoE FFN on prefill and
                decode, every forward launch wgmma; (b) ``train_step_mfu``
                takes 8 AdamW steps at B = 4, S = 2048 (each kernel 8 x 8
                launches, all wgmma, the loss finite and falling) and one
                step's gradients are held against ``attention="ref"``
                by phase 4's rule; (c) the ring's chunk schedule of an
                sp = 4 run in one process (``ring_schedule``: each rank's
                query chunk against the K/V chunks in ring order, merged
                by lse; per-chunk dq and dk/dv from the merged lse) at
                BH = 64, S = 2048, bf16, causal, through the kernels (10
                launches of each), against plain attention over the whole
                sequence.
  12. pipeline and vision — (a) GPipe's schedule for gpt2-small at B = 8,
                S = 1024 over pp = 4 stages of 3 layers with M = 4
                microbatches, every stage held in this process
                (``parallel.pipeline_schedule``: the schedule and reverse
                schedule of the pp ranks, the hand-overs in memory), bf16
                with the kernels: its loss and every gradient against
                unpipelined ``gpt.loss_fn`` with the kernels, by phase
                4's rule (bf16 within twice the bf16 model's own distance
                to the fp32 model, leaf by leaf; fp32 within 1e-3 of each
                leaf's largest gradient); launch counts zeroed just before
                the bf16 pipeline and read just after: 12 x 4 of each
                kernel, all wgmma. (b) ResNet-50 (SGD(0.1, momentum 0.9))
                and ViT-S/16 (Adam(1e-3)) train 8 steps each on one
                synthetic batch of B = 128 images, 224x224, 1000 classes,
                bf16 compute (``gpu_bench.vision_train_step``): the loss
                finite and falling, ResNet's BatchNorm running statistics
                moved; images/s, step time and peak memory printed.
  13. data and tune — Data, Tune, Workflow and DAG with the card:
                ``rmt.init(num_gpus=1)`` with a 1 GiB shm store. (a) 64
                seeded rows of 1024 tokens go through ``map_batches(
                runtime_smoke.score_batch, batch_size=8, batch_format=
                "numpy", compute=ActorPoolStrategy(size=1, num_gpus=1))``:
                gpt2-small's bf16 forward in the pool actor scores each
                batch (each row's mean next-token log-probability, fp32,
                and the argmax after its last position), counting its
                forward launches from zero just before each batch's
                forward and reading them just after. Held: 8 batches in
                one actor on the driver's card by UUID, >= 12 launches a
                batch, all wgmma; every argmax equal to, and every
                log-probability within 1e-5 of, the driver's own call of
                the same function on the same rows; a second
                ``map_batches`` (a new pool actor) gives the same. (b)
                ``TorchTrainer(runtime_smoke.data_train_loop,
                datasets={"train": ds})`` (one GPU worker, ``dist``): ``ds``
                is 64 seeded rows of 1025 ids split into tokens and
                targets by ``map_batches``; the worker reads its shard
                through ``iter_batches(batch_size=8)`` and takes 8 AdamW
                steps of gpt2-small (phase 6's seed) through
                ``make_train_step``. Held: the worker's lease and card
                are the driver's, NCCL, 12 x 8 wgmma launches of each
                kernel, the losses finite and falling, each within 1e-5
                relative of the same steps in this process on the same
                batches in the same order. Printed: the step (median of
                the last 6, from the end of one step to the end of the
                next, the wait in ``iter_batches`` included), the wait
                alone, tokens/s and MFU, beside the in-process loop
                timed alike and phase 10's worker step. (c)
                ``Tuner(runtime_smoke.tune_trial, grid lr {1e-4, 3e-4},
                resources_per_trial={"CPU": 1, "GPU": 1},
                max_concurrent_trials=1)``: each trial actor leases the
                card and trains 4 steps from phase 6's seed and batch.
                Held: both trials TERMINATED with no error, each first
                loss phase 6's within 1e-5 relative, 12 x 4
                wgmma launches of each kernel counted in the trial, the
                lease and card the driver's, ``get_best_result()`` the
                trial with the lowest last loss. (d) A workflow of two
                steps: ``step(num_gpus=1)`` runs the forward kernel on
                seeded q, k, v (BH = 12, S = 992), a CPU step sums each
                output row in fp32. Held: SUCCESS, the output bit-equal to
                the driver's own call reduced alike, the first step's
                stored CUDA output back on the driver's card bit-equal;
                the same workflow whose second step fails once is FAILED,
                and ``rerun`` gives the same output with 0 forward
                launches (the first step comes from storage). A DAG
                (``InputNode`` -> a ``num_gpus=1`` task over
                ``runtime_smoke.attend``) gives the driver's output
                bit-equal, on its card by UUID, one wgmma launch. After
                ``rmt.shutdown()`` no shm segment, worker or zygote of the
                port is left.
  14. surfaces — the state API, dashboard, CLI, job submission and
                autoscaler over the card, gpt2-small at full width (bf16,
                weights from seed 0). In this process first: the prefill
                of 8 seeded rows x 1024 ids (``runtime_smoke.score_batch``,
                12 forward launches at BH = 96) gives the reference digest
                (sha256 of the argmax ids and log-probabilities), an
                ``LLMServer`` the reference greedy tokens, and a
                ``utils.profiling.trace`` of ``phase_serve``'s burst must
                name the wgmma forward kernel. Then ``rmt.init(num_gpus=0)``
                (the head holds no card) with a thin-client port
                (``ClusterServer``). (b) A ``num_gpus=1`` task of the flash
                forward (bf16, BH = 12, S = 992, causal) waits as pending
                demand until ``StandardAutoscaler(ProcessNodeProvider(rt),
                node_config={"num_cpus": 2, "num_gpus": 1},
                max_workers=1)`` adds a node agent that leases the card;
                its output is held against ``reference_attention`` at phase
                2's tolerance, and the idle node is scaled down. (c0) A
                node agent holding the card joins, and a ``num_gpus=1``
                task pins gpt2-small's bf16 weights, packed into one
                tensor, in its device tier (``list_tasks`` shows its
                ``hbm_bytes`` at least the weights' bytes). (a)
                ``JobSubmissionClient(address=...).submit_job`` runs a
                driver script that joins the head (``init(address=
                "auto")``) and runs the prefill as a ``num_gpus=1`` task:
                the job SUCCEEDED, its logged digest equals the in-process
                one, its head-side job row carries the submission id and
                ``list_tasks(job_id=...)`` lists the finished GPU task.
                (c) ``serve.run(llm_deployment("gpt2-small", num_gpus=1,
                placement_hint=<the weights' id>))`` places the replica
                ``tier_affine`` (``rmt_serve_replica_placements_total``) on
                the agent; it serves ``phase_serve``'s burst (>= 12 wgmma
                launches a request, pages back to 0) and the in-process
                greedy tokens. (d) While the weights are pinned: the
                dashboard's ``/api/nodes`` gives the agent GPU 1,
                ``/api/objects`` the weights ``where == "device"`` on the
                agent, ``/metrics`` ``rmt_device_bytes_pinned`` of a
                process on the agent at least their bytes; the port's CLI, run as a subprocess through
                the client port (``status --address``, ``list objects
                --address``), prints the same. Nothing is left after
                ``rmt.shutdown()``.
  15. rllib    — RLlib's learners on the card, rollouts on CPU actors.
                (a) From one 4000-step CartPole batch recorded by a CPU
                rollout worker, PPO's update (hidden (64, 64), Adam 5e-4)
                runs on the card and on the CPU with the same minibatch
                order, fp32 with TF32 off: the first 8 of its 6 epochs x
                31 minibatches of 128 must agree within 1e-5 * max|leaf| +
                1e-6 of the CPU's leaves, the largest difference over all
                of them is printed (not gated: the clip's branches can
                part); one IMPALA and one APPO update on a recorded
                fragment, one DQN update against a distinct target net and
                one recurrent-PPO update over 8 recorded sequences of 200
                steps are held alike. (b) PPO at the JAX package's defaults
                (2 CPU rollout actors, fragment 200, batch 4000, 6 epochs
                of 128, episodes of 200 steps) trains CartPole until
                ``episode_reward_mean`` exceeds max(2 x the first, 50),
                within 12 iterations. (c) ``gpu_bench.rl_learner_bench``
                at its defaults. (d) IMPALA (2 actors, batch 1600, lr
                1e-3, seed 1) over 7 iterations ends above 1.5 x its first
                reward; DQN with 2 actors trains 4 iterations and its
                target net is synced at least once. Last, 20 of (a)'s PPO
                updates on the card are traced with ``torch.profiler``:
                kernels an update, their device time, the idle share of
                the wall. (e) The flash kernels' launch counts, zeroed at
                the phase's start, read 0 at its end. Nothing is left
                after ``rmt.shutdown()``.
  16. rllib2   — RLlib's second half on the card, fp32 with TF32 off.
                (a) Each new learner's update runs on the card and on the
                CPU from the same params, optimizer state and draws, 3
                updates each held to phase 15's 1e-5 * max|leaf| + 1e-6:
                SAC, TD3 and DDPG (Pendulum's shapes, the draws given),
                BC, MARWIL and CQL (on a CartPole recording a CPU actor
                wrote), QMIX (batches a CPU collector recorded), MADDPG
                (agents stacked [N, ...]), SlateQ, R2D2 (sequences a CPU
                collector recorded, burn-in 4), the MBPETS ensemble (4 x
                128 x 128), AlphaZero, and one batched AlphaZero leaf
                evaluation; one MBPETS plan (horizon 25, population 256,
                5 rounds) from the trained ensembles with the same draws
                keeps the same elites every round; ES and ARS steps with
                eps rebuilt on the card from the seeds, bit-equal to the
                CPU worker's; 20 LinUCB and LinTS selects (the same arm)
                and updates. Each learner's updates a second on the card
                are printed. (b) SAC at ``TestSAC::test_learns_pendulum``'s
                settings, learner on the card, meets its rule
                (episode_reward_mean > -900, > 1000 updates, 0 < alpha <
                0.9) within 80 iterations, stopping at the first that
                meets it. (c) MBPETS at ``TestMBPETS``'s settings,
                planner and ensemble on the card, meets its rule
                (model_loss < 0.05, the reward above the first + 100 and
                above -560) within its 22 iterations, stopping at the
                first that meets it, and its ensemble round-trips
                save/restore. (d) ES with 2 CPU rollout actors at
                ``test_learns_cartpole_gradient_free``'s settings, the
                update on the card, reaches best > 60. (e) 20 SAC
                updates and 5 MBPETS plans traced with ``torch.profiler``
                (kernels, device ms, idle share); the flash kernels'
                launch counts, zeroed at the phase's start, read 0 at
                its end. Nothing is left after ``rmt.shutdown()``.
  17. harnesses — the measurement harnesses of ``utils/`` on the card.
                (a) Each flash kernel at BH = 4, D = 128, bf16, causal, S
                = 4096 and 8192 against its plain version by phase 2's
                rules (forward 1e-2, lse atol 1e-3; backward 2^-8 * |ref|
                + 1e-3 * max|ref|), every launch wgmma, each timed beside
                its plain version, SDPA and its bound; then
                ``gpu_bench.flash_attention_bench`` at its defaults (S =
                1024, 4096, 8192: the loss sum(o^2) and its gradients a
                step, kernels against the plain version) with the launch
                counts zeroed just before and read just after (3 x 9 of
                each kernel, all wgmma), beside SDPA in the same loop. (b)
                ``gpu_bench.llm_serving_bench`` at its defaults
                (gpt2-small, 32 requests of 128 tokens, Poisson arrivals,
                continuous and barrier batching through handle -> router
                -> a ``num_gpus=1`` replica, ``ServedLLM`` in place of
                ``LLMServer``): every request gets its budget of
                in-vocabulary ids, KV pages back at 0, the replica's
                forward launches > 0 and all wgmma. (c)
                ``serve_bench.run_serve_suite(mini=True)``: paged slots
                > slab slots, ratio >= 1.5, the open-loop p50/p99. (d)
                ``device_bench.run_device_suite(payload_mb=64)`` on CUDA
                tensors: ``bytes_avoided_mb`` > 0, the zero-copy speedup
                printed beside its 10x bar (a miss is printed, not
                failed). (e) ``rmt-torch microbenchmark --scale 0.05``
                and the transfer, compression, locality, tracing,
                logging, profile, health, elastic, job-plane, scale and
                pod harnesses at their CPU tests' sizes, one line each.
                (f) ``allreduce_busbw()``: None on one card. Nothing is
                left behind.
  18. train rows — the JAX package's four headline training rows
                through ``train_step_mfu`` at full width, 8 AdamW steps
                each, with the launch counts zeroed just before each row
                and read just after: gpt2-small at B = 16, S = 1024 with
                fp32 and with bf16 parameters (``bf16_params``: the
                parameters, their gradients and both moments in bf16,
                ``gpu_bench.LowPrecisionAdamW``), gpt2-small at B = 4, S =
                4096, and llama-1b (GQA 32/8, 839,976,960 parameters) at
                B = 4, S = 2048 with bf16 parameters. Each row's loss
                finite and falling, each kernel launched once per layer
                per step (12 x 8, 16 x 8), all wgmma; step ms, tokens/s,
                MFU and peak memory printed per row. Then each row's
                attention shape (BH 192 S 1024, BH 48 S 4096, BH 128 S
                2048; D 64) through every kernel against its plain
                version by phase 2's rules, all wgmma, timed beside its
                plain version, SDPA and its bound; one step's gradients
                of each row's model against attention="ref" by phase
                4's rule (the two long rows at 4 layers: "ref" keeps
                each layer's S x S probabilities); and one
                ``LowPrecisionAdamW`` step on the card within one bf16
                step of the same step on the CPU, from the same
                parameters, moments and gradients.
  19. native   — the native tier: (a) ``native/build.py`` builds the C++
                thin client's ``rmt_demo`` and ``rmt_executor_demo`` and
                the shm store's stress test from the checkout's sources
                (g++, each timed) and the stress test must print
                ``STRESS OK`` (its TSan and ASan runs stay in the CPU
                tests); the flash forward kernel at this path's prefill
                shape (fp32, BH = 12, S = 6, D = 64, causal) against its
                plain version. (b) ``rmt.init(num_cpus=4, num_gpus=1)``,
                ``runtime_smoke.cpp_generate`` registered as
                ``cpp_transform`` with ``num_gpus=1`` and a
                ``ClusterServer``; the unchanged ``rmt_demo`` runs against
                it four times, each exiting 0 with ``DEMO OK`` and a
                RESULT line equal, token for token, to the driver's own
                ``gpt.generate`` (fp32 gpt2-small, the same seed, prompt
                ``b"abcdef"``, 16 greedy tokens); each call's prefill in
                the GPU worker launches the forward kernel once per layer
                (12; counts zeroed just before each generate, read just
                after) on the driver's card. The demo's first and warm
                wall times are printed. (c) ``rmt_executor_demo`` joins
                the same cluster; ``rev``'s ObjectRef feeds
                ``runtime_smoke.flip_on_card`` in a ``num_gpus=1`` task,
                which must give back the original bytes from the card;
                round trips timed. Nothing is left behind.

It prints the card's name and power limit first, one JSON line of kernel
figures before the last line (the forward kernel runs on both main paths:
its entry gives the serving figures, and the training ones under keys
ending in ``_train``), and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA card, or run from a
directory that does not hold the repository, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,     # dense tensor-core bf16
            "float32": 67e12}       # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# lse is fp32 from both sides (only the order of the sums differs)
LSE_TOL = dict(atol=1e-3, rtol=1e-4)
# backward: fp32 to 1e-4 (the same fp32 sums, possibly in another
# order); a bf16 output is one rounding (at most 2^-9 relative) of a fp32
# sum of up to 1024 terms, so it is held to twice that relative to |ref|,
# plus 1e-3 of the output's largest |ref| where the sum cancels to ~0
BWD_TOL = {"float32": dict(rtol=1e-4, atol_of_max=0.0, atol=1e-4),
           "bfloat16": dict(rtol=2.0 ** -8, atol_of_max=1e-3, atol=0.0)}
BH, HEAD_DIM = 12, 64               # gpt2-small: 12 heads of 64, one row
MAIN_CASE = ("bfloat16", 992, 992, True)  # the paged prefill's 992 bucket
TRAIN_B, TRAIN_S = 8, 1024          # the training batch of train_step_mfu
TRAIN_BH = TRAIN_B * 12             # attention rows per layer in training
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one call from CUDA events around ``reps`` calls. It
    takes in the host's gaps between launches, so it reads host time where
    a call is short or is several launches behind Python; it is kept only
    under ``*_event_ms`` keys, beside :func:`device_ms`."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3, attempts: int = 5):
    """Mean device time of one call of ``fn``: the summed device time of
    the CUDA kernels (and copies and sets) in a ``torch.profiler`` trace of
    ``reps`` calls, over ``reps``. Returns (ms, names of the device rows).
    Each call launches the same kernels, so a complete trace has every
    row a multiple of ``reps`` times. On the H100 the profiler now and
    then returns a trace with no device rows, or with some calls' rows
    missing (18 of 20); such a trace is taken again, up to ``attempts``
    times, and then this raises: there is no fallback to events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_memory_management_tpu_torch.utils.profile_serve import (
        device_us, kernel_rows)

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = kernel_rows(prof)
        if rows and all(e.count % reps == 0 for e in rows):
            us = sum(device_us(e) for e in rows)
            return us / 1e3 / reps, sorted({e.key for e in rows})
        log(f"[profiler] trace {attempt} of {attempts} incomplete for {reps} "
            f"calls: {[(e.key[:40], e.count) for e in rows]}")
    raise AssertionError(f"device_ms: no complete profiler trace in "
                         f"{attempts} attempts")


def short_names(names, width=60):
    return ", ".join(n if len(n) <= width else n[:width] + "..."
                     for n in names)


def admitted_pairs(s, skv, causal):
    """(row, col) pairs of one head that the mask admits."""
    if not causal:
        return s * skv
    off = skv - s
    return sum(min(skv, max(0, r + off + 1)) for r in range(s))


def _bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def attention_bound(bh, s, skv, d, causal, dtype_name, itemsize,
                    save_lse=False):
    """Least time (ms) for the forward: each of q, k, v, o (and lse) moved
    once, and the QK^T and PV products over the pairs the mask admits."""
    nbytes = (2 * bh * s * d + 2 * bh * skv * d) * itemsize
    nbytes += 4 * bh * s if save_lse else 0
    ops = 4 * bh * admitted_pairs(s, skv, causal) * d
    return _bound(nbytes, ops, dtype_name)


def backward_bound(kernel, bh, s, skv, d, causal, dtype_name, itemsize):
    """Least time (ms) for one backward kernel. dq reads q, dO, k, v, lse
    and delta and writes dq, and runs 3 products (QK^T, dO V^T, ds K) over
    the admitted pairs; dk/dv reads the same and writes dk and dv, and
    runs 4 (QK^T, dO V^T, p^T dO, ds^T Q)."""
    rows_s, rows_kv, products = ((3, 2, 3) if kernel == "dq" else (2, 4, 4))
    nbytes = (rows_s * bh * s * d + rows_kv * bh * skv * d) * itemsize
    nbytes += 2 * 4 * bh * s  # lse and delta, fp32
    ops = 2 * products * bh * admitted_pairs(s, skv, causal) * d
    return _bound(nbytes, ops, dtype_name)


def bwd_close(got, ref, dtype_name, scale=1):
    """(max abs error, worst error over its limit, ok) under ``scale``
    times BWD_TOL for one backward output; ok iff that ratio is at most
    1."""
    t = BWD_TOL[dtype_name]
    err = (got.float() - ref).abs()
    limit = scale * (t["atol"] + t["atol_of_max"] * ref.abs().max()
                     + t["rtol"] * ref.abs())
    # 0 / 0 counts as 0: an output that is exactly 0 where the bound is 0
    ratio = (err / limit).masked_fill(err == 0, 0.0).max().item()
    return err.max().item(), ratio, bool((err <= limit).all())


# ------------------------------------------------------------------ phases
def phase_build():
    """One nvcc per source, all started together; returns the wall time."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_memory_management_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_build.build, SOURCES))
    wall = time.perf_counter() - t0
    for name, (path, seconds, compiler_out) in zip(SOURCES, built):
        for line in compiler_out.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
        log(f"[build] {name}: {path.name}, nvcc {seconds:.2f} s")
    log(f"[build] {len(SOURCES)} libraries in {wall:.2f} s wall")
    return wall


def _sdpa_kwargs(device, s, skv, causal):
    import torch

    if causal and s != skv:  # SDPA aligns is_causal top-left
        mask = (torch.arange(skv, device=device)[None, :]
                <= torch.arange(s, device=device)[:, None] + (skv - s))
        return {"attn_mask": mask}
    return {"is_causal": causal}


def phase_kernels(device):
    """The forward kernel, o and lse, in every case, each case launched
    through the main path's dispatch and checked for the design it took;
    timed (profiler device time) beside its plain version, SDPA and its
    bound; at the serving main case and the training shape also the SIMT
    design in turns with the wgmma one (prev, new, new, prev). Returns
    (rows, serving main row, training shape row)."""
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_simt, fwd_design,
        fwd_design_counts, reference_attention, reference_lse,
        reset_launch_count)

    cases = []
    for dtype_name in ("float32", "bfloat16"):
        for s in (64, 992, 1024):
            for causal in (True, False):
                cases.append((dtype_name, BH, s, s, HEAD_DIM, causal))
        for s, skv in ((64, 1024), (992, 1024)):
            cases.append((dtype_name, BH, s, skv, HEAD_DIM, True))
    cases += [("bfloat16", BH, 992, 992, 128, True),    # D = 128
              ("bfloat16", BH, 1000, 1000, HEAD_DIM, True)]  # ragged S
    train_case = ("bfloat16", TRAIN_BH, TRAIN_S, TRAIN_S, HEAD_DIM, True)
    cases.append(train_case)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, main, train = [], None, None
    for case in cases:
        dtype_name, bh, s, skv, d, causal = case
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=gen,
                               device=device).to(dtype)

        q, k, v = rand(s), rand(skv), rand(skv)
        design = fwd_design(dtype, d)
        reset_launch_count()
        out, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
        torch.cuda.synchronize()
        designs = fwd_design_counts()
        # the plain version in fp32 on the same values: the kernel
        # computes in fp32 and rounds its output to the input dtype (the
        # wgmma design also rounds p to bf16 before P V)
        ref = reference_attention(q.float(), k.float(), v.float(), causal)
        ref_lse = reference_lse(q.float(), k.float(), causal)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL[dtype_name]
        ok = bool(torch.allclose(out.float(), ref, atol=tol, rtol=tol)
                  and torch.allclose(lse, ref_lse, **LSE_TOL)
                  and designs[design] == 1 and sum(designs.values()) == 1)
        save = case == train_case

        def kernel():
            return flash_attention_fwd(q, k, v, causal=causal,
                                       save_lse=save)

        def prev():
            return flash_attention_fwd_simt(q, k, v, causal=causal,
                                            save_lse=save)

        b = bh // BH  # [B, 12 heads, S, D] for SDPA
        kw = _sdpa_kwargs(device, s, skv, causal)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.view(b, -1, s, d), k.view(b, -1, skv, d),
                v.view(b, -1, skv, d), **kw)

        timed = {}
        is_main = ((dtype_name, s, skv, causal) == MAIN_CASE and bh == BH
                   and d == HEAD_DIM)
        compare = is_main or save
        if compare:  # the SIMT design in turns with the wgmma one
            order = (("prev", prev), ("new", kernel), ("new", kernel),
                     ("prev", prev))
            for name, fn in order:
                timed.setdefault(name, []).append(device_ms(fn)[0])
            kernel_ms = sum(timed["new"]) / 2
        else:
            kernel_ms = device_ms(kernel)[0]
        plain_ms = device_ms(
            lambda: (reference_attention(q, k, v, causal),
                     reference_lse(q, k, causal) if save else None),
            reps=5)[0]
        library_ms, library_kernels = device_ms(sdpa)
        bound_ms, bound_by, nbytes, ops = attention_bound(
            bh, s, skv, d, causal, dtype_name, q.element_size(),
            save_lse=save)
        row = dict(dtype=dtype_name, BH=bh, S=s, Skv=skv, D=d,
                   causal=causal, save_lse=save, design=design,
                   designs=designs, max_abs_err=err,
                   lse_max_abs_err=lse_err, tol=tol, ok=ok,
                   kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_kernels=library_kernels,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   ops=ops, tflops=ops / (kernel_ms * 1e-3) / 1e12)
        extra = ""
        if compare:
            row["kernel_event_ms"] = cuda_time_ms(kernel)
            row["library_event_ms"] = cuda_time_ms(sdpa)
            row["prev_ms"] = sum(timed["prev"]) / 2
            row["prev_tflops"] = ops / (row["prev_ms"] * 1e-3) / 1e12
            row["turns_ms"] = timed
            extra = (f" [turns prev {timed['prev'][0]:.4f} new "
                     f"{timed['new'][0]:.4f} new {timed['new'][1]:.4f} prev "
                     f"{timed['prev'][1]:.4f}] prev_ms={row['prev_ms']:.4f} "
                     f"({row['prev_tflops']:.1f} TFLOP/s) event_ms kernel "
                     f"{row['kernel_event_ms']:.4f} sdpa "
                     f"{row['library_event_ms']:.4f}; sdpa kernels: "
                     f"{short_names(library_kernels)}")
        rows.append(row)
        log(f"[kernels] flash_fwd {dtype_name:8s} BH={bh} S={s:4d} "
            f"Skv={skv:4d} D={d} causal={causal!s:5s} design={design} "
            f"max_abs_err={err:.3e} (tol {tol:g}, atol=rtol) "
            f"lse_err={lse_err:.2e} {'ok' if ok else 'FAIL'} "
            f"kernel_ms={kernel_ms:.4f}{' (lse)' if save else ''} "
            f"({row['tflops']:.1f} TFLOP/s) plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({bound_by}){extra}")
        if is_main:
            main = row
        if save:
            train = row
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version "
                             f"or took another design in {len(bad)} "
                             f"case(s): {bad}")
    return rows, main, train


def phase_backward(device):
    """dq and dk/dv kernels against ``reference_flash_bwd`` (in fp32 on the
    same values, with o and lse from the forward kernel), each case
    checked for the design it took; then, at the main backward case, each
    kernel timed in turns with its SIMT design (prev, new, new, prev),
    beside its plain version, its bound and the SDPA backward of the
    pair."""
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        DKV, DQ, SIMT, WGMMA, bwd_design, bwd_design_counts,
        flash_attention_bwd,
        flash_attention_dkv, flash_attention_dkv_simt, flash_attention_dq,
        flash_attention_dq_simt, flash_attention_fwd, reference_delta,
        reference_flash_bwd, reference_flash_dkv, reference_flash_dq,
        reference_lse, reset_launch_count)

    main_case = ("bfloat16", TRAIN_BH, TRAIN_S, TRAIN_S, HEAD_DIM, True)
    cases = [main_case, ("float32",) + main_case[1:]]
    for dtype_name in ("bfloat16", "float32"):
        cases += [(dtype_name, BH, 1024, 1024, HEAD_DIM, False),
                  (dtype_name, BH, 64, 1024, HEAD_DIM, True),
                  (dtype_name, BH, 992, 1024, HEAD_DIM, True),
                  (dtype_name, BH, 67, 67, HEAD_DIM, True),
                  (dtype_name, BH, 131, 131, HEAD_DIM, False),
                  (dtype_name, BH, 1000, 1000, HEAD_DIM, True),
                  (dtype_name, BH, 1, 77, HEAD_DIM, True),
                  (dtype_name, BH, 96, 160, 128, True)]
    gen = torch.Generator(device=device).manual_seed(1)
    rows, main = [], None
    for case in cases:
        dtype_name, bh, s, skv, d, causal = case
        dtype = getattr(torch, dtype_name)

        def rand(n):
            return torch.randn((bh, n, d), generator=gen,
                               device=device).to(dtype)

        q, k, v, do = rand(s), rand(skv), rand(skv), rand(s)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, save_lse=True)
        design = bwd_design(dtype, d)
        reset_launch_count()
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        designs = bwd_design_counts()
        other = SIMT if design == WGMMA else WGMMA
        design_ok = all(designs[n] == {design: 1, other: 0}
                        for n in (DQ, DKV))
        want = reference_flash_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), causal)
        checks = [bwd_close(g, w, dtype_name) for g, w in zip(got, want)]
        lse_ok = bool(torch.allclose(
            lse, reference_lse(q.float(), k.float(), causal), **LSE_TOL))
        ok = lse_ok and design_ok and all(c[2] for c in checks)
        errs = {f"d{n}": c[0] for n, c in zip("qkv", checks)}
        ratios = {f"d{n}_over_limit": c[1] for n, c in zip("qkv", checks)}
        row = dict(dtype=dtype_name, BH=bh, S=s, Skv=skv, D=d,
                   causal=causal, design=design, designs=designs, ok=ok,
                   lse_ok=lse_ok, **errs, **ratios)
        del want
        if case == main_case:
            delta = reference_delta(o, do)

            def dq():
                return flash_attention_dq(q, k, v, do, lse, delta, causal)

            def dkv():
                return flash_attention_dkv(q, k, v, do, lse, delta, causal)

            def dq_prev():
                return flash_attention_dq_simt(q, k, v, do, lse, delta,
                                               causal)

            def dkv_prev():
                return flash_attention_dkv_simt(q, k, v, do, lse, delta,
                                                causal)

            # the SIMT design in turns with the wgmma one, per kernel
            for kernel, new, prev in (("dq", dq, dq_prev),
                                      ("dkv", dkv, dkv_prev)):
                timed = {}
                for name, fn in (("prev", prev), ("new", new),
                                 ("new", new), ("prev", prev)):
                    timed.setdefault(name, []).append(device_ms(fn)[0])
                row[f"{kernel}_ms"] = sum(timed["new"]) / 2
                row[f"{kernel}_prev_ms"] = sum(timed["prev"]) / 2
                row[f"{kernel}_turns_ms"] = timed
            row["dq_event_ms"] = cuda_time_ms(dq)
            row["dkv_event_ms"] = cuda_time_ms(dkv)
            row["dq_plain_ms"] = device_ms(lambda: reference_flash_dq(
                q, k, v, do, lse, delta, causal), reps=5)[0]
            row["dkv_plain_ms"] = device_ms(lambda: reference_flash_dkv(
                q, k, v, do, lse, delta, causal), reps=5)[0]
            # the yardstick: SDPA's backward for the pair (dq, dk, dv
            # together) on a retained graph; only the backward is traced
            b = bh // 12
            leaves = [t.view(b, 12, -1, d).detach().requires_grad_()
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            do4 = do.view(b, 12, s, d)

            def pair():
                return torch.autograd.grad(out, leaves, do4,
                                           retain_graph=True)

            row["pair_library_ms"], row["pair_library_kernels"] = (
                device_ms(pair))
            row["pair_library_event_ms"] = cuda_time_ms(pair)
            for kernel in ("dq", "dkv"):
                bound_ms, bound_by, nbytes, ops = backward_bound(
                    kernel, bh, s, skv, d, causal, dtype_name,
                    q.element_size())
                row[f"{kernel}_bound_ms"] = bound_ms
                row[f"{kernel}_bound_by"] = bound_by
                row[f"{kernel}_bytes"], row[f"{kernel}_ops"] = nbytes, ops
                # the function's products (3 and 4), not the split's 4, 6
                for key in ("", "prev_"):
                    row[f"{kernel}_{key}tflops"] = (
                        ops / (row[f"{kernel}_{key}ms"] * 1e-3) / 1e12)
            main = row
            del out, leaves
        rows.append(row)
        timing = "".join(
            f" {n}_ms={row[f'{n}_ms']:.4f} ({row[f'{n}_tflops']:.1f} "
            f"TFLOP/s; turns prev {row[f'{n}_turns_ms']['prev'][0]:.4f} "
            f"new {row[f'{n}_turns_ms']['new'][0]:.4f} new "
            f"{row[f'{n}_turns_ms']['new'][1]:.4f} prev "
            f"{row[f'{n}_turns_ms']['prev'][1]:.4f}; prev_ms "
            f"{row[f'{n}_prev_ms']:.4f}, plain {row[f'{n}_plain_ms']:.4f}, "
            f"bound {row[f'{n}_bound_ms']:.5f} {row[f'{n}_bound_by']})"
            for n in ("dq", "dkv")) if case == main_case else ""
        timing += (f" sdpa_bwd_pair_ms={row['pair_library_ms']:.4f} "
                  f"(event_ms dq {row['dq_event_ms']:.4f} dkv "
                  f"{row['dkv_event_ms']:.4f} sdpa pair "
                  f"{row['pair_library_event_ms']:.4f}; sdpa kernels: "
                  f"{short_names(row['pair_library_kernels'])})"
                  if case == main_case else "")
        log(f"[kernels] flash_bwd {dtype_name:8s} BH={bh} S={s:4d} "
            f"Skv={skv:4d} D={d} causal={causal!s:5s} design={design} "
            f"max_abs_err "
            + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
            + " err/limit " + " ".join(f"{c[1]:.3f}" for c in checks)
            + f" lse {'ok' if lse_ok else 'FAIL'} "
            f"{'ok' if ok else 'FAIL'}{timing}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_bwd disagrees with its plain version "
                             f"or took another design in {len(bad)} "
                             f"case(s): {bad}")
    return rows, main


def phase_forward(device, preset="gpt2-small", batch=8, seq=1024):
    """Full-width forward with the kernel vs attention="ref". bf16 is held
    to the plain path's own rounding noise (its distance to the fp32
    model, times two); fp32 to a fixed tolerance."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        fwd_design_counts, launch_count, reset_launch_count)

    cfg = gpt.PRESETS[preset]
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init_params(cfg, gen, device)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    with torch.inference_mode():
        reset_launch_count()
        t0 = time.perf_counter()
        logits = gpt.forward(params, toks, cfg)
        sync()
        fwd_s = time.perf_counter() - t0
        launches = launch_count()
        designs = fwd_design_counts()
        ref = gpt.forward(params, toks, dataclasses.replace(
            cfg, attention="ref"))
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        ref32 = gpt.forward(params, toks, dataclasses.replace(
            f32, attention="ref"))
        ker32 = gpt.forward(params, toks, f32)
        sync()
    err = (logits - ref).abs().max().item()
    floor = (ref - ref32).abs().max().item()
    err32 = (ker32 - ref32).abs().max().item()
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(ker32).all())
    shape_ok = tuple(logits.shape) == (batch, seq, cfg.vocab_size)
    tol32 = 1e-3
    log(f"[forward] {preset} B={batch} S={seq}: bf16 kernel-vs-ref "
        f"max_abs_err={err:.4e} (limit 2 x bf16 noise floor "
        f"{floor:.4e}); fp32 kernel-vs-ref max_abs_err={err32:.3e} "
        f"(tol {tol32:g}); flash launches={launches} {designs} "
        f"(expect {cfg.n_layers}, all wgmma); first bf16 forward "
        f"{fwd_s * 1e3:.1f} ms")
    if not (finite and shape_ok):
        raise AssertionError("forward logits are not finite or misshaped")
    if err > 2 * floor or err32 > tol32:
        raise AssertionError("forward with the kernel disagrees with "
                             "attention='ref'")
    if device.type == "cuda" and (launches != cfg.n_layers
                                  or designs["wgmma"] != cfg.n_layers):
        raise AssertionError(f"expected {cfg.n_layers} flash launches, all "
                             f"wgmma, got {launches} {designs}")
    return dict(err=err, floor=floor, err32=err32, launches=launches,
                designs=designs)


def phase_grad(device, preset="gpt2-small", batch=TRAIN_B, seq=TRAIN_S,
               n_layers=None):
    """Full-width gradients of ``loss_fn`` with the kernels vs
    attention="ref" (``n_layers`` cuts the depth; a ``seq`` past the
    preset's ``max_seq`` widens it, as ``setup_training`` does). fp32 is
    held to 1e-3 of each leaf's largest
    gradient; bf16 to twice the plain path's own rounding noise (its
    distance to the fp32 model), leaf by leaf. A MoE model's routing is
    discontinuous: a rounding-sized change of a router input can move a
    token to another expert, which moves its gradient wholesale. The
    fp32 kernel run therefore replays the fp32 "ref" run's expert
    choices, so that the fp32 rule measures the kernels alone; the
    tokens whose own choice differed are counted and printed. (The bf16
    rule's floor, bf16 against fp32, holds such moves already.)"""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
    from ray_memory_management_tpu_torch.ops.moe import pinned_routing
    from ray_memory_management_tpu_torch.utils import gpu_bench

    cfg = gpt.PRESETS[preset]
    over = {"n_layers": n_layers} if n_layers else {}
    if seq > cfg.max_seq:
        over["max_seq"] = seq
    cfg = dataclasses.replace(cfg, attention="flash", **over)
    gen = torch.Generator(device=device).manual_seed(2)
    params = gpt.init_params(cfg, gen, device)
    data = gpu_bench.make_batch(cfg, batch, seq, gen, device)
    leaves = [t.requires_grad_() for t in gpt.param_leaves(params)]
    names = [f"{k}.{n}" if isinstance(v, dict) else k
             for k, v in params.items()
             for n in (v if isinstance(v, dict) else [None])]

    def grads(c):
        loss = gpt.loss_fn(params, data, c)
        return loss.item(), torch.autograd.grad(loss, leaves)

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    reset_launch_count()
    loss_k, gk = grads(cfg)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    loss_r, gr = grads(dataclasses.replace(cfg, attention="ref"))
    choices, flips = [], []
    with pinned_routing(record=choices):
        loss_r32, gr32 = grads(dataclasses.replace(f32, attention="ref"))
    with pinned_routing(replay=choices, flips=flips):
        loss_k32, gk32 = grads(f32)
    torch.cuda.synchronize()
    tol32, rows = 1e-3, []
    for name, a, b, c, d in zip(names, gk, gr, gr32, gk32):
        scale = c.abs().max().item()
        rows.append(dict(leaf=name, err=(a - b).abs().max().item(),
                         floor=(b - c).abs().max().item(),
                         err32=(d - c).abs().max().item(), scale32=scale,
                         finite=bool(torch.isfinite(a).all()
                                     and torch.isfinite(d).all())))
    moved = int(sum(flips))
    bf16_ok = all(r["err"] <= 2 * r["floor"] for r in rows)
    fp32_ok = all(r["err32"] <= tol32 * r["scale32"] for r in rows)
    finite = all(r["finite"] for r in rows)
    worst = max(rows, key=lambda r: r["err"] / r["floor"])
    worst32 = max(rows, key=lambda r: r["err32"] / r["scale32"])
    log(f"[grad] {preset} L={cfg.n_layers} B={batch} S={seq}: loss bf16 "
        f"kernel {loss_k:.5f} "
        f"ref {loss_r:.5f}, fp32 kernel {loss_k32:.6f} ref {loss_r32:.6f}; "
        f"bf16 worst leaf {worst['leaf']} max_abs_err={worst['err']:.3e} "
        f"(limit 2 x bf16 noise floor {worst['floor']:.3e}); fp32 worst "
        f"leaf {worst32['leaf']} max_abs_err={worst32['err32']:.3e} "
        f"(tol {tol32:g} x max|grad| {worst32['scale32']:.3e}"
        + (f", routing replayed: {moved} of "
           f"{sum(c.numel() for c in choices)} fp32 kernel choices differed"
           if cfg.n_experts else "") + "); launches "
        f"{launches} forward {designs} backward {bwd_designs} (expect "
        f"{cfg.n_layers} each, all wgmma)")
    if not finite:
        raise AssertionError("grad: non-finite gradients")
    if not (bf16_ok and fp32_ok):
        raise AssertionError(f"grad: gradients with the kernels disagree "
                             f"with attention='ref': {rows}")
    if (any(n != cfg.n_layers for n in launches.values())
            or designs["wgmma"] != cfg.n_layers
            or any(c["wgmma"] != cfg.n_layers
                   for c in bwd_designs.values())):
        raise AssertionError(f"grad: launches {launches} {designs} "
                             f"{bwd_designs}, expected {cfg.n_layers} of "
                             f"each kernel, all wgmma")
    return dict(loss_bf16=loss_k, loss_ref_bf16=loss_r, loss_fp32=loss_k32,
                loss_ref_fp32=loss_r32, worst_bf16=worst, worst_fp32=worst32,
                routing_flips_fp32=moved,
                launches=launches, designs=designs, bwd_designs=bwd_designs)


def _serve_requests(vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    # a few tokens up to past the 992 cap (clipped into the 992 bucket)
    lens = (5, 40, 64, 100, 250, 513, 800, 991, 1000)
    reqs = [{"tokens": rng.integers(2, vocab, size=n).tolist()}
            for n in lens]
    reqs.append({"text": "The port serves GPT-2 small on one card."})
    return reqs


def _burst(srv, reqs):
    """Send every request from its own thread at once; return (results,
    per-request latencies in s, wall s, errors, requests still hung)."""
    results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []

    def call(i):
        t0 = time.perf_counter()
        try:
            results[i] = srv(reqs[i])
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errors.append(repr(e))
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    return results, lat, wall, errors, sum(t.is_alive() for t in threads)


def phase_serve(device, preset="gpt2-small", max_batch_size=8,
                max_new_tokens=32, seed=0, bursts=3):
    """The main path, driven once with the launch counts zeroed around it,
    then ``bursts - 1`` more times for timing only (host time varies from
    run to run; the median burst is reported, every burst is printed)."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        fwd_design_counts, launch_count, reset_launch_count)
    from ray_memory_management_tpu_torch.serve.llm import LLMServer

    srv = LLMServer(preset=preset, max_batch_size=max_batch_size,
                    max_new_tokens=max_new_tokens, batching="continuous",
                    kv_cache="paged", seed=seed,
                    device=None if device.type == "cuda" else device)
    try:
        srv({"tokens": [5, 6, 7]})  # warm-up: allocator, cuBLAS handles
        reqs = _serve_requests(srv.cfg.vocab_size, seed)
        reset_launch_count()
        runs = [_burst(srv, reqs)]
        launches = launch_count()
        designs = fwd_design_counts()
        stats = srv.stats()
        runs += [_burst(srv, reqs) for _ in range(bursts - 1)]
    finally:
        srv.close()
    if any(errors or hung for _, _, _, errors, hung in runs):
        raise AssertionError(f"serve: failed or hung requests: "
                             f"{[(r[3], r[4]) for r in runs]}")
    results = runs[0][0]
    gen_tokens = sum(len(r["tokens"]) for r in results)
    answers = [r for run in runs for r in run[0]]
    budget_ok = all(len(r["tokens"]) == max_new_tokens for r in answers)
    vocab_ok = all(0 <= t < srv.cfg.vocab_size
                   for r in answers for t in r["tokens"])
    pages = stats["kv"]["pages_in_use"]
    need = srv.cfg.n_layers * len(reqs)
    walls = [w for _, _, w, _, _ in runs]
    wall = float(np.median(walls))
    lat_ms = sorted(x * 1e3 for _, lat, _, _, _ in runs for x in lat)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    log(f"[serve] {preset} on {where}, paged continuous, {len(reqs)} "
        f"concurrent requests (prompt lens "
        f"{[r['prompt_len'] for r in results]}), "
        f"{len(runs)} bursts: walls {[round(w, 3) for w in walls]} s; "
        f"median {len(reqs) / wall:.2f} requests/s, "
        f"{gen_tokens / wall:.1f} generated tokens/s; latency over "
        f"{len(lat_ms)} requests median {float(np.median(lat_ms)):.1f} ms "
        f"max {lat_ms[-1]:.1f} ms; flash launches in the first burst="
        f"{launches} {designs} (need >= {need}, all wgmma); pages_in_use "
        f"after it={pages}; "
        f"kv_backpressure={stats['kv']['kv_backpressure']}")
    if not (budget_ok and vocab_ok):
        raise AssertionError("serve: a request missed its token budget or "
                             "returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"serve: {pages} KV pages still in use")
    if device.type == "cuda" and launches < need:
        raise AssertionError(f"serve: {launches} flash launches, fewer than "
                             f"one per layer per request ({need})")
    if device.type == "cuda" and designs["wgmma"] != launches:
        raise AssertionError(f"serve: flash launches by design {designs}; "
                             f"every one of {launches} should be wgmma")
    return dict(launches=launches, designs=designs, walls_s=walls,
                requests_per_s=len(reqs) / wall,
                tokens_per_s=gen_tokens / wall, requests=len(reqs),
                latency_ms_median=float(np.median(lat_ms)),
                latency_ms_max=lat_ms[-1])


def phase_engine_parity(device, preset="gpt2-small", new_tokens=8):
    """fp32 engine at full width vs per-prompt ``gpt.generate``: the
    batched, paged, bucketed path must give the same greedy tokens."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.llm import ContinuousBatcher

    cfg = dataclasses.replace(gpt.PRESETS[preset], dtype=torch.float32)
    params = gpt.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(1), device)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab_size,
                            size=min(n, cfg.max_seq - new_tokens)).tolist()
               for n in (7, 130, 991)]
    eng = ContinuousBatcher(params, cfg, max_slots=4,
                            max_new_tokens=new_tokens, kv_cache="paged")
    try:
        got = [None] * len(prompts)

        def call(i):
            got[i] = eng.submit(prompts[i], timeout=600)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        eng.close()
    with torch.inference_mode():
        want = [gpt.generate(params, cfg, torch.tensor([p], device=device),
                             new_tokens)[0, len(p):].tolist()
                for p in prompts]
    same = got == want
    log(f"[serve] fp32 engine vs gpt.generate, prompt lens "
        f"{[len(p) for p in prompts]}: greedy tokens "
        f"{'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"engine tokens {got} != generate {want}")


def phase_train(device, steps=8, preset="gpt2-small", batch=TRAIN_B,
                seq=TRAIN_S, bf16_params=False):
    """The training main path: ``train_step_mfu`` (gpt2-small, B = 8,
    S = 1024, AdamW, fp32 parameters, unless told otherwise) with the
    launch counts zeroed just before its steps and read just after."""
    import math

    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
    from ray_memory_management_tpu_torch.utils.gpu_bench import (
        train_step_mfu)

    n_layers = gpt.PRESETS[preset].n_layers
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_count()
    r = train_step_mfu(preset, batch_size=batch, seq_len=seq, steps=steps,
                       device=device, bf16_params=bf16_params)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    losses = r["losses"]
    log(f"[train] {preset} B={batch} S={seq} "
        f"{'bf16' if bf16_params else 'fp32'} params on {r['device']}: "
        f"{steps} AdamW steps, losses {[round(x, 4) for x in losses]}; "
        f"step_ms={r['step_ms']:.2f} tokens_per_s={r['tokens_per_s']:.1f} "
        f"mfu={r['mfu']:.4f} (PaLM accounting, 989 TFLOP/s peak) "
        f"n_params={r['n_params']} peak_mem={peak_gb:.2f} GB; launches "
        f"{launches} forward {designs} backward {bwd_designs} (need "
        f"{n_layers * steps} each, all wgmma)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("train: non-finite loss")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if (any(n != n_layers * steps for n in launches.values())
            or designs["wgmma"] != n_layers * steps
            or any(c["wgmma"] != n_layers * steps
                   for c in bwd_designs.values())):
        raise AssertionError(f"train: launches {launches} {designs} "
                             f"{bwd_designs}, expected {n_layers * steps} "
                             f"of each kernel, all wgmma")
    return dict(r, launches=launches, designs=designs,
                bwd_designs=bwd_designs, peak_mem_gb=peak_gb)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    """Bytes the caching allocator holds in live tensors, after the
    queued work is done."""
    import torch

    _sync(device)
    return torch.cuda.memory_allocated(device)


def _bits(t):
    """A tensor's raw bits, for bit-exact comparison (NaN-safe)."""
    import torch

    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                    t.element_size()])


def _bit_equal(a, b) -> bool:
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a.cpu()), _bits(b.cpu())))


def _runtime_device_tier(device, rt, n):
    """Driver device tier: zero-copy get, consume, then LRU demotion of
    a tier bounded at three tensors of ``n`` fp32 values and
    re-promotion onto the card."""
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.exceptions import ObjectLostError

    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn(n, device=device, generator=gen)
    ptr = x.data_ptr()
    ref = rmt.put(x, device=True)
    got = rmt.get(ref)
    if got is not x or got.data_ptr() != ptr:
        raise AssertionError("runtime: device-tier get is not the pinned "
                             "tensor")
    del got
    taken = rmt.get(ref, consume=True)
    if taken.data_ptr() != ptr or rt.device_store.contains(ref.binary()):
        raise AssertionError("runtime: consume did not hand over the "
                             "pinned tensor")
    try:
        rmt.get(ref, timeout=5)
    except ObjectLostError:
        pass
    else:
        raise AssertionError("runtime: a consumed ref is still readable")
    del x, taken, ref

    nbytes = n * 4
    refs, first = [], None
    for i in range(3):
        t = torch.randn(n, device=device, generator=gen)
        if i == 0:
            first = t.cpu()
        refs.append(rmt.put(t, device=True))
        del t
    fourth = torch.randn(n, device=device, generator=gen)
    before = _allocated(device)
    refs.append(rmt.put(fourth, device=True))
    del fourth
    after = _allocated(device)
    demoted = not rt.device_store.contains(refs[0].binary())
    resident = rt.device_store.count()
    back = rmt.get(refs[0])
    repromoted = rt.device_store.contains(refs[0].binary())
    ok = (demoted and resident == 3 and before - after == nbytes
          and back.device.type == device.type and _bit_equal(back, first)
          and repromoted)
    log(f"[runtime] device tier: get returns the pinned tensor (same "
        f"data_ptr), consume hands it over and kills the ref; a tier of "
        f"3 x {nbytes / 2**20:.0f} MiB demoted the LRU tensor to shm when "
        f"a fourth was pinned: demoted={demoted} resident={resident} "
        f"memory_allocated fell {before - after} bytes (want {nbytes}); "
        f"next get on {back.device} bit-equal={_bit_equal(back, first)} "
        f"re-promoted={repromoted}")
    if not ok:
        raise AssertionError("runtime: device-tier demotion or "
                             "re-promotion failed")
    del back, refs


def _runtime_host_path(device, nbytes=256 << 20, reps=3):
    """CUDA tensors through the host object plane (device→host copy,
    shm store, host→device copy): bit-exact, with put and get GB/s."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt

    gen = torch.Generator(device=device).manual_seed(12)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = nbytes // torch.tensor([], dtype=dtype).element_size()
        x = torch.randn(n, device=device, generator=gen).to(dtype)
        puts, gets = [], []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            ref = rmt.put(x)
            puts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            y = rmt.get(ref)
            _sync(device)
            gets.append(time.perf_counter() - t0)
            if not (y.device.type == device.type and _bit_equal(y, x)):
                raise AssertionError(f"runtime: a {dtype} CUDA tensor did "
                                     f"not come back bit-equal on cuda "
                                     f"(got {y.device})")
            del ref, y
        name = str(dtype).removeprefix("torch.")
        out[name] = dict(put_gb_s=nbytes / float(np.median(puts)) / 1e9,
                         get_gb_s=nbytes / float(np.median(gets)) / 1e9,
                         put_s=puts, get_s=gets)
        log(f"[runtime] host path {name} {nbytes >> 20} MiB: bit-equal on "
            f"{device.type}; put {out[name]['put_gb_s']:.2f} GB/s, get "
            f"{out[name]['get_gb_s']:.2f} GB/s (median of {reps}; puts "
            f"{[round(t, 4) for t in puts]} s, gets "
            f"{[round(t, 4) for t in gets]} s)")
        del x
    return out


def _runtime_gpu_task(device, warm=10, lease=None, node=None,
                      tag="runtime"):
    """A ``num_gpus=1`` task runs the forward kernel in its worker on
    q, k, v passed as ObjectRefs at the serving prefill shape. ``lease``
    is the ``CUDA_VISIBLE_DEVICES`` the worker must see (default: the
    driver's first card) and ``node`` the node it must run on (default:
    any)."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    gen = torch.Generator(device=device).manual_seed(13)
    q, k, v = (torch.randn(BH, MAIN_CASE[1], HEAD_DIM, device=device,
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    refs = [rmt.put(t) for t in (q, k, v)]
    attend = rmt.remote(runtime_smoke.attend).options(num_gpus=1)
    t0 = time.perf_counter()
    first = rmt.get(attend.remote(*refs), timeout=600)
    first_s = time.perf_counter() - t0
    warm_s = []
    for _ in range(warm):
        t0 = time.perf_counter()
        rmt.get(attend.remote(*refs), timeout=600)
        warm_s.append(time.perf_counter() - t0)
    with torch.inference_mode():
        want = flash_attention(q, k, v, causal=True)
    out = first["out"]
    launches = first["launches"]["flash_attention_fwd"]
    driver_lease, uuid = _driver_card(device)
    lease = driver_lease if lease is None else lease
    on_node = node is None or first["node_id"] == node.hex()
    ok = (out.device.type == device.type and _bit_equal(out, want)
          and launches >= 1 and first["designs"]["wgmma"] == launches
          and first["cuda_visible_devices"] == lease
          and first["device_uuid"] == uuid and on_node)
    where = "" if node is None else (
        f" on node {first['node_id'][:8]} (want {node.hex()[:8]})")
    log(f"[{tag}] GPU task (num_gpus=1){where} flash_attention bf16 BH={BH} "
        f"S={MAIN_CASE[1]} D={HEAD_DIM} causal from ObjectRefs: output on "
        f"{out.device} bit-equal to the driver's call="
        f"{_bit_equal(out, want)}; worker CUDA_VISIBLE_DEVICES="
        f"{first['cuda_visible_devices']!r} (want {lease!r}), its card "
        f"the driver's={first['device_uuid'] == uuid}, launches "
        f"{first['launches']} "
        f"{first['designs']}; first call {first_s:.3f} s (spawn, torch "
        f"import, CUDA init, library load), warm median "
        f"{float(np.median(warm_s)) * 1e3:.1f} ms over {warm}")
    if not ok:
        raise AssertionError(f"{tag}: the GPU task's kernel call failed "
                             "its checks")
    return dict(first_s=first_s, warm_ms_median=float(np.median(warm_s))
                * 1e3, warm_s=warm_s, launches=launches,
                designs=first["designs"])


def _runtime_actor(device, serve, preset="gpt2-small", max_batch_size=8,
                   max_new_tokens=32, seed=0, lease=None, node=None,
                   tag="runtime", keep=False):
    """A GPU actor serving gpt2-small: ``phase_serve``'s burst through
    ``.generate.remote``, then greedy parity with an in-process
    ``LLMServer`` of the same seed, one prompt at a time. ``lease`` and
    ``node`` as for ``_runtime_gpu_task`` (a ``node`` also pins the
    actor there); with ``keep`` the live actor is returned under
    ``"actor"`` instead of killed."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.llm import (
        LLMServer, _bytes_tokenize)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    cfg = gpt.PRESETS[preset]
    opts = dict(num_gpus=1, max_concurrency=16)
    if node is not None:
        from ray_memory_management_tpu_torch.core.scheduling_strategies \
            import NodeAffinitySchedulingStrategy

        opts["scheduling_strategy"] = NodeAffinitySchedulingStrategy(
            node_id=node, soft=False)
    served = rmt.remote(runtime_smoke.ServedLLM).options(**opts)
    t0 = time.perf_counter()
    actor = served.remote(preset=preset, max_batch_size=max_batch_size,
                          max_new_tokens=max_new_tokens, seed=seed)
    rmt.get(actor.generate.remote([5, 6, 7]), timeout=600)  # warm-up
    start_s = time.perf_counter() - t0
    prompts = [r["tokens"] if "tokens" in r
               else _bytes_tokenize(r["text"], cfg.vocab_size)
               for r in _serve_requests(cfg.vocab_size, seed)]
    rmt.get(actor.reset_counters.remote(), timeout=60)
    t0 = time.perf_counter()
    outs = rmt.get([actor.generate.remote(p) for p in prompts], timeout=600)
    wall = time.perf_counter() - t0
    c = rmt.get(actor.counters.remote(), timeout=60)
    launches = c["launches"]["flash_attention_fwd"]
    pages = c["stats"]["kv"]["pages_in_use"]
    need = cfg.n_layers * len(prompts)
    gen_tokens = sum(len(o) for o in outs)
    budget_ok = all(len(o) == max_new_tokens for o in outs)
    vocab_ok = all(0 <= t < cfg.vocab_size for o in outs for t in o)

    rng = np.random.default_rng(2)
    seq = [rng.integers(2, cfg.vocab_size, size=n).tolist()
           for n in (7, 130, 600)]
    srv = LLMServer(preset=preset, max_batch_size=max_batch_size,
                    max_new_tokens=max_new_tokens, seed=seed,
                    device=device)
    try:
        mine = [srv.generate(p) for p in seq]
    finally:
        srv.close()
    theirs = [rmt.get(actor.generate.remote(p), timeout=600) for p in seq]
    same = mine == theirs
    if not keep:
        rmt.kill(actor)
    rps, tps = len(prompts) / wall, gen_tokens / wall
    driver_lease, uuid = _driver_card(device)
    lease = driver_lease if lease is None else lease
    on_node = node is None or c["node_id"] == node.hex()
    where = "" if node is None else (
        f" on node {c['node_id'][:8]} (want {node.hex()[:8]})")
    log(f"[{tag}] GPU actor {preset}{where} on {c['device']} (worker "
        f"CUDA_VISIBLE_DEVICES={c['cuda_visible_devices']!r}, want "
        f"{lease!r}; its card the driver's={c['device_uuid'] == uuid}), "
        f"started in "
        f"{start_s:.2f} s; burst of {len(prompts)} concurrent "
        f".generate.remote requests: wall {wall:.3f} s, {rps:.2f} "
        f"requests/s, {tps:.1f} generated tokens/s (in-process "
        f"phase_serve median: {serve['requests_per_s']:.2f} requests/s, "
        f"{serve['tokens_per_s']:.1f} tokens/s); flash launches "
        f"{launches} {c['designs']} (need >= {need}, all wgmma); "
        f"pages_in_use after it={pages}; sequential greedy tokens vs an "
        f"in-process LLMServer of seed {seed}, prompt lens "
        f"{[len(p) for p in seq]}: {'equal' if same else 'DIFFER'}")
    if not (budget_ok and vocab_ok):
        raise AssertionError(f"{tag}: an actor request missed its token "
                             "budget or returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"{tag}: the actor holds {pages} KV pages")
    if launches < need or c["designs"]["wgmma"] != launches:
        raise AssertionError(f"{tag}: actor flash launches {launches} "
                             f"{c['designs']}, need >= {need}, all wgmma")
    if (c["cuda_visible_devices"] != lease or c["device_uuid"] != uuid
            or not c["device"].startswith("cuda") or not on_node):
        raise AssertionError(f"{tag}: the actor runs on {c['device']} "
                             f"with CUDA_VISIBLE_DEVICES="
                             f"{c['cuda_visible_devices']!r} on node "
                             f"{c['node_id']}")
    if not same:
        raise AssertionError(f"{tag}: actor tokens {theirs} != "
                             f"in-process {mine}")
    out = dict(start_s=start_s, wall_s=wall, requests_per_s=rps,
               tokens_per_s=tps, launches=launches, designs=c["designs"],
               requests=len(prompts))
    if keep:
        out["actor"] = actor
    return out


def _driver_card(device):
    """(the ``CUDA_VISIBLE_DEVICES`` a one-GPU lease must export, the
    UUID of the driver's card): a GPU worker must run on the driver's
    card, whatever the driver's own variable says."""
    from ray_memory_management_tpu_torch.core.node_manager import (
        visible_devices)
    from ray_memory_management_tpu_torch.utils.runtime_smoke import (
        _device_uuid)

    return visible_devices(1)[0], _device_uuid(device)


def _port_processes():
    """PIDs of live node-agent, worker and zygote processes of the
    port."""
    marks = (b"ray_memory_management_tpu_torch.core.worker_main",
             b"ray_memory_management_tpu_torch.core.zygote",
             b"ray_memory_management_tpu_torch.core.node_agent")
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == os.getpid():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{name}/stat", "rb") as f:
                state = f.read().rsplit(b")", 1)[1].split()[0]
        except OSError:
            continue
        if state != b"Z" and any(m in cmd for m in marks):
            pids.append(int(name))
    return pids


def _leftovers(wait_s=20.0):
    """(shm segments of this driver and of any node agent, live
    node-agent/worker/zygote processes of the port), waiting up to
    ``wait_s`` for a shutdown to clear them."""
    prefixes = (f"rmt_{os.getpid()}_", "rmtA_")
    deadline = time.monotonic() + wait_s
    while True:
        segs = [n for n in os.listdir("/dev/shm") if n.startswith(prefixes)]
        procs = _port_processes()
        if not (segs or procs) or time.monotonic() > deadline:
            return segs, procs
        time.sleep(0.2)


def phase_runtime(device, serve, card, tier_n=16 << 20):
    """The runtime core on the card (see the module docstring, phase 7)."""
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.config import Config

    cfg = Config(device_store_capacity_bytes=3 * tier_n * 4)
    t0 = time.perf_counter()
    rt = rmt.init(num_cpus=4, object_store_memory=2 << 30, _config=cfg)
    init_s = time.perf_counter() - t0
    try:
        gpus = rmt.cluster_resources().get("GPU")
        log(f"[runtime] rmt.init(num_cpus=4) in {init_s:.3f} s; "
            f"cluster_resources GPU={gpus} (CUDA initialized in the driver "
            f"before init: {torch.cuda.is_initialized()})")
        if gpus != 1:
            raise AssertionError(f"runtime: {gpus} GPUs counted, want 1")
        _runtime_device_tier(device, rt, tier_n)
        host = _runtime_host_path(device)
        task = _runtime_gpu_task(device)
        actor = _runtime_actor(device, serve)
    finally:
        rmt.shutdown()
    segs, procs = _leftovers()
    log(f"[runtime] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"runtime: left behind shm {segs} and "
                             f"processes {procs}")
    figures = (f"[runtime] {card}: init_s={init_s:.3f} gpu_task_first_s="
        f"{task['first_s']:.3f} gpu_task_warm_ms={task['warm_ms_median']:.2f}"
        f" put_gb_s fp32={host['float32']['put_gb_s']:.2f} "
        f"bf16={host['bfloat16']['put_gb_s']:.2f} get_gb_s "
        f"fp32={host['float32']['get_gb_s']:.2f} "
        f"bf16={host['bfloat16']['get_gb_s']:.2f} actor_start_s="
        f"{actor['start_s']:.2f} actor_requests_per_s="
        f"{actor['requests_per_s']:.2f} actor_tokens_per_s="
        f"{actor['tokens_per_s']:.1f} in_process_requests_per_s="
        f"{serve['requests_per_s']:.2f} in_process_tokens_per_s="
        f"{serve['tokens_per_s']:.1f}")
    log(figures)
    return dict(init_s=init_s, gpus=gpus, host=host, task=task,
                actor=actor, figures=figures)


SERVE_PLANE_STORE = 4 << 30  # shm for the payload's hops (324 MB each)


def _served(app):
    """``app`` (an ``llm_deployment``) with ``ServedLLM`` in place of
    ``LLMServer``: the same name, options, arguments and payload, plus
    reads of the replica's own process (launches, card, pid, cold
    starts) through a handle method."""
    from ray_memory_management_tpu_torch import serve as rserve
    from ray_memory_management_tpu_torch.utils.runtime_smoke import (
        ServedLLM)

    d = app.deployment
    return rserve.deployment(
        ServedLLM, name=d.name, ray_actor_options=d.ray_actor_options,
        max_concurrent_queries=d.max_concurrent_queries,
        placement_hint=d.placement_hint).bind(*app.args, **app.kwargs)


def _same_payload(a, b) -> bool:
    import numpy as np

    return (a["p"] == b["p"] and a["paths"] == b["paths"]
            and all(x["p"] == y["p"] and x["q"].dtype == y["q"].dtype
                    and np.array_equal(x["q"], y["q"])
                    for x, y in zip(a["leaves"], b["leaves"])))


def _http_post(port, name, body, timeout=600):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/{name}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class _Echo:
    """An actor, and a deployment, that hands its argument back: what a
    request costs on each layer of the serve plane without the model."""

    def __call__(self, x=None):
        return x

    echo = __call__  # an actor handle calls no __call__


def _plane_overhead(rserve, rmt, port, body, n=30):
    """Median and max ms of ``n`` sequential echo requests of ``body``
    by a plain actor call, through ``handle.remote`` (router, replica
    wrapper) and through the HTTP proxy (JSON, proxy actor, router)."""
    import numpy as np

    actor = rmt.remote(_Echo).options(num_cpus=0).remote()
    handle = rserve.run(rserve.deployment(_Echo, name="echo").bind())
    paths = {"actor": lambda: rmt.get(actor.echo.remote(body), timeout=60),
             "handle": lambda: rmt.get(handle.remote(body), timeout=60),
             "http": lambda: _http_post(port, "echo", body, timeout=60)}
    out = {}
    try:
        for name, call in paths.items():
            if call() != body:
                raise AssertionError(f"serve plane: {name} echo differs")
            ms = []
            for _ in range(n):
                t0 = time.perf_counter()
                call()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[name] = (float(np.median(ms)), max(ms))
    finally:
        rmt.kill(actor)
        rserve.delete("echo")
    return out


def _deploy_served(rserve, rmt, app, t0):
    """``serve.run`` of ``app`` as ``ServedLLM``; returns (handle, run s,
    s from ``t0`` to the first reply). One replica must be live when
    ``serve.run`` returns: a replica that missed readiness leaves none."""
    handle = rserve.run(_served(app))
    run_s = time.perf_counter() - t0
    live = rserve.status("LLM")["num_replicas"]
    if live != 1:
        raise AssertionError(f"serve plane: {live} live replicas after "
                             "serve.run, want 1")
    rmt.get(handle.remote({"tokens": [5, 6, 7]}), timeout=600)
    return handle, run_s, time.perf_counter() - t0


def phase_serve_plane(device, serve, actor, card, preset="gpt2-small",
                      max_batch_size=8, max_new_tokens=32, seed=0):
    """The serve plane on the card (see the module docstring, phase 8)."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import serve as rserve
    from ray_memory_management_tpu_torch.core import codec
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.api import _ctrl
    from ray_memory_management_tpu_torch.serve.http_proxy import start_proxy
    from ray_memory_management_tpu_torch.serve.llm import (
        LLMServer, llm_deployment, pack_weights)

    cfg = gpt.PRESETS[preset]
    kw = dict(max_batch_size=max_batch_size, max_new_tokens=max_new_tokens,
              seed=seed)
    rng = np.random.default_rng(2)
    seq = [rng.integers(2, cfg.vocab_size, size=n).tolist()
           for n in (7, 130, 600)]
    reqs = _serve_requests(cfg.vocab_size, seed)

    # in-process references and cold starts: init, then pack + shipped
    t0 = time.perf_counter()
    srv = LLMServer(preset=preset, device=device, **kw)
    _sync(device)
    cold_init_s = time.perf_counter() - t0
    try:
        want_init = [srv.generate(p) for p in seq]
        t0 = time.perf_counter()
        payload = pack_weights(srv.params, "bf16")
        pack_s = time.perf_counter() - t0
    finally:
        srv.close()
    del srv
    payload_bytes = sum(codec.quantized_nbytes(leaf)
                        for leaf in payload["leaves"])
    t0 = time.perf_counter()
    srv = LLMServer(preset=preset, weights=payload, device=device, **kw)
    _sync(device)
    cold_shipped_s = time.perf_counter() - t0
    try:
        want_shipped = [srv.generate(p) for p in seq]
    finally:
        srv.close()
    del srv
    torch.cuda.empty_cache()
    log(f"[serve-plane] in-process {preset} on {device}: cold start init "
        f"{cold_init_s:.3f} s, shipped {cold_shipped_s:.3f} s (+ pack "
        f"{pack_s:.3f} s = {pack_s + cold_shipped_s:.3f} s); bf16 payload "
        f"{payload_bytes} bytes for {sum(l['q'].size for l in payload['leaves'])} "
        f"parameters")

    opts = {"num_gpus": 1}
    t0 = time.perf_counter()
    rmt.init(num_cpus=4, object_store_memory=SERVE_PLANE_STORE)
    init_s = time.perf_counter() - t0
    try:
        rserve.start(http_port=0)
        port = start_proxy(_ctrl(), 0)
        log(f"[serve-plane] rmt.init(num_cpus=4, object_store_memory="
            f"{SERVE_PLANE_STORE}) in {init_s:.3f} s; HTTP proxy on "
            f"127.0.0.1:{port}")

        overhead = _plane_overhead(rserve, rmt, port,
                                   {"tokens": seq[2]})
        log(f"[serve-plane] echo of a {len(seq[2])}-token request, "
            f"median / max ms of 30: " + ", ".join(
                f"{k} {m:.2f} / {x:.2f}" for k, (m, x) in overhead.items()))

        # the main path: shipped weights, one GPU replica
        t0 = time.perf_counter()
        app = llm_deployment(preset, ray_actor_options=opts,
                             ship_weights="bf16", **kw)
        build_s = time.perf_counter() - t0
        if not _same_payload(app.kwargs["weights"], payload):
            raise AssertionError("serve plane: llm_deployment's payload "
                                 "differs from the in-process one")
        h, run_s, first_s = _deploy_served(rserve, rmt, app, t0)
        c0 = rmt.get(h.counters.remote(), timeout=60)
        rmt.get(h.reset_counters.remote(), timeout=60)
        runs = [_burst(lambda r: rmt.get(h.remote(r), timeout=600), reqs)]
        c = rmt.get(h.counters.remote(), timeout=60)
        runs.append(_burst(lambda r: rmt.get(h.remote(r), timeout=600),
                           reqs))
        got = [rmt.get(h.remote({"tokens": p}), timeout=600)["tokens"]
               for p in seq]
        http_got = [_http_post(port, "LLM", {"tokens": p})["tokens"]
                    for p in seq]
        http_runs = [_burst(lambda r: _http_post(port, "LLM", r), reqs)
                     for _ in range(2)]
        before = rmt.get(h.counters.remote(), timeout=60)
        t0 = time.perf_counter()
        h = rserve.run(_served(llm_deployment(
            preset, ray_actor_options=opts, ship_weights="bf16", **kw)))
        redeploy_s = time.perf_counter() - t0
        after = rmt.get(h.counters.remote(), timeout=60)
        live = rserve.status("LLM")["num_replicas"]
        rserve.delete("LLM")

        # the same without shipping: the replica draws its own weights
        t0 = time.perf_counter()
        app = llm_deployment(preset, ray_actor_options=opts, **kw)
        h, run_init_s, first_init_s = _deploy_served(rserve, rmt, app, t0)
        got_init = [rmt.get(h.remote({"tokens": p}), timeout=600)["tokens"]
                    for p in seq]
        c_init = rmt.get(h.counters.remote(), timeout=60)
    finally:
        rserve.shutdown()
        rmt.shutdown()
    segs, procs = _leftovers()

    errors = [(r[3], r[4]) for r in runs + http_runs if r[3] or r[4]]
    answers = [r for run in runs + http_runs for r in run[0] if r]
    budget_ok = all(len(r["tokens"]) == max_new_tokens for r in answers)
    vocab_ok = all(0 <= t < cfg.vocab_size
                   for r in answers for t in r["tokens"])
    launches = c["launches"]["flash_attention_fwd"]
    pages = c["stats"]["kv"]["pages_in_use"]
    need = cfg.n_layers * len(reqs)
    lease, uuid = _driver_card(device)

    def rate(run):
        gen = sum(len(r["tokens"]) for r in run[0] if r)
        return len(reqs) / run[2], gen / run[2]

    handle_rates = [rate(r) for r in runs]
    http_rates = [rate(r) for r in http_runs]
    kept = (after["pid"] == before["pid"]
            and after["stats"]["requests"] == before["stats"]["requests"]
            and after["cold_starts"] == before["cold_starts"])
    log(f"[serve-plane] serve.run(llm_deployment({preset!r}, "
        f"ray_actor_options={opts}, ship_weights='bf16')): llm_deployment "
        f"(draw, pack, put) {build_s:.3f} s, serve.run returned at "
        f"{run_s:.3f} s, first reply at {first_s:.3f} s; replica pid "
        f"{c0['pid']} on {c0['device']} (CUDA_VISIBLE_DEVICES="
        f"{c0['cuda_visible_devices']!r}, want {lease!r}; its card the "
        f"driver's={c0['device_uuid'] == uuid}); its cold start "
        f"{c0['cold_starts']}")
    log(f"[serve-plane] bursts of {len(reqs)} concurrent requests through "
        f"handle.remote: walls {[round(r[2], 3) for r in runs]} s, "
        f"requests/s {[round(x, 2) for x, _ in handle_rates]}, tokens/s "
        f"{[round(y, 1) for _, y in handle_rates]}; through the HTTP proxy:"
        f" walls {[round(r[2], 3) for r in http_runs]} s, requests/s "
        f"{[round(x, 2) for x, _ in http_rates]}, tokens/s "
        f"{[round(y, 1) for _, y in http_rates]} (in-process phase_serve "
        f"median {serve['requests_per_s']:.2f} requests/s, "
        f"{serve['tokens_per_s']:.1f} tokens/s; GPU actor "
        f"{actor['requests_per_s']:.2f} requests/s, "
        f"{actor['tokens_per_s']:.1f} tokens/s); replica flash launches in "
        f"the first burst {launches} {c['designs']} (need >= {need}, all "
        f"wgmma); pages_in_use after it={pages}; errors {errors}")
    log(f"[serve-plane] greedy tokens, prompt lens {[len(p) for p in seq]}:"
        f" handle vs in-process LLMServer(weights=payload) "
        f"{'equal' if got == want_shipped else 'DIFFER'}; HTTP "
        f"{'equal' if http_got == want_shipped else 'DIFFER'}; redeploy of "
        f"the same application in {redeploy_s:.3f} s kept the replica="
        f"{kept} (pid {before['pid']} -> {after['pid']}, requests "
        f"{before['stats']['requests']} -> {after['stats']['requests']}, "
        f"{live} live); without ship_weights: serve.run returned at "
        f"{run_init_s:.3f} s, first reply at {first_init_s:.3f} s, replica "
        f"cold start {c_init['cold_starts']}, tokens vs in-process "
        f"LLMServer(seed={seed}) "
        f"{'equal' if got_init == want_init else 'DIFFER'}")
    log(f"[serve-plane] after serve.shutdown() and rmt.shutdown(): shm "
        f"segments {segs}, port worker/zygote processes {procs}")
    if errors:
        raise AssertionError(f"serve plane: failed or hung requests "
                             f"{errors}")
    if not (budget_ok and vocab_ok):
        raise AssertionError("serve plane: a request missed its token "
                             "budget or returned ids outside the vocabulary")
    if pages != 0:
        raise AssertionError(f"serve plane: the replica holds {pages} KV "
                             "pages")
    if launches < need or c["designs"]["wgmma"] != launches:
        raise AssertionError(f"serve plane: replica flash launches "
                             f"{launches} {c['designs']}, need >= {need}, "
                             "all wgmma")
    for probe in (c0, c_init):
        if (probe["cuda_visible_devices"] != lease
                or probe["device_uuid"] != uuid
                or not probe["device"].startswith("cuda")):
            raise AssertionError(
                f"serve plane: a replica runs on {probe['device']} with "
                f"CUDA_VISIBLE_DEVICES={probe['cuda_visible_devices']!r}")
    if c0["cold_starts"]["shipped"]["count"] != 1 or \
            c_init["cold_starts"]["init"]["count"] != 1:
        raise AssertionError("serve plane: replica cold starts "
                             f"{c0['cold_starts']} {c_init['cold_starts']}")
    if got != want_shipped or http_got != want_shipped:
        raise AssertionError(f"serve plane: handle {got} / HTTP {http_got}"
                             f" != in-process {want_shipped}")
    if got_init != want_init:
        raise AssertionError(f"serve plane: unshipped replica {got_init} "
                             f"!= in-process {want_init}")
    if not kept or live != 1:
        raise AssertionError(f"serve plane: the redeploy replaced the "
                             f"replica ({before} -> {after}, {live} live)")
    if segs or procs:
        raise AssertionError(f"serve plane: left behind shm {segs} and "
                             f"processes {procs}")
    med = lambda xs: float(np.median(xs))  # noqa: E731
    figures = (
        f"[serve-plane] {card}: handle_requests_per_s="
        f"{med([x for x, _ in handle_rates]):.2f} handle_tokens_per_s="
        f"{med([y for _, y in handle_rates]):.1f} http_requests_per_s="
        f"{med([x for x, _ in http_rates]):.2f} http_tokens_per_s="
        f"{med([y for _, y in http_rates]):.1f} in_process_requests_per_s="
        f"{serve['requests_per_s']:.2f} actor_requests_per_s="
        f"{actor['requests_per_s']:.2f} run_to_first_reply_shipped_s="
        f"{first_s:.3f} run_to_first_reply_init_s={first_init_s:.3f} "
        f"cold_start_in_process_init_s={cold_init_s:.3f} "
        f"cold_start_in_process_shipped_s={cold_shipped_s:.3f} pack_s="
        f"{pack_s:.3f} payload_bytes={payload_bytes} redeploy_s="
        f"{redeploy_s:.3f} echo_ms_median actor="
        f"{overhead['actor'][0]:.2f} handle={overhead['handle'][0]:.2f} "
        f"http={overhead['http'][0]:.2f}")
    log(figures)
    return dict(launches=launches, designs=c["designs"],
                handle_rates=handle_rates, http_rates=http_rates,
                first_reply_shipped_s=first_s, first_reply_init_s=first_init_s,
                build_s=build_s, run_s=run_s, run_init_s=run_init_s,
                cold_init_s=cold_init_s, cold_shipped_s=cold_shipped_s,
                pack_s=pack_s, payload_bytes=payload_bytes,
                redeploy_s=redeploy_s, init_s=init_s, overhead=overhead,
                figures=figures)


def _multinode_bytes(device, agent, lease, nbytes=256 << 20, reps=3):
    """CUDA tensors driver → a ``num_gpus=1`` task on the agent, which
    hands them back → driver: bit-equal both ways, with GB/s each way
    (the task stamps when the tensor had landed on its card and when it
    returned; the driver's clock reads the rest, on the same host). The
    way there is split at the driver's ``put`` (device→host copy into
    the head's store) and the rest (to the agent's card)."""
    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    echo = rmt.remote(runtime_smoke.echo).options(num_gpus=1)
    gen = torch.Generator(device=device).manual_seed(14)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = nbytes // torch.tensor([], dtype=dtype).element_size()
        x = torch.randn(n, device=device, generator=gen).to(dtype)
        there, back, puts = [], [], []
        for _ in range(reps):
            _sync(device)
            t0 = time.time()
            ref = rmt.put(x)
            puts.append(time.time() - t0)
            r = rmt.get(echo.remote(ref), timeout=600)
            y = r["x"]
            _sync(device)
            t1 = time.time()
            there.append(r["t_in"] - t0)
            back.append(t1 - r["t_out"])
            if not (y.device.type == device.type and _bit_equal(y, x)):
                raise AssertionError(f"multinode: a {dtype} CUDA tensor did "
                                     f"not come back bit-equal on cuda "
                                     f"(got {y.device})")
            if (r["node_id"] != agent.hex()
                    or r["cuda_visible_devices"] != lease):
                raise AssertionError(f"multinode: the echo ran on node "
                                     f"{r['node_id']} with "
                                     f"CUDA_VISIBLE_DEVICES="
                                     f"{r['cuda_visible_devices']!r}")
            del r, y, ref
        name = str(dtype).removeprefix("torch.")
        out[name] = dict(to_agent_gb_s=nbytes / float(np.median(there)) / 1e9,
                         from_agent_gb_s=nbytes / float(np.median(back))
                         / 1e9, to_agent_s=there, from_agent_s=back,
                         put_s=puts)
        log(f"[multinode] {name} {nbytes >> 20} MiB driver -> agent GPU task "
            f"-> driver: bit-equal both ways on the agent's node; to the "
            f"agent {out[name]['to_agent_gb_s']:.2f} GB/s, back "
            f"{out[name]['from_agent_gb_s']:.2f} GB/s (median of {reps}; "
            f"{[round(t, 4) for t in there]} s, of which the driver's put "
            f"{[round(t, 4) for t in puts]} s, and "
            f"{[round(t, 4) for t in back]} s)")
        del x
    return out


def phase_multinode(device, serve, gpu_actor, card):
    """The multi-node runtime with the card on a node agent (see the
    module docstring, phase 9)."""
    import signal

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.exceptions import ActorDiedError

    t_phase = t0 = time.perf_counter()
    rt = rmt.init(num_cpus=4, num_gpus=0, object_store_memory=2 << 30)
    init_s = time.perf_counter() - t0
    try:
        head_gpus = rmt.cluster_resources().get("GPU", 0)
        t0 = time.perf_counter()
        agent = rt.add_remote_node_process(num_cpus=4, num_gpus=1)
        join_s = time.perf_counter() - t0
        nm = rt.nodes[agent]
        # the names the agent reported for its GPU, before any lease
        reported = list(nm.free_chips)
        gpus = rmt.cluster_resources().get("GPU", 0)
        on_agent = nm.resources.total.get("GPU")
        on_head = rt.head_node().resources.total.get("GPU")
        log(f"[multinode] rmt.init(num_cpus=4, num_gpus=0) in {init_s:.3f} "
            f"s (GPU={head_gpus}); add_remote_node_process(num_cpus=4, "
            f"num_gpus=1) joined node {agent.hex()[:8]} (agent pid "
            f"{nm.agent_pid}) in {join_s:.3f} s; cluster GPU={gpus}, on the "
            f"agent {on_agent}, on the head {on_head}; the agent's reported "
            f"device names {reported}")
        if head_gpus != 0 or gpus != 1 or on_agent != 1 or on_head != 0 \
                or len(reported) != 1:
            raise AssertionError(f"multinode: GPU {head_gpus} before the "
                                 f"agent, {gpus} after ({on_agent} on the "
                                 f"agent, {on_head} on the head), names "
                                 f"{reported}")
        lease = reported[0]
        task = _runtime_gpu_task(device, lease=lease, node=agent,
                                 tag="multinode")
        moved = _multinode_bytes(device, agent, lease)
        store_path = type(rt._store_clients.get(agent)).__name__
        log(f"[multinode] the head reads the agent's store through "
            f"{store_path} (StoreClient: the same-host shm store mapped "
            f"directly; else pulled over the channel)")
        actor = _runtime_actor(device, serve, lease=lease, node=agent,
                               tag="multinode", keep=True)
        handle = actor.pop("actor")

        # agent death: SIGKILL the agent process
        os.kill(nm.agent_pid, signal.SIGKILL)
        t0 = time.perf_counter()
        while nm.alive and time.perf_counter() - t0 < 60:
            time.sleep(0.05)
        detect_s = time.perf_counter() - t0
        try:
            rmt.get(handle.generate.remote([5, 6, 7]), timeout=120)
            died = "answered"
        except ActorDiedError as e:
            died = type(e).__name__
        gpus_after = rmt.cluster_resources().get("GPU", 0)
        log(f"[multinode] SIGKILL of the agent: node dead after "
            f"{detect_s:.3f} s (alive={nm.alive}); the actor's next call "
            f"raised {died}; cluster GPU={gpus_after}")
        if nm.alive or died != "ActorDiedError" or gpus_after != 0:
            raise AssertionError(f"multinode: after the agent's death the "
                                 f"node alive={nm.alive}, the actor call "
                                 f"{died}, GPU={gpus_after}")
        del handle
    finally:
        rmt.shutdown()
    segs, procs = _leftovers()
    log(f"[multinode] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"multinode: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[multinode] {card}: phase_s={phase_s:.1f} join_s={join_s:.3f} "
        f"agent_task_first_s="
        f"{task['first_s']:.3f} agent_task_warm_ms="
        f"{task['warm_ms_median']:.2f} to_agent_gb_s fp32="
        f"{moved['float32']['to_agent_gb_s']:.2f} bf16="
        f"{moved['bfloat16']['to_agent_gb_s']:.2f} from_agent_gb_s fp32="
        f"{moved['float32']['from_agent_gb_s']:.2f} bf16="
        f"{moved['bfloat16']['from_agent_gb_s']:.2f} store_path={store_path}"
        f" agent_actor_start_s={actor['start_s']:.2f} "
        f"agent_actor_requests_per_s={actor['requests_per_s']:.2f} "
        f"agent_actor_tokens_per_s={actor['tokens_per_s']:.1f} "
        f"gpu_actor_requests_per_s={gpu_actor['requests_per_s']:.2f} "
        f"gpu_actor_tokens_per_s={gpu_actor['tokens_per_s']:.1f} "
        f"agent_death_detect_s={detect_s:.3f}")
    log(figures)
    return dict(phase_s=phase_s, init_s=init_s, join_s=join_s, lease=lease,
                task=task,
                moved=moved, store_path=store_path, actor=actor,
                detect_s=detect_s, figures=figures)


# the step-4 checkpoint (1,946,661,486 bytes on an H100 80GB HBM3 at
# 700 W, chip call 13) crosses the store twice: 3.9 GB of its 6.4 GB
TRAIN_PLANE_STORE = 6 << 30
PROBE_N = 1 << 22             # elements of the collectives' CUDA tensor
# the JAX package's quantized-allreduce envelopes (tests/test_collective.py
# :222-223), times absmax and the world size (1 here)
COLLECTIVE_TOL = {"bf16": 2.0 ** -7, "int8": 0.75 / 127.0}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _train_plane_collectives(card_lease, card_uuid, gpus):
    """Phase 10 (a): every collective of a world-1 dist group on the
    probe actor's card, each beside its plain expectation."""
    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import collective as col
    from ray_memory_management_tpu_torch.collective.coordinator import (
        destroy_coordinator)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    probe = rmt.remote(num_gpus=gpus)(runtime_smoke.CollectiveProbe).remote()
    t0 = time.perf_counter()
    col.create_collective_group([probe], 1, [0], backend="dist",
                                group_name="train_plane")
    join_s = time.perf_counter() - t0
    c = rmt.get(probe.probe.remote("train_plane", PROBE_N), timeout=600)
    rmt.kill(probe)
    destroy_coordinator("train_plane")
    bad = []
    for row in c["rows"]:
        p = row["precision"]
        if p == "f32":
            ok = row["bit_equal"] and row["counted"] == 0
        else:
            ok = (row["max_abs_err"] <= c["absmax"] * COLLECTIVE_TOL[p]
                  and row["counted"] == 1)
        if not ok or (gpus and not row["device"].startswith("cuda")):
            bad.append(row)
    log(f"[train_plane] collectives: a num_gpus={gpus} actor joined a "
        f"world-{c['world']} dist group over {c['backend']} in "
        f"{join_s:.3f} s (lease {c['lease']!r}); {len(c['rows'])} calls on "
        f"{PROBE_N} elements (absmax {c['absmax']:.4f}): " + "; ".join(
            f"{r['op']}/{r['reduce']}/{r['precision']} "
            f"{'bit-equal' if r['bit_equal'] else 'err'} "
            f"{r['max_abs_err']:.3g} counted {r['counted']:g} "
            f"{r['ms']:.3f} ms" for r in c["rows"]))
    if gpus and (c["backend"] != "nccl" or c["lease"] != card_lease
                 or c["device_uuid"] != card_uuid):
        raise AssertionError(
            f"train plane: the collective actor ran over {c['backend']} "
            f"with lease {c['lease']!r} on {c['device_uuid']}, want nccl, "
            f"{card_lease!r}, {card_uuid}")
    if bad:
        raise AssertionError(f"train plane: collectives off their plain "
                             f"expectation: {bad}")
    return dict(join_s=join_s, absmax=c["absmax"], rows=c["rows"],
                backend=c["backend"])


def _train_plane_final(result, tag):
    if result.error is not None:
        raise AssertionError(f"train plane: {tag} fit() failed: "
                             f"{result.error}")
    finals = [m for m in result.metrics_history if m.get("final")]
    if len(finals) != 1:
        raise AssertionError(f"train plane: {tag} reported "
                             f"{result.metrics_history}")
    return finals[0]


def _check_trainer_launches(final, n_steps, n_layers, tag):
    want = n_layers * n_steps
    launches, designs = final["launches"], final["designs"]
    bwd = final["bwd_designs"]
    if (any(n != want for n in launches.values())
            or designs["wgmma"] != want
            or any(c["wgmma"] != want for c in bwd.values())):
        raise AssertionError(f"train plane: {tag} launches {launches} "
                             f"{designs} {bwd}, want {want} of each, all "
                             f"wgmma")


def phase_train_plane(device, train, card, preset="gpt2-small", steps=8,
                      ckpt_at=4):
    """Collectives, the parallel library and Train on the card (see the
    module docstring, phase 10). ``train`` is phase 6's result, whose
    losses the trainer's must equal."""
    import math
    import shutil
    import tempfile

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.train import (
        CheckpointConfig, RunConfig, ScalingConfig, TorchTrainer)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    gpus = int(device.type == "cuda")
    if gpus:
        import torch

        # the workers need the card's memory that this driver's earlier
        # phases left in its allocator's cache
        torch.cuda.empty_cache()
    n_layers = gpt.PRESETS[preset].n_layers
    lease, uuid = _driver_card(device)
    storage = tempfile.mkdtemp(prefix="rmt_train_plane_")
    t_phase = time.perf_counter()
    rmt.init(num_cpus=4, object_store_memory=TRAIN_PLANE_STORE)
    try:
        coll = _train_plane_collectives(lease, uuid, gpus)
        config = dict(device=device.type, preset=preset, batch=TRAIN_B,
                      seq=TRAIN_S, steps=steps, ckpt_at=ckpt_at)
        scaling = ScalingConfig(num_workers=1, use_gpu=bool(gpus),
                                gpus_per_worker=gpus,
                                collective_backend="dist")
        saves = mdefs.train_checkpoint_save_seconds()
        before = saves.get(tags={"phase": "drain"})
        t0 = time.time()
        r1 = TorchTrainer(
            runtime_smoke.train_loop, train_loop_config=config,
            scaling_config=scaling,
            run_config=RunConfig(name="first", storage_path=storage,
                                 checkpoint_config=CheckpointConfig(
                                     mode="sync"))).fit()
        fit_s = time.time() - t0
        first = _train_plane_final(r1, "first")
        cold_s = first["t_loop"] - t0
        setup_s = first["t_ready"] - first["t_loop"]
        after = saves.get(tags={"phase": "drain"})
        save_s = after["sum"] - before["sum"]
        ckpt_dir = os.path.join(storage, "first", "checkpoint_000000")
        ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, fs in os.walk(ckpt_dir) for f in fs)
        losses = first["losses"]
        log(f"[train_plane] TorchTrainer fit(): {fit_s:.2f} s; the worker's "
            f"loop started {cold_s:.2f} s after fit() (lease "
            f"{first['lease']!r}, {first['backend']}), set up its mesh, "
            f"model and optimizer in {setup_s:.2f} s; {steps} steps, losses "
            f"{[round(x, 5) for x in losses]} (phase 6: "
            f"{[round(x, 5) for x in train['losses']]}); step_ms="
            f"{first['step_ms']:.2f} tokens_per_s={first['tokens_per_s']:.1f}"
            f" mfu={first['mfu']} (phase 6 step_ms={train['step_ms']:.2f} "
            f"tokens_per_s={train['tokens_per_s']:.1f} mfu={train['mfu']}); "
            f"segments {first['segments']}; launches {first['launches']} "
            f"forward {first['designs']} backward {first['bwd_designs']}; "
            f"checkpoint at step {ckpt_at}: snapshot "
            f"{first['snapshot_s']:.2f} s in the worker, durable save "
            f"{save_s:.2f} s, {ckpt_bytes} bytes; peak_mem="
            f"{first['peak_mem_gb']} GB")
        if gpus and (first["lease"] != lease
                     or first["device_uuid"] != uuid
                     or first["backend"] != "nccl"):
            raise AssertionError(
                f"train plane: the worker ran with lease "
                f"{first['lease']!r} on {first['device_uuid']} over "
                f"{first['backend']}, want {lease!r}, {uuid}, nccl")
        _check_trainer_launches(first, steps, n_layers, "first")
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"train plane: losses {losses}")
        ref = train["losses"]
        if len(losses) != steps or _rel(losses[0], ref[0]) > 1e-5 \
                or _rel(losses[-1], ref[steps - 1]) > 1e-3:
            raise AssertionError(f"train plane: losses {losses} against "
                                 f"phase 6's {ref}")
        if r1.checkpoint is None or not any(
                m.get("checkpoint_at") == ckpt_at
                for m in r1.metrics_history):
            raise AssertionError("train plane: no checkpoint at step "
                                 f"{ckpt_at}")

        t0 = time.time()
        r2 = TorchTrainer(
            runtime_smoke.train_loop, train_loop_config=config,
            scaling_config=scaling,
            run_config=RunConfig(name="resumed", storage_path=storage),
            resume_from_checkpoint=r1.checkpoint).fit()
        resume_fit_s = time.time() - t0
        second = _train_plane_final(r2, "resumed")
        resumed = second["losses"]
        log(f"[train_plane] resumed fit(): {resume_fit_s:.2f} s from step "
            f"{second['start']}; losses {[round(x, 5) for x in resumed]} "
            f"(first run's steps {ckpt_at}-{steps - 1}: "
            f"{[round(x, 5) for x in losses[ckpt_at:]]})")
        _check_trainer_launches(second, steps - ckpt_at, n_layers,
                                "resumed")
        tol = [1e-5] + [1e-3] * (steps - ckpt_at - 1)
        if second["start"] != ckpt_at \
                or len(resumed) != steps - ckpt_at \
                or any(_rel(a, b) > t for a, b, t in
                       zip(resumed, losses[ckpt_at:], tol)):
            raise AssertionError(f"train plane: resumed losses {resumed} "
                                 f"against {losses[ckpt_at:]}")
    finally:
        rmt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    segs, procs = _leftovers()
    log(f"[train_plane] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"train plane: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[train_plane] {card}: phase_s={phase_s:.1f} "
        f"collective_join_s={coll['join_s']:.3f} cold_start_s={cold_s:.2f} "
        f"setup_s={setup_s:.2f} step_ms={first['step_ms']:.2f} "
        f"tokens_per_s={first['tokens_per_s']:.1f} mfu={first['mfu']} "
        f"in_process_step_ms={train['step_ms']:.2f} in_process_tokens_per_s"
        f"={train['tokens_per_s']:.1f} in_process_mfu={train['mfu']} "
        f"fit_s={fit_s:.2f} resume_fit_s={resume_fit_s:.2f} "
        f"ckpt_snapshot_s={first['snapshot_s']:.2f} ckpt_save_s="
        f"{save_s:.2f} ckpt_bytes={ckpt_bytes} first_loss_rel="
        f"{_rel(losses[0], train['losses'][0]):.3g} last_loss_rel="
        f"{_rel(losses[-1], train['losses'][steps - 1]):.3g}")
    log(figures)
    return dict(phase_s=phase_s, collectives=coll, cold_start_s=cold_s,
                setup_s=setup_s, fit_s=fit_s, resume_fit_s=resume_fit_s,
                save_s=save_s, ckpt_bytes=ckpt_bytes, first=first,
                resumed=second, launches=first["launches"],
                figures=figures)


MOE_PRESET = "mixtral-tiny"   # 8 experts, top-2, GQA 16/4, 32k vocab
MOE_B, MOE_S = 4, 2048         # the MoE training batch
RING = 4                       # the sp size whose chunk schedule is held


def _ring_schedule_check(device, cfg):
    """The ring's per-chunk schedule of an sp = ``RING`` run in one
    process (``ring_attention.ring_schedule``: each rank's query chunk
    against the K/V chunks in ring order, merged by lse; the backward's
    dq and dk/dv per chunk from the merged lse; the same per-rank loops,
    ``ring_forward`` and ``ring_backward``, that sp-ring training runs
    over rotating chunks) at the MoE training
    shape, bf16, causal, through the three kernels, held against the
    plain attention over the whole sequence: the output against
    ``reference_attention``, and dq, dk and dv against
    ``reference_flash_bwd`` given that output (as phase 2 gives the
    backward kernels and their plain version the same o). A row's
    output, dq, dk and dv are sums of up to ``RING`` chunk terms, each a
    kernel output rounded once to bf16 (the single kernel's tolerance
    holds one rounding), so they are held to ``RING`` times the single
    kernel's tolerance: the output to ``RING x TOL``, dq, dk and dv to
    ``RING x BWD_TOL``."""
    import torch

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reference_attention, reference_flash_bwd, reference_lse,
        reset_launch_count)
    from ray_memory_management_tpu_torch.ops.ring_attention import (
        ring_schedule)

    gen = torch.Generator(device=device).manual_seed(11)
    bh, d = MOE_B * cfg.n_heads, cfg.head_dim
    q, k, v, do = (torch.randn(bh, MOE_S, d, generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    reset_launch_count()
    o, dq, dk, dv = ring_schedule(q, k, v, do, RING, causal=True)
    _sync(device)
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    o_ref = reference_attention(q, k, v, True)
    lse_ref = reference_lse(q, k, True)
    grads_ref = reference_flash_bwd(q, k, v, o, lse_ref, do, True)
    o_err = (o.float() - o_ref.float()).abs().max().item()
    o_tol = RING * TOL["bfloat16"]
    rows = {name: bwd_close(got, ref.float(), "bfloat16", scale=RING)
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                      grads_ref)}
    steps = RING * (RING + 1) // 2  # the causal ring's chunks attended
    log(f"[moe] ring schedule sp={RING} BH={bh} S={MOE_S} D={d} bf16 "
        f"causal: o max_abs_err={o_err:.3e} (tol {o_tol:g}); "
        + "; ".join(f"{n} max_abs_err={e:.3e} worst/limit={r:.3f}"
                    for n, (e, r, _) in rows.items())
        + f"; launches {launches} forward {designs} backward "
        f"{bwd_designs} (expect {steps} each, all wgmma)")
    if not torch.isfinite(o.float()).all() or o_err > o_tol:
        raise AssertionError("moe: the ring's schedule disagrees with "
                             "plain attention over the whole sequence")
    if not all(ok for _, _, ok in rows.values()):
        raise AssertionError(f"moe: the ring's backward disagrees with "
                             f"the plain backward: {rows}")
    if device.type == "cuda" and (
            any(n != steps for n in launches.values())
            or designs["wgmma"] != steps
            or any(c["wgmma"] != steps for c in bwd_designs.values())):
        raise AssertionError(f"moe: ring launches {launches} {designs} "
                             f"{bwd_designs}, expected {steps} of each "
                             f"kernel, all wgmma")
    return dict(o_err=o_err, launches=launches,
                **{n: dict(max_abs_err=e, worst_over_limit=r)
                   for n, (e, r, _) in rows.items()})


def phase_moe(device, steps=8):
    """Phase 11: mixtral-tiny at full width on the card. (a) serve-burst:
    ``LLMServer`` (bf16, 8 slots, paged) answers ``phase_serve``'s
    requests through the MoE FFN on prefill and decode, launch counts
    zeroed around the first burst; (b) ``train_step_mfu`` takes ``steps``
    AdamW steps at B = 4, S = 2048 (each kernel launched once per layer
    per step, all wgmma; the loss finite and falling), and one step's
    gradients are held against ``attention="ref"`` by phase 4's rule;
    (c) the ring's chunk schedule (sp = 4) through the kernels against
    plain attention."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt

    t0 = time.perf_counter()
    cfg = gpt.PRESETS[MOE_PRESET]
    serve = phase_serve(device, preset=MOE_PRESET, bursts=2)
    train = phase_train(device, steps=steps, preset=MOE_PRESET,
                        batch=MOE_B, seq=MOE_S)
    grad = phase_grad(device, preset=MOE_PRESET, batch=MOE_B, seq=MOE_S)
    torch.cuda.empty_cache()
    ring = _ring_schedule_check(device, cfg)
    phase_s = time.perf_counter() - t0
    log(f"[moe] {MOE_PRESET}: n_params={train['n_params']} serve "
        f"{serve['requests_per_s']:.2f} requests/s "
        f"{serve['tokens_per_s']:.1f} tokens/s; train step_ms="
        f"{train['step_ms']:.2f} tokens_per_s={train['tokens_per_s']:.1f} "
        f"mfu={train['mfu']:.4f} (6N counts every expert) peak_mem="
        f"{train['peak_mem_gb']:.2f} GB; phase_s={phase_s:.1f}")
    return dict(serve=serve, train=train, grad=grad, ring=ring,
                phase_s=phase_s)


PP_STAGES, PP_MICRO = 4, 4    # gpt2-small's 12 layers in 4 stages of 3
VISION_B = 128


def phase_pipeline(device, preset="gpt2-small", batch=TRAIN_B,
                   seq=TRAIN_S):
    """Phase 12a: ``pipeline_schedule`` (pp = ``PP_STAGES``, M =
    ``PP_MICRO``) against unpipelined ``gpt.loss_fn``, both with the
    kernels, by phase 4's rule; each kernel launched (L / S) x M times per
    stage, L x M in all, all wgmma."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        bwd_design_counts, fwd_design_counts, launch_counts,
        reset_launch_count)
    from ray_memory_management_tpu_torch.parallel import pipeline_schedule
    from ray_memory_management_tpu_torch.utils import gpu_bench

    t0 = time.perf_counter()
    cfg = dataclasses.replace(gpt.PRESETS[preset], attention="flash")
    gen = torch.Generator(device=device).manual_seed(3)
    params = gpt.init_params(cfg, gen, device)
    data = gpu_bench.make_batch(cfg, batch, seq, gen, device)
    leaves = [t.requires_grad_() for t in gpt.param_leaves(params)]
    names = [f"{k}.{n}" if isinstance(v, dict) else k
             for k, v in params.items()
             for n in (v if isinstance(v, dict) else [None])]

    def grads(loss_of, c):
        loss = loss_of(c)
        out = loss.item(), torch.autograd.grad(loss, leaves)
        _sync(device)
        return out

    def piped(c):
        return pipeline_schedule(params, data, c, PP_STAGES, PP_MICRO)

    def plain(c):
        return gpt.loss_fn(params, data, c)

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    reset_launch_count()
    t1 = time.perf_counter()
    loss_p, gp = grads(piped, cfg)
    pipe_s = time.perf_counter() - t1
    launches = launch_counts()
    designs = fwd_design_counts()
    bwd_designs = bwd_design_counts()
    loss_u, gu = grads(plain, cfg)
    warm = {}
    for name, loss_of in (("pipelined", piped), ("unpipelined", plain),
                          ("pipelined", piped), ("unpipelined", plain)):
        t1 = time.perf_counter()
        grads(loss_of, cfg)
        warm.setdefault(name, []).append(
            (time.perf_counter() - t1) * 1e3)
    loss_p32, gp32 = grads(piped, f32)
    loss_u32, gu32 = grads(plain, f32)
    tol32, rows = 1e-3, []
    for name, a, b, c, d in zip(names, gp, gu, gp32, gu32):
        rows.append(dict(leaf=name, err=(a - b).abs().max().item(),
                         floor=(b - d).abs().max().item(),
                         err32=(c - d).abs().max().item(),
                         scale32=d.abs().max().item(),
                         finite=bool(torch.isfinite(a).all()
                                     and torch.isfinite(c).all())))
    want = cfg.n_layers * PP_MICRO
    worst = max(rows, key=lambda r: r["err"] / r["floor"])
    worst32 = max(rows, key=lambda r: r["err32"] / r["scale32"])
    phase_s = time.perf_counter() - t0
    log(f"[pipeline] {preset} B={batch} S={seq} pp={PP_STAGES} "
        f"M={PP_MICRO} in one process: loss bf16 {loss_p:.5f} (unpipelined "
        f"{loss_u:.5f}), fp32 {loss_p32:.6f} ({loss_u32:.6f}); bf16 worst "
        f"leaf {worst['leaf']} max_abs_err={worst['err']:.3e} (limit 2 x "
        f"bf16 noise floor {worst['floor']:.3e}); fp32 worst leaf "
        f"{worst32['leaf']} max_abs_err={worst32['err32']:.3e} (tol "
        f"{tol32:g} x max|grad| {worst32['scale32']:.3e}); launches "
        f"{launches} forward {designs} backward {bwd_designs} (expect "
        f"{want} each, all wgmma); bf16 loss+grad {pipe_s * 1e3:.1f} ms "
        f"(first call), warm in turns pipelined {warm['pipelined']} "
        f"unpipelined {warm['unpipelined']} ms; phase_s={phase_s:.1f}")
    if not all(r["finite"] for r in rows):
        raise AssertionError("pipeline: non-finite gradients")
    if not (all(r["err"] <= 2 * r["floor"] for r in rows)
            and all(r["err32"] <= tol32 * r["scale32"] for r in rows)):
        raise AssertionError(f"pipeline: the pipelined gradients disagree "
                             f"with the unpipelined ones: {rows}")
    if (any(n != want for n in launches.values())
            or designs["wgmma"] != want
            or any(c["wgmma"] != want for c in bwd_designs.values())):
        raise AssertionError(f"pipeline: launches {launches} {designs} "
                             f"{bwd_designs}, expected {want} of each "
                             f"kernel, all wgmma")
    return dict(loss_bf16=loss_p, loss_unpipelined_bf16=loss_u,
                loss_fp32=loss_p32, loss_unpipelined_fp32=loss_u32,
                worst_bf16=worst, worst_fp32=worst32, launches=launches,
                designs=designs, bwd_designs=bwd_designs, warm_ms=warm,
                phase_s=phase_s)


def phase_vision(device, card, steps=8):
    """Phase 12b: ResNet-50 and ViT-S/16 train ``steps`` steps each on one
    synthetic batch of ``VISION_B`` images (``vision_train_step``)."""
    import math

    import torch

    from ray_memory_management_tpu_torch.utils.gpu_bench import (
        vision_train_step)

    out = {}
    for name in ("resnet50", "vit-s16"):
        torch.cuda.empty_cache()
        r = vision_train_step(name, VISION_B, steps, device)
        losses = r["losses"]
        log(f"[vision] {name} B={VISION_B} 224x224 bf16 on {card}: "
            f"{steps} steps, losses {[round(x, 4) for x in losses]}; "
            f"step_ms={r['step_ms']:.2f} images_per_s="
            f"{r['images_per_s']:.1f} n_params={r['n_params']} "
            f"peak_mem={r['peak_mem_gb']:.2f} GB"
            + (f" BatchNorm statistics moved by up to "
               f"{r['stats_moved']:.3e}" if r["stats_moved"] is not None
               else ""))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"vision: {name}: non-finite loss")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"vision: {name}: the loss did not fall: "
                                 f"{losses}")
        if name == "resnet50" and not r["stats_moved"] > 0:
            raise AssertionError("vision: ResNet-50's BatchNorm running "
                                 "statistics did not move")
        out[name] = r
    return out


DATA_ROWS = 64                # rows of the inference and training datasets
DATA_STORE = 1 << 30          # shm for the blocks, batches and step results
DATA_TOL = 1e-5               # |log-prob| and relative loss tolerance
DATA_IDS = 1024               # the training rows' ids: a slice of the vocab
TUNE_STEPS = 4


def _data_inference(device, gpus, uuid, preset, seq):
    """Phase 13 (a): a ``Dataset`` of seeded token rows scored through
    ``map_batches`` on a one-actor GPU pool, against the driver's own
    call of the same batch function on the same rows."""
    import numpy as np

    from ray_memory_management_tpu_torch import data as rd
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    vocab, n_layers = (gpt.PRESETS[preset].vocab_size,
                       gpt.PRESETS[preset].n_layers)
    rows = np.random.default_rng(21).integers(0, vocab, (DATA_ROWS, seq))
    ds = rd.from_numpy(rows)
    where = None if gpus else "cpu"

    def score():
        return ds.map_batches(
            runtime_smoke.score_batch, batch_size=TRAIN_B,
            batch_format="numpy",
            compute=rd.ActorPoolStrategy(size=1, num_gpus=gpus),
            preset=preset, device=where).to_numpy()

    t0 = time.perf_counter()
    got = score()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = score()
    second_s = time.perf_counter() - t0
    batch_s = got["batch_s"][::TRAIN_B]
    n_batches = len(batch_s)
    launches = got["launches"][::TRAIN_B]
    wgmma = got["wgmma"][::TRAIN_B]
    want = {"logprob": [], "argmax": []}
    for i in range(0, DATA_ROWS, TRAIN_B):
        w = runtime_smoke.score_batch(rows[i:i + TRAIN_B], preset=preset,
                                      device=device)
        want["logprob"].append(w["logprob"])
        want["argmax"].append(w["argmax"])
    want = {k: np.concatenate(v) for k, v in want.items()}
    runtime_smoke._SCORERS.clear()   # the driver's copy of the model
    err = float(np.abs(got["logprob"] - want["logprob"]).max())
    same_argmax = bool((got["argmax"] == want["argmax"]).all())
    repeat = bool((again["argmax"] == got["argmax"]).all()
                  and np.abs(again["logprob"] - got["logprob"]).max()
                  <= DATA_TOL)
    steady_s = float(batch_s[1:].sum())
    steady_rows = DATA_ROWS - TRAIN_B
    r = dict(cold_s=cold_s, second_s=second_s,
             first_batch_s=float(batch_s[0]),
             rows_per_s=DATA_ROWS / second_s,
             tokens_per_s=DATA_ROWS * seq / second_s,
             steady_rows_per_s=steady_rows / steady_s,
             steady_tokens_per_s=steady_rows * seq / steady_s,
             batches=n_batches, launches=int(launches.sum()),
             launches_per_batch=launches.tolist(),
             wgmma=int(wgmma.sum()), max_abs_err=err,
             pids=sorted(set(got["pid"].tolist())),
             uuids=sorted(set(got["device_uuid"].tolist())))
    log(f"[data] batch inference: {DATA_ROWS} rows of {seq} tokens through "
        f"map_batches(batch_size={TRAIN_B}, ActorPoolStrategy(size=1, "
        f"num_gpus={gpus})): {n_batches} batches in pool actor(s) "
        f"{r['pids']}, forward launches per batch {r['launches_per_batch']}"
        f" ({r['wgmma']} wgmma of {r['launches']}); argmax equal to the "
        f"driver's={same_argmax}, log-prob max_abs_err={err:.3e} (tol "
        f"{DATA_TOL:g}); a second map equal={repeat}; first map "
        f"{cold_s:.2f} s, second map {second_s:.2f} s (a new pool actor: "
        f"the pool lives for one execution) = {r['rows_per_s']:.1f} rows/s "
        f"{r['tokens_per_s']:.0f} tokens/s; in the actor: first batch "
        f"{r['first_batch_s']:.2f} s (CUDA init, model draw), batches 2-"
        f"{n_batches} {r['steady_rows_per_s']:.1f} rows/s "
        f"{r['steady_tokens_per_s']:.0f} tokens/s")
    if n_batches != DATA_ROWS // TRAIN_B or not same_argmax \
            or err > DATA_TOL or not repeat or len(r["pids"]) != 1:
        raise AssertionError(f"data: batch inference off: {r}")
    if gpus and (r["uuids"] != [uuid] or r["wgmma"] != r["launches"]
                 or min(r["launches_per_batch"]) < n_layers):
        raise AssertionError(f"data: the pool's batches ran on {r['uuids']}"
                             f" (want {uuid}) with launches "
                             f"{r['launches_per_batch']}, {r['wgmma']} "
                             f"wgmma")
    return r


def _data_training(device, gpus, lease, uuid, train_plane, preset, seq,
                   steps=8):
    """Phase 13 (b): ``TorchTrainer`` fed by a ``Dataset`` (one GPU
    worker, ``runtime_smoke.data_train_loop``), against the same loop's
    arithmetic in this process (``gpu_bench.train_step`` from the same
    seed on the same numpy batches in the same order)."""
    import math
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from ray_memory_management_tpu_torch import data as rd
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.train import (
        RunConfig, ScalingConfig, TorchTrainer)
    from ray_memory_management_tpu_torch.utils import gpu_bench, runtime_smoke

    n_layers = gpt.PRESETS[preset].n_layers
    # ids from a slice of the vocabulary: fresh rows every step, and
    # still something for 8 steps to learn (their unigram statistics)
    ids = min(DATA_IDS, gpt.PRESETS[preset].vocab_size)
    rows = np.random.default_rng(22).integers(
        0, ids, (TRAIN_B * steps, seq + 1))
    ds = rd.from_numpy(rows).map_batches(runtime_smoke.split_next_token,
                                         batch_format="numpy")
    config = dict(device=device.type, preset=preset, batch=TRAIN_B,
                  seq=seq, dtype="bfloat16")
    storage = tempfile.mkdtemp(prefix="rmt_data_fed_")
    t0 = time.time()
    try:
        res = TorchTrainer(
            runtime_smoke.data_train_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=bool(gpus),
                                         gpus_per_worker=gpus,
                                         collective_backend="dist"),
            run_config=RunConfig(name="data_fed", storage_path=storage),
            datasets={"train": ds}).fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    fit_s = time.time() - t0
    final = _train_plane_final(res, "data-fed")
    losses = final["losses"]

    params, opt, _, cfg = gpu_bench.setup_training(preset, TRAIN_B, seq,
                                                   False, "flash", device)
    want, own_s = [], []
    _sync(device)
    t_prev = time.perf_counter()
    for b in ds.iter_batches(batch_size=TRAIN_B, batch_format="numpy",
                             drop_last=True):
        batch = {k: torch.from_numpy(b[k].astype("int64")).to(device)
                 for k in ("tokens", "targets")}
        want.append(gpu_bench.train_step(params, opt, batch, cfg))
        _sync(device)
        t_now = time.perf_counter()
        own_s.append(t_now - t_prev)
        t_prev = t_now
    want = [float(x) for x in want]
    del params, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rel = [_rel(a, b) for a, b in zip(losses, want)]
    tail = slice(2, None)
    step_ms = statistics.median(final["step_s"][tail]) * 1e3
    own_ms = statistics.median(own_s[tail]) * 1e3
    wait_ms = statistics.median(final["wait_s"][tail]) * 1e3
    tokens_per_s = TRAIN_B * seq / (step_ms / 1e3)
    mfu = (tokens_per_s * final["flops_per_token"]
           / gpu_bench.PEAK_BF16_H100 if gpus else None)
    plane = train_plane["first"] if train_plane else {}
    r = dict(fit_s=fit_s, cold_start_s=final["t_loop"] - t0,
             setup_s=final["t_ready"] - final["t_loop"], losses=losses,
             in_process_losses=want, max_loss_rel=max(rel),
             step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu,
             wait_ms=wait_ms, in_process_step_ms=own_ms,
             step_ms_all=[s * 1e3 for s in final["step_s"]],
             wait_ms_all=[s * 1e3 for s in final["wait_s"]],
             launches=final["launches"], designs=final["designs"],
             bwd_designs=final["bwd_designs"],
             plane_step_ms=plane.get("step_ms"))
    log(f"[data] data-fed TorchTrainer: fit() {fit_s:.2f} s, the worker's "
        f"loop started {r['cold_start_s']:.2f} s after fit() (lease "
        f"{final['lease']!r}, {final['backend']}), set up in "
        f"{r['setup_s']:.2f} s; {len(losses)} steps from iter_batches, "
        f"losses {[round(x, 5) for x in losses]} (in-process "
        f"{[round(x, 5) for x in want]}, max rel {max(rel):.3g}, tol "
        f"{DATA_TOL:g}); step ms {[round(x, 2) for x in r['step_ms_all']]}"
        f" median of the last {steps - 2} {step_ms:.2f} (the in-process "
        f"loop timed alike {own_ms:.2f}; phase 10's worker "
        f"{r['plane_step_ms']}); iter_batches wait ms "
        f"{[round(x, 3) for x in r['wait_ms_all']]} median {wait_ms:.3f}; "
        f"tokens_per_s={tokens_per_s:.1f} mfu={mfu}; launches "
        f"{final['launches']} forward {final['designs']} backward "
        f"{final['bwd_designs']}")
    if gpus and (final["lease"] != lease or final["device_uuid"] != uuid
                 or final["backend"] != "nccl"):
        raise AssertionError(
            f"data: the worker ran with lease {final['lease']!r} on "
            f"{final['device_uuid']} over {final['backend']}, want "
            f"{lease!r}, {uuid}, nccl")
    if gpus:
        _check_trainer_launches(final, steps, n_layers, "data-fed")
    if len(losses) != steps or len(want) != steps \
            or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0] or max(rel) > DATA_TOL:
        raise AssertionError(f"data: the data-fed losses {losses} against "
                             f"the in-process loop's {want}")
    return r


def _tune_trials(device, gpus, lease, uuid, train, preset, seq):
    """Phase 13 (c): two Tune trials that lease the card, each training
    ``TUNE_STEPS`` steps from phase 6's seed and batch."""
    import math

    from ray_memory_management_tpu_torch import tune
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    n_layers = gpt.PRESETS[preset].n_layers
    lrs = [1e-4, 3e-4]
    t0 = time.time()
    grid = tune.Tuner(
        runtime_smoke.tune_trial,
        param_space={"lr": tune.grid_search(lrs), "preset": preset,
                     "batch": TRAIN_B, "seq": seq, "steps": TUNE_STEPS,
                     "device": None if gpus else "cpu"},
        resources_per_trial={"CPU": 1, "GPU": gpus} if gpus else {"CPU": 1},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1)).fit()
    fit_s = time.time() - t0
    if grid.errors or [r.status for r in grid] != ["TERMINATED"] * len(lrs):
        raise AssertionError(f"tune: trial states "
                             f"{[r.status for r in grid]}, errors "
                             f"{grid.errors}")
    trials, mark = [], t0
    for res in sorted(grid, key=lambda r: r.metrics["t_start"]):
        hist = [m for m in res.metrics_history if "loss" in m]
        last = hist[-1]
        losses = [m["loss"] for m in hist]
        want = n_layers * TUNE_STEPS
        launched = (all(n == want for n in last["launches"].values())
                    and last["designs"]["wgmma"] == want
                    and all(c["wgmma"] == want
                            for c in last["bwd_designs"].values()))
        t = dict(lr=res.config["lr"], losses=losses,
                 first_rel=_rel(losses[0], train["losses"][0]),
                 cold_start_s=last["t_ready"] - mark,
                 wall_s=last["t_end"] - mark, launches=last["launches"],
                 designs=last["designs"], bwd_designs=last["bwd_designs"],
                 lease=last["lease"], device_uuid=last["device_uuid"])
        mark = last["t_end"]
        trials.append(t)
        log(f"[tune] trial lr={t['lr']:g}: losses "
            f"{[round(x, 5) for x in losses]} (first against phase 6's "
            f"{train['losses'][0]:.5f}: rel {t['first_rel']:.3g}); cold "
            f"start {t['cold_start_s']:.2f} s, wall {t['wall_s']:.2f} s; "
            f"lease {t['lease']!r}; launches {t['launches']} forward "
            f"{t['designs']} backward {t['bwd_designs']}")
        if len(losses) != TUNE_STEPS or t["first_rel"] > DATA_TOL \
                or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"tune: trial lr={t['lr']} losses {losses}")
        if gpus and (not launched or t["lease"] != lease
                     or t["device_uuid"] != uuid):
            raise AssertionError(f"tune: trial lr={t['lr']} ran with lease "
                                 f"{t['lease']!r} on {t['device_uuid']} "
                                 f"and launches {t['launches']} "
                                 f"{t['designs']} {t['bwd_designs']}")
    best = grid.get_best_result()
    low = min(trials, key=lambda t: t["losses"][-1])
    if sorted(t["lr"] for t in trials) != lrs \
            or best.config["lr"] != low["lr"] \
            or best.metrics["loss"] != low["losses"][-1]:
        raise AssertionError(f"tune: best result {best.config} "
                             f"{best.metrics.get('loss')} against the "
                             f"trials' last losses {trials}")
    log(f"[tune] Tuner.fit(): {len(trials)} trials TERMINATED, no errors, "
        f"in {fit_s:.2f} s; best lr={best.config['lr']:g} loss "
        f"{best.metrics['loss']:.5f}")
    return dict(fit_s=fit_s, trials=trials, best_lr=best.config["lr"],
                launches=trials[0]["launches"])


def _workflow_and_dag(device, gpus, lease, uuid):
    """Phase 13 (d): a two-step workflow whose first step runs the
    forward kernel on the card, resumed once after its second step
    failed; and a DAG over a GPU task."""
    import shutil
    import tempfile

    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import workflow
    from ray_memory_management_tpu_torch.dag import InputNode
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention)
    from ray_memory_management_tpu_torch.utils import runtime_smoke
    from ray_memory_management_tpu_torch.workflow.storage import (
        WorkflowStorage)

    gen = torch.Generator(device=device).manual_seed(17)
    q, k, v = (torch.randn(BH, MAIN_CASE[1], HEAD_DIM, device=device,
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    with torch.inference_mode():
        want = flash_attention(q, k, v, causal=True)
    want_sums = want.cpu().float().sum(-1)
    base = tempfile.mkdtemp(prefix="rmt_workflow_")
    old = workflow.get_storage()
    workflow.set_storage(base)
    log_path, marker = f"{base}/attend.log", f"{base}/failed_once"

    def runs():
        with open(log_path) as f:
            return [int(line.split()[1]) for line in f]

    try:
        attend = workflow.step(num_gpus=gpus)(runtime_smoke.attend_step)
        reduce = workflow.step(max_retries=0)(runtime_smoke.row_sums)
        first = attend.step(q, k, v, log_path)
        t0 = time.perf_counter()
        out = workflow.run(reduce.step(first), workflow_id="attend")
        run_s = time.perf_counter() - t0
        stored = WorkflowStorage("attend").load_step_result(
            first.step_id({}))
        status = workflow.get_status("attend")
        dag = reduce.step(attend.step(q, k, v, log_path), marker)
        failed = None
        try:
            workflow.run(dag, workflow_id="resumed")
        except Exception as e:  # noqa: BLE001 - the injected failure
            failed = repr(e)
        failed_status = workflow.get_status("resumed")
        launched = runs()      # the first step of each workflow, once
        t0 = time.perf_counter()
        resumed = workflow.rerun(dag, workflow_id="resumed")
        resume_s = time.perf_counter() - t0
        resumed_launches = sum(runs()[len(launched):])
        resumed_status = workflow.get_status("resumed")
    finally:
        workflow.set_storage(old)
        shutil.rmtree(base, ignore_errors=True)
    wf = dict(run_s=run_s, resume_s=resume_s, status=status,
              failed_status=failed_status, resumed_status=resumed_status,
              launches=launched, resumed_launches=resumed_launches,
              bit_equal=_bit_equal(out["sums"], want_sums),
              resumed_bit_equal=_bit_equal(resumed["sums"], want_sums),
              stored_bit_equal=_bit_equal(stored["out"], want),
              stored_device=str(stored["out"].device),
              device_uuid=out["device_uuid"])
    log(f"[workflow] two steps (step(num_gpus={gpus}): flash_attention "
        f"bf16 BH={BH} S={MAIN_CASE[1]}; then row sums on a CPU worker): "
        f"{status} in {run_s:.2f} s, output bit-equal to the driver's "
        f"call={wf['bit_equal']}, first step's launches {launched}, its "
        f"stored output back on {wf['stored_device']} bit-equal="
        f"{wf['stored_bit_equal']}, ran on the driver's card="
        f"{out['device_uuid'] == uuid}; the second step failing once: "
        f"{failed_status} ({failed}), rerun {resumed_status} in "
        f"{resume_s:.2f} s, bit-equal={wf['resumed_bit_equal']}, forward "
        f"launches in the resumed run {resumed_launches}")
    if not (status == resumed_status == "SUCCESS"
            and failed_status == "FAILED" and "injected" in str(failed)
            and wf["bit_equal"] and wf["resumed_bit_equal"]
            and wf["stored_bit_equal"] and resumed_launches == 0
            and stored["out"].device.type == device.type
            and len(launched) == 2):
        raise AssertionError(f"workflow: {wf}")
    if gpus and (launched != [1, 1] or out["device_uuid"] != uuid):
        raise AssertionError(f"workflow: launches {launched} on "
                             f"{out['device_uuid']} (want {uuid})")

    task = rmt.remote(runtime_smoke.attend).options(num_gpus=gpus)
    with InputNode() as inp:
        graph = task.bind(inp, k, v)
    t0 = time.perf_counter()
    got = rmt.get(graph.execute(q), timeout=600)
    dag_s = time.perf_counter() - t0
    d = dict(dag_s=dag_s, bit_equal=_bit_equal(got["out"], want),
             launches=got["launches"]["flash_attention_fwd"],
             designs=got["designs"], lease=got["cuda_visible_devices"],
             device_uuid=got["device_uuid"])
    log(f"[dag] InputNode -> num_gpus={gpus} task (flash_attention): "
        f"execute() in {dag_s:.2f} s, output on {got['out'].device} "
        f"bit-equal to the driver's call={d['bit_equal']}, lease "
        f"{d['lease']!r}, its card the driver's={d['device_uuid'] == uuid}"
        f", launches {d['launches']} {d['designs']}")
    if not d["bit_equal"] or (gpus and (
            d["device_uuid"] != uuid or d["lease"] != lease
            or d["launches"] != 1 or d["designs"]["wgmma"] != 1)):
        raise AssertionError(f"dag: {d}")
    return dict(workflow=wf, dag=d)


def phase_data_tune(device, train, train_plane, card, preset="gpt2-small",
                    seq=TRAIN_S):
    """Phase 13: Data, Tune, Workflow and DAG on the card (see the module
    docstring). ``train`` is phase 6's result, whose first loss the Tune
    trials must give; ``train_plane`` phase 10's, whose worker step is
    printed beside the data-fed one."""
    import torch

    import ray_memory_management_tpu_torch as rmt

    gpus = int(device.type == "cuda")
    if gpus:
        torch.cuda.empty_cache()
    lease, uuid = _driver_card(device) if gpus else (None, None)
    t_phase = time.perf_counter()
    rmt.init(num_cpus=4, num_gpus=gpus, object_store_memory=DATA_STORE)
    try:
        inference = _data_inference(device, gpus, uuid, preset, seq)
        training = _data_training(device, gpus, lease, uuid, train_plane,
                                  preset, seq)
        trials = _tune_trials(device, gpus, lease, uuid, train, preset, seq)
        wf = _workflow_and_dag(device, gpus, lease, uuid)
    finally:
        rmt.shutdown()
    segs, procs = _leftovers()
    log(f"[data] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"data and tune: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[data_tune] {card}: phase_s={phase_s:.1f} "
        f"inference_rows_per_s={inference['rows_per_s']:.1f} "
        f"inference_tokens_per_s={inference['tokens_per_s']:.0f} "
        f"inference_steady_rows_per_s={inference['steady_rows_per_s']:.1f} "
        f"inference_first_map_s={inference['cold_s']:.2f} "
        f"actor_first_batch_s={inference['first_batch_s']:.2f} "
        f"data_fed_step_ms={training['step_ms']:.2f} "
        f"data_fed_tokens_per_s={training['tokens_per_s']:.1f} "
        f"data_fed_mfu={training['mfu']} "
        f"ingest_wait_ms={training['wait_ms']:.3f} "
        f"in_process_step_ms={training['in_process_step_ms']:.2f} "
        f"train_plane_step_ms={training['plane_step_ms']} "
        f"data_fed_fit_s={training['fit_s']:.2f} "
        f"data_fed_max_loss_rel={training['max_loss_rel']:.3g} "
        f"tune_fit_s={trials['fit_s']:.2f} " + " ".join(
            f"trial_lr{t['lr']:g}_wall_s={t['wall_s']:.2f} "
            f"trial_lr{t['lr']:g}_cold_start_s={t['cold_start_s']:.2f}"
            for t in trials["trials"])
        + f" workflow_run_s={wf['workflow']['run_s']:.2f} "
        f"workflow_resume_s={wf['workflow']['resume_s']:.2f} "
        f"dag_execute_s={wf['dag']['dag_s']:.2f}")
    log(figures)
    return dict(phase_s=phase_s, inference=inference, training=training,
                tune=trials, workflow=wf["workflow"], dag=wf["dag"],
                figures=figures)


SURFACES_STORE = 2 << 30      # shm for the job's rows and the replica's hops
SURFACES_IDS_SEED = 31        # the GPU job's 8 x 1024 prefill ids
AUTOSCALE_IDLE_S = 4.0        # an idle autoscaled node's life
JOB_DRIVER = '''\
"""A job's driver: joins the head that submitted it and runs one GPU
task, gpt2-small's bf16 prefill of 8 rows x 1024 ids."""
import json
import numpy as np
import ray_memory_management_tpu_torch as rmt
from ray_memory_management_tpu_torch.utils import runtime_smoke

rmt.init(address="auto")
ids = np.random.default_rng({seed}).integers(0, {vocab}, (8, {seq}))
score = rmt.remote(runtime_smoke.score_batch).options(num_gpus=1)
out = rmt.get(score.remote(ids, preset={preset!r}, device={where!r}),
              timeout=900)
print("JOB_RESULT " + json.dumps({{
    "digest": runtime_smoke.score_digest(out),
    "launches": int(out["launches"][0]), "wgmma": int(out["wgmma"][0]),
    "device_uuid": str(out["device_uuid"][0])}}))
rmt.shutdown()
'''


def _surfaces_autoscale(device, on_card, rt, uuid):
    """Phase 14 (b): a ``num_gpus=1`` flash forward task waits on a head
    without a card until ``StandardAutoscaler`` adds a node agent that
    leases it; the idle agent is then scaled down."""
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.autoscaler import (
        ProcessNodeProvider, StandardAutoscaler)
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        reference_attention)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    provider = ProcessNodeProvider(rt)
    scaler = StandardAutoscaler(
        provider, node_config={"num_cpus": 2, "num_gpus": 1},
        max_workers=1, idle_timeout_s=AUTOSCALE_IDLE_S, runtime=rt)
    gen = torch.Generator(device=device).manual_seed(14)
    q, k, v = (torch.randn(BH, MAIN_CASE[1], HEAD_DIM, device=device,
                           generator=gen).to(torch.bfloat16)
               for _ in range(3))
    head_gpus = rmt.cluster_resources().get("GPU", 0)
    t0 = time.perf_counter()
    ref = rmt.remote(runtime_smoke.attend).options(
        num_gpus=1).remote(q, k, v)
    demand = 0
    while time.perf_counter() - t0 < 60 and not demand:
        demand = scaler.pending_demand()
        time.sleep(0.05)
    while not provider.non_terminated_nodes():
        if time.perf_counter() - t0 > 120:
            raise AssertionError("surfaces: the autoscaler added no node")
        scaler.update()
        time.sleep(0.1)
    (node,) = provider.non_terminated_nodes()
    join_s = time.perf_counter() - t0
    got = rmt.get(ref, timeout=600)
    result_s = time.perf_counter() - t0
    want = reference_attention(q.float(), k.float(), v.float(), True)
    err = (got["out"].float() - want).abs().max().item()
    close = bool(torch.allclose(got["out"].float(), want,
                                atol=TOL["bfloat16"], rtol=TOL["bfloat16"]))
    launches = got["launches"]["flash_attention_fwd"]
    while provider.non_terminated_nodes():
        if time.perf_counter() - t0 > 240:
            raise AssertionError("surfaces: the idle node never went")
        scaler.update()
        time.sleep(0.1)
    down_s = time.perf_counter() - t0
    r = dict(join_s=join_s, result_s=result_s, down_s=down_s,
             launches=launches, designs=got["designs"], max_abs_err=err,
             launched=scaler.num_launches,
             terminated=scaler.num_terminations)
    log(f"[surfaces] (b) head GPU={head_gpus}; a num_gpus=1 flash "
        f"forward task (bf16 BH={BH} S={MAIN_CASE[1]} causal) made "
        f"pending demand {demand}; StandardAutoscaler(ProcessNodeProvider,"
        f" num_gpus=1) launched node {node.hex()[:8]}: joined "
        f"{join_s:.2f} s, result {result_s:.2f} s, scaled down "
        f"{down_s:.2f} s after the demand (idle timeout "
        f"{AUTOSCALE_IDLE_S:g} s); ran on node {got['node_id'][:8]} "
        f"CUDA_VISIBLE_DEVICES={got['cuda_visible_devices']!r}, launches "
        f"{got['launches']} {got['designs']}, max_abs_err={err:.3e} "
        f"against reference_attention (tol {TOL['bfloat16']:g})")
    ok = (head_gpus == 0 and demand >= 1 and close
          and got["node_id"] == node.hex() and r["launched"] == 1
          and r["terminated"] == 1 and not rt.nodes[node].alive)
    if on_card:
        ok = ok and (launches == 1 and got["designs"]["wgmma"] == 1
                     and got["device_uuid"] == uuid)
    if not ok:
        raise AssertionError(f"surfaces: autoscaled GPU task off: {r}")
    return r


def _surfaces_job(here, tmp, address, on_card, uuid, preset, seq, want):
    """Phase 14 (a): a submitted driver joins the head and runs the GPU
    prefill; its digest must be the in-process one."""
    from ray_memory_management_tpu_torch import state
    from ray_memory_management_tpu_torch.job_submission import (
        JobSubmissionClient)
    from ray_memory_management_tpu_torch.models import gpt

    path = os.path.join(tmp, "job_driver.py")
    with open(path, "w") as f:
        f.write(JOB_DRIVER.format(
            seed=SURFACES_IDS_SEED, vocab=gpt.PRESETS[preset].vocab_size,
            seq=seq, preset=preset, where=None if on_card else "cpu"))
    client = JobSubmissionClient(os.path.join(tmp, "jobs"), address=address)
    t0 = time.perf_counter()
    job = client.submit_job(
        entrypoint=f"{sys.executable} {path}",
        runtime_env={"env_vars": {"PYTHONPATH": here}})
    status = client.get_job_status(job)
    while status == "RUNNING" and time.perf_counter() - t0 < 600:
        time.sleep(0.2)
        status = client.get_job_status(job)
    done_s = time.perf_counter() - t0
    logs = client.get_job_logs(job)
    lines = [ln for ln in logs.splitlines() if ln.startswith("JOB_RESULT ")]
    if status != "SUCCEEDED" or not lines:
        raise AssertionError(f"surfaces: job {job} ended {status}; its "
                             f"log:\n{logs[-4000:]}")
    res = json.loads(lines[-1].split(" ", 1)[1])
    rows = [r for r in state.list_jobs() if r.get("submission_id") == job]
    head_job = rows[0]["job_id"] if rows else None
    tasks = state.list_tasks(job_id=head_job) if head_job else []
    gpu_tasks = [t for t in tasks if t["name"].endswith("score_batch")]
    r = dict(s=done_s, status=status, digest=res["digest"],
             launches=res["launches"], head_job=head_job,
             tasks=[(t["name"], t["state"]) for t in tasks])
    log(f"[surfaces] (a) job {job}: submit to {status} {done_s:.2f} s; "
        f"its driver joined the head as job {str(head_job)[:8]}, whose "
        f"tasks {r['tasks']}; the GPU task's prefill (8 x {seq}) digest "
        f"{res['digest'][:16]} (in-process {want[:16]}, equal="
        f"{res['digest'] == want}), launches {res['launches']} "
        f"({res['wgmma']} wgmma) on card {res['device_uuid'][:12] or '-'}")
    n_layers = gpt.PRESETS[preset].n_layers
    ok = (res["digest"] == want and len(rows) == 1
          and [t["state"] for t in gpu_tasks] == ["FINISHED"])
    if on_card:
        ok = ok and (res["launches"] == n_layers
                     and res["wgmma"] == n_layers
                     and res["device_uuid"] == uuid)
    if not ok:
        raise AssertionError(f"surfaces: the GPU job is off: {r}")
    return r


def _surfaces_replica(on_card, agent, uuid, hint, preset, kw, seq,
                      want_tokens, reqs):
    """Phase 14 (c): ``llm_deployment(placement_hint=...)`` of the pinned
    weights' id: the replica placed ``tier_affine`` on the agent serves
    the burst and the in-process engine's greedy tokens."""
    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import serve as rserve
    from ray_memory_management_tpu_torch.core import metrics_defs as mdefs
    from ray_memory_management_tpu_torch.serve.llm import llm_deployment

    def placements():
        out = {}
        for tags, v in mdefs.serve_replica_placements().series().items():
            mode = dict(tags).get("mode")
            out[mode] = out.get(mode, 0.0) + v
        return out

    before = placements()
    rserve.start(http_port=None)
    t0 = time.perf_counter()
    app = llm_deployment(preset, ray_actor_options={"num_gpus": 1},
                         placement_hint=hint,
                         device=None if on_card else "cpu", **kw)
    h, run_s, first_s = _deploy_served(rserve, rmt, app, t0)
    added = {}
    while time.perf_counter() - t0 < 60 + first_s:
        added = {m: v - before.get(m, 0.0) for m, v in placements().items()
                 if v - before.get(m, 0.0) > 0}
        if added:
            break
        time.sleep(0.2)
    rmt.get(h.reset_counters.remote(), timeout=60)
    results, _lat, wall, errors, hung = _burst(
        lambda r: rmt.get(h.remote(r), timeout=600), reqs)
    c = rmt.get(h.counters.remote(), timeout=60)
    got = [rmt.get(h.remote({"tokens": p}), timeout=600)["tokens"]
           for p in seq]
    launches = c["launches"]["flash_attention_fwd"]
    r = dict(placements=added, node_id=c["node_id"], run_s=run_s,
             first_s=first_s, wall_s=wall,
             requests_per_s=len(reqs) / wall, launches=launches,
             designs=c["designs"], tokens_equal=got == want_tokens,
             pages=c["stats"]["kv"]["pages_in_use"], handle=h)
    log(f"[surfaces] (c) serve.run(llm_deployment({preset!r}, num_gpus=1,"
        f" placement_hint={hint[:8]})): placements {added}, replica "
        f"on node {str(c['node_id'])[:8]} (the weights' node "
        f"{agent.hex()[:8]}), card {str(c['device_uuid'])[:12]}; run "
        f"{run_s:.2f} s, first reply {first_s:.2f} s; burst of "
        f"{len(reqs)} in {wall:.3f} s = {r['requests_per_s']:.2f} "
        f"requests/s, launches {launches} {c['designs']}, pages "
        f"{r['pages']}; greedy tokens equal to the in-process engine's="
        f"{r['tokens_equal']}")
    need = len(reqs) * 12
    ok = (added == {"tier_affine": 1.0} and c["node_id"] == agent.hex()
          and not errors and not hung and r["tokens_equal"]
          and r["pages"] == 0
          and all(len(x["tokens"]) == kw["max_new_tokens"]
                  for x in results))
    if on_card:
        ok = ok and (c["device_uuid"] == uuid and launches >= need
                     and c["designs"]["wgmma"] == launches)
    if not ok:
        raise AssertionError(f"surfaces: the tier-affine replica is off: "
                             f"{ {k: v for k, v in r.items() if k != 'handle'} }"
                             f" errors {errors} hung {hung}")
    return r


def _surfaces_readings(agent, address, hint, nbytes, here):
    """Phase 14 (d): the dashboard's routes and the CLI, run as a
    subprocess through the client port, while the weights are pinned."""
    import urllib.request

    from ray_memory_management_tpu_torch.dashboard import Dashboard

    dash = Dashboard(port=0)
    try:
        def fetch(route):
            with urllib.request.urlopen(dash.url + route, timeout=60) as f:
                return f.read().decode()

        nodes = json.loads(fetch("/api/nodes"))
        objects = json.loads(fetch("/api/objects"))
        metrics = fetch("/metrics")
    finally:
        dash.stop()
    agent_row = [n for n in nodes if n["node_id"] == agent.hex()]
    agent_gpu = (agent_row[0]["resources_total"].get("GPU")
                 if agent_row else None)
    weights = [(o["where"], o["node_id"]) for o in objects
               if o["object_id"] == hint]
    # one series per process: the agent's processes hold the weights
    pinned = [float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
              if ln.startswith("rmt_device_bytes_pinned{")
              and f'node_id="{agent.hex()}"' in ln]
    env = dict(os.environ, PYTHONPATH=here)
    cli = [sys.executable, "-m", "ray_memory_management_tpu_torch.scripts.cli"]
    status = subprocess.run(cli + ["status", "--address", address],
                            capture_output=True, text=True, timeout=300,
                            env=env)
    listed = subprocess.run(cli + ["list", "objects", "--address", address],
                            capture_output=True, text=True, timeout=300,
                            env=env)
    cli_rows = (json.loads(listed.stdout) if listed.returncode == 0
                else [])
    cli_weights = [(o["where"], o["node_id"]) for o in cli_rows
                   if o["object_id"] == hint]
    agent_line = [ln for ln in status.stdout.splitlines()
                  if agent.hex() in ln]
    r = dict(agent_gpu=agent_gpu, weights=weights, pinned=pinned,
             cli_weights=cli_weights, cli_agent_line=agent_line)
    log(f"[surfaces] (d) dashboard /api/nodes: the agent's GPU "
        f"{agent_gpu}; /api/objects: the weights {weights}; /metrics "
        f"rmt_device_bytes_pinned of the agent's processes {pinned} "
        f"(weights {nbytes} bytes); CLI "
        f"status (rc {status.returncode}): {agent_line}; CLI list objects "
        f"(rc {listed.returncode}): the weights {cli_weights}")
    ok = (agent_gpu == 1 and weights == [("device", agent.hex())]
          and pinned and max(pinned) >= nbytes and status.returncode == 0
          and listed.returncode == 0 and cli_weights == weights
          and len(agent_line) == 1 and "GPU 1.0" in agent_line[0])
    if not ok:
        raise AssertionError(f"surfaces: the readings disagree: {r}; CLI "
                             f"stderr {status.stderr[-2000:]} "
                             f"{listed.stderr[-2000:]}")
    return r


def _surfaces_reference(device, preset, kw, seq_prompts, reqs, seq, tmp):
    """In-process references of phase 14: the GPU job's prefill digest,
    the engine's greedy tokens, and a ``utils/profiling`` trace of one
    burst, which must name the forward kernel."""
    import numpy as np

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.serve.llm import LLMServer
    from ray_memory_management_tpu_torch.utils import profiling, runtime_smoke

    ids = np.random.default_rng(SURFACES_IDS_SEED).integers(
        0, gpt.PRESETS[preset].vocab_size, (8, seq))
    digest = runtime_smoke.score_digest(runtime_smoke.score_batch(
        ids, preset=preset, device=device))
    runtime_smoke._SCORERS.clear()
    srv = LLMServer(preset=preset, device=device, **kw)
    try:
        want_tokens = [srv.generate(p) for p in seq_prompts]
        logdir = os.path.join(tmp, "trace")
        with profiling.trace(logdir, device=device.type):
            _, _, wall, errors, hung = _burst(srv, reqs)
    finally:
        srv.close()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"
                      and "flash_fwd" in e.get("name", "")})
    log(f"[surfaces] in-process references: prefill digest "
        f"{digest[:16]}; utils.profiling.trace of one burst ({wall:.3f} s,"
        f" {len(events)} events) names the forward kernel(s) "
        f"{short_names(kernels)}")
    if errors or hung or (device.type == "cuda" and not any(
            "flash_fwd_wgmma_kernel" in k for k in kernels)):
        raise AssertionError(f"surfaces: the traced burst failed ({errors},"
                             f" {hung} hung) or named no forward kernel "
                             f"({kernels})")
    return digest, want_tokens, kernels


def phase_surfaces(device, card, preset="gpt2-small", seq=TRAIN_S,
                   max_batch_size=8, max_new_tokens=32, seed=0):
    """Phase 14: the surfaces over the card (see the module docstring)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch import serve as rserve
    from ray_memory_management_tpu_torch import state
    from ray_memory_management_tpu_torch.client import ClusterServer
    from ray_memory_management_tpu_torch.core.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    uuid = _driver_card(device)[1] if on_card else None
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="rmt_surfaces_")
    cfg = gpt.PRESETS[preset]
    kw = dict(max_batch_size=max_batch_size, max_new_tokens=max_new_tokens,
              seed=seed)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in (7, 130, 600)]
    reqs = _serve_requests(cfg.vocab_size, seed)
    t_phase = time.perf_counter()
    digest, want_tokens, kernels = _surfaces_reference(
        device, preset, kw, prompts, reqs, seq, tmp)
    if on_card:
        torch.cuda.empty_cache()
    rt = rmt.init(num_cpus=4, num_gpus=0, object_store_memory=SURFACES_STORE)
    server = ClusterServer(port=0)
    address = f"127.0.0.1:{server.port}"
    try:
        autoscaled = _surfaces_autoscale(device, on_card, rt, uuid)
        t0 = time.perf_counter()
        agent = rt.add_remote_node_process(num_cpus=4, num_gpus=1)
        join_s = time.perf_counter() - t0
        pin = rmt.remote(runtime_smoke.pin_weights).options(
            num_gpus=1, scheduling_strategy=NodeAffinitySchedulingStrategy(
                agent, soft=False))
        held = rmt.get(pin.remote(preset, seed, "bfloat16",
                                  None if on_card else "cpu"), timeout=600)
        hint = held["object_id"]
        pin_rows = [t for t in state.list_tasks()
                    if t["name"].endswith("pin_weights")]
        hbm = [t["hbm_bytes"] for t in pin_rows]
        log(f"[surfaces] agent {agent.hex()[:8]} (num_gpus=1) joined "
            f"in {join_s:.2f} s; a GPU task pinned {preset}'s bf16 weights "
            f"({held['nbytes']} bytes, object {hint[:8]}) in its device "
            f"tier on node {str(held['node_id'])[:8]}, card "
            f"{str(held['device_uuid'])[:12]}; the task's hbm_bytes {hbm}")
        if not (held["node_id"] == agent.hex() and len(hbm) == 1
                and hbm[0] and hbm[0] >= held["nbytes"]
                and (not on_card or held["device_uuid"] == uuid)):
            raise AssertionError(f"surfaces: pinning the weights is off: "
                                 f"{held}, hbm_bytes {hbm}")
        job = _surfaces_job(here, tmp, address, on_card, uuid, preset, seq,
                            digest)
        replica = _surfaces_replica(on_card, agent, uuid, hint, preset, kw,
                                    prompts, want_tokens, reqs)
        readings = _surfaces_readings(agent, address, hint, held["nbytes"],
                                      here)
        replica.pop("handle")
        del held
    finally:
        try:
            rserve.shutdown()
        finally:
            server.close()
            rmt.shutdown()
            shutil.rmtree(tmp, ignore_errors=True)
    segs, procs = _leftovers()
    log(f"[surfaces] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}")
    if segs or procs:
        raise AssertionError(f"surfaces: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[surfaces] {card}: phase_s={phase_s:.1f} job_submit_to_"
        f"succeeded_s={job['s']:.2f} autoscale_join_s="
        f"{autoscaled['join_s']:.2f} autoscale_first_result_s="
        f"{autoscaled['result_s']:.2f} autoscale_down_s="
        f"{autoscaled['down_s']:.2f} agent_join_s={join_s:.2f} "
        f"replica_run_s={replica['run_s']:.2f} replica_first_reply_s="
        f"{replica['first_s']:.2f} replica_requests_per_s="
        f"{replica['requests_per_s']:.2f}")
    log(figures)
    return dict(phase_s=phase_s, job=job, autoscale=autoscaled,
                replica=replica, readings=readings, kernels=kernels,
                figures=figures)


RL_HIDDEN = (64, 64)          # the JAX package's default actor-critic
RL_BATCH = 4000               # PPO's train_batch_size (the JAX default)
RL_FRAGMENT = 200             # rollout_fragment_length (the JAX default)
RL_MINIBATCH = 128            # sgd_minibatch_size (the JAX default)
RL_EPOCHS = 6                 # num_sgd_iter (the JAX default)
RL_GATED = 8                  # PPO minibatch updates held to RL_TOL
RL_PPO_ITERS = 12             # phase 15b's budget of training iterations
RL_TOL = (1e-5, 1e-6)         # |card - plain| <= a * max|plain leaf| + b


def _rl_err(got, want):
    """(largest |got - want| over the leaves of two trees, largest ratio
    of a leaf's error to its tolerance RL_TOL)."""
    from ray_memory_management_tpu_torch.rllib.models import tree_leaves

    worst = over = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g = g.detach().cpu().double()
        w = w.detach().cpu().double()
        err = float((g - w).abs().max())
        tol = RL_TOL[0] * float(w.abs().max()) + RL_TOL[1]
        worst, over = max(worst, err), max(over, err / tol)
    return worst, over


def _rl_pair(device, init, lr, make):
    """The same initial tree as trainable leaves on the card and on the
    CPU, each with its own Adam and update function ``make(opt)``."""
    import torch

    from ray_memory_management_tpu_torch.rllib.models import (
        make_adam, tree_map)

    out = []
    for dev in (device, torch.device("cpu")):
        params = tree_map(
            lambda t: t.detach().clone().to(dev).requires_grad_(True), init)
        opt = make_adam(params, lr)
        out.append((params, make(opt)))
    return out


def _rl_update_trace(step, reps=20):
    """One PPO minibatch update on the card, ``reps`` times back to back:
    the kernels it launches, their device time, and the wall time of an
    update from a ``torch.profiler`` trace (device rows as in
    ``device_ms``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_memory_management_tpu_torch.utils.profile_serve import (
        device_us, kernel_rows)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = kernel_rows(prof)
    busy_ms = sum(device_us(e) for e in rows) / 1e3 / reps
    wall_ms = wall / reps * 1e3
    return dict(kernels_per_update=sum(e.count for e in rows) / reps,
                device_ms=busy_ms, traced_wall_ms=wall_ms,
                idle_share=1.0 - busy_ms / wall_ms)


def _rl_learner_parity(device):
    """Phase 15a: the learners' updates on the card against the same
    updates on the CPU (the plain path), fp32 with TF32 off."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.rllib import models as rm
    from ray_memory_management_tpu_torch.rllib import sample_batch as sb
    from ray_memory_management_tpu_torch.rllib.appo import make_appo_update
    from ray_memory_management_tpu_torch.rllib.dqn import (
        DQNRolloutWorker, make_dqn_update, q_init)
    from ray_memory_management_tpu_torch.rllib.impala import (
        IMPALA_COLUMNS, make_impala_update)
    from ray_memory_management_tpu_torch.rllib.ppo import (
        PPO_COLUMNS, make_ppo_update, to_device)
    from ray_memory_management_tpu_torch.rllib.recurrent import (
        C0, H0, SEQ_COLUMNS, RecurrentRolloutWorker, lstm_ac_init,
        make_recurrent_ppo_update)
    from ray_memory_management_tpu_torch.rllib.rollout_worker import (
        RolloutWorker)

    cpu = torch.device("cpu")
    env = ("CartPole", {"max_episode_steps": 200})
    worker = RolloutWorker(*env, RL_HIDDEN, seed=0)
    t0 = time.perf_counter()
    batch = sb.concat_batches(
        [worker.sample(RL_FRAGMENT) for _ in range(RL_BATCH // RL_FRAGMENT)])
    record_s = time.perf_counter() - t0
    n = sb.batch_size(batch)
    init = rm.ac_init(rm.make_generator(0), 4, 2, RL_HIDDEN)

    # PPO: the same minibatch order on both devices
    (pc, uc), (pp, up) = _rl_pair(
        device, init, 5e-4, lambda o: make_ppo_update(o, 0.2, 0.5, 0.01))
    cols_c = to_device(batch, PPO_COLUMNS, device)
    cols_p = to_device(batch, PPO_COLUMNS, cpu)
    rng = np.random.default_rng(0)
    order = [i for _ in range(RL_EPOCHS)
             for i in sb.minibatch_indices(n, RL_MINIBATCH, rng)]
    gated = ungated = 0.0
    card_s = plain_s = 0.0
    for k, idx in enumerate(order):
        ic, ip = torch.as_tensor(idx, device=device), torch.as_tensor(idx)
        t = time.perf_counter()
        uc(pc, *(cols_c[c][ic] for c in PPO_COLUMNS))
        _sync(device)
        t1 = time.perf_counter()
        up(pp, *(cols_p[c][ip] for c in PPO_COLUMNS))
        if k:  # the first update of each pays its device's warm-up
            card_s += t1 - t
            plain_s += time.perf_counter() - t1
        err, over = _rl_err(pc, pp)
        if k < RL_GATED:
            gated = max(gated, over)
            if over > 1.0:
                raise AssertionError(
                    f"rllib: PPO update {k} on the card is {err:.3e} from "
                    f"the CPU's, {over:.2f}x the tolerance")
        ungated = max(ungated, err)
    ppo = dict(updates=len(order), gated_over=gated,
               max_abs_err_all=ungated,
               card_ms=card_s / (len(order) - 1) * 1e3,
               plain_ms=plain_s / (len(order) - 1) * 1e3, record_s=record_s)
    # traced at the end of the phase: a profiler session may leave
    # launches slower for the rest of the process
    ppo["trace_step"] = lambda: uc(pc, *(cols_c[c][ic] for c in PPO_COLUMNS))

    def one(name, pair, args_c, args_p):
        (pc, uc), (pp, up) = pair
        uc(pc, *args_c)
        up(pp, *args_p)
        err, over = _rl_err(pc, pp)
        if over > 1.0:
            raise AssertionError(f"rllib: the {name} update on the card is "
                                 f"{err:.3e} from the CPU's, {over:.2f}x "
                                 f"the tolerance")
        return dict(max_abs_err=err, over=over)

    # IMPALA and APPO: one fragment with its bootstrap value
    frag = worker.sample(RL_FRAGMENT)
    fc, fp = (to_device(frag, IMPALA_COLUMNS, d) for d in (device, cpu))
    boot = [torch.as_tensor(frag[sb.BOOTSTRAP][0], device=d)
            for d in (device, cpu)]
    out = dict(ppo=ppo)
    out["impala"] = one("IMPALA", _rl_pair(
        device, init, 5e-4,
        lambda o: make_impala_update(o, 0.99, 0.5, 0.01)),
        [*(fc[c] for c in IMPALA_COLUMNS), boot[0]],
        [*(fp[c] for c in IMPALA_COLUMNS), boot[1]])
    out["appo"] = one("APPO", _rl_pair(
        device, init, 5e-4,
        lambda o: make_appo_update(o, 0.99, 0.5, 0.01, 0.3)),
        [*(fc[c] for c in IMPALA_COLUMNS), boot[0]],
        [*(fp[c] for c in IMPALA_COLUMNS), boot[1]])

    # DQN: one double-Q update against a target net that differs from
    # the online one
    trans = DQNRolloutWorker(*env, RL_HIDDEN, seed=0).sample(1000, 1.0)
    pick = np.random.default_rng(1).choice(1000, 128, replace=False)
    keys = (sb.OBS, sb.ACTIONS, sb.REWARDS, "next_obs", sb.DONES)
    qinit = q_init(rm.make_generator(0), 4, 2, RL_HIDDEN)
    target = q_init(rm.make_generator(1), 4, 2, RL_HIDDEN)
    pair = _rl_pair(device, qinit, 1e-3, lambda o: make_dqn_update(o, 0.99))
    out["dqn"] = one(
        "DQN", pair,
        [rm.tree_map(lambda t: t.to(device), target),
         *(torch.as_tensor(trans[k][pick], device=device) for k in keys)],
        [target, *(torch.as_tensor(trans[k][pick]) for k in keys)])

    # recurrent PPO: one update over 8 recorded sequences of 200 steps
    rw = RecurrentRolloutWorker(*env, None, seed=0, embed_dim=64,
                                lstm_dim=64)
    frags = [rw.sample(RL_FRAGMENT) for _ in range(8)]
    seq = [{c: torch.as_tensor(np.stack([f[c] for f in frags]), device=d)
            for c in SEQ_COLUMNS} for d in (device, cpu)]
    state = [[torch.as_tensor(np.concatenate([f[k] for f in frags]),
                              device=d) for k in (H0, C0)]
             for d in (device, cpu)]
    out["recurrent_ppo"] = one("recurrent PPO", _rl_pair(
        device, lstm_ac_init(rm.make_generator(0), 4, 2, 64, 64), 5e-4,
        lambda o: make_recurrent_ppo_update(o, 0.2, 0.5, 0.01)),
        [*(seq[0][c] for c in SEQ_COLUMNS), *state[0]],
        [*(seq[1][c] for c in SEQ_COLUMNS), *state[1]])
    return out


def _rl_ppo_learns(device, rmt):
    """Phase 15b: PPO at the JAX package's defaults, learner on the card
    behind 2 CPU rollout actors, until the reference case's rule holds."""
    from ray_memory_management_tpu_torch.rllib import PPOConfig

    rmt.init(num_cpus=4, num_gpus=0)
    try:
        algo = (PPOConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=RL_FRAGMENT)
                .training(train_batch_size=RL_BATCH,
                          num_sgd_iter=RL_EPOCHS,
                          sgd_minibatch_size=RL_MINIBATCH,
                          model={"fcnet_hiddens": list(RL_HIDDEN)})
                .resources(device=str(device))
                .debugging(seed=0)
                .build())
        if algo.device != device or algo.workers is None:
            raise AssertionError(f"rllib: the learner is on {algo.device}")
        rows = []
        first = None
        try:
            for _ in range(RL_PPO_ITERS):
                r = algo.train()
                rows.append({k: r[k] for k in (
                    "episode_reward_mean", "num_env_steps_sampled",
                    "sample_time_s", "learn_time_s")})
                if first is None:
                    first = r["episode_reward_mean"]
                if r["episode_reward_mean"] > max(2 * first, 50):
                    break
        finally:
            algo.stop()
    finally:
        rmt.shutdown()
    last = rows[-1]["episode_reward_mean"]
    if not last > max(2 * first, 50):
        raise AssertionError(f"rllib: PPO on the card did not learn "
                             f"CartPole in {RL_PPO_ITERS} iterations: "
                             f"{[r['episode_reward_mean'] for r in rows]}")
    steps = sum(r["num_env_steps_sampled"] for r in rows)
    sample_s = sum(r["sample_time_s"] for r in rows)
    learn_s = sum(r["learn_time_s"] for r in rows)
    updates = sum(RL_EPOCHS * (r["num_env_steps_sampled"] // RL_MINIBATCH)
                  for r in rows)
    return dict(iterations=len(rows), first=first, last=last,
                rewards=[r["episode_reward_mean"] for r in rows],
                env_steps_per_s=steps / (sample_s + learn_s),
                learner_ms=learn_s / updates * 1e3, sample_s=sample_s,
                learn_s=learn_s)


def _rl_impala_dqn(device, rmt):
    """Phase 15d: IMPALA's async loop with its learner on the card (the
    copied ``test_learns_async`` rule), then DQN on the card until its
    target net has been synced."""
    from ray_memory_management_tpu_torch.rllib import DQNConfig, IMPALAConfig
    from ray_memory_management_tpu_torch.rllib.models import tree_leaves

    rmt.init(num_cpus=4, num_gpus=0)
    try:
        algo = (IMPALAConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=2,
                          rollout_fragment_length=RL_FRAGMENT)
                .training(train_batch_size=1600, lr=1e-3)
                .resources(device=str(device))
                .debugging(seed=1)
                .build())
        rewards, t0, steps = [], time.perf_counter(), 0
        try:
            for _ in range(7):
                r = algo.train()
                rewards.append(r["episode_reward_mean"])
                steps += r["num_env_steps_sampled"]
        finally:
            algo.stop()
        impala = dict(rewards=rewards,
                      env_steps_per_s=steps / (time.perf_counter() - t0))
        if not rewards[-1] > 1.5 * rewards[0]:
            raise AssertionError(f"rllib: IMPALA on the card missed the "
                                 f"async rule: {rewards}")

        dqn_algo = (DQNConfig()
                    .environment("CartPole",
                                 env_config={"max_episode_steps": 200})
                    .rollouts(num_rollout_workers=2,
                              rollout_fragment_length=100)
                    .training(lr=1e-3, train_batch_size=128,
                              learning_starts=400,
                              target_network_update_freq=100,
                              updates_per_step=64)
                    .resources(device=str(device))
                    .debugging(seed=1)
                    .build())
        try:
            before = [t.clone() for t in tree_leaves(dqn_algo.target_params)]
            t0 = time.perf_counter()
            rows = [dqn_algo.train() for _ in range(4)]
            dqn_s = time.perf_counter() - t0
            synced = not all(
                bool((a == b).all()) for a, b in zip(
                    before, tree_leaves(dqn_algo.target_params)))
            updates = dqn_algo._updates_done
            on_card = all(t.device == device
                          for t in tree_leaves(dqn_algo.params))
        finally:
            dqn_algo.stop()
    finally:
        rmt.shutdown()
    dqn = dict(updates=updates, syncs=updates // 100, synced=synced,
               s=dqn_s, learn_s=sum(r["learn_time_s"] for r in rows),
               loss=rows[-1].get("loss"))
    if not (synced and updates >= 100 and on_card):
        raise AssertionError(f"rllib: DQN on the card: {dqn}, learner on "
                             f"the card {on_card}")
    return impala, dqn


def phase_rllib(device, card):
    """Phase 15: RLlib's learners on the card (see the module docstring).
    The flash kernels' launch counts are zeroed at the start and must
    read 0 at the end: no RLlib path reaches them."""
    import math

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        launch_counts, reset_launch_count)
    from ray_memory_management_tpu_torch.utils.gpu_bench import (
        rl_learner_bench)

    t_phase = time.perf_counter()
    reset_launch_count()
    parity = _rl_learner_parity(device)
    ppo = parity["ppo"]
    log(f"[rllib] {card}: (a) learner parity, card against CPU, fp32, TF32 "
        f"off, tolerance {RL_TOL[0]:g} * max|leaf| + {RL_TOL[1]:g}: PPO "
        f"({RL_BATCH} recorded steps, {RL_EPOCHS} epochs of "
        f"{RL_MINIBATCH}) first {RL_GATED} updates at "
        f"{ppo['gated_over']:.3f}x the tolerance, all {ppo['updates']} "
        f"updates max_abs_err={ppo['max_abs_err_all']:.3e} (not gated); "
        f"update ms (after the first, each synchronised) card "
        f"{ppo['card_ms']:.3f} CPU {ppo['plain_ms']:.3f}; "
        + " ".join(f"{k} {v['max_abs_err']:.3e} ({v['over']:.3f}x)"
                   for k, v in parity.items() if k != "ppo"))

    learns = _rl_ppo_learns(device, rmt)
    log(f"[rllib] {card}: (b) PPO at the JAX defaults (hidden "
        f"{RL_HIDDEN}, 2 CPU rollout actors, fragment {RL_FRAGMENT}, "
        f"batch {RL_BATCH}, {RL_EPOCHS} x {RL_MINIBATCH}), learner on "
        f"{device}: episode_reward_mean {learns['rewards']} "
        f"({learns['iterations']} iterations; rule > max(2 x "
        f"{learns['first']:.2f}, 50)); env_steps_per_s="
        f"{learns['env_steps_per_s']:.1f} learner_ms="
        f"{learns['learner_ms']:.3f} per update sample_s="
        f"{learns['sample_s']:.2f} learn_s={learns['learn_s']:.2f}")
    bench = rl_learner_bench(device=device)
    log(f"[rllib] {card}: (c) rl_learner_bench (2 workers, 4 iterations, "
        f"batch 4096, fragment 512, 6 x 512): " + json.dumps(bench))
    impala, dqn = _rl_impala_dqn(device, rmt)
    log(f"[rllib] {card}: (d) IMPALA async, 2 workers, learner on card: "
        f"episode_reward_mean {impala['rewards']} (rule > 1.5 x first) "
        f"env_steps_per_s={impala['env_steps_per_s']:.1f}; DQN on card: "
        f"{dqn['updates']} updates, {dqn['syncs']} target syncs, "
        f"learn_s={dqn['learn_s']:.2f}, last loss {dqn['loss']}")
    trace_step = ppo.pop("trace_step")
    if device.type == "cuda":
        ppo.update(_rl_update_trace(trace_step))
        log(f"[rllib] {card}: a PPO update (minibatch {RL_MINIBATCH}) "
            f"traced 20 times: {ppo['kernels_per_update']:.1f} kernels, "
            f"device {ppo['device_ms']:.4f} ms of "
            f"{ppo['traced_wall_ms']:.3f} ms wall (idle "
            f"{ppo['idle_share']:.3f})")
    launches = launch_counts()
    log(f"[rllib] (e) flash kernel launches over phase 15: {launches} "
        f"(RLlib's nets reach no kernel)")
    if any(launches.values()):
        raise AssertionError(f"rllib: flash kernels launched {launches}")
    if not (math.isfinite(bench["learner_ms"]) and bench["learner_ms"] > 0):
        raise AssertionError(f"rllib: bench row {bench}")
    segs, procs = _leftovers()
    if segs or procs:
        raise AssertionError(f"rllib: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[rllib] {card}: phase_s={phase_s:.1f} ppo_update_ms_card="
        f"{ppo['card_ms']:.3f} ppo_update_ms_cpu={ppo['plain_ms']:.3f} "
        f"ppo_update_kernels={ppo.get('kernels_per_update')} "
        f"ppo_update_device_ms={ppo.get('device_ms')} "
        f"ppo_update_idle={ppo.get('idle_share')} "
        f"ppo_iterations={learns['iterations']} ppo_env_steps_per_s="
        f"{learns['env_steps_per_s']:.1f} ppo_learner_ms="
        f"{learns['learner_ms']:.3f} bench_env_steps_per_s="
        f"{bench['env_steps_per_s']:.1f} bench_learner_ms="
        f"{bench['learner_ms']:.3f} impala_env_steps_per_s="
        f"{impala['env_steps_per_s']:.1f}")
    log(figures)
    return dict(phase_s=phase_s, parity=parity, ppo=learns, bench=bench,
                impala=impala, dqn=dqn, launches=launches, figures=figures)


RL2_SAC_ITERS = 80            # TestSAC::test_learns_pendulum's budget
RL2_MBPETS_ITERS = 22         # TestMBPETS's iterations
RL2_ES_ITERS = 25             # test_learns_cartpole_gradient_free's budget
RL2_RATE_REPS = 20            # card updates timed a learner, after parity


def _rl2_rate(device, step, reps=RL2_RATE_REPS):
    """Updates a second of ``step`` on the card, each synchronised."""
    step()
    _sync(device)
    t = time.perf_counter()
    for _ in range(reps):
        step()
        _sync(device)
    return reps / (time.perf_counter() - t)


def _rl2_hold(name, card_tree, cpu_tree):
    err, over = _rl_err(card_tree, cpu_tree)
    if over > 1.0:
        raise AssertionError(f"rllib2: the {name} update on the card is "
                             f"{err:.3e} from the CPU's, {over:.2f}x the "
                             f"tolerance")
    return err, over


def _rl2_pair(device, name, build, batches):
    """``build(dev) -> (trees, step)`` on the card and on the CPU from the
    same initial trees; ``step(batch)`` runs one update in place. The
    recorded ``batches`` (tuples of numpy arrays, each update's draws
    among them) go through both, and every tree is held to RL_TOL after
    each update, then the card's update is timed. Returns the figures and
    copies of both trees as the held updates left them."""
    import torch

    from ray_memory_management_tpu_torch.rllib.models import (
        detached_copy as copy_tree)

    cpu = torch.device("cpu")
    (tc, sc), (tp, sp) = build(device), build(cpu)
    worst = over = 0.0
    for b in batches:
        sc(tuple(torch.as_tensor(x, device=device) for x in b))
        sp(tuple(torch.as_tensor(x) for x in b))
        err, o = _rl2_hold(name, tc, tp)
        worst, over = max(worst, err), max(over, o)
    trees = (copy_tree(tc), copy_tree(tp))
    last = tuple(torch.as_tensor(x, device=device) for x in batches[-1])
    rate = _rl2_rate(device, lambda: sc(last))
    return dict(updates=len(batches), max_abs_err=worst, over=over,
                updates_per_s=rate), trees


def _rl2_offpolicy_learners():
    """SAC, TD3 and DDPG learners (Pendulum's shapes, hidden (64, 64)),
    their numpy-seeded batches with the draws each update takes."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.rllib import models as rm
    from ray_memory_management_tpu_torch.rllib.sac import (
        CRITICS, make_sac_update, sac_init)
    from ray_memory_management_tpu_torch.rllib.td3 import (
        critic_keys, make_td3_update, td3_init)

    rng = np.random.default_rng(11)
    B, D, A = 128, 3, 1

    def batches(n_draws):
        return [(rng.normal(size=(B, D)).astype(np.float32),
                 rng.uniform(-2, 2, (B, A)).astype(np.float32),
                 rng.normal(-5, 3, B).astype(np.float32),
                 rng.normal(size=(B, D)).astype(np.float32),
                 (rng.uniform(size=B) < 0.05).astype(np.float32),
                 *(rng.normal(size=(B, A)).astype(np.float32)
                   for _ in range(n_draws))) for _ in range(3)]

    sac0 = sac_init(rm.make_generator(0), D, A, RL_HIDDEN)
    sac_t = sac_init(rm.make_generator(1), D, A, RL_HIDDEN)

    def sac(dev):
        p = rm.trainable(rm.detached_copy(sac0), dev)
        tg = rm.tree_map(lambda t: t.clone().to(dev), sac_t)
        la = torch.tensor(float(np.log(0.5)), device=dev,
                          requires_grad=True)
        opts = (rm.make_adam(p["pi"], 1e-3),
                rm.make_adam({k: p[k] for k in CRITICS}, 1e-3),
                rm.make_adam([la], 1e-3))
        upd = make_sac_update(*opts, 0.99, 0.005, -1.0, 2.0)
        return (p, tg, [la]), lambda b: upd(p, tg, la, b[:5], b[5:])

    def td3(twin):
        init = td3_init(rm.make_generator(2), D, A, RL_HIDDEN, twin)
        target = td3_init(rm.make_generator(3), D, A, RL_HIDDEN, twin)

        def build(dev):
            p = rm.trainable(rm.detached_copy(init), dev)
            tg = rm.tree_map(lambda t: t.clone().to(dev), target)
            upd = make_td3_update(
                rm.make_adam(p["pi"], 1e-3),
                rm.make_adam({k: p[k] for k in critic_keys(twin)}, 1e-3),
                0.99, 0.005, 2.0, twin, 0.2 if twin else 0.0, 0.5)
            count = [0]

            def step(b):
                # the delay schedule on the host's counter
                upd(p, tg, b[:5], count[0] % (2 if twin else 1) == 0, b[5])
                count[0] += 1
            return (p, tg), step
        return build

    return dict(sac=(sac, batches(2)), td3=(td3(True), batches(1)),
                ddpg=(td3(False), batches(1)))


def _rl2_offline_learners(rmt, tmp):
    """BC, MARWIL and CQL on a CartPole recording that a CPU actor wrote
    (the expert of the offline tests, then uniform random)."""
    import numpy as np

    from ray_memory_management_tpu_torch.rllib import models as rm
    from ray_memory_management_tpu_torch.rllib import sample_batch as sb
    from ray_memory_management_tpu_torch.rllib.cql import (
        derive_next_obs, make_cql_update)
    from ray_memory_management_tpu_torch.rllib.dqn import q_init
    from ray_memory_management_tpu_torch.rllib.marwil import (
        episode_returns, make_marwil_update)
    from ray_memory_management_tpu_torch.rllib.offline import (
        DatasetReader, collect_dataset, make_bc_update)
    from ray_memory_management_tpu_torch.rllib.offline import TERMINATED

    @rmt.remote(num_cpus=1)
    def record(path):
        def expert(obs):
            return (1 if obs[2] + 0.3 * obs[3] > 0 else 0), -0.05

        collect_dataset("CartPole", path, num_steps=1500, policy=expert,
                        env_config={"max_episode_steps": 200}, seed=0)
        collect_dataset("CartPole", path, num_steps=2500,
                        env_config={"max_episode_steps": 200}, seed=1)
        return os.getpid()

    path = os.path.join(tmp, "offline")
    writer_pid = rmt.get(record.remote(path))
    if writer_pid == os.getpid():
        raise AssertionError("rllib2: the dataset was not written by an "
                             "actor process")
    reader = DatasetReader(path)
    d = derive_next_obs(reader.data, reader.recording_starts)
    ret, valid = episode_returns(reader.data[sb.REWARDS],
                                 reader.data[sb.DONES], 0.99,
                                 reader.recording_starts)
    rng = np.random.default_rng(12)
    idx = [rng.integers(0, len(ret), 256) for _ in range(3)]
    cidx = [rng.integers(0, len(d[sb.OBS]), 256) for _ in range(3)]
    obs, acts = reader.data[sb.OBS], reader.data[sb.ACTIONS].astype(np.int64)
    pi0 = {"pi": rm.mlp_init(rm.make_generator(4), [4, *RL_HIDDEN, 2])}
    mw0 = {**pi0, "vf": rm.mlp_init(rm.make_generator(5),
                                    [4, *RL_HIDDEN, 1])}
    q0 = q_init(rm.make_generator(6), 4, 2, RL_HIDDEN)
    qt = q_init(rm.make_generator(7), 4, 2, RL_HIDDEN)

    def bc(dev):
        p = rm.trainable(rm.detached_copy(pi0), dev)
        upd = make_bc_update(rm.make_adam(p, 1e-3))
        return p, lambda b: upd(p, *b)

    def marwil(dev):
        import torch

        p = rm.trainable(rm.detached_copy(mw0), dev)
        c = [torch.tensor(1.0, device=dev)]
        upd = make_marwil_update(rm.make_adam(p, 1e-3), 1.0, 1.0, 1e-2)

        def step(b):
            c[0], _ = upd(p, c[0], *b)
        return (p, c), step

    def cql(dev):
        p = rm.trainable(rm.detached_copy(q0), dev)
        tg = rm.tree_map(lambda t: t.clone().to(dev), qt)
        upd = make_cql_update(rm.make_adam(p, 1e-3), 0.99, 1.0)
        return p, lambda b: upd(p, tg, *b)

    return dict(
        bc=(bc, [(obs[i], acts[i]) for i in idx]),
        marwil=(marwil, [(obs[i], acts[i], ret[i], valid[i]) for i in idx]),
        cql=(cql, [(d[sb.OBS][i], d[sb.ACTIONS][i].astype(np.int64),
                    d[sb.REWARDS][i], d["next_obs"][i], d[TERMINATED][i])
                   for i in cidx])), reader.num_samples


def _rl2_multi_learners():
    """QMIX (batches a CPU collector recorded on TwoStepCoop), MADDPG
    (Rendezvous' shapes, agents stacked [N, ...]), SlateQ (the interest-
    evolution corpus), R2D2 (sequences a CPU collector recorded on
    CartPole, burn-in 4) and the MBPETS ensemble (4 x 128 x 128)."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.rllib import models as rm
    from ray_memory_management_tpu_torch.rllib import sample_batch as sb
    from ray_memory_management_tpu_torch.rllib.maddpg import (
        maddpg_init, make_maddpg_update)
    from ray_memory_management_tpu_torch.rllib.mbrl import (
        make_model_update, mb_init)
    from ray_memory_management_tpu_torch.rllib.qmix import (
        QMIX_COLUMNS, QMixRolloutWorker, make_qmix_update, qmix_init)
    from ray_memory_management_tpu_torch.rllib.r2d2 import (
        R2D2_COLUMNS, R2D2RolloutWorker, lstm_q_init, make_r2d2_update)
    from ray_memory_management_tpu_torch.rllib.slateq import (
        InterestEvolution, _slate_combos, make_slateq_update)

    rng = np.random.default_rng(13)
    out = {}

    rec = QMixRolloutWorker("TwoStepCoop", None, (64,), seed=0).sample(
        512, 1.0)
    q0 = qmix_init(rm.make_generator(8), 5, 2, 2, 3, (64,), 32)
    qt = qmix_init(rm.make_generator(9), 5, 2, 2, 3, (64,), 32)

    def qmix(dev):
        p = rm.trainable(rm.detached_copy(q0), dev)
        tg = rm.tree_map(lambda t: t.clone().to(dev), qt)
        upd = make_qmix_update(rm.make_adam(p, 5e-4), 0.99, 2, 32)
        return p, lambda b: upd(p, tg, *b)

    picks = [rng.choice(512, 64, replace=False) for _ in range(3)]
    out["qmix"] = (qmix, [tuple(rec[k][i].astype(np.int64)
                                if k == sb.ACTIONS else rec[k][i]
                                for k in QMIX_COLUMNS) for i in picks])

    N, O, A = 2, 4, 2
    m0 = maddpg_init(rm.make_generator(10), N, O, A, RL_HIDDEN)
    mt = maddpg_init(rm.make_generator(11), N, O, A, RL_HIDDEN)

    def maddpg(dev):
        p = rm.trainable(rm.detached_copy(m0), dev)
        tg = rm.tree_map(lambda t: t.clone().to(dev), mt)
        upd = make_maddpg_update(rm.make_adam(p["pi"], 1e-3),
                                 rm.make_adam(p["q"], 1e-3), 0.95, 0.01, 1.0)
        return (p, tg), lambda b: upd(p, tg, *b)

    out["maddpg"] = (maddpg, [(
        rng.uniform(-1, 1, (256, N, O)).astype(np.float32),
        rng.uniform(-1, 1, (256, N, A)).astype(np.float32),
        rng.normal(-1, 0.3, (256, N)).astype(np.float32),
        rng.uniform(-1, 1, (256, N, O)).astype(np.float32),
        (rng.uniform(size=256) < 0.05).astype(np.float32))
        for _ in range(3)])

    env = InterestEvolution()
    combos = _slate_combos(8, env.slate_size)
    s0 = rm.mlp_init(rm.make_generator(12),
                     [env.n_topics + env.feat_dim, *RL_HIDDEN, 1])
    st = rm.mlp_init(rm.make_generator(13),
                     [env.n_topics + env.feat_dim, *RL_HIDDEN, 1])

    def slateq(dev):
        p = rm.trainable(rm.detached_copy(s0), dev)
        tg = rm.tree_map(lambda t: t.clone().to(dev), st)
        upd = make_slateq_update(rm.make_adam(p, 1e-3), 0.95)
        feats = torch.as_tensor(env.doc_feats, device=dev)[None].expand(
            128, -1, -1)
        cmb = torch.as_tensor(combos, dtype=torch.long, device=dev)
        return p, lambda b: upd(p, tg, feats, *b, cmb, 8)

    def slate_batch():
        user = rng.normal(size=(128, env.n_topics)).astype(np.float32)
        user /= np.linalg.norm(user, axis=1, keepdims=True)
        nxt = rng.normal(size=(128, env.n_topics)).astype(np.float32)
        nxt /= np.linalg.norm(nxt, axis=1, keepdims=True)
        scores = np.exp(nxt @ env.doc_topics.T + env.doc_appeal)
        return (user, env.doc_feats[rng.integers(0, env.n_docs, 128)],
                env.doc_quality[rng.integers(0, env.n_docs, 128)],
                nxt, scores.astype(np.float32),
                np.zeros(128, np.float32))

    out["slateq"] = (slateq, [slate_batch() for _ in range(3)])

    worker = R2D2RolloutWorker("CartPole", {"max_episode_steps": 200}, None,
                               seed=0, embed_dim=64, lstm_dim=64)
    seqs = [worker.sample(20, 1.0) for _ in range(48)]
    r0 = lstm_q_init(rm.make_generator(14), 4, 2, 64, 64)
    rt = lstm_q_init(rm.make_generator(15), 4, 2, 64, 64)

    def r2d2(dev):
        p = rm.trainable(rm.detached_copy(r0), dev)
        tg = rm.tree_map(lambda t: t.clone().to(dev), rt)
        upd = make_r2d2_update(rm.make_adam(p, 1e-3), 0.99, 4)
        return p, lambda b: upd(p, tg, *b)

    out["r2d2"] = (r2d2, [tuple(
        np.stack([s[k] for s in seqs[16 * j:16 * (j + 1)]]).astype(
            np.int64 if k == sb.ACTIONS else np.float32)
        for k in R2D2_COLUMNS) for j in range(3)])

    e0 = mb_init(rm.make_generator(16), 4, 3, 1, (128, 128))

    def model(dev):
        p = rm.trainable(rm.detached_copy(e0), dev)
        upd = make_model_update(rm.make_adam(p, 1e-3))
        return p, lambda b: upd(p, *b)

    out["mbpets_model"] = (model, [(
        rng.normal(size=(256, 3)).astype(np.float32),
        rng.uniform(-2, 2, (256, 1)).astype(np.float32),
        rng.normal(scale=0.1, size=(256, 3)).astype(np.float32),
        rng.normal(-5, 2, 256).astype(np.float32)) for _ in range(3)])
    return out


def _rl2_plan_parity(device, card_ensemble, cpu_ensemble):
    """One MBPETS plan (TestMBPETS's settings) on the card and on the CPU
    from the same ensemble and the same draws: each round must keep the
    same elites, and the refined mean is held to RL_TOL."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.rllib.mbrl import (
        cem_round, discounts)

    H, P, K, R, A = 25, 256, 16, 5, 1
    noise = np.random.default_rng(14).normal(
        size=(R, P, H, A)).astype(np.float32)
    obs0 = np.array([0.3, -0.9, 0.5], np.float32)
    runs = []
    for dev, params in ((device, card_ensemble),
                        (torch.device("cpu"), cpu_ensemble)):
        mean = torch.zeros((H, A), device=dev)
        std = torch.full((H, A), 1.0, device=dev)
        disc = torch.as_tensor(discounts(H, 0.99), device=dev)
        tops = []
        for i in range(R):
            mean, std, top = cem_round(
                params, torch.as_tensor(obs0, device=dev), mean, std,
                torch.as_tensor(noise[i], device=dev), disc, K, 2.0, 1.0)
            tops.append(sorted(top.tolist()))
        runs.append((mean, tops))
    if runs[0][1] != runs[1][1]:
        raise AssertionError(f"rllib2: the card's CEM elites part from the "
                             f"CPU's: {runs[0][1]} against {runs[1][1]}")
    err, over = _rl2_hold("MBPETS plan", [runs[0][0]], [runs[1][0]])
    return dict(rounds=R, same_elites=True, max_abs_err=err, over=over)


def _rl2_az_es_bandit(device):
    """AlphaZero's update and one batched leaf evaluation; the ES and ARS
    steps with eps rebuilt on the card from the seeds (bit-equal to the
    CPU worker's); twenty LinUCB and LinTS selects and updates."""
    import numpy as np
    import torch

    from ray_memory_management_tpu_torch.rllib import AlphaZeroConfig
    from ray_memory_management_tpu_torch.rllib import models as rm
    from ray_memory_management_tpu_torch.rllib.alphazero import (
        make_az_update)
    from ray_memory_management_tpu_torch.rllib.ars import make_ars_update
    from ray_memory_management_tpu_torch.rllib.bandit import (
        make_bandit_programs)
    from ray_memory_management_tpu_torch.rllib.es import (
        _perturbation, make_es_update, perturbations)

    cpu = torch.device("cpu")
    rng = np.random.default_rng(15)
    out = {}
    # the net AlphaZeroConfig builds: the config's hidden (64, 64)
    az0 = {"torso_pi": rm.mlp_init(rm.make_generator(17),
                                   [9, *RL_HIDDEN, 9]),
           "torso_v": rm.mlp_init(rm.make_generator(18), [9, *RL_HIDDEN, 1])}

    def az(dev):
        p = rm.trainable(rm.detached_copy(az0), dev)
        upd = make_az_update(rm.make_adam(p, 3e-3), 1e-4)
        return p, lambda b: upd(p, *b)

    def az_batch():
        pi = rng.uniform(size=(128, 9)).astype(np.float32)
        return (rng.integers(-1, 2, (128, 9)).astype(np.float32),
                pi / pi.sum(-1, keepdims=True),
                rng.choice([-1.0, 0.0, 1.0], 128).astype(np.float32))

    out["alphazero"], _ = _rl2_pair(device, "AlphaZero", az,
                                    [az_batch() for _ in range(3)])
    leaves = rng.integers(-1, 2, (32, 9)).astype(np.float32)
    evals = []
    for dev in (device, cpu):
        algo = AlphaZeroConfig().resources(device=str(dev)).build()
        algo.set_weights(rm.params_to_numpy(az0))
        evals.append(algo._evaluate(leaves))
        algo.stop()
    err, over = _rl2_hold("AlphaZero leaf evaluation",
                          [torch.as_tensor(x) for x in evals[0]],
                          [torch.as_tensor(x) for x in evals[1]])
    out["alphazero"]["leaf_eval"] = dict(max_abs_err=err, over=over,
                                         leaves=len(leaves))

    dim = 4 * 32 + 32 + 32 * 2 + 2  # CartPole's MLP (32,) as ES flattens it
    seeds = [int(s) for s in rng.integers(0, 1 << 31, 32)]
    eps_card = perturbations(seeds, dim, device)
    eps_worker = torch.stack([_perturbation(s, dim) for s in seeds])
    if not torch.equal(eps_card.cpu(), eps_worker):
        raise AssertionError("rllib2: eps rebuilt on the card differs from "
                             "the CPU worker's")
    theta = rng.normal(scale=0.3, size=dim).astype(np.float32)
    weights = rng.uniform(-0.5, 0.5, 32).astype(np.float32)
    pos = rng.normal(60, 20, 16).astype(np.float32)
    neg = rng.normal(60, 20, 16).astype(np.float32)
    res = []
    for dev, eps in ((device, eps_card), (cpu, eps_worker)):
        es = make_es_update(0.03, 0.1, 0.005)(
            torch.as_tensor(theta, device=dev), eps,
            torch.as_tensor(weights, device=dev))
        ars = make_ars_update(0.3, 0.5)(
            torch.as_tensor(theta, device=dev), eps[:16],
            torch.as_tensor(pos, device=dev), torch.as_tensor(neg, device=dev),
            float(np.std(np.concatenate([pos, neg]))))
        res.append((es, ars))
    out["es"] = dict(zip(("max_abs_err", "over"),
                         _rl2_hold("ES", [res[0][0]], [res[1][0]])),
                     eps_bit_equal=True, seeds=len(seeds), dim=dim)
    out["ars"] = dict(zip(("max_abs_err", "over"),
                          _rl2_hold("ARS", [res[0][1]], [res[1][1]])))

    K, D = 5, 8
    ctxs = rng.normal(size=(20, D)).astype(np.float32)
    ctxs /= np.linalg.norm(ctxs, axis=1, keepdims=True)
    draws = rng.normal(size=(20, K)).astype(np.float32)
    rewards = rng.normal(size=20).astype(np.float32)
    for mode in ("ucb", "ts"):
        init, select, update = make_bandit_programs(K, D, 1.0, 1.0, mode)
        states = [init(device), init(cpu)]
        for i in range(20):
            arms = [int(select(s, torch.as_tensor(ctxs[i], device=dev),
                               torch.as_tensor(draws[i], device=dev)))
                    for s, dev in zip(states, (device, cpu))]
            if arms[0] != arms[1]:
                raise AssertionError(f"rllib2: bandit {mode} step {i}: "
                                     f"arm {arms[0]} on the card, "
                                     f"{arms[1]} on the CPU")
            for s, dev in zip(states, (device, cpu)):
                update(s, torch.as_tensor(ctxs[i], device=dev), arms[0],
                       float(rewards[i]))
        err, over = _rl2_hold(f"bandit {mode}", states[0], states[1])
        out[f"bandit_{mode}"] = dict(steps=20, max_abs_err=err, over=over)
    return out


def _rl2_learner_parity(device, rmt, tmp):
    """Phase 16a: every new learner's update on the card against the same
    update on the CPU, fp32 with TF32 off."""
    rows = {}
    learners = _rl2_offpolicy_learners()
    rmt.init(num_cpus=2, num_gpus=0)
    try:
        offline, n_rows = _rl2_offline_learners(rmt, tmp)
    finally:
        rmt.shutdown()
    learners.update(offline)
    learners.update(_rl2_multi_learners())
    trees = {}
    for name, (build, batches) in learners.items():
        rows[name], trees[name] = _rl2_pair(device, name, build, batches)
    rows["offline_rows"] = n_rows
    # the plan from the ensembles the model-update parity trained
    rows["mbpets_plan"] = _rl2_plan_parity(device, *trees["mbpets_model"])
    rows.update(_rl2_az_es_bandit(device))
    return rows


def _sac_rule(row) -> bool:
    """TestSAC::test_learns_pendulum's rule on one iteration's row."""
    reward = row["episode_reward_mean"]
    return (reward is not None and reward > -900
            and row["num_updates"] > 1000 and 0 < row["alpha"] < 0.9)


def _mbpets_rule(row, first) -> bool:
    """TestMBPETS's rule on one iteration's row, against the first
    finite reward."""
    return (first is not None and row["model_loss"] < 0.05
            and row["episode_reward_mean"] > first + 100
            and row["episode_reward_mean"] > -560)


def _rl2_sac_learns(device):
    """Phase 16b: SAC at TestSAC::test_learns_pendulum's settings, its
    learner on the card, until the reference rule holds (at most
    RL2_SAC_ITERS iterations)."""
    from ray_memory_management_tpu_torch.rllib import SACConfig

    algo = (SACConfig()
            .environment("Pendulum", env_config={"max_episode_steps": 200})
            .rollouts(num_rollout_workers=0, rollout_fragment_length=200)
            .training(lr=1e-3, train_batch_size=128, learning_starts=500,
                      random_steps=500, updates_per_step=200, tau=0.005)
            .resources(device=str(device))
            .debugging(seed=1)
            .build())
    rows = []
    try:
        if algo.log_alpha.device != device:
            raise AssertionError(f"rllib2: SAC's learner is on "
                                 f"{algo.log_alpha.device}")
        for _ in range(RL2_SAC_ITERS):
            r = algo.train()
            rows.append({k: r.get(k) for k in (
                "episode_reward_mean", "num_updates", "alpha",
                "num_env_steps_sampled", "sample_time_s", "learn_time_s")})
            if _sac_rule(rows[-1]):
                break
        trace_step = _rl2_sac_trace_step(algo)
    finally:
        algo.stop()
    last = rows[-1]
    if not _sac_rule(last):
        raise AssertionError(f"rllib2: SAC on the card missed "
                             f"test_learns_pendulum's rule: {last}")
    learn_s = sum(r["learn_time_s"] for r in rows)
    steps = sum(r["num_env_steps_sampled"] for r in rows)
    return dict(iterations=len(rows), last=last,
                rewards=[r["episode_reward_mean"] for r in rows],
                updates_per_s=last["num_updates"] / learn_s,
                env_steps_per_s=steps / sum(r["sample_time_s"] + r[
                    "learn_time_s"] for r in rows),
                learn_s=learn_s), trace_step


def _rl2_sac_trace_step(algo):
    """One SAC update of the trained learner on a fixed minibatch of its
    replay (what phase 16e traces)."""
    mb = algo.replay.sample(algo.train_batch_size)
    return lambda: algo.learn_on_minibatch(mb)


def _rl2_mbpets_learns(device):
    """Phase 16c: MBPETS at TestMBPETS's settings with its planner and
    ensemble on the card, until the reference rule holds (at most
    TestMBPETS's RL2_MBPETS_ITERS iterations); then the save/restore
    round-trip of the stacked ensemble."""
    import numpy as np

    from ray_memory_management_tpu_torch.rllib import MBPETSConfig
    from ray_memory_management_tpu_torch.rllib.models import tree_leaves

    algo = (MBPETSConfig()
            .environment("Pendulum", env_config={"max_episode_steps": 100})
            .training(lr=1e-3, horizon=25, population=256, cem_iters=5,
                      model_updates_per_iter=100, random_steps=1200)
            .resources(device=str(device))
            .debugging(seed=3)
            .build())
    rows, first = [], None
    t0 = time.perf_counter()
    try:
        for _ in range(RL2_MBPETS_ITERS):
            r = algo.train()
            rows.append(r)
            if first is None and not np.isnan(r["episode_reward_mean"]):
                first = r["episode_reward_mean"]
            if _mbpets_rule(r, first):
                break
        wall = time.perf_counter() - t0
        obs = np.asarray(algo._obs, np.float32)
        trace_step = lambda: algo.plan(obs)  # noqa: E731
        plans = algo.plans_done
        blob = algo.save()
        before = algo.get_weights()
        # the plan's own time, synchronised (one read back a step)
        _sync(device)
        t = time.perf_counter()
        for _ in range(10):
            algo.plan(obs)
        _sync(device)
        plan_ms = (time.perf_counter() - t) / 10 * 1e3
    finally:
        algo.stop()
    last = rows[-1]
    if not _mbpets_rule(last, first):
        raise AssertionError(f"rllib2: MBPETS on the card missed the "
                             f"reference rule: first {first}, last {last}")
    algo2 = (MBPETSConfig()
             .environment("Pendulum", env_config={"max_episode_steps": 100})
             .resources(device=str(device))
             .debugging(seed=3)
             .build())
    try:
        algo2.restore(blob)
        for a, b in zip(tree_leaves(before),
                        tree_leaves(algo2.get_weights())):
            if not np.array_equal(a, b):
                raise AssertionError("rllib2: MBPETS's ensemble did not "
                                     "round-trip save/restore")
    finally:
        algo2.stop()
    return dict(iterations=len(rows), first=first,
                last=last["episode_reward_mean"],
                model_loss=last["model_loss"], plans=plans,
                plan_ms=plan_ms, env_steps_per_s=len(rows) * 200 / wall,
                rewards=[r["episode_reward_mean"] for r in rows]), trace_step


def _rl2_es_learns(device, rmt):
    """Phase 16d: ES with 2 CPU rollout actors at
    test_learns_cartpole_gradient_free's settings, the update on the
    card."""
    from ray_memory_management_tpu_torch.rllib import ESConfig

    rmt.init(num_cpus=4, num_gpus=0)
    try:
        algo = (ESConfig()
                .environment("CartPole",
                             env_config={"max_episode_steps": 200})
                .rollouts(num_rollout_workers=2)
                .training(lr=0.03, sigma=0.1, episodes_per_batch=64)
                .resources(device=str(device))
                .debugging(seed=3)
                .build())
        best, rows = 0.0, []
        t0 = time.perf_counter()
        try:
            if algo.device != device or algo.workers is None:
                raise AssertionError(f"rllib2: ES's learner is on "
                                     f"{algo.device}")
            for _ in range(RL2_ES_ITERS):
                r = algo.train()
                rows.append(r["fitness_mean"])
                best = max(best, r["fitness_mean"])
                if best > 120:
                    break
            steps = r["timesteps_total"]
        finally:
            algo.stop()
        wall = time.perf_counter() - t0
    finally:
        rmt.shutdown()
    if not best > 60:
        raise AssertionError(f"rllib2: ES on the card missed the rule: "
                             f"{rows}")
    return dict(iterations=len(rows), best=best, fitness=rows,
                env_steps_per_s=steps / wall)


def phase_rllib2(device, card):
    """Phase 16: RLlib's second half on the card (see the module
    docstring). The flash kernels' launch counts are zeroed at the start
    and must read 0 at the end: no RLlib path reaches them."""
    import shutil
    import tempfile

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        launch_counts, reset_launch_count)

    t_phase = time.perf_counter()
    reset_launch_count()
    tmp = tempfile.mkdtemp(prefix="rllib2_")
    try:
        parity = _rl2_learner_parity(device, rmt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[rllib2] {card}: (a) learner parity, card against CPU, fp32, "
        f"TF32 off, tolerance {RL_TOL[0]:g} * max|leaf| + {RL_TOL[1]:g}, "
        f"3 updates each; updates/s on the card (each synchronised): "
        + json.dumps(parity, default=str))
    sac, sac_step = _rl2_sac_learns(device)
    log(f"[rllib2] {card}: (b) SAC (test_learns_pendulum's settings), "
        f"learner on {device}: episode_reward_mean {sac['rewards']} "
        f"({sac['iterations']} iterations; rule > -900, num_updates "
        f"{sac['last']['num_updates']} > 1000, 0 < alpha "
        f"{sac['last']['alpha']:.4f} < 0.9); updates_per_s="
        f"{sac['updates_per_s']:.1f} env_steps_per_s="
        f"{sac['env_steps_per_s']:.1f} learn_s={sac['learn_s']:.2f}")
    mb, plan_step = _rl2_mbpets_learns(device)
    log(f"[rllib2] {card}: (c) MBPETS (TestMBPETS's settings), planner and "
        f"ensemble on {device}: episode_reward_mean {mb['rewards']} (rule "
        f"> first {mb['first']:.1f} + 100 and > -560; model_loss "
        f"{mb['model_loss']:.4f} < 0.05); {mb['plans']} plans, "
        f"plan_ms={mb['plan_ms']:.3f} env_steps_per_s="
        f"{mb['env_steps_per_s']:.2f}; ensemble save/restore round-trip "
        f"held")
    es = _rl2_es_learns(device, rmt)
    log(f"[rllib2] {card}: (d) ES, 2 CPU rollout actors, update on "
        f"{device}: fitness_mean {es['fitness']} (best {es['best']:.1f} > "
        f"60); env_steps_per_s={es['env_steps_per_s']:.1f}")
    sac_trace = plan_trace = {}
    if device.type == "cuda":
        sac_trace = _rl_update_trace(sac_step, reps=20)
        plan_trace = _rl_update_trace(plan_step, reps=5)
        log(f"[rllib2] {card}: (e) a SAC update (minibatch 128) traced 20 "
            f"times: {sac_trace['kernels_per_update']:.1f} kernels, device "
            f"{sac_trace['device_ms']:.4f} ms of "
            f"{sac_trace['traced_wall_ms']:.3f} ms wall (idle "
            f"{sac_trace['idle_share']:.3f}); an MBPETS plan traced 5 "
            f"times: {plan_trace['kernels_per_update']:.1f} kernels, device "
            f"{plan_trace['device_ms']:.4f} ms of "
            f"{plan_trace['traced_wall_ms']:.3f} ms wall (idle "
            f"{plan_trace['idle_share']:.3f})")
    launches = launch_counts()
    log(f"[rllib2] (e) flash kernel launches over phase 16: {launches} "
        f"(RLlib's nets reach no kernel)")
    if any(launches.values()):
        raise AssertionError(f"rllib2: flash kernels launched {launches}")
    segs, procs = _leftovers()
    if segs or procs:
        raise AssertionError(f"rllib2: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    rates = " ".join(f"{k}={v['updates_per_s']:.1f}"
                     for k, v in parity.items()
                     if isinstance(v, dict) and "updates_per_s" in v)
    figures = (
        f"[rllib2] {card}: phase_s={phase_s:.1f} updates_per_s_card: "
        f"{rates} sac_iterations={sac['iterations']} sac_updates_per_s="
        f"{sac['updates_per_s']:.1f} sac_env_steps_per_s="
        f"{sac['env_steps_per_s']:.1f} sac_update_kernels="
        f"{sac_trace.get('kernels_per_update')} sac_update_device_ms="
        f"{sac_trace.get('device_ms')} sac_update_wall_ms="
        f"{sac_trace.get('traced_wall_ms')} sac_update_idle="
        f"{sac_trace.get('idle_share')} mbpets_plan_ms={mb['plan_ms']:.3f} "
        f"mbpets_plan_kernels={plan_trace.get('kernels_per_update')} "
        f"mbpets_plan_device_ms={plan_trace.get('device_ms')} "
        f"mbpets_plan_wall_ms={plan_trace.get('traced_wall_ms')} "
        f"mbpets_plan_idle={plan_trace.get('idle_share')} "
        f"mbpets_env_steps_per_s={mb['env_steps_per_s']:.2f} "
        f"es_env_steps_per_s={es['env_steps_per_s']:.1f}")
    log(figures)
    return dict(phase_s=phase_s, parity=parity, sac=sac, mbpets=mb, es=es,
                sac_trace=sac_trace, plan_trace=plan_trace,
                launches=launches, figures=figures)


LONG_BH, LONG_D = 4, 128      # flash_attention_bench's heads and head dim
LONG_SEQS = (4096, 8192)      # its sequence lengths past phase 2's
SERVE_BENCH_VOCAB = 50_304    # gpt2-small's vocabulary
ZERO_COPY_BAR = 10.0          # the device suite's zero-copy bar at 64 MB


def _kernel_cases(device, shapes, where):
    """Each kernel at each (BH, S, D) of ``shapes``, bf16, causal, against
    its plain version by phase 2's rules, every launch wgmma; each timed
    (profiler device time) beside its plain version, SDPA (the forward,
    and the backward of the pair) and its bound. ``where`` opens each log
    line and names the phase in the error. Returns {(BH, S, D): row}."""
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        DKV, DQ, WGMMA, bwd_design_counts, flash_attention_bwd,
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
        fwd_design_counts, reference_attention, reference_delta,
        reference_flash_bwd, reference_flash_dkv, reference_flash_dq,
        reference_lse, reset_launch_count)
    from ray_memory_management_tpu_torch.utils.gpu_bench import (
        flash_bench_inputs)

    one_wgmma = {WGMMA: 1, "simt": 0}
    rows = {}
    for bh, s, d in shapes:
        q, k, v = flash_bench_inputs(bh, s, d, device)
        gen = torch.Generator().manual_seed(1)
        do = torch.randn(bh, s, d, generator=gen).to(
            torch.bfloat16).to(device)
        reset_launch_count()
        o, lse = flash_attention_fwd(q, k, v, causal=True, save_lse=True)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        torch.cuda.synchronize()
        designs = {"fwd": fwd_design_counts(), **bwd_design_counts()}
        design_ok = (designs["fwd"] == one_wgmma and designs[DQ] == one_wgmma
                     and designs[DKV] == one_wgmma)
        ref = reference_attention(q.float(), k.float(), v.float(), True)
        ref_lse = reference_lse(q.float(), k.float(), True)
        tol = TOL["bfloat16"]
        fwd_err = (o.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        fwd_ok = bool(torch.allclose(o.float(), ref, atol=tol, rtol=tol)
                      and torch.allclose(lse, ref_lse, **LSE_TOL))
        del ref, ref_lse
        want = reference_flash_bwd(q.float(), k.float(), v.float(),
                                   o.float(), lse, do.float(), True)
        checks = [bwd_close(g, w, "bfloat16") for g, w in zip(got, want)]
        del want, got
        ok = fwd_ok and design_ok and all(c[2] for c in checks)
        delta = reference_delta(o, do)
        row = dict(BH=bh, S=s, D=d, dtype="bfloat16", causal=True,
                   designs=designs, ok=ok, fwd_max_abs_err=fwd_err,
                   lse_max_abs_err=lse_err,
                   **{f"d{n}": c[0] for n, c in zip("qkv", checks)},
                   **{f"d{n}_over_limit": c[1]
                      for n, c in zip("qkv", checks)})
        if ok:
            row["fwd_ms"] = device_ms(lambda: flash_attention_fwd(
                q, k, v, causal=True, save_lse=True))[0]
            row["dq_ms"] = device_ms(lambda: flash_attention_dq(
                q, k, v, do, lse, delta, True))[0]
            row["dkv_ms"] = device_ms(lambda: flash_attention_dkv(
                q, k, v, do, lse, delta, True))[0]
            row["fwd_plain_ms"] = device_ms(
                lambda: (reference_attention(q, k, v, True),
                         reference_lse(q, k, True)), reps=3)[0]
            row["dq_plain_ms"] = device_ms(lambda: reference_flash_dq(
                q, k, v, do, lse, delta, True), reps=3)[0]
            row["dkv_plain_ms"] = device_ms(lambda: reference_flash_dkv(
                q, k, v, do, lse, delta, True), reps=3)[0]
            shape = (1, bh, s, d)
            row["fwd_library_ms"] = device_ms(
                lambda: F.scaled_dot_product_attention(
                    q.view(shape), k.view(shape), v.view(shape),
                    is_causal=True))[0]
            leaves = [t.view(shape).detach().requires_grad_()
                      for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            row["pair_library_ms"] = device_ms(
                lambda: torch.autograd.grad(out, leaves, do.view(shape),
                                            retain_graph=True))[0]
            del out, leaves
            row["fwd_bound_ms"], row["fwd_bound_by"] = attention_bound(
                bh, s, s, d, True, "bfloat16", 2,
                save_lse=True)[:2]
            for kernel in ("dq", "dkv"):
                row[f"{kernel}_bound_ms"], row[f"{kernel}_bound_by"] = (
                    backward_bound(kernel, bh, s, s, d, True,
                                   "bfloat16", 2)[:2])
        rows[(bh, s, d)] = row
        log(f"{where} kernels at BH={bh} S={s} "
            f"D={d} bf16 causal: designs {designs}; fwd max_abs_err="
            f"{fwd_err:.3e} (tol {tol:g}) lse_err={lse_err:.2e}; backward "
            f"max_abs_err " + " ".join(
                f"d{n}={c[0]:.3e}" for n, c in zip("qkv", checks))
            + " err/limit " + " ".join(f"{c[1]:.3f}" for c in checks)
            + f" {'ok' if ok else 'FAIL'}" + ("; ms: " + " ".join(
                f"{n} {row[f'{n}_ms']:.4f} (plain {row[f'{n}_plain_ms']:.4f},"
                f" bound {row[f'{n}_bound_ms']:.5f} {row[f'{n}_bound_by']})"
                for n in ("fwd", "dq", "dkv"))
                + f"; sdpa fwd {row['fwd_library_ms']:.4f} sdpa bwd pair "
                f"{row['pair_library_ms']:.4f}" if ok else ""))
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()
    bad = [r for r in rows.values() if not r["ok"]]
    if bad:
        raise AssertionError(f"{where} the flash kernels disagree with "
                             f"their plain versions or took another design: "
                             f"{bad}")
    return rows


def _flash_bench(device, card):
    """Phase 17 (a), second half: ``flash_attention_bench`` at its
    defaults with the launch counts zeroed just before and read just
    after (each S: one warm-up and 8 timed steps through the kernels, all
    wgmma; the plain route launches none), beside SDPA in the same loop
    (a yardstick outside the port)."""
    import torch
    import torch.nn.functional as F

    from ray_memory_management_tpu_torch.ops.flash_attention import (
        DKV, DQ, WGMMA, bwd_design_counts, fwd_design_counts,
        launch_counts, reset_launch_count)
    from ray_memory_management_tpu_torch.utils import gpu_bench

    iters = 8
    reset_launch_count()
    bench = gpu_bench.flash_attention_bench(iters=iters)
    launches = launch_counts()
    designs = {"fwd": fwd_design_counts(), **bwd_design_counts()}
    want = len(bench) * (iters + 1)
    if (sorted(bench) != [1024, *LONG_SEQS]
            or any(n != want for n in launches.values())
            or any(d != {WGMMA: want, "simt": 0} for d in designs.values())):
        raise AssertionError(f"harnesses: flash_attention_bench ran "
                             f"{sorted(bench)}, launches {launches}, "
                             f"designs {designs} (want {want} wgmma each)")
    timer = gpu_bench.loop_timer(device)
    for s, row in bench.items():
        q, k, v = gpu_bench.flash_bench_inputs(LONG_BH, s, LONG_D, device)
        shape = (1, LONG_BH, s, LONG_D)
        state = {"q": q, "acc": torch.zeros((), device=device)}

        def sdpa_step():
            leaves = [t.detach().requires_grad_()
                      for t in (state["q"], k, v)]
            o = F.scaled_dot_product_attention(
                *(t.view(shape) for t in leaves), is_causal=True)
            dq, _, dv = torch.autograd.grad(torch.sum(o.float() ** 2),
                                            leaves)
            state["q"] = state["q"] + 1e-6 * dq
            state["acc"] = state["acc"] + torch.sum(dv.float())

        row["sdpa_ms"] = timer(sdpa_step, iters)
        del q, k, v, state
        torch.cuda.empty_cache()
        log(f"[harnesses] {card}: (a) flash_attention_bench S={s} "
            f"BH={LONG_BH} D={LONG_D} bf16 causal, loss sum(o^2) and its "
            f"gradients a step: flash_ms={row['flash_ms']:.4f} "
            f"ref_ms={row['ref_ms']:.4f} speedup={row['speedup']:.2f} "
            f"sdpa_ms={row['sdpa_ms']:.4f} (CUDA events)")
    log(f"[harnesses] (a) the bench's kernel launches {launches}, designs "
        f"{designs}")
    return dict(bench=bench, launches=launches)


def _serving_bench(card):
    """Phase 17 (b): ``llm_serving_bench`` at its defaults (gpt2-small,
    32 requests, Poisson arrivals, both batching modes), its replica a
    ``ServedLLM``: every request gets its budget (the barrier mode the
    deployment's whole budget) of in-vocabulary ids, KV pages back at 0,
    the replica's forward launches > 0 and all wgmma."""
    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.utils import gpu_bench

    max_new = 64
    seen = {}

    def on_mode(mode, handle, budgets, replies):
        c = rmt.get(handle.counters.remote(), timeout=60)
        lens = [len(r) for r in replies]
        want = budgets if mode == "continuous" else [max_new] * len(budgets)
        fwd = c["launches"]["flash_attention_fwd"]
        pages = (c["stats"]["kv"]["pages_in_use"] if mode == "continuous"
                 else 0)
        bad = [t for r in replies for t in r
               if not 0 <= t < SERVE_BENCH_VOCAB]
        seen[mode] = dict(launches=fwd, designs=c["designs"], pages=pages,
                          requests=len(replies), tokens=sum(lens))
        if (lens != want or bad or pages or fwd <= 0
                or c["designs"] != {"wgmma": fwd, "simt": 0}):
            raise AssertionError(
                f"harnesses: llm_serving_bench ({mode}) reply lengths "
                f"{lens} (want {want}), out-of-vocabulary ids {bad[:8]}, "
                f"pages_in_use {pages}, forward launches {fwd} "
                f"{c['designs']}")

    out = gpu_bench.llm_serving_bench(max_new_tokens=max_new,
                                      app_wrapper=_served, on_mode=on_mode)
    log(f"[harnesses] {card}: (b) llm_serving_bench gpt2-small, 32 "
        f"requests of 128 tokens, budgets 64/16, Poisson gaps of 0.05 s: "
        f"decode_tokens_per_s={out['decode_tokens_per_s']:.1f} "
        f"decode_tokens_per_s_barrier="
        f"{out['decode_tokens_per_s_barrier']:.1f} continuous_vs_barrier="
        f"{out['continuous_vs_barrier']:.3f} requests_per_s="
        f"{out['requests_per_s']:.2f} decode_steps="
        f"{out.get('decode_steps')}; replica {seen}")
    return dict(out, replica=seen)


def _serve_device_suites(card):
    """Phase 17 (c) and (d): the serve suite at ``mini=True`` and the
    device suite over 64 MB CUDA tensors."""
    from ray_memory_management_tpu_torch.utils.device_bench import (
        run_device_suite)
    from ray_memory_management_tpu_torch.utils.serve_bench import (
        run_serve_suite)

    serve = run_serve_suite(mini=True)
    if not (serve["paged_slots"] > serve["slab_slots"]
            and serve["paged_slots_ratio"] >= 1.5
            and serve["continuous_tokens_per_s"] > 0
            and serve["cold_start_shipped_s"] > 0
            and serve["n_requests"] > 0):
        raise AssertionError(f"harnesses: the serve suite missed its "
                             f"rules: {serve}")
    log(f"[harnesses] {card}: (c) run_serve_suite(mini=True): "
        f"paged_slots={serve['paged_slots']} slab_slots="
        f"{serve['slab_slots']} ratio={serve['paged_slots_ratio']} "
        f"continuous_vs_barrier={serve['continuous_vs_barrier']} "
        f"open loop at {serve['offered_rps']} rps: p50_ms="
        f"{serve['p50_ms']} p99_ms={serve['p99_ms']} violation_pct="
        f"{serve['slo_violation_pct']} n_requests={serve['n_requests']} "
        f"cold_start_init_s={serve['cold_start_init_s']} "
        f"cold_start_shipped_s={serve['cold_start_shipped_s']} "
        f"tokens_per_s_per_chip={serve['tokens_per_s_per_chip']}")
    dev = run_device_suite(payload_mb=64)
    if not dev["bytes_avoided_mb"] > 0:
        raise AssertionError(f"harnesses: the device suite's zero-copy read "
                             f"avoided no bytes: {dev}")
    log(f"[harnesses] {card}: (d) run_device_suite(payload_mb=64) on CUDA "
        f"tensors: zero_copy_speedup={dev['zero_copy_speedup']} (bar "
        f"{ZERO_COPY_BAR:g}x: "
        f"{'met' if dev['zero_copy_speedup'] >= ZERO_COPY_BAR else 'missed'}"
        f") zero_copy_gbps={dev['zero_copy_gbps']} shm_roundtrip_gbps="
        f"{dev['shm_roundtrip_gbps']} bytes_avoided_mb="
        f"{dev['bytes_avoided_mb']} demotion_gbps={dev['demotion_gbps']} "
        f"ici_gbps={dev['ici_gbps']} host_path_gbps="
        f"{dev['host_path_gbps']} ici_transfers={dev['ici_transfers']} "
        f"sweep {dev['eviction_sweep']}")
    return serve, dev


# (module, function, arguments as the CPU tests give them, the fields that
# must be > 0, the fields printed)
HARNESS_SUITES = (
    ("transfer_bench", "run_transfer_microbench",
     dict(small_pulls=25, payload_mb=16, n_dests=2), ("stripe_requests",),
     ("pool_speedup", "striped_gbps", "naive_source_bytes",
      "chain_max_source_bytes")),
    ("transfer_bench", "run_compression_bench",
     dict(payload_mb=8, n_dests=2, trials=1, overhead_trials=1),
     ("broadcast_effective_gbps",),
     ("codecs_offered", "corpus_ratio", "allreduce_err")),
    ("locality_bench", "run_locality_suite",
     dict(n_nodes=2, n_tasks=4, arg_mb=4, trials=1),
     ("locality_on_tasks_per_s", "locality_off_tasks_per_s"),
     ("locality_speedup", "locality_bytes_avoided_mb",
      "prefetch_overlap_ms")),
    ("tracing_bench", "run_tracing_suite", dict(n_tasks=16, trials=1),
     ("tracing_on_tasks_per_s", "tracing_off_tasks_per_s"),
     ("tracing_overhead_pct",)),
    ("logging_bench", "run_logging_suite", dict(n_tasks=16, trials=1),
     ("logging_on_tasks_per_s", "logging_off_tasks_per_s"),
     ("logging_overhead_pct",)),
    ("profile_bench", "run_profile_suite", dict(n_tasks=16, trials=1),
     ("profile_on_tasks_per_s", "profile_off_tasks_per_s"),
     ("profile_overhead_pct",)),
    ("health_bench", "run_health_suite",
     dict(n_tasks=16, trials=1, sim_nodes=16, n_rules=3),
     ("health_on_tasks_per_s", "store_points"),
     ("health_overhead_pct", "rule_eval_ms")),
    ("train_elastic_bench", "run_elastic_suite",
     dict(n_steps=6, checkpoint_every=2, payload_kb=8, save_trials=3),
     ("steps_per_s_ckpt_off", "steps_per_s_ckpt_async"),
     ("async_blocking_vs_sync_pct", "recovery_s")),
    ("job_plane_bench", "run_job_plane_suite", dict(mini=True),
     ("single_job_tasks_per_s", "churn_jobs"),
     ("isolation_overhead_pct", "churn_leaked_rows",
      "churn_leaked_device_bytes")),
    ("scale_bench", "run_scale_curve",
     dict(node_counts=(1, 2), per_node_cpus=1, n_tasks=100, n_actors=2,
          trials=1), (), ("many_tasks_per_s", "many_actors_per_s")),
    ("pod_bench", "run_pod_curve",
     dict(node_counts=(2, 4), tasks_per_point=80, rows_target=3000,
          hot_max_rows=512, rows_per_agent_chunk=250), (),
     ("tasks_per_s", "dir_p99_us")),
)


def _host_harnesses(card, here):
    """Phase 17 (e): ``rmt-torch microbenchmark --scale 0.05`` as a
    subprocess (each ``BASELINE`` row printed, every rate > 0), then each
    host harness at its CPU test's size, one line of headline fields
    each; the job plane leaks no rows or device bytes."""
    import importlib

    from ray_memory_management_tpu_torch.utils.microbenchmark import (
        BASELINE)

    proc = subprocess.run(
        [sys.executable, "-m", "ray_memory_management_tpu_torch.scripts.cli",
         "microbenchmark", "--scale", "0.05"], cwd=here, capture_output=True,
        text=True, timeout=300)
    rows = dict(ln.split(": ", 1) for ln in proc.stdout.splitlines()
                if ": " in ln and ln.split(": ", 1)[0] in BASELINE)
    rates = {k: float(v.rsplit(" ", 1)[0].replace(",", ""))
             for k, v in rows.items()}
    if (proc.returncode != 0 or list(rates) != list(BASELINE)
            or not all(r > 0 for r in rates.values())):
        raise AssertionError(f"harnesses: rmt-torch microbenchmark exit "
                             f"{proc.returncode}, rows {rows}; stderr "
                             f"{proc.stderr[-2000:]}")
    log(f"[harnesses] {card}: (e) rmt-torch microbenchmark --scale 0.05: "
        + " ".join(f"{k}={v:.1f}" for k, v in rates.items()))
    out = {"microbenchmark": rates}
    for module, fn, kwargs, positive, shown in HARNESS_SUITES:
        mod = importlib.import_module(
            f"ray_memory_management_tpu_torch.utils.{module}")
        t = time.perf_counter()
        res = getattr(mod, fn)(**kwargs)
        secs = time.perf_counter() - t
        bad = [k for k in positive if not res[k] > 0]
        if module == "job_plane_bench":
            bad += [k for k in ("sweep_leaked_rows", "churn_leaked_rows",
                                "churn_leaked_device_bytes") if res[k]]
        if bad:
            raise AssertionError(f"harnesses: {fn} missed {bad}: {res}")
        log(f"[harnesses] {card}: (e) {fn}({kwargs}) in {secs:.1f} s: "
            + " ".join(f"{k}={res[k]}" for k in positive + shown))
        out[fn] = {k: res[k] for k in positive + shown}
    return out


def _kernel_figures(row, kernel):
    """One kernel's figures in a :func:`_kernel_cases` row."""
    err = (row["fwd_max_abs_err"] if kernel == "fwd" else
           row["dq"] if kernel == "dq" else max(row["dk"], row["dv"]))
    return {"max_abs_err": err, "ms": row[f"{kernel}_ms"],
            "plain_ms": row[f"{kernel}_plain_ms"],
            "bound_ms": row[f"{kernel}_bound_ms"],
            "bound_by": row[f"{kernel}_bound_by"],
            "library_ms": row["fwd_library_ms" if kernel == "fwd"
                              else "pair_library_ms"]}


def _long_keys(harnesses, kernel):
    """One kernel's figures at the flash bench's shapes (BH = 4, D =
    128, bf16, causal), keyed by S, for the kernels line."""
    return {f"{key}_s{s}": value
            for s, row in harnesses["long"].items()
            for key, value in _kernel_figures(row, kernel).items()}


def _row_keys(train_rows, kernel):
    """One kernel's figures at the training rows' attention shapes, for
    the kernels line."""
    return {"shapes_train_rows": {
        shape: _kernel_figures(row, kernel)
        for shape, row in train_rows["kernels"].items()}}


def phase_harnesses(device, card):
    """Phase 17: the measurement harnesses on the card (see the module
    docstring)."""
    import torch

    from ray_memory_management_tpu_torch.utils import gpu_bench

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    long_rows = {s: row for (_, s, _), row in _kernel_cases(
        device, [(LONG_BH, s, LONG_D) for s in LONG_SEQS],
        f"[harnesses] {card}: (a)").items()}
    flash = _flash_bench(device, card)
    torch.cuda.empty_cache()
    serving = _serving_bench(card)
    serve_suite, device_suite = _serve_device_suites(card)
    host = _host_harnesses(card, here)
    busbw = gpu_bench.allreduce_busbw()
    if torch.cuda.device_count() == 1 and busbw is not None:
        raise AssertionError(f"harnesses: allreduce_busbw on one card gave "
                             f"{busbw}, not None")
    log(f"[harnesses] {card}: (f) allreduce_busbw() over "
        f"{torch.cuda.device_count()} card(s): {busbw}")
    segs, procs = _leftovers()
    if segs or procs:
        raise AssertionError(f"harnesses: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[harnesses] {card}: phase_s={phase_s:.1f} " + " ".join(
            f"S{s}: fwd_ms={r['fwd_ms']:.4f} dq_ms={r['dq_ms']:.4f} "
            f"dkv_ms={r['dkv_ms']:.4f} sdpa_fwd_ms={r['fwd_library_ms']:.4f}"
            f" sdpa_pair_ms={r['pair_library_ms']:.4f}"
            for s, r in long_rows.items()) + " flash_bench: " + " ".join(
            f"S{s}: flash_ms={r['flash_ms']:.4f} ref_ms={r['ref_ms']:.4f} "
            f"sdpa_ms={r['sdpa_ms']:.4f}"
            for s, r in flash["bench"].items())
        + f" decode_tokens_per_s={serving['decode_tokens_per_s']:.1f} "
        f"continuous_vs_barrier={serving['continuous_vs_barrier']:.3f} "
        f"requests_per_s={serving['requests_per_s']:.2f} "
        f"serve_suite p50_ms={serve_suite['p50_ms']} p99_ms="
        f"{serve_suite['p99_ms']} paged_slots_ratio="
        f"{serve_suite['paged_slots_ratio']} zero_copy_speedup="
        f"{device_suite['zero_copy_speedup']} busbw={busbw}")
    log(figures)
    return dict(phase_s=phase_s, long=long_rows, flash=flash,
                serving=serving, serve_suite=serve_suite,
                device_suite=device_suite, host=host, busbw=busbw,
                figures=figures)


# the JAX package's headline training rows (bench.py): preset, B, S,
# bf16 parameters
TRAIN_ROWS = (("gpt2-small", 16, 1024, False),
              ("gpt2-small", 16, 1024, True),
              ("gpt2-small", 4, 4096, False),
              ("llama-1b", 4, 2048, True))
# the gradient check's depth where attention="ref" keeps too much: it
# holds each layer's S x S probabilities for the backward (fp32 and a
# bf16 copy), 4.8 GB a layer for gpt2-small at B = 4, S = 4096 and 3.2 GB
# for llama-1b at B = 4, S = 2048; the kernels' grid is the same at any
# depth
GRAD_ROW_LAYERS = {("gpt2-small", 4, 4096): 4, ("llama-1b", 4, 2048): 4}


def _row_shapes():
    """{(preset, B, S): (BH, S, D)}: each row's attention shape as the
    kernels see it (kv heads repeated up to the query heads)."""
    from ray_memory_management_tpu_torch.models import gpt

    out = {}
    for preset, batch, seq, _ in TRAIN_ROWS:
        cfg = gpt.PRESETS[preset]
        out[(preset, batch, seq)] = (batch * cfg.n_heads, seq,
                                     cfg.d_model // cfg.n_heads)
    return out


def _ulps_bf16(a, b):
    """Per element, how many bf16 steps lie between two bf16 tensors."""
    import torch

    def ordered(t):  # sign-magnitude bits onto one integer line
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordered(a) - ordered(b)).abs()


def _bf16_adamw_card_vs_cpu(device, preset="gpt2-small", batch=4,
                            seq=1024):
    """``LowPrecisionAdamW`` on the card against the same update on the
    CPU: gpt2-small's bf16 parameters after one step on the card, the
    next step's gradients, then that step on both sides from the same
    parameters, moments and gradients. Every parameter, mu and nu must be
    within one bf16 step of the CPU's; how many differ at all is
    printed."""
    import torch

    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.utils import gpu_bench

    params, opt, data, cfg = gpu_bench.setup_training(
        preset, batch, seq, False, "flash", device, bf16_params=True)
    if not isinstance(opt, gpu_bench.LowPrecisionAdamW):
        raise AssertionError(f"train_rows: bf16 parameters got {opt!r}")
    gpu_bench.train_step(params, opt, data, cfg)
    opt.zero_grad(set_to_none=True)
    gpt.loss_fn(params, data, cfg).backward()
    leaves = list(gpt.param_leaves(params))
    host = [t.detach().cpu().requires_grad_() for t in leaves]
    host_opt = gpu_bench.LowPrecisionAdamW(host, **gpu_bench.ADAMW)
    for h, t in zip(host, leaves):
        h.grad = t.grad.cpu()
        st = opt.state[t]
        host_opt.state[h] = {"step": st["step"],
                             "exp_avg": st["exp_avg"].cpu(),
                             "exp_avg_sq": st["exp_avg_sq"].cpu()}
    opt.step()
    host_opt.step()
    torch.cuda.synchronize()
    worst, differ, total = 0, 0, 0
    for h, t in zip(host, leaves):
        pairs = [(t.detach(), h.detach())] + [
            (opt.state[t][k], host_opt.state[h][k])
            for k in ("exp_avg", "exp_avg_sq")]
        for card_t, cpu_t in pairs:
            if card_t.dtype != torch.bfloat16:
                raise AssertionError(f"train_rows: {card_t.dtype} state")
            ulps = _ulps_bf16(card_t.cpu(), cpu_t)
            worst = max(worst, int(ulps.max()))
            differ += int((ulps > 0).sum())
            total += ulps.numel()
    out = dict(worst_ulps=worst, differ=differ, elements=total,
               step=opt.state[leaves[0]]["step"])
    log(f"[train_rows] LowPrecisionAdamW step {out['step']} on the card vs "
        f"the CPU from the same state and gradients ({preset}, bf16): "
        f"{differ} of {total} elements of params, mu and nu differ, worst "
        f"{worst} bf16 ulps (limit 1)")
    if worst > 1:
        raise AssertionError(f"train_rows: LowPrecisionAdamW on the card is "
                             f"{worst} bf16 ulps off the CPU's update")
    del params, opt, host, host_opt, leaves
    return out


def phase_train_rows(device, card, steps=8):
    """Phase 18: :data:`TRAIN_ROWS` through ``phase_train``, one after
    another; then each row's attention shape through the kernels against
    their plain versions, one step's gradients of each row's model
    against attention="ref" by phase 4's rule, and ``LowPrecisionAdamW``
    on the card against the CPU (see the module docstring)."""
    import torch

    t0 = time.perf_counter()
    rows = {}
    for preset, batch, seq, bf16 in TRAIN_ROWS:
        torch.cuda.empty_cache()
        tag = f"{preset} B={batch} S={seq}" + (" bf16" if bf16 else "")
        rows[tag] = phase_train(device, steps=steps, preset=preset,
                                batch=batch, seq=seq, bf16_params=bf16)
    torch.cuda.empty_cache()
    train_s = time.perf_counter() - t0
    shapes = _row_shapes()
    kernels = {f"BH{bh} S{s} D{d}": row for (bh, s, d), row in
               _kernel_cases(device, sorted(set(shapes.values())),
                             f"[train_rows] {card}:").items()}
    grads = {}
    for (preset, batch, seq) in shapes:
        torch.cuda.empty_cache()
        grads[f"{preset} B={batch} S={seq}"] = phase_grad(
            device, preset=preset, batch=batch, seq=seq,
            n_layers=GRAD_ROW_LAYERS.get((preset, batch, seq)))
    torch.cuda.empty_cache()
    adamw = _bf16_adamw_card_vs_cpu(device)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    figures = (f"[train_rows] {card}: phase_s={phase_s:.1f} rows_s="
               f"{train_s:.1f} " + "; ".join(
                   f"{tag}: step_ms={r['step_ms']:.2f} tokens_per_s="
                   f"{r['tokens_per_s']:.1f} mfu={r['mfu']:.4f} peak_mem_gb="
                   f"{r['peak_mem_gb']:.2f} n_params={r['n_params']} loss "
                   f"{r['losses'][0]:.4f}->{r['losses'][-1]:.4f} launches "
                   f"{r['launches']['flash_attention_fwd']}"
                   for tag, r in rows.items())
               + "; kernels " + " ".join(
                   f"{shape}: fwd {r['fwd_ms']:.4f} dq "
                   f"{r['dq_ms']:.4f} dkv {r['dkv_ms']:.4f} ms (sdpa fwd "
                   f"{r['fwd_library_ms']:.4f} pair "
                   f"{r['pair_library_ms']:.4f})"
                   for shape, r in kernels.items())
               + f"; adamw card vs cpu {adamw['differ']} of "
               f"{adamw['elements']} differ, worst {adamw['worst_ulps']} ulps")
    log(figures)
    return dict(rows=rows, kernels=kernels, grads=grads, adamw=adamw,
                phase_s=phase_s, rows_s=train_s, figures=figures)


NATIVE_PROGRAMS = ("rmt_demo", "rmt_executor_demo", "stress")
NATIVE_WARM = 3               # warm calls after each native path's first
NATIVE_PROMPT = b"abcdef"     # the demo's cpp_transform("abc", "def")


def _native_build(card):
    """Phase 19 (a): the C++ client's programs and the plain stress test
    built from the checkout's sources (``native/build.py``), each timed;
    one stress run must print ``STRESS OK`` with no failure."""
    from ray_memory_management_tpu_torch.native import build

    paths, build_s = {}, {}
    for name in NATIVE_PROGRAMS:
        t0 = time.perf_counter()
        paths[name] = build.program_path(name)
        build_s[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = subprocess.run([paths["stress"]], capture_output=True, text=True,
                         timeout=120)
    stress_s = time.perf_counter() - t0
    log(f"[native] {card}: (a) built {list(NATIVE_PROGRAMS)} in "
        f"{sum(build_s.values()):.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in build_s.items())}) into "
        f"{os.path.dirname(paths['stress'])}; stress rc={run.returncode} in "
        f"{stress_s:.3f} s: {run.stdout.strip()!r} {run.stderr.strip()!r}")
    if (run.returncode != 0 or "STRESS OK" not in run.stdout
            or "failures=0" not in run.stderr):
        raise AssertionError(f"native: the stress test failed: {run.stdout}"
                             f"{run.stderr}")
    return paths, build_s, stress_s


def _native_demo(demo, address):
    """One run of the unchanged ``rmt_demo`` against ``address``: (its
    wall seconds, its RESULT text); it must exit 0 and print every
    line of ``tests/test_torch_cpp_client.py``'s end-to-end case."""
    t0 = time.perf_counter()
    run = subprocess.run([demo, address[0], str(address[1])],
                         capture_output=True, text=True, timeout=180)
    wall = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    need = ("CONNECTED", "GET roundtrip=ok", "DUPGET ok",
            "NAMED registered=yes", "WAIT ready=1 not_ready=0", "DEMO OK")
    if run.returncode != 0 or any(n not in lines for n in need):
        raise AssertionError(f"native: rmt_demo rc={run.returncode}: "
                             f"{run.stdout} {run.stderr}")
    result = [ln for ln in lines if ln.startswith("RESULT ")]
    return wall, result[0][len("RESULT "):] if result else None


def _wait_cpp(rmt, name, timeout=30.0):
    deadline = time.monotonic() + timeout
    while name not in rmt.cpp_functions():
        if time.monotonic() > deadline:
            raise AssertionError(f"native: no C++ executor registered "
                                 f"{name!r} in {timeout} s")
        time.sleep(0.05)


def phase_native(device, card, preset="gpt2-small"):
    """Phase 19: the native tier (see the module docstring). (a) builds
    the C++ programs and runs the stress test; (b) the unchanged
    ``rmt_demo`` calls ``runtime_smoke.cpp_generate`` as the cluster's
    ``cpp_transform`` in a ``num_gpus=1`` worker, and its RESULT must be
    the driver's own ``gpt.generate`` of the same weights and prompt,
    token for token, each call's prefill through the flash forward
    kernel once per layer; (c) ``rmt_executor_demo``'s ``rev`` result
    feeds ``runtime_smoke.flip_on_card`` on the card by ObjectRef."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    import ray_memory_management_tpu_torch as rmt
    from ray_memory_management_tpu_torch.client.server import (
        ClusterServer, register_named_function, unregister_named_function)
    from ray_memory_management_tpu_torch.models import gpt
    from ray_memory_management_tpu_torch.ops.flash_attention import (
        flash_attention, fwd_design, fwd_design_counts, launch_count,
        reference_attention, reset_launch_count)
    from ray_memory_management_tpu_torch.utils import runtime_smoke

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    paths, build_s, stress_s = _native_build(card)
    cfg = dataclasses.replace(gpt.PRESETS[preset], dtype=torch.float32)
    prompt_len = len(NATIVE_PROMPT)

    # the kernel at this path's prefill shape against its plain version
    gen = torch.Generator(device=device).manual_seed(19)
    q, k, v = (torch.randn(cfg.n_heads, prompt_len, cfg.d_model //
                           cfg.n_heads, device=device, generator=gen)
               for _ in range(3))
    reset_launch_count()
    out = flash_attention(q, k, v, causal=True)
    _sync(device)
    kernel_designs = fwd_design_counts()
    err = (out - reference_attention(q, k, v, True)).abs().max().item()
    design = fwd_design(torch.float32, q.shape[-1])
    if on_card and not (err <= TOL["float32"]
                        and kernel_designs[design] == 1):
        raise AssertionError(f"native: flash forward at BH={q.shape[0]} "
                             f"S={prompt_len} fp32 err {err} "
                             f"{kernel_designs}")
    del q, k, v, out

    # the driver's own greedy tokens: the same seed and prompt
    params = gpt.init_params(cfg, torch.Generator(device=device).manual_seed(
        runtime_smoke.CPP_SEED), device)
    reset_launch_count()
    want = runtime_smoke.generate_text(params, cfg, NATIVE_PROMPT).decode()
    driver_launches = launch_count()
    del params
    if on_card:
        torch.cuda.empty_cache()
    lease, uuid = _driver_card(device) if on_card else (None, None)

    tmp = tempfile.mkdtemp(prefix="rmt_native_")  # removed at the end
    gen_log = os.path.join(tmp, "cpp_generate.jsonl")
    os.environ[runtime_smoke.CPP_GENERATE_LOG] = gen_log
    executor = server = None
    try:
        rmt.init(num_cpus=4, num_gpus=1)
        register_named_function("cpp_transform", runtime_smoke.cpp_generate,
                                num_gpus=1)
        server = ClusterServer()
        walls, results = [], []
        for _ in range(1 + NATIVE_WARM):
            wall, result = _native_demo(paths["rmt_demo"], server.address)
            walls.append(wall)
            results.append(result)
        with open(gen_log) as f:
            calls = [json.loads(line) for line in f]

        executor = subprocess.Popen(
            [paths["rmt_executor_demo"], *map(str, server.address)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        _wait_cpp(rmt, "rev")
        flip = rmt.remote(runtime_smoke.flip_on_card).options(num_gpus=1)
        rev = rmt.cpp_function("rev")
        trips, flips = [], []
        for _ in range(1 + NATIVE_WARM):
            t0 = time.perf_counter()
            ref = rev.remote(NATIVE_PROMPT)
            flips.append(rmt.get(
                flip.remote(ref, device=None if on_card else "cpu"),
                timeout=300))
            trips.append(time.perf_counter() - t0)
    finally:
        unregister_named_function("cpp_transform")
        if executor is not None:
            executor.kill()
            executor.communicate(timeout=10)
        if server is not None:
            server.close()
        rmt.shutdown()
        os.environ.pop(runtime_smoke.CPP_GENERATE_LOG, None)
        shutil.rmtree(tmp, ignore_errors=True)
    segs, procs = _leftovers()

    n_layers = cfg.n_layers
    same = all(r == want for r in results)
    launches = [c["launches"] for c in calls]
    per_call_ok = len(calls) == 1 + NATIVE_WARM and all(
        c["launches"] == n_layers and c["designs"][design] == n_layers
        and (not on_card or (c["cuda_visible_devices"] == lease
                             and c["device_uuid"] == uuid))
        for c in calls)
    flips_ok = all(
        f["value"] == NATIVE_PROMPT and f["sum"] == sum(NATIVE_PROMPT)
        and (not on_card or (f["device"].startswith("cuda")
                             and f["cuda_visible_devices"] == lease
                             and f["device_uuid"] == uuid))
        for f in flips)
    warm_ms = float(np.median(walls[1:])) * 1e3
    gen_warm_ms = float(np.median([c["seconds"] for c in calls[1:]])) * 1e3
    trip_warm_ms = float(np.median(trips[1:])) * 1e3
    log(f"[native] {card}: (b) rmt_demo -> cpp_transform = "
        f"runtime_smoke.cpp_generate (num_gpus=1, {preset} fp32, seed "
        f"{runtime_smoke.CPP_SEED}, prompt {NATIVE_PROMPT!r}, "
        f"{runtime_smoke.CPP_NEW_TOKENS} greedy tokens): RESULT "
        f"{results[0]!r}, the driver's gpt.generate {want!r}: "
        f"{'equal' if same else 'DIFFER'} in {len(results)} calls; flash "
        f"forward at BH={cfg.n_heads} S={prompt_len} D="
        f"{cfg.d_model // cfg.n_heads} fp32 err {err:.3g} (tol "
        f"{TOL['float32']}), design {design}; launches per call in the "
        f"worker {launches} {[c['designs'] for c in calls]} (need "
        f"{n_layers}, one per layer), in the driver's generate "
        f"{driver_launches}; worker lease "
        f"{[c['cuda_visible_devices'] for c in calls][:1]} (want {lease!r}),"
        f" its card the driver's="
        f"{all(c['device_uuid'] == uuid for c in calls)}; demo wall first "
        f"{walls[0]:.3f} s (GPU worker start, CUDA init, weights), warm "
        f"{[round(w * 1e3, 1) for w in walls[1:]]} ms (median "
        f"{warm_ms:.1f}); in the worker: generate first "
        f"{calls[0]['seconds'] if calls else float('nan'):.3f} s, warm "
        f"median {gen_warm_ms:.1f} ms")
    log(f"[native] {card}: (c) rmt_executor_demo rev({NATIVE_PROMPT!r}"
        f") -> ObjectRef -> flip_on_card (num_gpus=1): "
        f"{[f['value'] for f in flips][:1]} on {flips[0]['device']} (lease "
        f"{flips[0]['cuda_visible_devices']!r}, its card the driver's="
        f"{flips[0]['device_uuid'] == uuid}), sum {flips[0]['sum']}: "
        f"{'right' if flips_ok else 'WRONG'}; round trip first "
        f"{trips[0] * 1e3:.1f} ms, warm {[round(t * 1e3, 1) for t in trips[1:]]}"
        f" ms (median {trip_warm_ms:.1f})")
    log(f"[native] after rmt.shutdown(): shm segments {segs}, port "
        f"agent/worker/zygote processes {procs}, executor rc "
        f"{executor.returncode}")
    if not same:
        raise AssertionError(f"native: the C++ call's tokens {results} != "
                             f"the driver's {want}")
    if not per_call_ok or (on_card and driver_launches != n_layers):
        raise AssertionError(f"native: cpp_generate calls {calls}, driver "
                             f"launches {driver_launches}, want {n_layers} "
                             f"{design} launches per call on the driver's "
                             f"card")
    if not flips_ok:
        raise AssertionError(f"native: the executor's result through the "
                             f"GPU task gave {flips}")
    if segs or procs or executor.returncode is None:
        raise AssertionError(f"native: left behind shm {segs} and "
                             f"processes {procs}")
    phase_s = time.perf_counter() - t_phase
    figures = (
        f"[native] {card}: phase_s={phase_s:.1f} build_s="
        f"{sum(build_s.values()):.2f} " + " ".join(
            f"build_{k}_s={v:.2f}" for k, v in build_s.items())
        + f" stress_s={stress_s:.3f} cpp_call_first_s={walls[0]:.3f} "
        f"cpp_call_warm_ms={warm_ms:.1f} worker_generate_first_s="
        f"{calls[0]['seconds']:.3f} worker_generate_warm_ms="
        f"{gen_warm_ms:.1f} flash_fwd_launches_per_call={launches} "
        f"executor_roundtrip_first_ms={trips[0] * 1e3:.1f} "
        f"executor_roundtrip_warm_ms={trip_warm_ms:.1f}")
    log(figures)
    return dict(phase_s=phase_s, build_s=build_s, stress_s=stress_s,
                kernel_err=err, demo_walls=walls, calls=calls,
                launches=launches, driver_launches=driver_launches,
                trips=trips, figures=figures)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here,
                                      "ray_memory_management_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[card] {card}")
    kind = torch.cuda.get_device_name(0)
    device = torch.device("cuda", 0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} CUDA_VISIBLE_DEVICES="
        f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}")

    phases_s = {}

    def timed(name, fn, *args):
        # each phase's wall seconds, so that a slower run names its phase
        t = time.perf_counter()
        out = fn(*args)
        phases_s[name] = time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    build_s = timed("build", phase_build)
    rows, main_row, train_fwd = timed("kernels", phase_kernels, device)
    bwd_rows, bwd = timed("backward", phase_backward, device)
    fwd = timed("forward", phase_forward, device)
    grad = timed("grad", phase_grad, device)
    serve = timed("serve", phase_serve, device)
    timed("engine_parity", phase_engine_parity, device)
    train = timed("train", phase_train, device)
    runtime = timed("runtime", phase_runtime, device, serve, card)
    plane = timed("serve_plane", phase_serve_plane, device, serve,
                  runtime["actor"], card)
    multinode = timed("multinode", phase_multinode, device, serve,
                      runtime["actor"], card)
    train_plane = timed("train_plane", phase_train_plane, device, train,
                        card)
    moe = timed("moe", phase_moe, device)
    torch.cuda.empty_cache()
    pipeline = timed("pipeline", phase_pipeline, device)
    torch.cuda.empty_cache()
    vision = timed("vision", phase_vision, device, card)
    torch.cuda.empty_cache()
    data_tune = timed("data_tune", phase_data_tune, device, train,
                      train_plane, card)
    torch.cuda.empty_cache()
    surfaces = timed("surfaces", phase_surfaces, device, card)
    torch.cuda.empty_cache()
    rllib = timed("rllib", phase_rllib, device, card)
    torch.cuda.empty_cache()
    rllib2 = timed("rllib2", phase_rllib2, device, card)
    torch.cuda.empty_cache()
    harnesses = timed("harnesses", phase_harnesses, device, card)
    torch.cuda.empty_cache()
    train_rows = timed("train_rows", phase_train_rows, device, card)
    torch.cuda.empty_cache()
    native = timed("native", phase_native, device, card)
    total_s = time.perf_counter() - t0

    log(json.dumps({"summary": {
        "card": card, "build_s": build_s, "total_s": total_s,
        "phases_s": phases_s,
        "main_shape": {"BH": BH, "S": MAIN_CASE[1], "Skv": MAIN_CASE[2],
                       "D": HEAD_DIM, "dtype": MAIN_CASE[0],
                       "causal": MAIN_CASE[3]},
        "forward_train_shape": train_fwd, "backward_main": bwd,
        "forward": fwd, "grad": grad, "serve": serve, "train": train,
        "runtime": runtime, "serve_plane": plane,
        "multinode": multinode, "train_plane": train_plane, "moe": moe,
        "pipeline": pipeline, "vision": vision, "data_tune": data_tune,
        "surfaces": surfaces, "rllib": rllib, "rllib2": rllib2,
        "harnesses": harnesses, "train_rows": train_rows,
        "native": native}},
        default=str))
    # the runtime's, the serve plane's and the multi-node figures again,
    # where the end of the output keeps them
    log(runtime["figures"])
    log(plane["figures"])
    log(multinode["figures"])
    log(train_plane["figures"])
    log(data_tune["figures"])
    log(surfaces["figures"])
    log(rllib["figures"])
    log(rllib2["figures"])
    log(harnesses["figures"])
    log(train_rows["figures"])
    log(native["figures"])
    log(f"[phases] {card}: total_s={total_s:.1f} " + " ".join(
        f"{k}={v:.1f}" for k, v in phases_s.items()))
    src = "ray_memory_management_tpu_torch/csrc/"
    ref = "ray_memory_management_tpu/ops/flash_attention.py:"
    pair = ("SDPA backward, dq, dk and dv together, on the same inputs")
    flash_bench = harnesses["flash"]
    log(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": src + "flash_attention_fwd.cu",
        "replaces": ref + "74",
        "launches": serve["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        # the design every bf16 launch of both main paths took, and the
        # previous (SIMT) design's time in the same call
        "design": main_row["design"],
        "prev_ms": main_row["prev_ms"],
        "tflops": main_row["tflops"],
        "kernel_event_ms": main_row["kernel_event_ms"],
        "library_event_ms": main_row["library_event_ms"],
        # the training path: its launches, and the lse variant at BH = 96
        "launches_train": train["launches"]["flash_attention_fwd"],
        "max_abs_err_train": train_fwd["max_abs_err"],
        "ms_train": train_fwd["kernel_ms"],
        "plain_ms_train": train_fwd["plain_ms"],
        "bound_ms_train": train_fwd["bound_ms"],
        "bound_by_train": train_fwd["bound_by"],
        "library_ms_train": train_fwd["library_ms"],
        "prev_ms_train": train_fwd["prev_ms"],
        "tflops_train": train_fwd["tflops"],
        "kernel_event_ms_train": train_fwd["kernel_event_ms"],
        "library_event_ms_train": train_fwd["library_event_ms"],
        # the runtime path: launches in the GPU actor's burst (its own
        # process, counts zeroed just before) and in one GPU task
        "launches_actor": runtime["actor"]["launches"],
        "launches_gpu_task": runtime["task"]["launches"],
        # the serve plane: launches in the replica's first burst through
        # handle.remote (its own process, counts zeroed just before)
        "launches_replica": plane["launches"],
        # the multi-node path: launches in one GPU task on the node agent
        # and in the agent-hosted GPU actor's burst (counts zeroed just
        # before, in their own processes)
        "launches_agent_task": multinode["task"]["launches"],
        "launches_agent_actor": multinode["actor"]["launches"],
        # the train plane: launches in the TorchTrainer worker's 8 steps
        # (its own process, counts zeroed just before)
        "launches_trainer": train_plane["launches"]["flash_attention_fwd"],
        # mixtral-tiny (phase 11): its serve burst, its 8 training steps,
        # and the sp = 4 ring's chunk schedule
        "launches_moe_serve": moe["serve"]["launches"],
        "launches_moe_train": moe["train"]["launches"]["flash_attention_fwd"],
        "launches_ring_schedule": moe["ring"]["launches"][
            "flash_attention_fwd"],
        # phase 12a: gpt2-small's GPipe schedule, pp = 4, M = 4
        "launches_pipeline_schedule": pipeline["launches"][
            "flash_attention_fwd"],
        # phase 13 (each in its own process, counts zeroed just before):
        # the Data pool actor's 8 batches, the data-fed trainer's 8 steps,
        # one Tune trial's 4 steps, the two workflows' first steps and
        # the DAG's task
        "launches_data_pool": data_tune["inference"]["launches"],
        "launches_data_trainer": data_tune["training"]["launches"][
            "flash_attention_fwd"],
        "launches_tune_trial": data_tune["tune"]["launches"][
            "flash_attention_fwd"],
        "launches_workflow": sum(data_tune["workflow"]["launches"]),
        "launches_dag": data_tune["dag"]["launches"],
        # phase 14 (each in its own process, counts zeroed just before):
        # the submitted job's GPU prefill, the autoscaled node's task and
        # the tier-affine replica's burst
        "launches_job": surfaces["job"]["launches"],
        "launches_autoscaled_task": surfaces["autoscale"]["launches"],
        "launches_tier_affine_replica": surfaces["replica"]["launches"],
        # phase 15: RLlib's learners, rollouts and bench reach no kernel
        "launches_rllib": rllib["launches"]["flash_attention_fwd"],
        # phase 16: RLlib's second half reaches no kernel either
        "launches_rllib2": rllib2["launches"]["flash_attention_fwd"],
        # phase 17: flash_attention_bench's steps and the serving bench's
        # replica (continuous mode; its own process)
        "launches_flash_bench": flash_bench["launches"][
            "flash_attention_fwd"],
        "launches_serving_bench_replica": harnesses["serving"]["replica"][
            "continuous"]["launches"],
        **_long_keys(harnesses, "fwd"),
        # phase 18: each headline training row's 8 steps
        "launches_train_rows": {
            tag: r["launches"]["flash_attention_fwd"]
            for tag, r in train_rows["rows"].items()},
        **_row_keys(train_rows, "fwd"),
        # phase 19: each C++ driver call's prefill in its GPU worker
        # (counts zeroed just before each generate, read just after)
        "launches_cpp_generate": native["launches"],
    }, {
        "name": "flash_attention_dq",
        "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": ref + "168",
        "launches": train["launches"]["flash_attention_dq"],
        "launches_trainer": train_plane["launches"]["flash_attention_dq"],
        "launches_moe_train": moe["train"]["launches"]["flash_attention_dq"],
        "launches_ring_schedule": moe["ring"]["launches"][
            "flash_attention_dq"],
        "launches_pipeline_schedule": pipeline["launches"][
            "flash_attention_dq"],
        "launches_data_trainer": data_tune["training"]["launches"][
            "flash_attention_dq"],
        "launches_tune_trial": data_tune["tune"]["launches"][
            "flash_attention_dq"],
        "launches_rllib": rllib["launches"]["flash_attention_dq"],
        "launches_rllib2": rllib2["launches"]["flash_attention_dq"],
        "launches_flash_bench": flash_bench["launches"][
            "flash_attention_dq"],
        **_long_keys(harnesses, "dq"),
        # phase 18: each headline training row's 8 steps
        "launches_train_rows": {
            tag: r["launches"]["flash_attention_dq"]
            for tag, r in train_rows["rows"].items()},
        **_row_keys(train_rows, "dq"),
        "max_abs_err": bwd["dq"],
        "ms": bwd["dq_ms"],
        "plain_ms": bwd["dq_plain_ms"],
        "bound_ms": bwd["dq_bound_ms"],
        "bound_by": bwd["dq_bound_by"],
        "library_ms": bwd["pair_library_ms"],
        "library_covers": pair,
        # the design every bf16 launch of the training path took, and the
        # previous (SIMT) design's time in the same call
        "design": bwd["design"],
        "max_err_over_limit": bwd["dq_over_limit"],
        "prev_ms": bwd["dq_prev_ms"],
        "tflops": bwd["dq_tflops"],
        "prev_tflops": bwd["dq_prev_tflops"],
        "kernel_event_ms": bwd["dq_event_ms"],
        "library_event_ms": bwd["pair_library_event_ms"],
    }, {
        "name": "flash_attention_dkv",
        "route": "cuda",
        "source": src + "flash_attention_bwd.cu",
        "replaces": ref + "208",
        "launches": train["launches"]["flash_attention_dkv"],
        "launches_trainer": train_plane["launches"]["flash_attention_dkv"],
        "launches_moe_train": moe["train"]["launches"][
            "flash_attention_dkv"],
        "launches_ring_schedule": moe["ring"]["launches"][
            "flash_attention_dkv"],
        "launches_pipeline_schedule": pipeline["launches"][
            "flash_attention_dkv"],
        "launches_data_trainer": data_tune["training"]["launches"][
            "flash_attention_dkv"],
        "launches_tune_trial": data_tune["tune"]["launches"][
            "flash_attention_dkv"],
        "launches_rllib": rllib["launches"]["flash_attention_dkv"],
        "launches_rllib2": rllib2["launches"]["flash_attention_dkv"],
        "launches_flash_bench": flash_bench["launches"][
            "flash_attention_dkv"],
        **_long_keys(harnesses, "dkv"),
        # phase 18: each headline training row's 8 steps
        "launches_train_rows": {
            tag: r["launches"]["flash_attention_dkv"]
            for tag, r in train_rows["rows"].items()},
        **_row_keys(train_rows, "dkv"),
        "max_abs_err": max(bwd["dk"], bwd["dv"]),
        "ms": bwd["dkv_ms"],
        "plain_ms": bwd["dkv_plain_ms"],
        "bound_ms": bwd["dkv_bound_ms"],
        "bound_by": bwd["dkv_bound_by"],
        "library_ms": bwd["pair_library_ms"],
        "library_covers": pair,
        # the design every bf16 launch of the training path took, and the
        # previous (SIMT) design's time in the same call
        "design": bwd["design"],
        "max_err_over_limit": max(bwd["dk_over_limit"], bwd["dv_over_limit"]),
        "prev_ms": bwd["dkv_prev_ms"],
        "tflops": bwd["dkv_tflops"],
        "prev_tflops": bwd["dkv_prev_tflops"],
        "kernel_event_ms": bwd["dkv_event_ms"],
        "library_event_ms": bwd["pair_library_event_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
