#!/usr/bin/env python3
"""Drive gdmcf_torch's serving (in Python and over HTTP), training and
LightGCN pretraining paths, every denoiser backbone's golden gate and the
legacy and ablation diffusion variants on one NVIDIA GPU and check them.

    python3 chip_smoke.py                  # from the root of a checkout
    python3 chip_smoke.py --profile FILE   # also writes torch.profiler
                                           # tables of 5 lightGCN dispatches,
                                           # 5 flagship train steps, 5
                                           # flagship dispatches and 5 BPR
                                           # steps, and times the SpMM
                                           # kernel at several segment
                                           # lengths
    python3 chip_smoke.py --fresh-seed-gates
                                           # only the LightGCN gate (phase
                                           # 13) at seeds 6-8 and G4 at
                                           # seeds 3-8, verdicts reported
                                           # against the bands of phases 13
                                           # and 16 (reference-only and
                                           # pooled for G4)

Phases (any failure exits non-zero):
  1. build the CUDA kernel from gdmcf_torch/csrc/ and print the card;
  2. SpMM kernel phase: the row-gather kernel against its plain PyTorch
     version on the card, both directions, on tile operands at br 8 and
     128 and on a hybrid operand (tiles and COO remainder), D 64, 50 and
     100, with empty rows and columns, duplicate COO entries, x shorter
     than the grid, and a dense row and column cut into several segments
     (at ROW_SEGMENT and at 64); rtol 1e-4 / atol 1e-5, TF32 off on the
     plain side, whose index_add_ runs deterministically (two runs of each
     plain version bitwise equal); two launches must be bitwise equal;
  3. lightGCN path: the lightGCN backbone with the Amazon-Book recipe
     widths on a seeded power-law graph of the published Amazon-Book size
     (108,822 users x 94,949 items): build_recommender (demo mode; the
     init-time propagation launches the kernel twice per direction) and
     several recommend() calls, checked for range, uniqueness, history
     exclusion and determinism; the host build of N timed in parts
     (normalization, hybrid format, each row operand); the propagated
     tables are held against the plain tile + COO propagation on the card;
  4. lightGCN timings: the kernel, its plain version and torch.sparse.mm
     on the whole hybrid N and on its tiles alone, propagation, request
     p50 (with --profile also the kernel at several segment lengths); the
     recommender is then freed;
  5. AdamW kernel phase: the Triton kernel against adamw_reference on the
     card (0-d, [1024], [1000, 37], 65,535 and 65,537 elements and
     [94,959, 1024]; bfloat16 and float32 moments; wd 0 and 0.01; three
     steps each), within fused_adamw.update_bounds;
  6. flagship training: a Trainer on configs/amazonOneEmbGcn.yaml
     (DNNOneHotEmbeddingGCN at full width) over the same graph as a
     NativeCSR, one train_epoch of 272 steps of 400, checked for finite
     losses, full Lt rows, every parameter moved and one AdamW launch per
     trainable tensor per step; one more step held leaf by leaf against
     adamw_reference on clones; train-step p50/p90, and one AdamW pass
     against its plain version, torch.optim.AdamW(fused=True) and the
     byte bound;
  7. flagship serving: a Recommender over the trained Trainer, the same
     request checks, request p50/p90; then the phase-6 trainer is freed;
  8. the flagship golden gate: generate_synthetic_dataset(seed=0) and the
     Config of benchmarks/parity_run.py with its defaults
     (DNNOneHotEmbeddingGCN, dims [1000], batch 1024, lr 1e-5, steps 5,
     n_user_cap 3000, fidelity), Trainer.fit for 150 epochs at seeds 0, 1
     and 2, written to chiprun_out/torch_flagship.json in parity_run.py's
     JSON shape and judged by the unchanged benchmarks/golden_parity.py
     against docs/parity_data/ref_flagship_s{0,1,2}.json: "parity" must be
     true; AdamW launches 13 per step;
  9. fit at the Amazon-Book width: the graph of phases 3-7 split into
     train/valid/test, configs/amazonOneEmbGcn.yaml with host_dense false,
     1 epoch, eval_every 1 and a checkpoint (max_to_keep 1) in a temporary
     directory: the epoch, each evaluate_streaming split, the checkpoint's
     snapshot, write and size, and restore are timed; the device metric
     sums of a few batches are held against a numpy oracle on the same
     rankings; the save/restore round trip must be bitwise equal in every
     tensor, the Lt ring, the step and the generator; build_recommender
     from the checkpoint must serve the ids of the in-memory trainer;
 10. resume at the golden geometry: fit for 10 epochs (ckpt_every 5)
     against fit for 5 and a resume to 10, losses of epochs 6-10 within
     RESUME_RTOL; then one `python -m gdmcf_torch.cli` subprocess on cuda
     (golden geometry, 5 epochs), checked for metrics.jsonl and the
     "End. Best Epoch" line;
 11. gradients through the SpMM kernel: d/d e0 of (fu w_u).sum() +
     (fi w_i).sum() through propagate_hybrid, 3 layers, on the phase-2
     graph's pattern normalized as LightGCN does, D 64 and 50, against the
     same loss through both plain versions (deterministic index_add_) and
     dense autograd through N, within TOL; two backward passes bitwise
     equal; exactly 3 + 3 launches forward and 3 + 3 backward;
 12. LightGCN pretraining at the Amazon-Book size: the graph of phases 3-9,
     the reference recipe (3 layers, dim 64, batch 1024, lr 5e-3, decay
     1e-4), the hybrid operand (br 8, bc 128), evaluation off, one epoch
     of nnz // 1024 = 2,127 steps: finite losses, the epoch's mean below
     the first step's, every row the batches touched moved, 6 launches per
     direction and one AdamW launch a step, the final tables against the
     plain propagation of the returned initial ones; the epoch, the step
     (synced; host sampling excluded and included), host sampling, the
     backward launches alone and peak memory (with --profile also a table
     of 5 BPR steps);
 13. the LightGCN golden gate: generate_ml100k_csv(400, 600, 40, seed 0)
     and load_ml100k (400 x 584), pretrain at seeds 0-2 for 30 epochs,
     judged with the band rule of benchmarks/lightgcn_parity.py against
     the reference runs of docs/parity_data/lightgcn_parity.json, once on
     the dense operand and once on the hybrid one; both must read
     "parity": true (written to chiprun_out/torch_lightgcn_parity.json);
 14. one `python -m gdmcf_torch.pretrain_cli` subprocess on cuda over the
     golden dataset, 2 epochs, checked for the .npz's four tables;
 15. DNN at OneHotMatrix 0 at the Amazon-Book width: configs/
     amazonOneEmbGcn.yaml with backbone DNN (194,561,875 trainable
     elements in 6 tensors) over the graph of phases 3-12, one train_epoch
     of 272 steps checked for finite losses, every parameter moved and
     exactly 6 AdamW launches a step; one more step held leaf by leaf
     against adamw_reference; train-step p50/p90; a Recommender over the
     trained Trainer with the request checks and request p50/p90; peak
     memory;
 16. the backbone golden gates, 3 seeds each of Trainer.fit judged by the
     unchanged benchmarks/golden_parity.py (every one must read "parity":
     true; AdamW launches one per trainable tensor per step): on the
     phase-8 dataset (lr 1e-5, batch 1024) G1 DNNOneHotEmbedding, G2
     DNNOneHot and G3 DNNOneHotEmbedding with mean_type eps; on
     ROUND3_GATE_SET (1200 x 1000; lr 1e-4, batch 400) G4 DNN at
     OneHotMatrix 0 (against the reference's and the JAX package's runs in
     docs/parity_data/jax_oh0.json, pooled), G5 DNNCat, G6 DNNOneHotEmbedding_conti, G7
     DNNOneHotTransformer (60 epochs, a 5-seed reference band), G8
     DNNOneHotEmbedding at sampling_steps 2 (100 epochs), G9 DNN at
     OneHotMatrix 1 (tail loss against the reference, final R@20/N@20
     against the JAX package's runs in docs/parity_data/jax_oh1.json,
     split per seed, and the verdict of record: each seed's final raw
     scores, dumped as gdmcf_torch.parity_run --dump-scores does, ranked
     by the unchanged benchmarks/oh1_neutral_eval.py's neutral_metrics,
     the tie-neutral test R@20 and N@20 of every seed inside its band of
     the reference's values in docs/parity_data/oh1_neutral_result.json)
     and DNNOneHotEmbeddingGCN_conti; on AMAZON_GATE_SET
     the Amazon recipe (flagship, batch 400, dims [1024], lr 5e-5,
     noise_scale 1e-4, 120 epochs, 1,200 users); each written to
     chiprun_out/torch_<gate>.json;
 17. HTTP serving at the Amazon-Book size, the lightGCN backbone and the
     flagship, each through serve_http.make_server on 127.0.0.1 in this
     process, with a load generator in a process of its own: start-up
     launches the SpMM kernel 2 + 2 times for lightGCN, requests and
     reloads none; 1, 16 and 64 concurrent clients of 1-user
     GET /recommend?k=20, every response equal to rec.recommend for its
     user (HTTP p50/p90/p99, requests/s, dispatches and rows a dispatch);
     64 clients through serve_multiproc with 4 pre-forked fronts; a quiet
     POST /reload (wall time, peak device memory growth against one
     parameter set) and one under 16 clients between two checkpoints
     whose parameters differ (no failed request, params_version + 1, every
     response the old or the new ids, every request after it the ids of a
     fresh Recommender.from_checkpoint; the longest request during it);
     a checkpoint of another geometry gets 409 and the loaded parameters
     keep serving; for lightGCN also `python -m gdmcf_torch.serve_http
     --device cuda` from a checkpoint: launch to the first /healthz, one
     recommend, SIGHUP reloads, SIGTERM exits 0 (chiprun_out/
     torch_http.json);
 18. the legacy and ablation golden gates (DNN at OneHotMatrix 0, dims
     [1000], batch 400, lr 1e-4, noise_scale 0.01, steps 5, 150 epochs,
     n_user_cap 3000, seeds 0-2, on the phase-8 set), judged by the
     unchanged benchmarks/golden_parity.py against docs/parity_data/
     ref_{legacy,ablation}_s*.json pooled with the JAX package's recorded
     runs jax_{legacy,ablation}_head.json (the reference-only verdict is
     printed too): both must read "parity": true; then
     one train_epoch (272 steps) of DNN at OneHotMatrix 0 under each
     variant at the Amazon-Book width, 6 AdamW launches a step, each
     followed by the request checks of a served batch;
 19. (dp, mp) meshes on torch.distributed, each a world of ranks sharing
     the one card over gloo (backend="gloo", device="cuda:0"), launched
     through the env contract of multihost.initialize as subprocesses of
     this script (--mesh-worker): the flagship at the Amazon-Book width on
     meshes (2,1), (1,2) and (2,2), with every leaf's placement printed,
     3 train steps of 400 on the batches of a single-process run on the
     card from the same init, TF32 off on both sides (every step's loss
     within rtol 2e-4; the parameters after the steps within rtol 5e-3 /
     atol 1e-5 but for elements at float32's rounding floor: both runs'
     gradients of it under AdamW's eps 1e-8 at one of the steps, not
     both zero; counted, and at most MESH_EXCUSED_SHARE of any rank's
     tensor),
     (2,2) again at the configured compute_dtype bfloat16 (TF32 on) on
     both sides (losses within rtol 2e-4, at most MESH_TF32_SHARE of any
     rank's tensor past rtol 5e-3 / atol 1e-5), one AdamW
     launch per rank per step for each of the rank's trainable tensors,
     evaluate_streaming of 4,000 users dp-sharded and replicated (both
     within 1.01e-4 of each other and of the single process) and the ids
     of one dp-sharded eval batch of 400 users equal to the single
     process's except swapped pairs scored within 1e-5 (counted),
     allgather_host_vectors bit-exact on float64; a checkpoint written on
     (2,2) restored into a single-process Trainer with every tensor
     bitwise equal to the mesh run's full_tensor() (fingerprints of the
     bits), and the single-process Recommender.from_checkpoint passing
     phase 7's request checks; lightGCN on (1,2): 2 + 2 SpMM launches per
     rank at start-up, the eval ids equal to the single process's except
     swapped pairs whose single-process scores differ by less than 1e-5
     (counted); step p50 and each rank's peak memory, labelled as ranks
     sharing one card (not a scaling number);
 20. bfloat16 parameter storage with float32 masters at the Amazon-Book
     width (configs/amazonOneEmbGcn.yaml on the graph of phases 3-19):
     one train_epoch (272 steps) under bf16_weights ["in_layers/",
     "embedding_item"] (3 tensors in bfloat16) and one under param_dtype
     bfloat16 (all 13) with prefetch_batches 2, each checked for finite
     losses, every tensor moved, the storage dtypes and masters as
     selected (each stored tensor its master's rounding), K1 launches by
     form (fused_adamw and fused_adamw_master, one per tensor per step)
     and the epoch's mean loss within BF16_LOSS_BAND of phase 6's float32
     epoch; epoch time, step p50/p90 and peak memory beside phase 6's;
     then on the param_dtype run: the K1 master form on the 13 tensors
     against adamw_master_reference within master_update_bounds, two
     launches bitwise equal, its time per pass against its plain version
     and the byte bound (no PyTorch call computes it); a checkpoint, its
     round trip bitwise with the masters, build_recommender from it
     serving the in-memory trainer's ids for 256 users, phase 7's request
     checks and request p50; one step under the NT-Xent remat form
     against the softmax form (loss and gradients); the epoch at
     prefetch_batches 0 and 2 (time only); three steps inside
     gdmcf_torch.utils.profiling.trace, the trace written to
     chiprun_out/bf16_trace/trace.json;
 21. serving on a (dp, mp) mesh and the options that read across batch
     rows on a mesh, each a world of ranks sharing the card over gloo,
     against single-process runs on the card: python -m
     gdmcf_torch.serve_http on (2,2) serving the flagship in float32 from
     a checkpoint of fit's layout (the main rank binds the port, the
     others follow): the ids of 512 users equal one process's but for
     swapped pairs scored within 1e-5, 256-user request p50/p90, 1 and 16
     clients of 1-user requests (every answer one process's), a SIGHUP
     reload to a newer checkpoint under 16 clients with 0 failed requests
     and the new checkpoint's ids after it, SIGTERM with every rank
     exiting 0, device memory by rank; lightGCN on (1,2) through
     build_recommender (2 + 2 SpMM launches per rank at start-up, none by
     the dispatches, the ids of 400 users one process's); 3 train steps
     of 400 of the flagship under symmetric_gcn on (2,2) at the
     Amazon-Book width, and of G9's OneHotMatrix 1 DNN and G7's
     transformer on (2,1) at the round-3 set, each under phase 19's
     limits (the transformer's attention key bias, rounding noise in
     exact arithmetic, within 2 lr a step), one AdamW launch per rank per
     step for each of the rank's tensors; step p50 and peak memory by
     rank, not scaling numbers;
 22. recovery from a killed process, each training process `python -m
     gdmcf_torch.cli` as a user runs it, instrumented by this script
     (--fault-cli): (a) the flagship (configs/amazonOneEmbGcn.yaml) at the
     Amazon-Book width on phase 9's splits written as .npy, host_dense
     false, a periodic checkpoint every epoch (about 5.6 GB), SIGKILLed
     once the epoch-1 checkpoint has committed and the epoch-2 .tmp- file
     is growing; resumed with --resume true: the committed step restored,
     every tensor bitwise equal to the file read on the host, one epoch
     with a finite loss and 13 K1 launches a step, then K1 held against
     adamw_reference on the state's 13 tensors (phase 5's bounds); killed
     again between the epoch-2 commit and its sidecar; resumed again, its
     restore held bitwise as before, up to its first step (13 K1
     launches, a finite loss); the write's wall time, what each kill left
     on disk and the relaunch to the first resumed step printed; (b) the
     flagship in float32 at the round-3 set on (2,2), four CLI ranks
     sharing the card over gloo with HEARTBEAT_TIMEOUT_S 30: rank 3
     SIGKILLs itself at the top of epoch 3 once the epoch-2 checkpoint has
     committed, every survivor exits non-zero within the heartbeat timeout
     plus 15 s without an epoch-3 result (they see the dead rank's sockets
     close; the timeout itself, which a rank that stops without dying
     leaves them to, is tested on the CPU in tests/test_torch_fault.py);
     the gang restarts, every rank restores epoch 2 bitwise (its blocks),
     trains epochs 3-4 and reports the same evaluation; (d) debug_nans on
     the flagship at the Amazon-Book width: a NaN planted in
     a parameter raises FloatingPointError at the loss, an infinite
     gradient raises after K1's 13 launches naming the tensor, the flag
     off neither raises; clean step p50 with the flag off and on;
 23. the kernel JSON line, the card's name and power limit, and as the
     last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --mesh-phase     # phase 19 alone, no JSON line
    python3 chip_smoke.py --serve-mesh-phase
                                           # phase 21 alone, no JSON line
    python3 chip_smoke.py --fault-phase    # phase 22 alone, no JSON line
    python3 chip_smoke.py --precision-phase
                                           # phases 5, 6 and 20 alone: the
                                           # float32 epoch, then the
                                           # bfloat16 ones; prints the
                                           # master form's kernel entry,
                                           # no JSON line of all kernels
    python3 chip_smoke.py --mesh-diagnostic
                                           # what phase 19's parameter
                                           # limits rest on: the first
                                           # GEMM's rounding by shape with
                                           # TF32 on and off, and (2,2)
                                           # steps at TF32 and with planted
                                           # faults (a dropped user-table
                                           # gradient, a gradient left out
                                           # of the dp all-reduce), written
                                           # to chiprun_out/
"""

import contextlib
import gc
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

N_USER, N_ITEM, N_EDGES = 108_822, 94_949, 2_200_000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
TOL = dict(rtol=1e-4, atol=1e-5)
FLAGSHIP_PARAMS = 697_972_335  # trainable elements at the Amazon-Book width
ADAMW_FLOP_PER_ELEM = 16       # the update's float32 operations
GOLDEN_SEEDS = (0, 1, 2)
GOLDEN_EPOCHS = 150
# a resumed run replays the uninterrupted one's draws and batches; CUDA
# does not promise bitwise-equal scatter and index backward passes, so the
# losses are held to float32 noise, not to equality
RESUME_RTOL = 1e-4
METRIC_RTOL = dict(rtol=1e-5, atol=1e-6)  # float32 sums of <= 400 users
PRETRAIN_BATCH = 1024
PRETRAIN_STEPS = 2_127         # nnz // batch on the graph of phases 3-9
LGN_GATE_SEEDS = (0, 1, 2)
LGN_GATE_EPOCHS = 30
DNN_PARAMS = 194_561_875       # DNN's trainable elements at that width
# generate_synthetic_dataset's arguments for the 1200 x 1000 set of the
# round-3 backbone gates (docs/parity_data/ref_{oh0,oh1,DNNCat,...}_s*.json
# name it only by its size and data seed 0); avg_degree 15 is settled by
# the loss comparison in PERF.md section 4
ROUND3_GATE_SET = dict(n_user=1200, n_item=1000, avg_degree=15, seed=0)
# the Amazon-shaped set of ref_amazon_s*.json (capped at 1,200 users)
AMAZON_GATE_SET = dict(n_user=4000, n_item=1500, avg_degree=9, seed=7)
ROUND3 = dict(lr=1e-4, batch_size=400, dims=[1000])
# phase 18: parity_run.py's recipe of ref_{legacy,ablation}_s*.json (their
# configs: DNN, OneHotMatrix 0, dims [1000], batch 400, lr 1e-4,
# noise_scale 0.01, steps 5, n_user_cap 3000) on the phase-8 set
VARIANT_RECIPE = dict(backbone="DNN", OneHotMatrix=0, **ROUND3)
# (variant, reference runs, the JAX package's recorded runs and their use):
# judged against both pooled, a choice made after the first card run read
# 2 of 3 tail losses over the reference-only band; the JAX package's own
# CPU seeds 0-5 spread past it too (PERF.md section 6, PR 7). The _head
# files are the runs of the current JAX package (its per-epoch shuffles)
VARIANT_GATES = (
    ("legacy", "ref_legacy_s*.json", ("jax_legacy_head.json", "pooled")),
    ("ablation", "ref_ablation_s*.json",
     ("jax_ablation_head.json", "pooled")),
)
# phase 20: the JAX package's own bf16_weights selection
# (tests/test_bf16_weights.py, docs/BENCH_NOTES.md); the band of a bfloat16
# epoch's mean loss against the float32 epoch of phase 6 at the same seed,
# |mean / float32 mean - 1|, the JAX package's own short-horizon bound
# (tests/test_bf16_weights.py::test_loss_decreases_and_tracks_f32), set
# before the first card run (PERF.md section 6)
BF16_SEL = ("in_layers/", "embedding_item")
BF16_LOSS_BAND = 0.02
PHASE6 = {}   # phase 6's float32 epoch, printed beside phase 20's
# phase 17: concurrent clients -> 1-user requests each client sends
HTTP_CLIENTS = {1: 60, 16: 40, 64: 25}
HTTP_USERS = 512               # distinct users the clients take in turn
HTTP_RELOAD_LOAD_S = 6.0       # the 16-client load around a reload
# --fresh-seed-gates: seeds no earlier run rehearsed
FRESH_LGN_SEEDS = (6, 7, 8)
FRESH_G4_SEEDS = (3, 4, 5, 6, 7, 8)
# phase 16: (label, data set, golden_config overrides, epochs, reference
# runs, the JAX package's recorded runs and what they judge); the labels
# name chiprun_out/torch_<label>.json. "pooled": the band spans the
# reference's and the JAX package's runs together (G4: the reference's
# three seeds span 1.3% of its tail loss while the JAX package's own
# seeds spread wider, see PERF.md section 6, PR 6); "finals": final
# R@20/N@20 against the JAX package alone (G9: the reference's OneHotMatrix
# 1 recall is torch heap-order tie noise, docs/PARITY.md)
BACKBONE_GATES = (
    ("G1_DNNOneHotEmbedding", "golden", dict(backbone="DNNOneHotEmbedding"),
     150, "ref_parity_s*.json", None),
    ("G2_DNNOneHot", "golden", dict(backbone="DNNOneHot"), 150,
     "ref_onehot_s*.json", None),
    ("G3_eps", "golden", dict(backbone="DNNOneHotEmbedding", mean_type="eps"),
     150, "ref_eps_s*.json", None),
    ("G4_oh0", "round3", dict(backbone="DNN", OneHotMatrix=0, **ROUND3), 150,
     "ref_oh0_s*.json", ("jax_oh0.json", "pooled")),
    ("G5_DNNCat", "round3", dict(backbone="DNNCat", **ROUND3), 150,
     "ref_DNNCat_s*.json", None),
    ("G6_DNNOneHotEmbedding_conti", "round3",
     dict(backbone="DNNOneHotEmbedding_conti", **ROUND3), 150,
     "ref_DNNOneHotEmbedding_conti_s*.json", None),
    ("G7_DNNOneHotTransformer", "round3",
     dict(backbone="DNNOneHotTransformer", **ROUND3), 60,
     "ref_DNNOneHotTransformer_s*.json", None),
    ("G8_ss2", "round3",
     dict(backbone="DNNOneHotEmbedding", sampling_steps=2, **ROUND3), 100,
     "ref_ss2_s*.json", None),
    ("G9_oh1", "round3", dict(backbone="DNN", OneHotMatrix=1, **ROUND3), 150,
     "ref_oh1_s*.json", ("jax_oh1.json", "finals")),
    ("amazon", "amazon", dict(batch_size=400, dims=[1024], lr=5e-5,
                              noise_scale=1e-4, n_user_cap=1200), 120,
     "ref_amazon_s*.json", None),
    ("DNNOneHotEmbeddingGCN_conti", "round3",
     dict(backbone="DNNOneHotEmbeddingGCN_conti", **ROUND3), 150,
     "ref_DNNOneHotEmbeddingGCN_conti_s*.json", None),
)


# G9's verdict of record: its final raw scores ranked tie-neutrally
# (docs/PARITY.md, benchmarks/oh1_neutral_eval.py)
OH1_NEUTRAL_GATE = "G9_oh1"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def power_law_graph(seed: int):
    """Seeded power-law user x item graph, vectorized: user degrees are
    10 + a Pareto tail (mean ~20, as in a 10-core dataset); item ids are in
    popularity order with weight (id + 1)^-0.8."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    deg = 10 + np.floor(rng.pareto(1.6, N_USER) * 6.0).astype(np.int64)
    deg = np.minimum(deg, 2_000)
    deg = np.maximum(np.round(deg * (N_EDGES / deg.sum())), 1).astype(np.int64)
    users = np.repeat(np.arange(N_USER, dtype=np.int64), deg)
    cdf = np.cumsum((np.arange(N_ITEM) + 1.0) ** -0.8)
    items = np.searchsorted(cdf, rng.random(len(users)) * cdf[-1])
    items = np.minimum(items, N_ITEM - 1)
    keys = np.unique(users * N_ITEM + items)
    return sp.csr_matrix((np.ones(len(keys), np.float32),
                          (keys // N_ITEM, keys % N_ITEM)),
                         shape=(N_USER, N_ITEM))


@contextlib.contextmanager
def deterministic(torch):
    """Run the plain versions with deterministic ``index_add_``. On CUDA it
    otherwise adds with float atomics in the order the threads arrive, so a
    row of hundreds of nonzeros sums to a different float32 value on each
    run, and a sum that cancels to near zero can land on either side of the
    stated tolerance. ``warn_only``: the tile products' cuBLAS calls have no
    deterministic switch short of CUBLAS_WORKSPACE_CONFIG, and on one stream
    they repeat; the caller checks that two runs are bitwise equal."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def tol_share(y, want) -> float:
    """The largest |y - want| / (atol + rtol |want|) under TOL: below 1
    passes, and the margin shows how near a comparison came to failing."""
    bound = TOL["atol"] + TOL["rtol"] * want.abs()
    return ((y - want).abs() / bound).max().item()


def phase2_matrix(rng):
    """The phase-2 operand: 1000 x 700 with empty rows and columns,
    duplicate COO entries and a dense row and column."""
    import scipy.sparse as sp
    n_rows, n_cols = 1000, 700           # x has fewer rows than the grid
    m = sp.random(n_rows, n_cols, density=0.03, random_state=1,
                  format="coo", dtype=np.float32)
    keep = ~(((m.row >= 256) & (m.row < 384))      # empty rows
             | ((m.col >= 256) & (m.col < 384)))   # empty columns
    r, c, v = m.row[keep], m.col[keep], m.data[keep]
    dup = rng.integers(0, len(r), 64)              # duplicate COO entries
    # a dense row (row 0) and column (column 0): rows of several segments
    # in A and in A^T
    dr = np.setdiff1d(np.arange(n_rows), np.arange(256, 384))
    dc = np.setdiff1d(np.arange(n_cols), np.arange(256, 384))
    m = sp.coo_matrix(
        (np.concatenate([v, v[dup], np.full(len(dr) + len(dc), 0.5,
                                            np.float32)]),
         (np.concatenate([r, r[dup], dr, np.zeros(len(dc), np.int64)]),
          np.concatenate([c, c[dup], np.zeros(len(dr), np.int64), dc]))),
        shape=(n_rows, n_cols))
    return m


def kernel_phase(S, torch):
    """Phase 2: the kernel against its plain version on the card; returns
    the largest |kernel - plain| per direction."""
    rng = np.random.default_rng(0)
    m = phase2_matrix(rng)
    n_rows, n_cols = m.shape
    dense = m.toarray()
    worst = {"spmm_rows_fwd": 0.0, "spmm_rows_t": 0.0}
    worst_share = 0.0
    for label, fmt in (("tiles br=8", S.to_block_sparse(m, br=8, bc=128)),
                       ("tiles br=128", S.to_block_sparse(m, br=128,
                                                          bc=128)),
                       ("hybrid", S.to_hybrid(m, br=8, bc=128,
                                              min_fill=32))):
        assert label != "hybrid" or fmt.rem_vals.numel() > 1_000
        fmt = fmt.to("cuda")
        tpu_plain = (S.hybrid_spmm_reference if label == "hybrid"
                     else S.spmm_reference)
        for transpose in (False, True):
            name = "spmm_rows_t" if transpose else "spmm_rows_fwd"
            full = fmt.t_rows if transpose else fmt.fwd_rows
            for op in (full, full.resegment(64)):
                assert op.n_part > 0, "no row was cut into segments"
                for d in (64, 50, 100):
                    n_x = n_rows if transpose else n_cols
                    x = torch.from_numpy(rng.standard_normal(
                        (n_x, d)).astype(np.float32)).cuda()
                    y = S.spmm_rows(op, x)
                    again = S.spmm_rows(op, x)
                    torch.cuda.synchronize()
                    assert torch.equal(y, again), f"{name}: launches differ"
                    with deterministic(torch):
                        y_plain = S.spmm_rows_reference(op, x)
                        y_tpu = tpu_plain(fmt, x, transpose)
                        assert torch.equal(y_plain, S.spmm_rows_reference(
                            op, x)), f"{name}: plain runs differ"
                        assert torch.equal(y_tpu, tpu_plain(
                            fmt, x, transpose)), f"{name}: plain runs differ"
                    err = (y - y_plain).abs().max().item()
                    share = max(tol_share(y, y_plain), tol_share(y, y_tpu))
                    worst_share = max(worst_share, share)
                    torch.testing.assert_close(y, y_plain, **TOL)
                    torch.testing.assert_close(y, y_tpu, **TOL)
                    want = (dense.T if transpose else dense) @ x.cpu().numpy()
                    n_out = want.shape[0]
                    np.testing.assert_allclose(y[:n_out].cpu().numpy(), want,
                                               rtol=1e-4, atol=1e-4)
                    assert not y[n_out:].any(), "pad rows must be zero"
                    assert not y[256:384].any(), f"{name}: empty row not zero"
                    worst[name] = max(worst[name], err)
                    seg_len = S.ROW_SEGMENT if op is full else 64
                    log(f"kernel {name} {label} segments of {seg_len} "
                        f"({op.n_seg} segments, {op.n_part} in split rows) "
                        f"d={d}: max|kernel-plain| {err:.3e} (rtol "
                        f"{TOL['rtol']}, atol {TOL['atol']}; {share:.3f} of "
                        f"the tolerance); two launches bitwise equal")
    log(f"kernel phase: largest |kernel - plain| / (atol + rtol |plain|) "
        f"over both plain versions {worst_share:.4f}")
    return worst


def bytes_and_flops(a, d, transpose):
    """The earlier tile-format design's bound, kept for history: tiles +
    the x rows its tiles touch + output, read or written once; 2 flops per
    stored nonzero per column."""
    nb = a.n_blocks
    if transpose:
        x_tiles = a.block_rows[:nb].unique().numel()
        x_rows = min(x_tiles * a.br, a.shape[0])
        out_rows = a.shape[1]
    else:
        x_tiles = a.block_cols[:nb].unique().numel()
        x_rows = min(x_tiles * a.bc, a.shape[1])
        out_rows = a.shape[0]
    meta = 4 * (2 * nb + (a.shape[0] // a.br) + (a.shape[1] // a.bc) + 2)
    nbytes = nb * a.br * a.bc * 4 + x_rows * d * 4 + out_rows * d * 4 + meta
    nnz = int((a.blocks[:nb] != 0).sum())
    return nbytes, 2 * nnz * d


def nnz_bytes(op, d):
    """The nonzero-only bound's bytes, each read or written once: each
    nonzero's value and column (8 B; the CSR implies its row), the segment
    arrays the kernel reads (seg_ptr, seg_row and seg_part, and two
    row_seg_ptr entries per row of several segments), the x rows the
    nonzeros touch and the output."""
    x_rows = op.cols.unique().numel()
    split_rows = op.seg_row[op.seg_part >= 0].unique().numel()
    meta = 4 * (op.n_seg + 1) + 8 * op.n_seg + 8 * split_rows
    return op.nnz * 8 + meta + (x_rows + op.n_out) * d * 4


def tpu_kernel_line(root: str, name: str, module: str = "spmm.py") -> str:
    """'file:line' of the Pallas kernel ``name`` in ``ops/<module>`` of the
    JAX package (read as text, never imported; the port's own package is
    skipped)."""
    import glob
    for path in sorted(glob.glob(os.path.join(root, "*", "ops", module))):
        if os.path.relpath(path, root).startswith("gdmcf_torch"):
            continue
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                if line.startswith(f"def {name}("):
                    return f"{os.path.relpath(path, root)}:{no}"
    raise FileNotFoundError(f"no Pallas kernel {name} in {root}")


def jax_source_line(root: str, module: str, needle: str) -> str:
    """'file:line' of the first line holding ``needle`` in ``ops/<module>``
    of the JAX package (read as text, never imported)."""
    import glob
    for path in sorted(glob.glob(os.path.join(root, "*", "ops", module))):
        if os.path.relpath(path, root).startswith("gdmcf_torch"):
            continue
        with open(path) as fh:
            for no, line in enumerate(fh, 1):
                if needle in line:
                    return f"{os.path.relpath(path, root)}:{no}"
    raise FileNotFoundError(f"no {needle!r} in {module} under {root}")


def library_operand(op, torch, n_x):
    """The operand's nonzeros as a torch sparse CSR [n_out, n_x], for
    torch.sparse.mm against x [n_x, D]."""
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(op.row_ptr, op.cols, op.vals,
                                       (op.n_out, n_x))


def flagship_matmul_flops(cfg, n_item: int, batch: int, train: bool):
    """Matmul flops of one flagship forward (``train``: forward and
    backward) at ``batch``, from the shapes: the two towers, NT-Xent's
    [B, B] similarity, the GCN user rows and the cosine head. The backward
    of a tower needs only its weight gradient (the input has none); the
    others need both operand gradients."""
    d = cfg.dims[-1]
    d_item = 3 * d
    towers = 2 * batch * ((n_item + cfg.emb_size)
                          + (2 * n_item + cfg.emb_size)) * d
    gcn = 2 * batch * d_item * 512 * 2 if cfg.gcnLayerNum == 2 else 0
    rest = 2 * batch * d_item * n_item + gcn
    if not train:
        return towers + rest
    return 2 * towers + 3 * (rest + 2 * batch * batch * d)


def check_requests(rec, csr, n_item: int, label: str):
    """Range, uniqueness, history exclusion and determinism of a few
    recommend() calls; returns 300 sampled users."""
    rng = np.random.default_rng(1)
    history = csr.tolil().rows
    users_a = rng.choice(csr.shape[0], 5, replace=False)
    users_b = rng.choice(csr.shape[0], 300, replace=False)  # two dispatches
    items_a, _ = rec.recommend(users_a, k=20)
    items_b, _ = rec.recommend(users_b, k=100)
    items_c, _ = rec.recommend(users_a[:3], k=10, exclude_history=False)
    items_a2, _ = rec.recommend(users_a, k=20)
    for items, users, excl in ((items_a, users_a, True),
                               (items_b, users_b, True),
                               (items_c, users_a[:3], False)):
        assert items.shape[0] == len(users)
        assert ((items >= 0) & (items < n_item)).all(), "ids out of range"
        for row, u in zip(items, users):
            assert len(set(row.tolist())) == len(row), "duplicate ids"
            if excl:
                assert not set(row.tolist()) & set(history[u]), \
                    "a history item was recommended"
    assert np.array_equal(items_a, items_a2), "same users, different ids"
    log(f"{label} requests ok: {items_a.shape} {items_b.shape} "
        f"{items_c.shape}; sample {items_a[0][:10].tolist()}")
    return users_b


def request_times(rec, users, card: str, label: str):
    excl = np.ones(len(users), dtype=bool)
    times = []
    for _ in range(25):
        t0 = time.perf_counter()
        rec.recommend_batch(users, excl)
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.percentile(times, 50))
    log(f"{label} request (256 users, k_max 100): p50 {p50:.3f} ms, p90 "
        f"{float(np.percentile(times, 90)):.3f} ms over {len(times)} "
        f"dispatches [{card}]")
    return excl


def write_profile(path: str, card: str, title: str, fn, torch, mode="w"):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, mode) as fh:
        fh.write(f"{card}\n{title}\n")
        fh.write(prof.key_averages().table(sort_by="cuda_time_total",
                                           row_limit=25))
        fh.write("\n")
    log(f"profile of {title} written to {path}")


def serve_lightgcn(args, root, card, torch, errors):
    """Phases 3-4: the lightGCN serving path and the SpMM timings; returns
    the SpMM kernel entries of the kernels line."""
    import scipy.sparse as sp

    from gdmcf_torch.config import load_config
    from gdmcf_torch.models import lightgcn as lg
    from gdmcf_torch.models.backbones import DNNlightGCN
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.trainer import matmul_precision

    t0 = time.perf_counter()
    csr = power_law_graph(seed=0)
    log(f"graph: {N_USER} x {N_ITEM}, {csr.nnz} edges "
        f"({time.perf_counter() - t0:.1f} s)")
    cfg = load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                      {"backbone": "lightGCN", "device": "cuda"})
    log(f"config: dims {cfg.dims} emb_size {cfg.emb_size} steps {cfg.steps}"
        f" noise_scale {cfg.noise_scale} sampling_steps {cfg.sampling_steps}"
        f" OneHotMatrix {cfg.OneHotMatrix} wire {cfg.wire_format}"
        f" compute_dtype {cfg.compute_dtype} -> TF32 "
        f"{'on' if cfg.compute_dtype == 'bfloat16' else 'off'}")
    assert N_USER * N_ITEM * 4 > lg._DENSE_LIMIT_BYTES

    S.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = build_recommender(cfg, None, csr, N_USER, N_ITEM, warmup=True,
                            serve_batch=256, k_max=100)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    init_launches = dict(S.LAUNCHES)
    log(f"build_recommender: {build_s:.1f} s, launches {init_launches}")
    users_b = check_requests(rec, csr, N_ITEM, "lightGCN")
    launches = dict(S.LAUNCHES)
    assert launches == init_launches, "requests must launch no SpMM kernel"
    assert launches == {"spmm_rows_fwd": 2, "spmm_rows_t": 2}, \
        "start-up must launch the kernel twice per direction"

    # start-up's host build of N, in parts (build_recommender runs the
    # normalization and to_hybrid with these defaults)
    t0 = time.perf_counter()
    n, _ = lg._normalized_sparse_n(csr, 1e-9, False)
    norm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = S.to_hybrid(n)
    hybrid_s = time.perf_counter() - t0
    coo = n.tocoo()
    t0 = time.perf_counter()
    padded = sp.csr_matrix((coo.data, (coo.row, coo.col)),
                           shape=h.tiles.shape)
    csr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    S.row_operand(padded, False)
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    S.row_operand(padded.T.tocsr(), True)
    t_s = time.perf_counter() - t0
    log(f"host build of N: normalization {norm_s:.3f} s, to_hybrid "
        f"{hybrid_s:.3f} s = padded CSR {csr_s:.3f} s + forward operand "
        f"{fwd_s:.3f} s + transpose operand {t_s:.3f} s + tiles and the "
        f"rest {hybrid_s - csr_s - fwd_s - t_s:.3f} s; the rest of "
        f"build_recommender (model init, propagation, warm-up) "
        f"{build_s - norm_s - hybrid_s:.3f} s")
    del coo, padded

    # the propagated tables against the plain tile + COO propagation
    model = rec.trainer.model
    g = torch.Generator("cuda").manual_seed(cfg.random_seed)
    raw_u, raw_i = DNNlightGCN.draw_lgn_table(N_USER, N_ITEM, 64, g, "cuda")
    h = h.to("cuda")
    with matmul_precision(tf32=False):
        pu, pi = lg._layers(
            raw_u, raw_i, 2,
            lambda x: S.hybrid_spmm_reference(h, x, transpose=False),
            lambda x: S.hybrid_spmm_reference(h, x, transpose=True))
    prop_err = max((model.frozen_lgn_user - pu).abs().max().item(),
                   (model.frozen_lgn_item - pi).abs().max().item())
    torch.testing.assert_close(model.frozen_lgn_user, pu, rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(model.frozen_lgn_item, pi, rtol=1e-4,
                               atol=1e-6)
    assert torch.isfinite(model.frozen_lgn_user).all()
    a = h.tiles
    log(f"propagation vs plain tile + COO: max abs err {prop_err:.3e}; "
        f"whole N {h.fwd_rows.nnz} nonzeros = tiles {a.fwd_rows.nnz} in "
        f"{a.n_blocks} tiles ({a.br}x{a.bc}) + COO remainder "
        f"{h.rem_vals.numel()}; segments of {S.ROW_SEGMENT}: forward "
        f"{h.fwd_rows.n_seg} ({h.fwd_rows.n_part} in split rows), "
        f"transpose {h.t_rows.n_seg} ({h.t_rows.n_part} in split rows); "
        f"longest row {int((h.fwd_rows.row_ptr[1:] - h.fwd_rows.row_ptr[:-1]).max())}"
        f", longest column "
        f"{int((h.t_rows.row_ptr[1:] - h.t_rows.row_ptr[:-1]).max())}")

    # 4. timings: operand (a) the whole hybrid N, (b) its tiles alone
    prop_ms = cuda_ms(lambda: lg.propagate_hybrid(raw_u, raw_i, h, 2),
                      iters=5, warmup=1)
    log(f"propagation (2 layers x 2 directions, one launch per product): "
        f"{prop_ms:.3f} ms [{card}]")
    kernels = []
    for name, transpose, x in (("spmm_rows_fwd", False, raw_i),
                               ("spmm_rows_t", True, raw_u)):
        d = x.shape[1]
        res = {}
        for label, op, call in (
                ("hybrid N", h.t_rows if transpose else h.fwd_rows,
                 lambda: S.hybrid_spmm(h, x, transpose)),
                ("tiles only", a.t_rows if transpose else a.fwd_rows,
                 lambda: S.spmm(a, x, transpose))):
            ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: S.spmm_rows_reference(op, x),
                               iters=5, warmup=1)
            lib = library_operand(op, torch, x.shape[0])
            torch.testing.assert_close(torch.sparse.mm(lib, x), call(),
                                       **TOL)
            lib_ms = cuda_ms(lambda: torch.sparse.mm(lib, x))
            bound_bytes = nnz_bytes(op, d) / HBM_BYTES_PER_S * 1e3
            bound_ops = 2 * op.nnz * d / F32_FLOP_PER_S * 1e3
            res[label] = {
                "nnz": op.nnz, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": ("bytes" if bound_bytes >= bound_ops
                             else "operations"),
                "library_ms": lib_ms}
            log(f"{name} on {label} ({op.nnz} nonzeros): {ms:.4f} ms/launch, "
                f"plain {plain_ms:.4f} ms, torch.sparse.mm {lib_ms:.4f} ms, "
                f"nonzero-only bound {res[label]['bound_ms']:.4f} ms "
                f"({res[label]['bound_by']}), gathers "
                f"{op.nnz * d * 4 / ms / 1e9:.1f} TB/s of x rows [{card}]")
        nbytes, flops = bytes_and_flops(a, d, transpose)
        log(f"{name}: the earlier design's tile-format bound on the tiles "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes} B, {flops} "
            f"flop)")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "gdmcf_torch/csrc/spmm.cu",
            # the TPU takes K2 for both directions at this size (x is over
            # its 6 MiB VMEM budget); K3/K4 are the same products, and the
            # COO remainder pass is folded in
            "replaces": tpu_kernel_line(root, "_spmm_kernel"),
            "launches": launches[name],
            "max_abs_err": errors[name],
            **{k: v for k, v in res["hybrid N"].items() if k != "nnz"},
            "operand": f"hybrid N, {res['hybrid N']['nnz']} nonzeros",
            "tiles_only": res["tiles only"],
        })

    if args.profile:
        # ROW_SEGMENT: the kernel on the whole N at several segment lengths
        for seg_len in (32, 64, 128, 256, 512, 1024, 4096, 1 << 20):
            ops = [(h.fwd_rows.resegment(seg_len), raw_i),
                   (h.t_rows.resegment(seg_len), raw_u)]
            times = [cuda_ms(lambda: S.spmm_rows(op, x)) for op, x in ops]
            log(f"seg_len {seg_len}: spmm_rows_fwd {times[0]:.4f} ms "
                f"({ops[0][0].n_seg} segments), spmm_rows_t "
                f"{times[1]:.4f} ms ({ops[1][0].n_seg} segments) [{card}]")
            del ops

    users = users_b[:256]
    excl = request_times(rec, users, card, "lightGCN")
    if args.profile:
        write_profile(args.profile, card, "5 lightGCN dispatches of 256 users",
                      lambda: [rec.recommend_batch(users, excl)
                               for _ in range(5)], torch)
    return kernels, csr


def leaf_errors(got, want, bounds):
    """(max |got - want| over p, mu, nu; count over their bounds)."""
    err, over = 0.0, 0
    for g, w, b in zip(got, want, bounds):
        d = (g.float() - w.float()).abs()
        err = max(err, d.max().item())
        over += int((d > b).sum())
    return err, over


def adamw_phase(FA, torch):
    """Phase 5: the Triton kernel against adamw_reference, three steps
    from the same inputs each, within update_bounds."""
    gen = torch.Generator("cuda").manual_seed(0)
    worst = 0.0
    for shape in ((), (1024,), (1000, 37), (65_535,), (65_537,),
                  (94_959, 1024)):
        for mdt in (torch.bfloat16, torch.float32):
            for wd in (0.0, 0.01):
                p = torch.randn(shape, generator=gen, device="cuda")
                mu = torch.zeros(shape, dtype=mdt, device="cuda")
                nu = torch.zeros(shape, dtype=mdt, device="cuda")
                count = torch.zeros((), dtype=torch.int32, device="cuda")
                err, over, differ = 0.0, 0, 0
                for _ in range(3):
                    g = 0.1 * torch.randn(shape, generator=gen,
                                          device="cuda")
                    count = count + 1
                    c = FA.step_scalars(count, 1e-3)
                    want = FA.adamw_reference(p, g, mu, nu, c, wd=wd)
                    bounds = FA.update_bounds(p, g, mu, nu, c, wd=wd)
                    FA.adamw_update_(p, g, mu, nu, c, wd=wd)
                    torch.cuda.synchronize()
                    e, o = leaf_errors((p, mu, nu), want, bounds)
                    err, over = max(err, e), over + o
                    differ += int((mu != want[1]).sum()
                                  + (nu != want[2]).sum())
                    # continue from the plain state, so steps 2 and 3
                    # start from the same inputs again
                    p, mu, nu = want
                log(f"adamw {tuple(shape)} {str(mdt)[6:]} wd={wd}: "
                    f"max|kernel-plain| {err:.3e}, {over} over "
                    f"update_bounds, moments differing {differ} of "
                    f"{6 * max(p.numel(), 1)}")
                assert over == 0, "the AdamW kernel is over its tolerance"
                worst = max(worst, err)
    return worst


def train_stream(dataset, batch_size, seed=1):
    """Packed training batches of ``dataset``, epoch after epoch."""
    from gdmcf_torch.data.loader import epoch_batches
    while True:
        yield from epoch_batches(dataset, batch_size,
                                 np.random.default_rng(seed), packed=True)
        seed += 1


def checked_step(trainer, state, x, idx, torch, label):
    """One more train step, its AdamW update held leaf by leaf against
    adamw_reference from clones taken before it; returns the largest error
    and (the clones of p, mu and nu, the grads, the count before)."""
    from gdmcf_torch.ops import fused_adamw as FA
    cfg = trainer.cfg
    loss, grads, new_lt = trainer.loss_and_grads(
        state, torch.from_numpy(x), torch.from_numpy(idx))
    opt = state.opt_state
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    mu0 = {k: m.clone() for k, m in opt.mu.items()}
    nu0 = {k: m.clone() for k, m in opt.nu.items()}
    count0 = opt.count.clone()
    c = FA.step_scalars(count0 + 1, cfg.lr)
    trainer.apply_grads(state, grads, new_lt)
    torch.cuda.synchronize()
    step_err, over = 0.0, 0
    for k, p in state.params.items():
        args_k = (p0[k], grads[k], mu0[k], nu0[k], c)
        want = FA.adamw_reference(*args_k, wd=cfg.weight_decay)
        bounds = FA.update_bounds(*args_k, wd=cfg.weight_decay)
        e, o = leaf_errors((p, state.opt_state.mu[k], state.opt_state.nu[k]),
                           want, bounds)
        step_err, over = max(step_err, e), over + o
        del want, bounds
    log(f"{label} step {state.step}: loss {loss.item():.6e}; AdamW kernel "
        f"vs plain over all {len(p0)} tensors: max abs err {step_err:.3e}, "
        f"{over} over update_bounds")
    assert over == 0 and bool(torch.isfinite(loss))
    return step_err, (p0, mu0, nu0, grads, count0)


def step_times(trainer, state, batches, torch):
    """Train-step p50 and p90 (ms) over 20 steps after 5 warm-up ones;
    batches are assembled first, so a step's time includes the
    host->device copy of the packed batch and the unpack."""
    pre = [next(batches) for _ in range(25)]
    times = []
    for x, idx in pre:
        xt, it = torch.from_numpy(x), torch.from_numpy(idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, xt, it)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[5:]
    return float(np.percentile(times, 50)), float(np.percentile(times, 90))


def flagship_train(args, root, card, torch, csr, worst):
    """Phase 6: one epoch of the flagship at full width, the AdamW check
    on a further step, and the timings. Returns (trainer, kernel entry)."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.train.trainer import Trainer

    cfg = load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                      {"device": "cuda"})
    t0 = time.perf_counter()
    trainer = Trainer(cfg, N_USER, N_ITEM)
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    n_leaves = len(state.params)
    log(f"flagship {cfg.backbone}: {n_params} trainable elements in "
        f"{n_leaves} tensors, moments {cfg.opt_moment_dtype}, batch "
        f"{cfg.batch_size}, lr {cfg.lr}, steps {cfg.steps}, noise_scale "
        f"{cfg.noise_scale}, TF32 {'on' if trainer.tf32 else 'off'} "
        f"(init {time.perf_counter() - t0:.1f} s)")
    assert n_params == FLAGSHIP_PARAMS, n_params
    dataset = NativeCSR.from_scipy(csr)
    before = {k: p.detach().clone() for k, p in state.params.items()}

    FA.reset_launch_counts()
    S.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, total = trainer.train_epoch(state, dataset,
                                       np.random.default_rng(0))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = dict(FA.LAUNCHES)
    steps = N_USER // cfg.batch_size
    log(f"train_epoch: {state.step} steps in {epoch_s:.2f} s, loss sum "
        f"{total:.6e}, launches {launches}, SpMM launches {dict(S.LAUNCHES)}")
    assert state.step == steps == 272
    assert np.isfinite(total), "a train-step loss is not finite"
    assert launches["fused_adamw"] == n_leaves * steps
    assert bool((state.lt.count == cfg.history_num_per_term).all()), \
        "an Lt row is not full"
    PHASE6.update(epoch_s=epoch_s, mean_loss=total / steps,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    for k, p in state.params.items():
        assert bool((p.detach() != before[k]).any()), f"{k} did not move"
    del before

    # one more step, its update held leaf by leaf against the plain version
    batches = train_stream(dataset, cfg.batch_size)
    step_err, (p0, mu0, nu0, grads, count0) = checked_step(
        trainer, state, *next(batches), torch, "flagship")
    worst = max(worst, step_err)

    p50, p90 = step_times(trainer, state, batches, torch)
    PHASE6.update(p50=p50, p90=p90)
    log(f"flagship train step (batch {cfg.batch_size}): p50 {p50:.3f} ms, "
        f"p90 {p90:.3f} ms over 20 steps, "
        f"{cfg.batch_size / p50 * 1e3:.1f} examples/s; matmul work "
        f"{flagship_matmul_flops(cfg, N_ITEM, cfg.batch_size, True):.4e} "
        f"flop per step from shapes [{card}]")

    # one AdamW pass over every trainable tensor, on the clones
    st0 = FA.FusedAdamWState(count=count0, mu=mu0, nu=nu0)
    pass_ms = cuda_ms(lambda: FA.fused_adamw_apply(p0, grads, st0,
                                                   lr=cfg.lr), iters=10,
                      warmup=2)

    def plain_pass():
        cc = FA.step_scalars(st0.count + 1, cfg.lr)
        for k in p0:
            FA.adamw_reference(p0[k], grads[k], mu0[k], nu0[k], cc)
    plain_ms = cuda_ms(plain_pass, iters=3, warmup=1)
    lib_params = [torch.nn.Parameter(p0[k]) for k in p0]
    for lp, k in zip(lib_params, p0):
        lp.grad = grads[k]
    lib_opt = torch.optim.AdamW(lib_params, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay,
                                fused=True)
    lib_ms = cuda_ms(lib_opt.step, iters=10, warmup=2)
    del lib_opt, lib_params
    mb = 2 if cfg.opt_moment_dtype == "bfloat16" else 4
    nbytes = (12 + 4 * mb) * n_params
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ADAMW_FLOP_PER_ELEM * n_params / F32_FLOP_PER_S * 1e3
    log(f"fused_adamw: {pass_ms:.4f} ms per pass of {n_leaves} launches "
        f"({pass_ms / n_leaves:.4f} ms per launch), plain {plain_ms:.4f} ms, "
        f"torch.optim.AdamW(fused=True, float32 moments, 28 B/element) "
        f"{lib_ms:.4f} ms, byte bound {bound_bytes:.4f} ms ({nbytes} B at "
        f"{12 + 4 * mb} B/element), operation bound {bound_ops:.4f} ms "
        f"[{card}]")
    entry = {
        "name": "fused_adamw", "route": "triton",
        "source": "gdmcf_torch/ops/fused_adamw.py",
        "replaces": tpu_kernel_line(root, "_adamw_kernel", "fused_adamw.py"),
        "launches": launches["fused_adamw"],
        "max_abs_err": worst,
        "ms": pass_ms, "ms_per_launch": pass_ms / n_leaves,
        "launches_per_pass": n_leaves, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": lib_ms,
    }
    del p0, mu0, nu0, st0, grads
    gc.collect()
    torch.cuda.empty_cache()

    if args.profile:
        prof_batches = [next(batches) for _ in range(5)]
        write_profile(
            args.profile, card, f"5 flagship train steps of "
            f"{cfg.batch_size}",
            lambda: [trainer.train_step(state, torch.from_numpy(x),
                                        torch.from_numpy(i))
                     for x, i in prof_batches], torch, mode="a")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB")
    return trainer, entry


def golden_config(seed: int, epochs: int = GOLDEN_EPOCHS, **kw):
    """The Config of benchmarks/parity_run.py at that script's defaults
    (the recipe the ref_flagship_s* bands were made with), on cuda."""
    from gdmcf_torch.config import Config
    base = dict(
        backbone="DNNOneHotEmbeddingGCN", dims=[1000], emb_size=10, lr=1e-5,
        weight_decay=0.0, batch_size=1024, steps=5,
        noise_schedule="linear-var", noise_scale=0.01, noise_min=0.001,
        noise_max=0.01, sampling_steps=0, mean_type="x0", reweight=True,
        OneHotMatrix=2, epochs=epochs, eval_every=5,
        diffusion_variant="discrete", n_user_cap=3000, fidelity=True,
        random_seed=seed, debug=True, train_steps_per_call=1,
        device="cuda")
    base.update(kw)
    return Config(**base)


class Collector:
    """metric_logger for Trainer.fit, as in benchmarks/parity_run.py:
    per-epoch train losses and the evaluations."""

    def __init__(self):
        self.losses = []
        self.evals = {}

    def metrics(self, epoch, **kw):
        if "train_loss" in kw:
            self.losses.append(round(float(kw["train_loss"]), 6))

    def eval_results(self, epoch, split, topn, results):
        self.evals.setdefault(epoch, {})[split] = [
            [float(v) for v in group] for group in results]


def golden_parity(root, ours, refs):
    """The verdict of the unchanged benchmarks/golden_parity.py."""
    judge = subprocess.run(
        [sys.executable, os.path.join(root, "benchmarks", "golden_parity.py"),
         "--ref", *refs, "--ours", ours],
        capture_output=True, text=True, check=True, timeout=120)
    return json.loads(judge.stdout)


def parity_refs(root, pattern):
    refs = sorted(glob.glob(os.path.join(root, "docs", "parity_data",
                                         pattern)))
    assert len(refs) >= 3, (pattern, refs)
    return refs


GATE_WORKERS = 3   # a gate's seeds train side by side, a process each
_GATE_POOL = []


def gate_pool():
    """The processes that train the gates' seeds: spawned at the first
    gate, kept for the run (``close_gate_pool`` ends them)."""
    if not _GATE_POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _GATE_POOL.append(ProcessPoolExecutor(
            GATE_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _GATE_POOL[0]


def close_gate_pool():
    while _GATE_POOL:
        _GATE_POOL.pop().shutdown()


def gate_seed(card, label, data_dir, epochs, cfg_kw, seed, dump_dir):
    """One seed of a gate, in a process of ``gate_pool``: ``epochs`` of
    Trainer.fit at golden_config(seed, epochs, **cfg_kw), every step
    launching K1 once per trainable tensor. Returns the run in
    parity_run.py's JSON shape, the K1 launches, the log line and fit's
    metric lines."""
    import io

    import torch

    from gdmcf_torch.data.loader import data_load_dir
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.parity_run import final_scores
    from gdmcf_torch.train.trainer import Trainer

    train, valid, test, n_user, n_item = data_load_dir(data_dir)
    cfg = golden_config(seed, epochs, **cfg_kw)
    n_rows = min(n_user, cfg.n_user_cap)
    trainer = Trainer(cfg, n_rows, n_item)
    col = Collector()
    FA.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_lines = io.StringIO()
    with contextlib.redirect_stdout(fit_lines):
        state, best = trainer.fit(train, valid, test, log=print,
                                  metric_logger=col)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n_leaves = len(state.params)
    got = FA.LAUNCHES["fused_adamw"]
    assert state.step == epochs * (n_rows // cfg.batch_size), state.step
    assert got == n_leaves * state.step, (got, n_leaves, state.step)
    assert len(col.losses) == epochs
    assert all(np.isfinite(col.losses)), f"a {label} loss is not finite"
    last = col.evals[max(col.evals)]["test"]
    tail = float(np.mean(col.losses[-epochs // 4:]))
    if dump_dir is not None:
        np.save(os.path.join(dump_dir, f"{label}.s{seed}.npy"),
                final_scores(trainer, train, n_rows))
    line = (f"{label} seed {seed}: {cfg.backbone} OneHotMatrix "
            f"{cfg.OneHotMatrix}, {n_rows} x {n_item}, {epochs} epochs, "
            f"{state.step} steps in {elapsed:.2f} s ({elapsed / epochs * 1e3:.1f}"
            f" ms per epoch with the evaluations, {GATE_WORKERS} seeds side "
            f"by side); final test R@20 {last[1][1]} N@20 {last[2][1]}, tail "
            f"loss {tail:.4f}; fused_adamw launches {got} = {n_leaves} x "
            f"{state.step} steps [{card}]")
    run = {"seed": seed, "losses": col.losses,
           "evals": [{"epoch": e, **ev} for e, ev in sorted(col.evals.items())],
           "best_test": ([[float(v) for v in g] for g in best] if best
                         else None),
           "elapsed_s": round(elapsed, 1)}
    backbone = cfg.backbone
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return run, got, line, fit_lines.getvalue(), backbone


def run_gate(root, card, label, data_dir, epochs, cfg_kw,
             seeds=GOLDEN_SEEDS, dump_dir=None):
    """``seeds`` x ``epochs`` of Trainer.fit at golden_config(seed,
    epochs, **cfg_kw) on the dataset in ``data_dir``, the seeds side by
    side in ``gate_pool`` (``gate_seed``), written to
    chiprun_out/torch_<label>.json in parity_run.py's JSON shape (fit's
    metric lines to torch_<label>_fit.log, seed after seed). ``dump_dir``:
    each seed's final raw score matrix (``parity_run.final_scores``, the
    ``--dump-scores`` protocol) goes to ``dump_dir/<label>.s<seed>.npy``.
    Returns (the JSON's path, the K1 launches)."""
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    pool = gate_pool()
    futures = [pool.submit(gate_seed, card, label, data_dir, epochs, cfg_kw,
                           seed, dump_dir) for seed in seeds]
    runs, launches = [], 0
    with open(os.path.join(out_dir, f"torch_{label}_fit.log"), "w") as fh:
        for f in futures:
            run, got, line, fit_lines, backbone = f.result()
            fh.write(fit_lines)
            log(line)
            runs.append(run)
            launches += got
    ours = os.path.join(out_dir, f"torch_{label}.json")
    with open(ours, "w") as fh:
        json.dump({"config": dict(cfg_kw, backbone=backbone,
                                  epochs=epochs,
                                  seeds=list(seeds), device=card),
                   "runs": runs}, fh)
    return ours, launches


def golden_phase(root, card, data_dir):
    """Phase 8: 3 seeds x 150 epochs of the flagship recipe through
    Trainer.fit, judged by benchmarks/golden_parity.py."""
    from gdmcf_torch.data.loader import data_load_dir

    train, valid, test, n_user, n_item = data_load_dir(data_dir)
    log(f"golden data: generate_synthetic_dataset(seed=0): {n_user} users x "
        f"{n_item} items, {train.nnz} train / {valid.nnz} valid / "
        f"{test.nnz} test edges; n_user_cap 3000")
    ours, launches = run_gate(root, card, "flagship", data_dir,
                              GOLDEN_EPOCHS, {})
    assert launches == len(GOLDEN_SEEDS) * 13 * 2 * GOLDEN_EPOCHS, launches
    verdict = golden_parity(root, ours, parity_refs(root,
                                                    "ref_flagship_s*.json"))
    log("golden_parity.py: " + json.dumps(verdict))
    assert verdict["parity"] is True, "the flagship golden gate failed"
    log(f"golden gate: parity true over {len(GOLDEN_SEEDS)} seeds x "
        f"{GOLDEN_EPOCHS} epochs; written to {ours}")
    return launches


def amazon_splits(csr, seed: int = 2):
    """The graph's edges split 80/10/10 into train/valid/test, seeded."""
    import scipy.sparse as sp
    coo = csr.tocoo()
    r = np.random.default_rng(seed).random(coo.nnz)
    parts = []
    for lo, hi in ((0.0, 0.8), (0.8, 0.9), (0.9, 1.0)):
        keep = (r >= lo) & (r < hi)
        parts.append(sp.csr_matrix(
            (np.ones(int(keep.sum()), np.float32),
             (coo.row[keep], coo.col[keep])), shape=csr.shape))
    return parts


def metric_oracle(gt, idx, topn):
    """numpy float64 metric sums [4, len(topn)] of rankings idx against
    binary ground truth gt, the reference's conventions."""
    hits = np.take_along_axis(gt, idx, axis=1).astype(np.float64)
    cnt = gt.sum(axis=1).astype(np.float64)
    disc = 1.0 / np.log2(np.arange(idx.shape[1]) + 2.0)
    out = np.zeros((4, len(topn)))
    for j, k in enumerate(topn):
        h = hits[:, :k]
        n_hit = h.sum(axis=1)
        valid = cnt > 0
        idcg = np.array([disc[:int(min(c, k))].sum() for c in cnt])
        first = np.argmax(h, axis=1)
        out[0, j] = (n_hit / k)[valid].sum()
        out[1, j] = (n_hit[valid] / cnt[valid]).sum()
        out[2, j] = ((h * disc[:k]).sum(axis=1)[valid] / idcg[valid]).sum()
        out[3, j] = np.where(h.any(axis=1), 1.0 / (first + 1), 0.0)[valid].sum()
    return out


def fit_amazon_phase(root, card, torch, csr):
    """Phase 9: fit at the Amazon-Book width with streaming evaluation and
    a checkpoint, the round trip, and serving from the checkpoint."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops.metrics import (compute_topn_accuracy,
                                         packed_batch_metric_sums)
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    train, valid, test = amazon_splits(csr)
    log(f"amazon splits: {train.nnz} train / {valid.nnz} valid / {test.nnz} "
        f"test edges over {N_USER} x {N_ITEM}")
    tmp = tempfile.mkdtemp(prefix="gdmcf_fit_")
    try:
        ckpt_dir = os.path.join(tmp, "ckpt")
        cfg = load_config(
            os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
            {"device": "cuda", "host_dense": False, "epochs": 1,
             "eval_every": 1, "ckpt_dir": ckpt_dir})
        times = {}

        class TimedCheckpointer(Checkpointer):
            def save(self, state, *a, **kw):
                t0 = time.perf_counter()
                super().save(state, *a, **kw)
                times["snapshot_s"] = time.perf_counter() - t0

            def _write(self, step, payload):
                t0 = time.perf_counter()
                super()._write(step, payload)
                times["write_s"] = time.perf_counter() - t0

        trainer = Trainer(cfg, N_USER, N_ITEM)
        for name in ("train_epoch", "evaluate_streaming"):
            inner = getattr(trainer, name)

            def timed(*a, _inner=inner, _name=name, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _inner(*a, **kw)
                torch.cuda.synchronize()
                times.setdefault(_name, []).append(time.perf_counter() - t0)
                return out
            setattr(trainer, name, timed)
        ckpt = TimedCheckpointer(ckpt_dir, max_to_keep=1)
        FA.reset_launch_counts()
        free = shutil.disk_usage(tmp).free
        t0 = time.perf_counter()
        state, best = trainer.fit(train, valid, test, log=log,
                                  checkpointer=ckpt)
        fit_s = time.perf_counter() - t0
        launches = FA.LAUNCHES["fused_adamw"]
        steps = N_USER // cfg.batch_size   # every user has a train row
        assert state.step == steps and launches == 13 * steps, launches
        assert best is not None and ckpt.latest_step() == state.step
        size = os.path.getsize(os.path.join(ckpt_dir, f"ckpt_{state.step}.pt"))
        n_eval = N_USER // cfg.batch_size * cfg.batch_size
        (valid_s, test_s) = times["evaluate_streaming"]
        log(f"fit (Amazon-Book width, host_dense false): {fit_s:.2f} s for 1 "
            f"epoch with both evaluations and the checkpoint; train_epoch "
            f"{times['train_epoch'][0]:.2f} s ({state.step} steps, "
            f"fused_adamw launches {launches}); evaluate_streaming valid "
            f"{valid_s:.2f} s ({n_eval / valid_s:.0f} users/s), test "
            f"{test_s:.2f} s ({n_eval / test_s:.0f} users/s), {n_eval} users "
            f"each; checkpoint snapshot {times['snapshot_s']:.2f} s, write "
            f"{times['write_s']:.2f} s, {size} B ({size / 2**30:.2f} GiB; "
            f"{free / 2**30:.0f} GiB free before) [{card}]")

        # device metric sums of a few batches against the numpy oracle
        from gdmcf_torch.data.native import NativeCSR
        train_n = NativeCSR.from_scipy(train)
        valid_n = NativeCSR.from_scipy(valid, strict=False)
        topn = tuple(cfg.topN)
        worst = 0.0
        for start in (0, N_USER // 3, N_USER - cfg.batch_size):
            users = np.arange(start, start + cfg.batch_size)
            rows = torch.from_numpy(train_n.gather_packed(users)).cuda()
            idx = trainer.eval_step(rows, torch.from_numpy(users).cuda(),
                                    rows, sampling_steps=cfg.sampling_steps,
                                    top_k=max(topn))
            gt_packed = torch.from_numpy(valid_n.gather_packed(users)).cuda()
            dev = packed_batch_metric_sums(gt_packed, idx, N_ITEM, topn)
            gt = valid_n.gather(users) > 0
            want = metric_oracle(gt, idx.cpu().numpy(), topn)
            np.testing.assert_allclose(dev.cpu().numpy(), want, **METRIC_RTOL)
            np.testing.assert_allclose(
                compute_topn_accuracy(gt, idx.cpu().numpy(), topn),
                np.round(want / len(users), 4), rtol=0, atol=1e-4 + 1e-9)
            worst = max(worst, float(np.abs(dev.cpu().numpy() - want).max()))
        log(f"device metric sums vs numpy oracle on 3 batches of "
            f"{cfg.batch_size}: max abs diff {worst:.3e} (rtol "
            f"{METRIC_RTOL['rtol']}, atol {METRIC_RTOL['atol']})")

        # serve from the checkpoint; the round trip, bitwise
        t0 = time.perf_counter()
        rec_ckpt = build_recommender(cfg, ckpt_dir, train, N_USER, N_ITEM,
                                     serve_batch=256, k_max=100)
        torch.cuda.synchronize()
        from_ckpt_s = time.perf_counter() - t0
        template = rec_ckpt.trainer.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = Checkpointer(ckpt_dir).restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        opt, ropt = state.opt_state, restored.opt_state
        pairs = [("count", opt.count, ropt.count),
                 ("lt.history", state.lt.history, restored.lt.history),
                 ("lt.count", state.lt.count, restored.lt.count),
                 ("generator", state.generator.get_state(),
                  restored.generator.get_state())]
        for key, a, b in (("p", state.params, restored.params),
                          ("mu", opt.mu, ropt.mu), ("nu", opt.nu, ropt.nu)):
            pairs += [(f"{key}.{k}", a[k].detach(), b[k].detach()) for k in a]
        for name, a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), \
                f"round trip differs in {name}"
        assert restored.step == state.step
        log(f"checkpoint round trip: {len(pairs)} tensors bitwise equal "
            f"(params, moments, Lt ring, generator) and step {restored.step};"
            f" restore {restore_s:.2f} s ({size / restore_s / 2**30:.2f} "
            f"GiB/s); build_recommender from the checkpoint {from_ckpt_s:.2f}"
            f" s [{card}]")
        del template, restored
        rec_live = build_recommender(cfg, None, train, N_USER, N_ITEM,
                                     trainer=trainer, serve_batch=256,
                                     k_max=100)
        users = np.random.default_rng(3).choice(N_USER, 300, replace=False)
        want, _ = rec_live.recommend(users, k=100)
        got, _ = rec_ckpt.recommend(users, k=100)
        assert np.array_equal(got, want), \
            "the checkpoint serves other ids than the in-memory trainer"
        log(f"serving from the checkpoint: the ids of the in-memory trainer "
            f"for {len(users)} users, k 100")
        del rec_live, rec_ckpt, trainer, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def resume_phase(card, torch, data_dir):
    """Phase 10: fit 10 epochs against fit 5 + resume to 10, at the golden
    geometry; the losses of epochs 6-10 within RESUME_RTOL."""
    from gdmcf_torch.data.loader import data_load_dir
    from gdmcf_torch.train.trainer import Trainer

    train, valid, test, n_user, n_item = data_load_dir(data_dir)
    tmp = tempfile.mkdtemp(prefix="gdmcf_resume_")
    try:
        def run(epochs, ckpt_dir, resume):
            cfg = golden_config(0, epochs=epochs, ckpt_dir=ckpt_dir,
                                ckpt_every=5, resume=resume)
            trainer = Trainer(cfg, min(n_user, 3000), n_item)
            col, logs = Collector(), []
            with contextlib.redirect_stdout(io.StringIO()):
                state, _ = trainer.fit(train, valid, test, log=logs.append,
                                       metric_logger=col)
            return state.step, col.losses, logs

        steps_a, full, _ = run(10, os.path.join(tmp, "a"), False)
        run(5, os.path.join(tmp, "b"), True)
        steps_b, tail, logs = run(10, os.path.join(tmp, "b"), True)
        assert any(ln.startswith("resumed from checkpoint at step 10 ")
                   for ln in logs), logs[:3]
        assert steps_a == steps_b == 20 and len(tail) == 5
        np.testing.assert_allclose(tail, full[5:], rtol=RESUME_RTOL)
        diff = float(np.max(np.abs(np.array(tail) - full[5:])
                            / np.abs(full[5:])))
        log(f"resume: epochs 6-10 losses {tail} against the uninterrupted "
            f"{full[5:]}: max rel diff {diff:.3e} (rtol {RESUME_RTOL}) "
            f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def cli_phase(root, data_dir):
    """One `python -m gdmcf_torch.cli` on cuda at the golden geometry."""
    tmp = tempfile.mkdtemp(prefix="gdmcf_cli_")
    try:
        cmd = [sys.executable, "-m", "gdmcf_torch.cli", "--device", "cuda",
               "--data_path", data_dir, "--dataset", "golden",
               "--log_name", tmp, "--backbone", "DNNOneHotEmbeddingGCN",
               "--dims", "[1000]", "--emb_size", "10", "--lr", "1e-5",
               "--batch_size", "1024", "--steps", "5", "--noise_scale",
               "0.01", "--sampling_steps", "0", "--n_user_cap", "3000",
               "--epochs", "5", "--eval_every", "5", "--debug", "true"]
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                              text=True, timeout=300)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-4000:]
        (out_dir,) = glob.glob(os.path.join(tmp, "golden", "*", "GDMCF"))
        records = [json.loads(x) for x in
                   open(os.path.join(out_dir, "metrics.jsonl"))]
        assert [r["step"] for r in records if "train_loss" in r] == \
            [1, 2, 3, 4, 5]
        assert "End. Best Epoch 005" in proc.stdout
        assert "End. Best Epoch 005" in open(
            os.path.join(out_dir, "output_NDCG.txt")).read()
        log(f"cli: python -m gdmcf_torch.cli, 5 epochs in {wall:.1f} s "
            f"(process start included); {len(records)} metrics.jsonl "
            f"records; last lines: "
            + " | ".join(proc.stdout.strip().splitlines()[-2:]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def grad_of(torch, prop, e0, w_u, w_i, n_user):
    """d/d e0 of (fu * w_u).sum() + (fi * w_i).sum() through prop."""
    e = e0.clone().requires_grad_(True)
    fu, fi = prop(e[:n_user], e[n_user:])
    loss = (fu * w_u).sum() + (fi * w_i).sum()
    return torch.autograd.grad(loss, e)[0]


def gradient_phase(torch):
    """Phase 11: gradients through the differentiable product at the
    phase-2 graph (its pattern as interactions, normalized as LightGCN
    does), 3 layers, against the plain versions and dense autograd."""
    from gdmcf_torch.models import lightgcn as lg
    from gdmcf_torch.ops import spmm as S

    m = phase2_matrix(np.random.default_rng(0)).tocsr()
    m.data[:] = 1.0
    n, _ = lg._normalized_sparse_n(m, 1e-9, False)
    h = S.to_hybrid(n, br=8, bc=128, min_fill=32)
    assert h.rem_vals.numel() > 1_000
    h = h.to("cuda")
    n_user, n_item = n.shape
    dense = torch.from_numpy(n.toarray()).cuda()
    rng = np.random.default_rng(5)
    worst, launches = 0.0, {"spmm_rows_fwd": 0, "spmm_rows_t": 0}
    for d in (64, 50):
        e0, w_u, w_i = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda() for shape in ((n_user + n_item, d),
                                              (n_user, d), (n_item, d)))
        S.reset_launch_counts()
        e = e0.clone().requires_grad_(True)
        fu, fi = lg.propagate_hybrid(e[:n_user], e[n_user:], h, 3)
        torch.cuda.synchronize()
        fwd = dict(S.LAUNCHES)
        (g,) = torch.autograd.grad((fu * w_u).sum() + (fi * w_i).sum(), e)
        torch.cuda.synchronize()
        both = dict(S.LAUNCHES)
        assert fwd == {"spmm_rows_fwd": 3, "spmm_rows_t": 3}, fwd
        assert both == {"spmm_rows_fwd": 6, "spmm_rows_t": 6}, both
        for k in launches:
            launches[k] += both[k]
        again = grad_of(torch, lambda u, i: lg.propagate_hybrid(u, i, h, 3),
                        e0, w_u, w_i, n_user)
        torch.cuda.synchronize()
        assert torch.equal(g, again), "two backward passes differ"
        with deterministic(torch):
            rows = grad_of(torch, lambda u, i: lg._layers(
                u, i, 3, lambda x: S.spmm_rows_reference(h.fwd_rows, x),
                lambda x: S.spmm_rows_reference(h.t_rows, x)),
                e0, w_u, w_i, n_user)
            tpu = grad_of(torch, lambda u, i: lg._layers(
                u, i, 3, lambda x: S.hybrid_spmm_reference(h, x, False),
                lambda x: S.hybrid_spmm_reference(h, x, True)),
                e0, w_u, w_i, n_user)
        full = grad_of(torch, lambda u, i: lg.propagate(u, i, dense, 3),
                       e0, w_u, w_i, n_user)
        shares = []
        for label, want in (("plain row gather", rows),
                             ("plain tiles + COO", tpu),
                             ("dense autograd", full)):
            torch.testing.assert_close(g, want, **TOL)
            shares.append(f"{label} {tol_share(g, want):.3f}")
            worst = max(worst, (g - want).abs().max().item())
        log(f"gradient d={d}: 3 layers of propagate_hybrid over "
            f"{h.fwd_rows.nnz} nonzeros ({h.rem_vals.numel()} in the COO "
            f"remainder); launches forward {fwd}, forward and backward "
            f"{both}; two backward passes bitwise equal; share of the "
            f"tolerance (rtol {TOL['rtol']}, atol {TOL['atol']}): "
            + ", ".join(shares))
    return worst, launches


def replay_batches(ncsr, seed: int, steps: int, batch: int):
    """The batches pretrain draws at this seed, replayed; returns them and
    the host time per batch."""
    from gdmcf_torch.models import lightgcn as lg
    rng = np.random.default_rng(seed)
    ncsr.sample_bpr(np.zeros(1, np.int64), 0)   # the index, built once
    out = []
    t0 = time.perf_counter()
    for _ in range(steps):
        users = lg._choose_users(rng, ncsr.n_user, batch)
        pos, neg = ncsr.sample_bpr(users, int(rng.integers(2 ** 62)))
        out.append(np.stack([users, pos, neg]).astype(np.int64))
    return out, (time.perf_counter() - t0) / steps * 1e3


def pretrain_phase(args, card, torch, csr):
    """Phase 12: one epoch of LightGCN pretraining at the Amazon-Book size
    (the graph of phases 3-9) with the reference recipe on the hybrid
    operand, checked and timed."""
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.models import lightgcn as lg
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.train.trainer import matmul_precision

    steps = csr.nnz // PRETRAIN_BATCH
    assert steps == PRETRAIN_STEPS, steps
    mark = {}

    def at_epoch_end(line):
        torch.cuda.synchronize()
        mark.update(t=time.perf_counter(), line=line, spmm=dict(S.LAUNCHES),
                    adamw=FA.LAUNCHES["fused_adamw"])

    S.reset_launch_counts()
    FA.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lg.pretrain(csr, csr, n_layers=3, latent_dim=64, epochs=1,
                      batch_size=PRETRAIN_BATCH, lr=0.005, decay=1e-4, k=10,
                      seed=0, log=at_epoch_end, sparse="hybrid",
                      block_size=128, block_rows=8, evaluate=False,
                      device="cuda")
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    spmm, adamw = mark["spmm"], mark["adamw"]
    want = {"spmm_rows_fwd": 6 * steps, "spmm_rows_t": 6 * steps}
    assert spmm == want, spmm
    assert adamw == steps, adamw
    final = dict(S.LAUNCHES)
    assert final == {k: v + 3 for k, v in want.items()}, final
    mean_loss = float(mark["line"].split()[-1])
    log(f"pretrain (Amazon-Book size, hybrid br 8 bc 128, 3 layers, dim 64, "
        f"batch {PRETRAIN_BATCH}, lr 0.005, decay 1e-4): {steps} steps; "
        f"epoch ends {mark['t'] - t0:.2f} s after the call starts (operand "
        f"build and upload included), call {call_s:.2f} s with the final "
        f"propagation and the copies back; launches at the epoch's end "
        f"{spmm} and fused_adamw {adamw}, after the final tables {final}; "
        f"peak device memory {peak:.2f} GiB; {mark['line']} [{card}]")

    # the first step's loss, the rows the batches touched, host sampling
    ncsr = NativeCSR.from_scipy(csr, strict=False)
    batches, sample_ms = replay_batches(ncsr, 0, steps, PRETRAIN_BATCH)
    h = lg.normalized_bipartite_hybrid(csr, br=8, bc=128).to("cuda")
    init = lg.initial_table(N_USER + N_ITEM, 64, 0, "cuda")
    b0 = torch.from_numpy(batches[0]).cuda()
    with torch.no_grad(), matmul_precision(tf32=False):
        fu, fi = lg.propagate_rows(init[:N_USER], init[N_USER:], h.fwd_rows,
                                   h.t_rows, 3)
        loss, reg = lg.bpr_loss(fu[b0[0]], fi[b0[1]], fi[b0[2]], init[b0[0]],
                                init[N_USER + b0[1]], init[N_USER + b0[2]],
                                PRETRAIN_BATCH)
        first = (loss + 1e-4 * reg).item()
    assert np.isfinite(mean_loss) and mean_loss < first, (mean_loss, first)
    touched = np.zeros(N_USER + N_ITEM, bool)
    for b in batches:
        touched[b[0]] = True
        touched[N_USER + b[1]] = True
        touched[N_USER + b[2]] = True
    trained = np.concatenate([res.initial_user, res.initial_item])
    moved = (trained != init.cpu().numpy()).any(axis=1)
    assert np.isfinite(trained).all() and moved[touched].all(), \
        "a row the batches touched did not move"
    log(f"pretrain: epoch mean loss {mean_loss:.4f} < first step's "
        f"{first:.4f}; {int(touched.sum())} rows touched by the batches, all "
        f"moved ({int(moved.sum())} of {len(moved)} moved); host sampling "
        f"{sample_ms:.3f} ms per batch of {PRETRAIN_BATCH} (replayed)")

    # the returned final tables: the returned initial ones propagated by
    # the plain version
    u0 = torch.from_numpy(res.initial_user).cuda()
    i0 = torch.from_numpy(res.initial_item).cuda()
    with deterministic(torch), matmul_precision(tf32=False):
        pu, pi = lg._layers(
            u0, i0, 3, lambda x: S.hybrid_spmm_reference(h, x, False),
            lambda x: S.hybrid_spmm_reference(h, x, True))
    fu_k = torch.from_numpy(res.final_user).cuda()
    fi_k = torch.from_numpy(res.final_item).cuda()
    torch.testing.assert_close(fu_k, pu, **TOL)
    torch.testing.assert_close(fi_k, pi, **TOL)
    share = max(tol_share(fu_k, pu), tol_share(fi_k, pi))
    log(f"pretrain: final tables vs the plain tiles + COO propagation of "
        f"the returned initial tables: max abs err "
        f"{max((fu_k - pu).abs().max().item(), (fi_k - pi).abs().max().item()):.3e}"
        f", {share:.3f} of the tolerance")
    del pu, pi, fu_k, fi_k, fu, fi

    # step times, then the backward launches alone
    def prop(e):
        return lg.propagate_rows(e[:N_USER], e[N_USER:], h.fwd_rows,
                                 h.t_rows, 3)
    e = torch.from_numpy(trained).cuda().requires_grad_(True)
    opt = FA.fused_adamw_init({"e0": e}, torch.float32)
    rng = np.random.default_rng(1)

    def sample():
        users = lg._choose_users(rng, N_USER, PRETRAIN_BATCH)
        pos, neg = ncsr.sample_bpr(users, int(rng.integers(2 ** 62)))
        return torch.from_numpy(np.stack([users, pos, neg]).astype(np.int64))

    def step(batch):
        nonlocal opt
        opt, _ = lg.bpr_step(e, opt, prop, batch.pin_memory().to(
            "cuda", non_blocking=True), N_USER, 0.005, 1e-4)

    times = {"excluded": [], "included": []}
    with matmul_precision(tf32=False):
        pre = [sample() for _ in range(30)]
        for batch in pre:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times["excluded"].append((time.perf_counter() - t1) * 1e3)
        for _ in range(30):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(sample())
            torch.cuda.synchronize()
            times["included"].append((time.perf_counter() - t1) * 1e3)
        stats = {k: (float(np.percentile(v[5:], 50)),
                     float(np.percentile(v[5:], 90)))
                 for k, v in times.items()}
        log(f"pretrain step (synced, 25 steps after 5 warm-up): host "
            f"sampling excluded p50 {stats['excluded'][0]:.3f} ms p90 "
            f"{stats['excluded'][1]:.3f} ms; included p50 "
            f"{stats['included'][0]:.3f} ms p90 {stats['included'][1]:.3f} "
            f"ms; epoch at the excluded p50 "
            f"{stats['excluded'][0] * steps / 1e3:.2f} s [{card}]")
        g_u = torch.randn(h.fwd_rows.n_out, 64, device="cuda")
        g_i = torch.randn(h.t_rows.n_out, 64, device="cuda")
        bwd = {"spmm_rows_t": cuda_ms(lambda: S.spmm_rows(h.t_rows, g_u)),
               "spmm_rows_fwd": cuda_ms(lambda: S.spmm_rows(h.fwd_rows, g_i))}
        log(f"backward launches at D 64 on the whole hybrid N: N^T g "
            f"(spmm_rows_t, g [{h.fwd_rows.n_out}, 64]) "
            f"{bwd['spmm_rows_t']:.4f} ms, N g (spmm_rows_fwd, g "
            f"[{h.t_rows.n_out}, 64]) {bwd['spmm_rows_fwd']:.4f} ms [{card}]")
        if args.profile:
            write_profile(args.profile, card,
                          f"5 LightGCN BPR steps of {PRETRAIN_BATCH}, host "
                          f"sampling included",
                          lambda: [step(sample()) for _ in range(5)], torch,
                          mode="a")
    del e, opt, h, init
    gc.collect()
    torch.cuda.empty_cache()
    return spmm, adamw, bwd, stats, sample_ms


def parity_band(root):
    """``band`` of benchmarks/lightgcn_parity.py (that file imports only
    the standard library and numpy at module level)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "lightgcn_parity", os.path.join(root, "benchmarks",
                                        "lightgcn_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.band


def parse_pretrain_log(lines, n_users, n_items, seed):
    """The log lines of pretrain as benchmarks/lightgcn_parity.py reads
    them."""
    out = {"recall": [], "precision": [], "ndcg": [], "map": [], "loss": [],
           "n_users": n_users, "n_items": n_items, "seed": seed}
    for ln in lines:
        parts = ln.split()
        d = {parts[i].split("@")[0]: float(parts[i + 1])
             for i in range(2, len(parts), 2)}
        out["loss"].append(round(d["loss"], 4))
        for k in ("recall", "precision", "ndcg", "map"):
            out[k].append(round(d[k], 4))
    return out


def lightgcn_gate_phase(root, card, torch, seeds=LGN_GATE_SEEDS,
                        out_name="torch_lightgcn_parity.json", require=True):
    """Phase 13: the LightGCN golden gate, 3 seeds x 30 epochs of the
    reference recipe on the ml-100k-shaped data, judged against the
    reference runs in docs/parity_data/lightgcn_parity.json with the band
    rule of benchmarks/lightgcn_parity.py, once with the recipe's dense
    operand and once with the hybrid one. ``require`` False reports the
    verdicts without failing on them (the --fresh-seed-gates run)."""
    from gdmcf_torch.data.loader import generate_ml100k_csv, load_ml100k
    from gdmcf_torch.models import lightgcn as lg
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S

    band = parity_band(root)
    with open(os.path.join(root, "docs", "parity_data",
                           "lightgcn_parity.json")) as fh:
        refs = json.load(fh)["reference"]
    tmp = tempfile.mkdtemp(prefix="gdmcf_ml100k_")
    try:
        path = generate_ml100k_csv(os.path.join(tmp, "u.data"), n_user=400,
                                   n_item=600, avg_degree=40, seed=0)
        train, test, n_users, n_items = load_ml100k(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert (n_users, n_items) == (400, 584), (n_users, n_items)
    steps = train.nnz // 1024
    tail = lambda xs: float(np.mean(xs[-8:]))  # noqa: E731
    results, launches = {}, {}
    for mode, sparse in (("dense", None), ("hybrid", "hybrid")):
        S.reset_launch_counts()
        FA.reset_launch_counts()
        ours = []
        for seed in seeds:
            lines = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg.pretrain(train, test, n_layers=3, latent_dim=64,
                        epochs=LGN_GATE_EPOCHS, batch_size=1024, lr=0.005,
                        decay=1e-4, k=10, seed=seed, log=lines.append,
                        sparse=sparse, device="cuda")
            torch.cuda.synchronize()
            run = parse_pretrain_log(lines, n_users, n_items, seed)
            run["elapsed_s"] = round(time.perf_counter() - t0, 2)
            assert len(run["loss"]) == LGN_GATE_EPOCHS
            assert np.isfinite(run["loss"]).all()
            ours.append(run)
            log(f"lightgcn gate {mode} seed {seed}: final r/p/n/m "
                f"{run['recall'][-1]}/{run['precision'][-1]}/"
                f"{run['ndcg'][-1]}/{run['map'][-1]}, tail loss "
                f"{tail(run['loss']):.4f} ({run['elapsed_s']} s) [{card}]")
        n = len(seeds)
        # per epoch: each step 3 layers x 2 directions forward and
        # backward, and the evaluation's forward propagation
        per_dir = n * LGN_GATE_EPOCHS * (6 * steps + 3)
        want = ({"spmm_rows_fwd": per_dir, "spmm_rows_t": per_dir}
                if sparse else {"spmm_rows_fwd": 0, "spmm_rows_t": 0})
        assert S.LAUNCHES == want, (S.LAUNCHES, want)
        assert FA.LAUNCHES["fused_adamw"] == n * LGN_GATE_EPOCHS * steps
        launches[mode] = dict(S.LAUNCHES,
                              fused_adamw=FA.LAUNCHES["fused_adamw"])
        checks = {}
        for m in ("recall", "precision", "ndcg", "map"):
            lo, hi = band([r[m][-1] for r in refs], 1.0)
            checks[f"final_{m}@10"] = all(lo <= o[m][-1] <= hi for o in ours)
        lo, hi = band([tail(r["loss"]) for r in refs], 1.0)
        checks["tail_bpr_loss"] = all(lo <= tail(o["loss"]) <= hi
                                      for o in ours)
        results[mode] = {"reference": refs, "gdmcf_torch": ours,
                         "checks": checks, "parity": all(checks.values()),
                         "device": card}
        log(f"lightgcn_parity ({mode}, launches {launches[mode]}): "
            + json.dumps({"checks": checks,
                          "parity": results[mode]["parity"]}))
    out = os.path.join(root, "chiprun_out", out_name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(results, fh)
    if not require:
        return results
    for mode, res in results.items():
        assert res["parity"] is True, f"the LightGCN gate failed ({mode})"
    log(f"lightgcn gate: parity true, dense and hybrid; written to {out}")
    return launches


def pretrain_cli_phase(root, data_dir):
    """Phase 14: one `python -m gdmcf_torch.pretrain_cli` on cuda over the
    golden dataset (dense, with the evaluation), 2 epochs."""
    from gdmcf_torch.data.loader import data_load_dir

    _, _, _, n_user, n_item = data_load_dir(data_dir)
    tmp = tempfile.mkdtemp(prefix="gdmcf_pretrain_cli_")
    try:
        out = os.path.join(tmp, "emb")
        cmd = [sys.executable, "-m", "gdmcf_torch.pretrain_cli", "--device",
               "cuda", "--data_path", data_dir, "--epochs", "2",
               "--out_dir", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, env=dict(os.environ,
                                                      PYTHONPATH=root),
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(os.path.join(out, "lightgcn_embeddings.npz")) as z:
            shapes = {k: z[k].shape for k in sorted(z.files)}
            assert all(np.isfinite(z[k]).all() for k in z.files)
        assert shapes == {"final_item_Embed": (n_item, 64),
                          "final_user_Embed": (n_user, 64),
                          "initial_item_Embed": (n_item, 64),
                          "initial_user_Embed": (n_user, 64)}, shapes
        lines = proc.stdout.strip().splitlines()
        assert sum("ndcg@10" in ln for ln in lines) == 2
        log(f"pretrain_cli: python -m gdmcf_torch.pretrain_cli, 2 epochs on "
            f"{n_user} x {n_item} in {wall:.1f} s (process start included); "
            f"lightgcn_embeddings.npz {shapes}; last lines: "
            + " | ".join(lines[-2:]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dnn_matmul_flops(cfg, n_item: int, batch: int, train: bool):
    """Matmul flops of one DNN forward (``train``: forward and backward) at
    ``batch``, from the shapes: in_layers over [x || emb], then
    out_layers. The first layer's input needs no gradient."""
    ins = [n_item + cfg.emb_size] + cfg.in_dims(n_item)[1:]
    outs = cfg.out_dims(n_item)
    towers = sum(2 * batch * a * b for a, b in zip(ins[:-1], ins[1:]))
    head = sum(2 * batch * a * b for a, b in zip(outs[:-1], outs[1:]))
    return towers + head if not train else 2 * towers + 3 * head


def dnn_phase(root, card, torch, csr):
    """Phase 15: DNN at OneHotMatrix 0 at the Amazon-Book width: one
    epoch, the AdamW check on a further step, step times, then serving.
    Returns the epoch's K1 launches and the AdamW check's largest error."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    cfg = load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                      {"device": "cuda", "backbone": "DNN",
                       "OneHotMatrix": 0})
    t0 = time.perf_counter()
    trainer = Trainer(cfg, N_USER, N_ITEM)
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state.params.values())
    n_leaves = len(state.params)
    log(f"DNN at OneHotMatrix 0: {n_params} trainable elements in {n_leaves}"
        f" tensors {[tuple(p.shape) for p in state.params.values()]}, "
        f"moments {cfg.opt_moment_dtype}, batch {cfg.batch_size}, lr "
        f"{cfg.lr}, TF32 {'on' if trainer.tf32 else 'off'}, contrastive "
        f"loss asked {trainer.diffusion.index_in and trainer.diffusion.cat_one_hot}"
        f" (init {time.perf_counter() - t0:.1f} s)")
    assert n_params == DNN_PARAMS and n_leaves == 6, (n_params, n_leaves)
    assert not trainer.diffusion.cat_one_hot and not trainer.diffusion.index_in
    dataset = NativeCSR.from_scipy(csr)
    before = {k: p.detach().clone() for k, p in state.params.items()}

    FA.reset_launch_counts()
    S.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, total = trainer.train_epoch(state, dataset,
                                       np.random.default_rng(0))
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = dict(FA.LAUNCHES)
    steps = N_USER // cfg.batch_size
    log(f"DNN train_epoch: {state.step} steps in {epoch_s:.2f} s, loss sum "
        f"{total:.6e}, launches {launches}, SpMM launches {dict(S.LAUNCHES)}"
        f" [{card}]")
    assert state.step == steps == 272
    assert np.isfinite(total), "a DNN train-step loss is not finite"
    assert launches["fused_adamw"] == n_leaves * steps == 1_632, launches
    assert not any(S.LAUNCHES.values())
    for k, p in state.params.items():
        assert bool((p.detach() != before[k]).any()), f"{k} did not move"
    del before

    batches = train_stream(dataset, cfg.batch_size)
    step_err, clones = checked_step(trainer, state, *next(batches), torch,
                                    "DNN")
    del clones
    p50, p90 = step_times(trainer, state, batches, torch)
    log(f"DNN train step (batch {cfg.batch_size}): p50 {p50:.3f} ms, p90 "
        f"{p90:.3f} ms over 20 steps, {cfg.batch_size / p50 * 1e3:.1f} "
        f"examples/s; matmul work "
        f"{dnn_matmul_flops(cfg, N_ITEM, cfg.batch_size, True):.4e} flop per"
        f" step from shapes, {dnn_matmul_flops(cfg, N_ITEM, cfg.batch_size, True) / p50 / 1e9:.1f}"
        f" TFLOP/s at the p50 [{card}]")

    FA.reset_launch_counts()
    t0 = time.perf_counter()
    rec = build_recommender(cfg, None, csr, N_USER, N_ITEM, trainer=trainer,
                            serve_batch=256, k_max=100)
    log(f"DNN build_recommender: {time.perf_counter() - t0:.1f} s")
    users_b = check_requests(rec, csr, N_ITEM, "DNN")
    assert FA.LAUNCHES["fused_adamw"] == 0 and not any(S.LAUNCHES.values())
    request_times(rec, users_b[:256], card, "DNN")
    log(f"DNN request matmul work: {cfg.steps} forwards of "
        f"{dnn_matmul_flops(cfg, N_ITEM, 256, False):.4e} flop from shapes; "
        f"peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    del rec, trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches["fused_adamw"], step_err


def split_runs(path, out_dir):
    """The runs of a parity_run.py JSON as one reference file per seed."""
    with open(path) as fh:
        runs = json.load(fh)["runs"]
    paths = []
    for r in runs:
        paths.append(os.path.join(out_dir, f"run_s{r['seed']}.json"))
        with open(paths[-1], "w") as fh:
            json.dump(r, fh)
    return paths


def judge_gate(root, tmp, label, ours, pattern, jax):
    """The verdict of the unchanged benchmarks/golden_parity.py on the runs
    in ``ours`` against the reference runs ``pattern``, printed. Where
    ``jax`` names the JAX package's recorded runs (file, use), they are
    split per seed into ``tmp`` and the verdict returned is the one against
    the reference's and the JAX package's runs pooled (``pooled``), or
    tail loss against the reference and final R@20/N@20 against the JAX
    package (``finals``); the reference-only verdict is printed first."""
    refs = parity_refs(root, pattern)
    verdict = golden_parity(root, ours, refs)
    log(f"golden_parity.py ({label}, against {pattern}): "
        + json.dumps(verdict))
    if jax is None:
        return verdict
    name, use = jax
    jax_refs = split_runs(os.path.join(root, "docs", "parity_data", name),
                          tempfile.mkdtemp(dir=tmp))
    if use == "pooled":
        verdict = golden_parity(root, ours, refs + jax_refs)
    else:   # finals against the JAX package, tail loss not
        finals = golden_parity(root, ours, jax_refs)
        log(f"golden_parity.py ({label}, against {name}): "
            + json.dumps(finals))
        checks = {"tail_loss": verdict["checks"]["tail_loss"],
                  **{k: v for k, v in finals["checks"].items()
                     if k.startswith("final_")}}
        verdict = {"checks": checks, "parity": all(checks.values())}
    log(f"golden_parity.py ({label}, against {pattern} and {name}, {use}): "
        + json.dumps(verdict))
    return verdict


def neutral_gate(root, card, data_dir, dumps):
    """G9's verdict of record: each seed's final raw scores ranked by the
    unchanged ``side`` of benchmarks/oh1_neutral_eval.py (its top level
    imports numpy alone; the splits come from the port's ``data_load_dir``,
    never the comparator's ``load_data``), its tie-neutral test R@20 and
    N@20 inside ``band`` (tolerance 1.0) of the reference's per-seed values
    in docs/parity_data/oh1_neutral_result.json; the band of that file's
    other side, the JAX package's recorded runs, is printed beside it."""
    from gdmcf_torch.data.loader import data_load_dir

    sys.path.insert(0, os.path.join(root, "benchmarks"))
    try:
        from oh1_neutral_eval import band, side
    finally:
        sys.path.pop(0)
    with open(os.path.join(root, "docs", "parity_data",
                           "oh1_neutral_result.json")) as fh:
        recorded = json.load(fh)
    # the comparator's output names its two sides "reference" and the
    # package it judged
    (jax_side,) = [k for k in recorded
                   if k not in ("reference", "checks", "parity")]
    tr, va, te = (m.astype(np.float32).toarray()
                  for m in data_load_dir(data_dir)[:3])
    ours = [row["test"][20] for row in side(dumps, tr, va, te)]
    ok = True
    for i, name in ((0, "R@20"), (1, "N@20")):
        ref = band([r["test"]["20"][i] for r in recorded["reference"]], 1.0)
        jax_band = band([r["test"]["20"][i] for r in recorded[jax_side]],
                        1.0)
        vals = [o[i] for o in ours]
        inside = all(ref[0] <= v <= ref[1] for v in vals)
        ok = ok and inside
        log(f"G9 tie-neutral test {name} by seed {vals}: inside the "
            f"reference's band [{ref[0]:.4f}, {ref[1]:.4f}] {inside} (the "
            f"JAX package's recorded runs' band [{jax_band[0]:.4f}, "
            f"{jax_band[1]:.4f}]) [{card}]")
    return ok


def backbone_gates_phase(root, card, golden_dir):
    """Phase 16: the golden gate of every backbone family with reference
    data, and the Amazon-recipe and DNNOneHotEmbeddingGCN_conti gates, each
    judged by the unchanged benchmarks/golden_parity.py against the
    reference's runs, or where BACKBONE_GATES names them with the JAX
    package's recorded runs too (split per seed): G4 against both pooled,
    G9 on tail loss against the reference and on final R@20/N@20 against
    the JAX package, which breaks ties as the port does, and on its
    tie-neutral verdict of record (``neutral_gate``). Returns the K1
    launches by gate."""
    from gdmcf_torch.data.loader import data_load_dir, generate_synthetic_dataset

    tmp = tempfile.mkdtemp(prefix="gdmcf_gates_")
    try:
        dirs = {"golden": golden_dir}
        for name, kw in (("round3", ROUND3_GATE_SET),
                         ("amazon", AMAZON_GATE_SET)):
            dirs[name] = os.path.join(tmp, name)
            generate_synthetic_dataset(dirs[name], **kw)
            train, _, _, n_user, n_item = data_load_dir(dirs[name])
            log(f"gate data {name}: generate_synthetic_dataset({kw}): "
                f"{n_user} x {n_item}, {train.nnz} train edges")
        launches, failed = {}, []
        for label, data, cfg_kw, epochs, pattern, jax in BACKBONE_GATES:
            t0 = time.perf_counter()
            dumps = os.path.join(tmp, f"{label}_scores")
            neutral = label == OH1_NEUTRAL_GATE
            if neutral:
                os.makedirs(dumps)
            ours, launches[label] = run_gate(
                root, card, label, dirs[data], epochs, cfg_kw,
                dump_dir=dumps if neutral else None)
            if judge_gate(root, tmp, label, ours, pattern,
                          jax)["parity"] is not True:
                failed.append(label)
            if neutral and not neutral_gate(
                    root, card, dirs[data],
                    sorted(glob.glob(os.path.join(dumps, "*.npy")))):
                failed.append(f"{label} (tie-neutral)")
            log(f"gate {label}: {time.perf_counter() - t0:.1f} s, "
                f"fused_adamw launches {launches[label]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not failed, f"golden gates failed: {failed}"
    log(f"backbone gates: parity true in all {len(BACKBONE_GATES)}")
    return launches


def http_client(argv) -> int:
    """``chip_smoke.py --http-client BASE CLIENTS COUNT SECONDS USERS``:
    the load generator, a process of its own (standard library only, so
    its threads share no interpreter with the server). CLIENTS threads
    start together; each sends 1-user ``GET /recommend?users=U&k=20``
    requests one after another, COUNT of them, or for SECONDS when COUNT
    is 0, taking users from the comma-separated USERS list in turn. Prints
    one JSON object: per request [user, wall-clock start, latency ms, ids
    or null, error or null], and the wall time of the run."""
    import http.client
    import threading
    from urllib.parse import urlparse

    base, clients, count, seconds = (argv[0], int(argv[1]), int(argv[2]),
                                     float(argv[3]))
    host, port = urlparse(base).hostname, urlparse(base).port
    users = [int(u) for u in argv[4].split(",")]
    out = [[] for _ in range(clients)]
    barrier = threading.Barrier(clients)

    def get(u):
        # http.client, not urllib: urllib's first call in each thread
        # builds an opener with a TLS context, tens of ms under the GIL
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            conn.request("GET", f"/recommend?users={u}&k=20")
            r = conn.getresponse()
            body = r.read()
            if r.status != 200:
                raise RuntimeError(f"HTTP {r.status}: {body[:200]!r}")
            return json.loads(body)["items"][0]
        finally:
            conn.close()

    def run(c):
        barrier.wait()
        stop = time.time() + seconds
        j = 0
        while (j < count) if count else (time.time() < stop):
            u = users[(c * max(count, 1) + j) % len(users)]
            j += 1
            t_wall, t0 = time.time(), time.perf_counter()
            try:
                items, err = get(u), None
            except Exception as e:   # recorded, and failed by the caller
                items, err = None, f"{type(e).__name__}: {e}"
            out[c].append([u, t_wall, (time.perf_counter() - t0) * 1e3,
                           items, err])

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps({"requests": [r for rs in out for r in rs],
                      "wall_s": time.perf_counter() - t0}))
    return 0


def start_load(base, clients, count, seconds, users):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--http-client", base,
         str(clients), str(count), str(seconds),
         ",".join(str(int(u)) for u in users)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_load(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def free_port() -> int:
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def get_json(url, payload=None, timeout=300):
    """(status, JSON body) of a GET, or of a POST of ``payload`` (bytes);
    an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=payload, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_healthz(base, proc=None, limit=120.0):
    """The /healthz body once the server answers; fails when ``proc``
    exits or ``limit`` seconds pass first."""
    deadline = time.time() + limit
    while time.time() < deadline:
        if proc is not None:
            assert proc.poll() is None, "the server exited during start-up"
        try:
            return get_json(base + "/healthz", timeout=10)[1]
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"{base} did not answer in {limit} s")


def load_summary(res, expected, label, card, stats0, stats1,
                 what="every response equals rec.recommend"):
    """Check every response against ``expected`` (user -> a list of
    acceptable id lists) and print latency percentiles, requests/s and
    rows per dispatch; returns the summary."""
    reqs = res["requests"]
    errors = [r[4] for r in reqs if r[4] is not None]
    assert not errors, f"{label}: {len(errors)} failed requests: {errors[:3]}"
    for u, _t, _ms, items, _e in reqs:
        want = expected[u]
        assert any(items == w for w in want), \
            f"{label}: user {u} got {items[:5]}..., the library {want[0][:5]}..."
    lat = np.array([r[2] for r in reqs])
    dispatches = stats1["dispatches"] - stats0["dispatches"]
    rows = stats1["rows"] - stats0["rows"]
    out = {"requests": len(reqs), "wall_s": res["wall_s"],
           "requests_per_s": len(reqs) / res["wall_s"],
           "p50_ms": float(np.percentile(lat, 50)),
           "p90_ms": float(np.percentile(lat, 90)),
           "p99_ms": float(np.percentile(lat, 99)),
           "max_ms": float(lat.max()), "dispatches": dispatches,
           "rows_per_dispatch": rows / max(dispatches, 1)}
    log(f"http {label}: {out['requests']} requests in {out['wall_s']:.2f} s"
        f" = {out['requests_per_s']:.1f} requests/s; latency p50 "
        f"{out['p50_ms']:.3f} ms, p90 {out['p90_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms, max {out['max_ms']:.3f} ms; {dispatches}"
        f" dispatches, {out['rows_per_dispatch']:.2f} rows a dispatch; "
        f"{what} [{card}]")
    return out


def write_checkpoint(torch, directory, params, cfg, step):
    """A checkpoint in fit's format (train/checkpoint.py) holding
    ``params`` (host tensors), zero moments and an empty Lt ring."""
    from gdmcf_torch.diffusion.engine import LtState
    from gdmcf_torch.ops.fused_adamw import fused_adamw_init
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.state import TrainState
    moments = {"bfloat16": torch.bfloat16,
               "float32": torch.float32}[cfg.opt_moment_dtype]
    state = TrainState(step=step, params=params,
                       opt_state=fused_adamw_init(params, moments),
                       lt=LtState.create(cfg.steps, cfg.history_num_per_term),
                       generator=torch.Generator())
    ck = Checkpointer(directory, max_to_keep=1)
    ck.save(state)
    ck.close()


def http_checkpoints(torch, rec, cfg, tmp, csr):
    """Three checkpoints for the reload checks, written from the host: the
    live parameters as they are (step 1), the same moved by half their mean
    magnitude times a seeded normal (step 2), and one of another geometry
    (the same backbone at 60 x 50)."""
    from gdmcf_torch.models.registry import build_model
    live = dict(rec.trainer.model.named_parameters())
    same = {k: p.detach().cpu() for k, p in live.items()}
    g = torch.Generator("cuda").manual_seed(11)
    moved = {}
    for k, p in live.items():
        scale = float(p.detach().abs().mean()) or 0.01
        moved[k] = (p.detach() + 0.5 * scale * torch.randn(
            p.shape, generator=g, device="cuda")).cpu()
    dirs = {name: os.path.join(tmp, f"{cfg.backbone}_{name}")
            for name in ("same", "moved", "other")}
    t0 = time.perf_counter()
    write_checkpoint(torch, dirs["same"], same, cfg, 1)
    write_checkpoint(torch, dirs["moved"], moved, cfg, 2)
    del same, moved
    small = build_model(cfg, 60, 50, train_csr=csr[:60, :50],
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    write_checkpoint(torch, dirs["other"],
                     {k: p.detach() for k, p in small.named_parameters()},
                     cfg, 3)
    log(f"http checkpoints of {cfg.backbone}: 3 written in "
        f"{time.perf_counter() - t0:.1f} s ("
        f"{os.path.getsize(os.path.join(dirs['moved'], 'ckpt_2.pt'))} B "
        f"each at full size)")
    return dirs


def daemon_data(tmp, csr):
    """The graph as {train,valid,test}_list.npy for a serve_http daemon;
    the last user and item get an edge, so data_load infers the full
    Amazon-Book geometry."""
    coo = csr.tocoo()
    edges = np.stack([coo.row, coo.col], 1).astype(np.int64)
    edges = np.concatenate([edges, [[N_USER - 1, N_ITEM - 1]]])
    d = os.path.join(tmp, "daemon_data")
    os.makedirs(d)
    np.save(os.path.join(d, "train_list.npy"), edges)
    for name in ("valid", "test"):
        np.save(os.path.join(d, f"{name}_list.npy"), edges[:100])
    return d


def daemon_phase(root, card, data_dir, ckpt_dir):
    """(e) `python -m gdmcf_torch.serve_http --device cuda` serving the
    lightGCN backbone from ``ckpt_dir``: start-up to the first /healthz,
    one recommend, SIGHUP reloads (params_version 1), SIGTERM exits 0."""
    import signal
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = os.path.join(os.path.dirname(data_dir), "daemon.log")
    cmd = [sys.executable, "-m", "gdmcf_torch.serve_http", "--device",
           "cuda", "-c", os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
           "--backbone", "lightGCN", "--data_path", data_dir,
           "--ckpt_dir_serve", ckpt_dir, "--host", "127.0.0.1", "--port",
           str(port)]
    with open(log_path, "w") as out:
        t0 = time.perf_counter()
        daemon = subprocess.Popen(cmd, cwd=root, stdout=out,
                                  stderr=subprocess.STDOUT,
                                  env=dict(os.environ, PYTHONPATH=root))
        try:
            body = wait_healthz(base, daemon, limit=300)
            up_s = time.perf_counter() - t0
            assert body["n_user"] == N_USER and body["n_item"] == N_ITEM
            assert body["stats"]["params_version"] == 0
            code, rec_body = get_json(
                base + f"/recommend?users=0,17,{N_USER - 1}&k=20")
            assert code == 200, rec_body
            for row in rec_body["items"]:
                assert len(set(row)) == 20 and all(0 <= i < N_ITEM
                                                   for i in row)
            t1 = time.perf_counter()
            daemon.send_signal(signal.SIGHUP)
            deadline = time.time() + 120
            while get_json(base + "/healthz")[1]["stats"][
                    "params_version"] != 1:
                assert time.time() < deadline, "SIGHUP did not reload"
                time.sleep(0.05)
            hup_s = time.perf_counter() - t1
            daemon.send_signal(signal.SIGTERM)
            rc = daemon.wait(timeout=60)
        finally:
            if daemon.poll() is None:
                daemon.kill()
                daemon.wait(timeout=30)
    text = open(log_path).read()
    assert rc == 0, text[-3000:]
    assert "SIGHUP reload: {'reloaded': True" in text, text[-3000:]
    log(f"daemon: python -m gdmcf_torch.serve_http --device cuda (lightGCN, "
        f"from a checkpoint): launch to the first /healthz {up_s:.2f} s; a "
        f"recommend answered; SIGHUP reloaded in {hup_s:.2f} s "
        f"(params_version 1); SIGTERM exited 0 [{card}]")
    return up_s


def http_phase(root, card, torch, csr):
    """Phase 17: HTTP serving at the Amazon-Book size, lightGCN and the
    flagship, through make_server in this process: (a) start-up launches
    the SpMM kernel 2 + 2 times for lightGCN, requests and reloads none;
    (b) 1, 16 and 64 concurrent clients of 1-user requests, every response
    equal to rec.recommend; (c) 64 clients through serve_multiproc with 4
    fronts; (d) a hot reload under 16-client load, a quiet one for its
    memory, a refused one (409) of another geometry; (e) the daemon
    (lightGCN). Returns the summaries and the lightGCN launches."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.serve import Recommender, build_recommender
    from gdmcf_torch.serve_http import make_server, serve_multiproc

    users = np.random.default_rng(5).choice(N_USER, HTTP_USERS,
                                            replace=False)
    tmp = tempfile.mkdtemp(prefix="gdmcf_http_")
    summary, launches = {}, {}
    try:
        for backbone in ("lightGCN", "DNNOneHotEmbeddingGCN"):
            cfg = load_config(os.path.join(root, "configs",
                                           "amazonOneEmbGcn.yaml"),
                              {"backbone": backbone, "device": "cuda"})
            S.reset_launch_counts()
            FA.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = build_recommender(cfg, None, csr, N_USER, N_ITEM,
                                    serve_batch=256, k_max=100)
            torch.cuda.synchronize()
            start = dict(S.LAUNCHES)
            log(f"http {backbone}: build_recommender {time.perf_counter() - t0:.1f}"
                f" s, launches {start}")
            want = rec.recommend(users, k=20)[0]
            old = {int(u): [row.tolist()] for u, row in zip(users, want)}
            srv = make_server(rec, "127.0.0.1", 0)
            thread = threading.Thread(target=srv.serve_forever, daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            res = {}
            try:
                wait_healthz(base)
                stats = srv.coalescer.stats
                for clients, count in HTTP_CLIENTS.items():
                    s0 = dict(stats)
                    r = finish_load(start_load(base, clients, count, 0,
                                               users))
                    res[f"{clients} clients"] = load_summary(
                        r, old, f"{backbone} {clients} clients", card, s0,
                        dict(stats))
                # (c) 4 pre-forked fronts
                port = free_port()
                backend, fronts = serve_multiproc(rec, "127.0.0.1", port, 4)
                try:
                    t0 = time.perf_counter()
                    wait_healthz(f"http://127.0.0.1:{port}")
                    fronts_up = time.perf_counter() - t0
                    s0 = dict(backend.coalescer.stats)
                    r = finish_load(start_load(f"http://127.0.0.1:{port}",
                                               64, HTTP_CLIENTS[64], 0,
                                               users))
                    res["64 clients, 4 fronts"] = load_summary(
                        r, old, f"{backbone} 64 clients, 4 fronts (up in "
                        f"{fronts_up:.2f} s)", card, s0,
                        dict(backend.coalescer.stats))
                    assert all(p.poll() is None for p in fronts)
                finally:
                    backend.close()
                    for p in fronts:
                        p.terminate()
                    for p in fronts:
                        p.wait(timeout=30)
                # (d) reloads
                dirs = http_checkpoints(torch, rec, cfg, tmp, csr)
                n_bytes = sum(p.numel() * p.element_size()
                              for p in rec.trainer.model.parameters())
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                code, body = get_json(base + "/reload", json.dumps(
                    {"ckpt_dir": dirs["same"]}).encode())
                quiet_s = time.perf_counter() - t0
                assert code == 200 and body["params_version"] == 1, body
                growth = torch.cuda.max_memory_allocated() - before
                after = torch.cuda.memory_allocated() - before
                log(f"http {backbone} quiet reload: {quiet_s:.3f} s, peak "
                    f"device memory growth {growth / 2**30:.3f} GiB against "
                    f"one parameter set of {n_bytes / 2**30:.3f} GiB "
                    f"({growth / n_bytes:.3f} sets), held after "
                    f"{after / 2**30:.3f} GiB [{card}]")
                assert rec.recommend(users[:64], k=20)[0].tolist() == \
                    want[:64].tolist(), "the same parameters moved the ids"
                # under 16 clients: every response is the old or the new
                # ids, and none fails; the fresh recommender's own start-up
                # launches are not the server's
                served = dict(S.LAUNCHES)
                fresh = Recommender.from_checkpoint(cfg, dirs["moved"], csr,
                                                    serve_batch=256)
                new = fresh.recommend(users, k=20)[0]
                S.LAUNCHES.update(served)
                del fresh
                gc.collect()
                torch.cuda.empty_cache()
                both = {int(u): [o[0], n.tolist()]
                        for (u, o), n in zip(old.items(), new)}
                s0 = dict(stats)
                load = start_load(base, 16, 0, HTTP_RELOAD_LOAD_S, users)
                time.sleep(HTTP_RELOAD_LOAD_S / 3)
                t_a = time.time()
                code, body = get_json(base + "/reload", json.dumps(
                    {"ckpt_dir": dirs["moved"]}).encode())
                t_b = time.time()
                assert code == 200 and body["params_version"] == 2, body
                r = finish_load(load)
                res["reload under 16 clients"] = load_summary(
                    r, both, f"{backbone} 16 clients across a reload", card,
                    s0, dict(stats), what="every response carries the ids "
                    "of the old or of the new parameters, none failed")
                during = [q[2] for q in r["requests"]
                          if q[1] < t_b and q[1] + q[2] / 1e3 > t_a]
                late = [q for q in r["requests"] if q[1] > t_b]
                assert late and all(q[3] == both[q[0]][1] for q in late), \
                    "a request after the reload got the old ids"
                changed = int(sum(o[0] != n.tolist()
                                  for o, n in zip(old.values(), new)))
                log(f"http {backbone} reload under 16 clients: "
                    f"{t_b - t_a:.3f} s, {len(during)} requests overlapped "
                    f"it, the longest {max(during, default=0.0):.3f} ms; "
                    f"{len(late)} requests after it all carry the ids of a "
                    f"fresh Recommender.from_checkpoint; {changed} of "
                    f"{len(users)} users' ids changed [{card}]")
                res["reload"] = {"quiet_s": quiet_s, "loaded_s": t_b - t_a,
                                 "longest_during_ms": max(during,
                                                          default=0.0),
                                 "peak_growth_bytes": growth,
                                 "param_bytes": n_bytes}
                # a checkpoint of another geometry: 409, the new ids stay
                code, body = get_json(base + "/reload", json.dumps(
                    {"ckpt_dir": dirs["other"]}).encode())
                assert code == 409 and "geometry" in body["error"], body
                health = get_json(base + "/healthz")[1]
                assert health["stats"]["params_version"] == 2
                assert rec.recommend(users[:64], k=20)[0].tolist() == \
                    new[:64].tolist()
                log(f"http {backbone}: another geometry's checkpoint got "
                    f"409 ({body['error'][:80]}...), params_version stays 2 "
                    f"and the loaded parameters keep serving")
                launches[backbone] = dict(S.LAUNCHES)
                log(f"http {backbone}: launches after start-up, "
                    f"{sum(res[k]['requests'] for k in res if 'clients' in k)}"
                    f" requests and 3 reloads {launches[backbone]}, AdamW "
                    f"{FA.LAUNCHES['fused_adamw']}")
                assert launches[backbone] == start
                assert FA.LAUNCHES["fused_adamw"] == 0
                if backbone == "lightGCN":
                    assert start == {"spmm_rows_fwd": 2, "spmm_rows_t": 2}
                    res["daemon_up_s"] = daemon_phase(
                        root, card, daemon_data(tmp, csr), dirs["moved"])
                else:
                    assert not any(start.values())
            finally:
                srv.shutdown()
                srv.server_close()
                thread.join(timeout=30)
            summary[backbone] = res
            del rec, srv
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = os.path.join(root, "chiprun_out", "torch_http.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"device": card, "backbones": summary}, fh, indent=1)
    return summary, launches["lightGCN"]


def variant_gates_phase(root, card, data_dir):
    """Phase 18: the legacy and ablation golden gates (3 seeds x 150
    epochs of DNN at OneHotMatrix 0, parity_run.py's recipe on the phase-8
    set), judged by the unchanged benchmarks/golden_parity.py against
    docs/parity_data/ref_{legacy,ablation}_s*.json and, pooled with them,
    the JAX package's recorded runs (VARIANT_GATES). Returns the K1
    launches by gate."""
    gates, failed = {}, []
    tmp = tempfile.mkdtemp(prefix="gdmcf_variants_")
    try:
        for variant, pattern, jax in VARIANT_GATES:
            t0 = time.perf_counter()
            ours, gates[variant] = run_gate(
                root, card, f"variant_{variant}", data_dir,
                GOLDEN_EPOCHS, dict(VARIANT_RECIPE, diffusion_variant=variant))
            if judge_gate(root, tmp, variant, ours, pattern,
                          jax)["parity"] is not True:
                failed.append(variant)
            log(f"gate {variant}: {time.perf_counter() - t0:.1f} s, "
                f"fused_adamw launches {gates[variant]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not failed, f"variant gates failed: {failed}"
    return gates


def variant_epochs_phase(root, card, torch, csr):
    """Phase 18, second part: one train_epoch (272 steps) of DNN at
    OneHotMatrix 0 under each variant at the Amazon-Book width, 6 AdamW
    launches a step, then one served batch with the request checks."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.trainer import Trainer

    dataset = NativeCSR.from_scipy(csr)
    launches = {}
    for variant in ("legacy", "ablation"):
        cfg = load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                          {"device": "cuda", "backbone": "DNN",
                           "OneHotMatrix": 0, "diffusion_variant": variant})
        trainer = Trainer(cfg, N_USER, N_ITEM)
        state = trainer.init_state()
        assert trainer.diffusion.variant == variant
        before = {k: p.detach().clone() for k, p in state.params.items()}
        FA.reset_launch_counts()
        S.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, total = trainer.train_epoch(state, dataset,
                                           np.random.default_rng(0))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches[variant] = FA.LAUNCHES["fused_adamw"]
        steps = N_USER // cfg.batch_size   # 272
        assert state.step == steps and np.isfinite(total)
        assert launches[variant] == 6 * steps, launches
        assert not any(S.LAUNCHES.values())
        for k, p in state.params.items():
            assert bool((p.detach() != before[k]).any()), f"{k} did not move"
        del before
        FA.reset_launch_counts()
        rec = build_recommender(cfg, None, csr, N_USER, N_ITEM,
                                trainer=trainer, serve_batch=256, k_max=100)
        check_requests(rec, csr, N_ITEM, f"DNN {variant}")
        assert FA.LAUNCHES["fused_adamw"] == 0
        log(f"DNN {variant} train_epoch at the Amazon-Book width: {steps} "
            f"steps in {epoch_s:.2f} s, loss sum {total:.6e}, fused_adamw "
            f"launches {launches[variant]} (6 a step) [{card}]")
        del rec, trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def fresh_seed_gates(root, card, torch):
    """--fresh-seed-gates: the LightGCN gate (phase 13, dense and hybrid)
    at FRESH_LGN_SEEDS and G4 (DNN at OneHotMatrix 0) at FRESH_G4_SEEDS,
    judged against the same bands as in phases 13 and 16 (G4 against the
    reference alone and pooled with the JAX package's runs). Reports the
    verdicts; fails only if a run does not complete."""
    from gdmcf_torch.data.loader import generate_synthetic_dataset

    results = lightgcn_gate_phase(root, card, torch, seeds=FRESH_LGN_SEEDS,
                                  out_name="torch_lightgcn_parity_fresh.json",
                                  require=False)
    for mode, res in results.items():
        log(f"fresh seeds {list(FRESH_LGN_SEEDS)}, LightGCN gate {mode}: "
            f"parity {res['parity']} " + json.dumps(res["checks"]))
    tmp = tempfile.mkdtemp(prefix="gdmcf_fresh_")
    try:
        data = os.path.join(tmp, "round3")
        generate_synthetic_dataset(data, **ROUND3_GATE_SET)
        label, _, cfg_kw, epochs, pattern, (name, _) = BACKBONE_GATES[3]
        ours, launches = run_gate(root, card, f"{label}_fresh", data,
                                  epochs, cfg_kw, seeds=FRESH_G4_SEEDS)
        refs = parity_refs(root, pattern)
        alone = golden_parity(root, ours, refs)
        pooled = golden_parity(root, ours, refs + split_runs(
            os.path.join(root, "docs", "parity_data", name),
            tempfile.mkdtemp(dir=tmp)))
        log(f"fresh seeds {list(FRESH_G4_SEEDS)}, G4 against {pattern} "
            f"alone: " + json.dumps(alone))
        log(f"fresh seeds {list(FRESH_G4_SEEDS)}, G4 against {pattern} and "
            f"{name} pooled: " + json.dumps(pooled))
        log(f"fresh-seed verdicts: LightGCN dense "
            f"{results['dense']['parity']}, hybrid "
            f"{results['hybrid']['parity']}; G4 reference-only "
            f"{alone['parity']}, pooled {pooled['parity']}; G4 K1 launches "
            f"{launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def precision_pairs(root, card, torch):
    """--precision-pairs: G4 (round-3 set) at seeds 0-5 and the legacy
    gate (phase-8 set) at seeds 0-2, each seed run with TF32 matmuls (the
    default compute_dtype bfloat16) and in full float32 (compute_dtype
    float32), everything else equal (the same seed draws the same numbers
    on the card): the tail losses side by side, and each precision's
    verdict against the reference's band."""
    from gdmcf_torch.data.loader import generate_synthetic_dataset

    tmp = tempfile.mkdtemp(prefix="gdmcf_pairs_")
    try:
        sets = {"round3": os.path.join(tmp, "round3"),
                "golden": os.path.join(tmp, "golden")}
        generate_synthetic_dataset(sets["round3"], **ROUND3_GATE_SET)
        generate_synthetic_dataset(sets["golden"], seed=0)
        for label, data, cfg_kw, pattern, seeds in (
                ("G4_oh0", "round3", BACKBONE_GATES[3][2], "ref_oh0_s*.json",
                 (0, 1, 2, 3, 4, 5)),
                ("legacy", "golden", dict(VARIANT_RECIPE,
                                          diffusion_variant="legacy"),
                 "ref_legacy_s*.json", GOLDEN_SEEDS)):
            tails = {}
            for dtype in ("bfloat16", "float32"):
                ours, _ = run_gate(root, card, f"{label}_{dtype}",
                                   sets[data], GOLDEN_EPOCHS,
                                   dict(cfg_kw, compute_dtype=dtype),
                                   seeds=seeds)
                verdict = golden_parity(root, ours, parity_refs(root, pattern))
                with open(ours) as fh:
                    # golden_parity.py's tail: the last quarter's mean
                    tails[dtype] = [float(np.mean(r["losses"][-max(
                        1, int(len(r["losses"]) * 0.25)):]))
                        for r in json.load(fh)["runs"]]
                log(f"precision pairs {label}, compute_dtype {dtype} (TF32 "
                    f"{'on' if dtype == 'bfloat16' else 'off'}): tail losses "
                    f"{[round(t, 4) for t in tails[dtype]]}, against "
                    f"{pattern}: " + json.dumps(verdict["checks"]))
            diff = np.array(tails["bfloat16"]) - np.array(tails["float32"])
            log(f"precision pairs {label}: TF32 minus float32 tail loss by "
                f"seed {[round(float(d), 4) for d in diff]}, mean "
                f"{float(diff.mean()):.4f} [{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 19: (dp, mp) meshes of ranks sharing the one card over gloo
def master_pass(FA, torch, state, grads, lr):
    """Phase 20 (a): the K1 master form on clones of every bfloat16 tensor
    of ``state`` (twice, from the same inputs, on two sets of clones)
    against adamw_master_reference within master_update_bounds. Returns
    (the largest error, the tensors over their bounds, one set of updated
    clones as a FusedAdamWState and its params, bitwise equal)."""
    opt = state.opt_state
    count = opt.count + 1
    c = FA.step_scalars(count, lr)

    def clones():
        return ({k: p.detach().clone() for k, p in state.params.items()},
                {k: m.clone() for k, m in opt.mu.items()},
                {k: m.clone() for k, m in opt.nu.items()},
                {k: m.clone() for k, m in opt.master.items()})
    runs = [clones(), clones()]
    for p, mu, nu, m in runs:
        for k in p:
            FA.adamw_master_update_(p[k], grads[k], mu[k], nu[k], m[k], c)
    torch.cuda.synchronize()
    twice = all(torch.equal(a[k], b[k]) for a, b in zip(*runs) for k in a)
    err, over = 0.0, 0
    p, mu, nu, m = runs[0]
    for k, p0 in state.params.items():
        args_k = (p0.detach(), grads[k], opt.mu[k], opt.nu[k], opt.master[k],
                  c)
        want = FA.adamw_master_reference(*args_k)
        bounds = FA.master_update_bounds(*args_k)
        e, o = leaf_errors((p[k], mu[k], nu[k], m[k]), want, bounds)
        err, over = max(err, e), over + o
        del want, bounds
    del runs[1]
    st = FA.FusedAdamWState(count=opt.count.clone(), mu=mu, nu=nu, master=m)
    return err, over, twice, st, p


def precision_phase(root, card, torch, csr):
    """Phase 20: bfloat16 parameter storage with float32 masters at the
    Amazon-Book width (configs/amazonOneEmbGcn.yaml on the phase-6 graph,
    host_dense as in phase 6). (b) one train_epoch under bf16_weights
    BF16_SEL, then one under param_dtype bfloat16 with prefetch_batches 2,
    each checked (finite losses, every tensor moved, storage dtypes and
    masters as selected, each stored tensor its master's rounding, K1
    launches by form, the epoch's mean loss within BF16_LOSS_BAND of phase
    6's float32 epoch) and timed (epoch, step p50/p90, peak memory);
    (a) the K1 master form on the 13 tensors against its plain version;
    (c) a checkpoint of the param_dtype run, its round trip bitwise with
    the masters, build_recommender from it answering with the in-memory
    trainer's ids, request p50; (d) one step under the NT-Xent remat form
    against the softmax form; (e) the epoch at prefetch_batches 0; (f)
    three steps inside utils.profiling.trace, the trace under
    chiprun_out/. Returns (the kernel entry of the master form, the plain
    form's launches in (b))."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.models import layers as TL
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer
    from gdmcf_torch.utils.profiling import TRACE_FILE, trace

    yaml = os.path.join(root, "configs", "amazonOneEmbGcn.yaml")
    dataset = NativeCSR.from_scipy(csr)
    steps = N_USER // 400
    f32_mean = PHASE6["mean_loss"]
    log(f"float32 epoch (phase 6): {PHASE6['epoch_s']:.2f} s, mean loss "
        f"{f32_mean:.6e}, step p50 {PHASE6['p50']:.3f} ms, p90 "
        f"{PHASE6['p90']:.3f} ms, peak {PHASE6['peak_gib']:.2f} GiB [{card}]")
    launches = {"fused_adamw": 0, "fused_adamw_master": 0}
    bf16 = torch.bfloat16
    trainer = state = None
    for label, kw in (("bf16_weights", {"bf16_weights": BF16_SEL}),
                      ("param_dtype", {"param_dtype": "bfloat16",
                                       "prefetch_batches": 2})):
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = load_config(yaml, dict(device="cuda", **kw))
        trainer = Trainer(cfg, N_USER, N_ITEM)
        state = trainer.init_state()
        stored = {k for k, p in state.params.items() if p.dtype == bf16}
        want = (set(state.params) if cfg.param_dtype == "bfloat16" else
                {"embedding_item", "in_layers.0.weight", "in_layers.0.bias"})
        assert stored == want == set(state.opt_state.master), stored
        assert len(state.params) == 13
        assert all(m.dtype == torch.float32
                   for m in state.opt_state.master.values())
        before = {k: p.detach().clone() for k, p in state.params.items()}
        FA.reset_launch_counts()
        S.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, total = trainer.train_epoch(state, dataset,
                                           np.random.default_rng(0))
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        got = dict(FA.LAUNCHES)
        assert not any(S.LAUNCHES.values())
        assert state.step == steps == 272
        assert got == {"fused_adamw": (13 - len(stored)) * steps,
                       "fused_adamw_master": len(stored) * steps}, got
        for k in launches:
            launches[k] += got[k]
        mean = total / steps
        assert np.isfinite(total), f"a {label} loss is not finite"
        off = mean / f32_mean - 1.0
        # a bfloat16 tensor moves through its master (lr-sized steps may
        # stay under the storage's ulp) and is stored as its rounding; while
        # a bfloat16 sumW is still exactly 1 the blend gives the GCN no
        # weight and no gradient (in the JAX package too)
        gcn_off = bool(state.params["sumW"].detach() == 1.0)
        still = []
        for k, p in state.params.items():
            now = state.opt_state.master[k] if k in stored else p.detach()
            if not bool((now != before[k].to(now.dtype)).any()):
                still.append(k)
            if k in stored:
                assert torch.equal(p.detach(), now.to(bf16)), k
        allowed = ({k for k in state.params if k.startswith("gcn.")}
                   if gcn_off and "sumW" in stored else set())
        assert set(still) <= allowed, f"did not move: {still}"
        del before
        p50, p90 = step_times(trainer, state,
                              train_stream(dataset, cfg.batch_size), torch)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"{label} epoch: {epoch_s:.2f} s ({steps} steps of "
            f"{cfg.batch_size}, prefetch_batches {cfg.prefetch_batches}), "
            f"mean loss {mean:.6e} ({off:+.4%} against float32, band "
            f"{BF16_LOSS_BAND:.0%}); bfloat16 tensors {len(stored)} of 13 "
            f"with float32 masters, every tensor moved"
            f"{f' but {still} (sumW stored at 1.0)' if still else ''}; "
            f"sumW {float(state.params['sumW'].detach()):.6f}; K1 launches {got}; "
            f"step p50 {p50:.3f} "
            f"ms, p90 {p90:.3f} ms; peak {peak:.2f} GiB [{card}]")
        assert abs(off) <= BF16_LOSS_BAND, \
            f"{label} epoch mean loss off the float32 one by {off:.4%}"

    # (a) the master form against its plain version on the 13 tensors
    batches = train_stream(dataset, cfg.batch_size, seed=7)
    x, idx = (torch.from_numpy(a) for a in next(batches))
    _, grads, _ = trainer.loss_and_grads(state, x, idx)
    err, over, twice, st, p1 = master_pass(FA, torch, state, grads, cfg.lr)
    n = sum(p.numel() for p in state.params.values())
    assert n == FLAGSHIP_PARAMS, n
    pass_ms = cuda_ms(lambda: FA.fused_adamw_apply(p1, grads, st,
                                                   lr=cfg.lr),
                      iters=10, warmup=2)
    opt = state.opt_state
    cc = FA.step_scalars(opt.count + 1, cfg.lr)
    plain_ms = cuda_ms(lambda: [FA.adamw_master_reference(
        state.params[k].detach(), grads[k], opt.mu[k], opt.nu[k],
        opt.master[k], cc) for k in state.params], iters=3, warmup=1)
    mu_b = next(iter(opt.mu.values())).element_size()
    per_elem = 4 + 4 + 2 + 2 + 4 * mu_b   # master r/w, g, p write, moments
    bound_bytes = per_elem * n / HBM_BYTES_PER_S * 1e3
    bound_ops = ADAMW_FLOP_PER_ELEM * n / F32_FLOP_PER_S * 1e3
    log(f"fused_adamw_master on the 13 flagship tensors: max|kernel-plain| "
        f"{err:.3e}, {over} over master_update_bounds; two launches bitwise "
        f"equal {twice}; {pass_ms:.4f} ms per pass, plain {plain_ms:.4f} "
        f"ms, byte bound {bound_bytes:.4f} ms ({per_elem} B x {n} elements "
        f"at 3.35 TB/s), operation bound {bound_ops:.4f} ms; no PyTorch call"
        f" computes this update [{card}]")
    assert over == 0 and twice, "the K1 master form disagrees"
    del st, p1, grads
    gc.collect()
    torch.cuda.empty_cache()
    entry = {
        "name": "fused_adamw_master", "route": "triton",
        "source": "gdmcf_torch/ops/fused_adamw.py",
        "replaces": tpu_kernel_line(root, "_adamw_kernel", "fused_adamw.py"),
        "replaces_branch": "the master branch of fused_adamw_apply, "
                           + jax_source_line(root, "fused_adamw.py",
                                             "if s in masters:"),
        "launches": launches["fused_adamw_master"],
        "max_abs_err": err, "ms": pass_ms, "ms_per_launch": pass_ms / 13,
        "launches_per_pass": 13, "plain_ms": plain_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
        "library": "none: no PyTorch call updates a float32 master and "
                   "writes its bfloat16 rounding",
    }

    # (c) a checkpoint of the param_dtype run: the round trip, serving
    tmp = tempfile.mkdtemp(prefix="gdmcf_bf16_")
    try:
        ck_dir = os.path.join(tmp, "ckpt")
        ck = Checkpointer(ck_dir, max_to_keep=1)
        t0 = time.perf_counter()
        ck.save(state)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(ck_dir, f"ckpt_{state.step}.pt"))
        rec_ckpt = build_recommender(cfg, ck_dir, csr, N_USER, N_ITEM,
                                     serve_batch=256, k_max=100)
        template = rec_ckpt.trainer.init_state()
        t0 = time.perf_counter()
        restored = Checkpointer(ck_dir).restore(template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ropt = restored.opt_state
        pairs = [("count", opt.count, ropt.count),
                 ("lt.history", state.lt.history, restored.lt.history),
                 ("generator", state.generator.get_state(),
                  restored.generator.get_state())]
        for key, a, b in (("p", state.params, restored.params),
                          ("mu", opt.mu, ropt.mu), ("nu", opt.nu, ropt.nu),
                          ("master", opt.master, ropt.master)):
            assert set(a) == set(b), key
            pairs += [(f"{key}.{k}", a[k].detach(), b[k].detach()) for k in a]
        for name, a, b in pairs:
            assert a.dtype == b.dtype and torch.equal(a, b), \
                f"round trip differs in {name}"
        del template, restored
        rec_live = build_recommender(cfg, None, csr, N_USER, N_ITEM,
                                     trainer=trainer, serve_batch=256,
                                     k_max=100)
        users = np.random.default_rng(5).choice(N_USER, 256, replace=False)
        want_ids, _ = rec_live.recommend(users, k=100)
        got_ids, _ = rec_ckpt.recommend(users, k=100)
        assert np.array_equal(got_ids, want_ids), \
            "the bfloat16 checkpoint serves other ids than the trainer"
        check_requests(rec_ckpt, csr, N_ITEM, "param_dtype bfloat16")
        log(f"param_dtype checkpoint: {len(pairs)} tensors bitwise equal "
            f"after the round trip (params, moments, masters, Lt ring, "
            f"generator); save {save_s:.2f} s, {size / 2**30:.2f} GiB, "
            f"restore {restore_s:.2f} s; build_recommender from it serves "
            f"the in-memory trainer's ids for 256 users, k 100 [{card}]")
        request_times(rec_ckpt, users, card, "param_dtype bfloat16 flagship")
        del rec_ckpt, rec_live
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) one step under the NT-Xent remat form against the softmax form
    gen = state.generator.get_state()
    out = {}
    for form in ("softmax", "remat"):
        TL._NT_XENT_IMPL = form
        state.generator.set_state(gen)
        loss, grads, _ = trainer.loss_and_grads(state, x, idx)
        out[form] = (loss, grads)
    TL._NT_XENT_IMPL = "auto"
    (l_s, g_s), (l_r, g_r) = out["softmax"], out["remat"]
    same = sum(torch.equal(g_s[k], g_r[k]) for k in g_s)
    worst = max(float((g_s[k].float() - g_r[k].float()).abs().max()
                      / g_s[k].float().abs().max().clamp_min(1e-30))
                for k in g_s)
    log(f"NT-Xent remat against softmax, one flagship step: loss "
        f"{l_r.item():.6e} / {l_s.item():.6e}, {same} of {len(g_s)} "
        f"gradients bitwise equal, the largest difference {worst:.3e} of "
        f"its tensor's largest gradient")
    assert abs(l_r.item() / l_s.item() - 1) <= 1e-6
    assert worst <= float(torch.finfo(bf16).eps)
    del out, g_s, g_r
    state.generator.set_state(gen)

    # (e) the same epoch with prefetch_batches 0: epoch time only
    epochs = {}
    for depth in (0, 2):
        trainer.cfg.prefetch_batches = depth
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, total = trainer.train_epoch(state, dataset,
                                           np.random.default_rng(0))
        torch.cuda.synchronize()
        epochs[depth] = time.perf_counter() - t0
        assert np.isfinite(total)
    log(f"param_dtype epoch, prefetch_batches 0: {epochs[0]:.2f} s, 2: "
        f"{epochs[2]:.2f} s [{card}]")

    # (f) three steps inside utils.profiling.trace
    out_dir = os.path.join(root, "chiprun_out", "bf16_trace")
    pre = [next(batches) for _ in range(3)]
    with trace(out_dir) as prof:
        for xb, ib in pre:
            trainer.train_step(state, torch.from_numpy(xb),
                               torch.from_numpy(ib))
    path = os.path.join(out_dir, TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    adamw = sum("_adamw_kernel" in e.get("name", "") for e in kernels)
    dev_us = sum(getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
                 for e in prof.key_averages())
    log(f"profiling.trace of 3 param_dtype steps: {path} "
        f"({os.path.getsize(path)} B, {len(events)} events, "
        f"{len(kernels)} device kernels, {adamw} of them K1's)")
    log(f"  device time in its key_averages: {dev_us / 1e3:.3f} ms")
    assert any(e.get("name", "").startswith("aten::") for e in events)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return entry, launches["fused_adamw"]


MESHES = ((2, 1), (1, 2), (2, 2))
MESH_STEPS = 3
MESH_EVAL_USERS = 4_000        # the evaluate_streaming split's users
MESH_LOSS_RTOL = 2e-4          # tests/test_sharding.py's tolerances
MESH_PARAMS = dict(rtol=5e-3, atol=1e-5)
# float32 (TF32 off on both sides): an element past MESH_PARAMS passes only
# when, at one of the steps, both runs' gradients of it were under
# MESH_FLOOR, AdamW's eps, and not both exactly zero: a sum of 400 rows
# that cancels to float32's rounding floor. Under eps AdamW moves a
# parameter in proportion to its gradient (g / (|g| + eps) of lr at the
# first step), so two roundings of such a sum, often of opposite signs,
# move it by a share of lr apart. (A gradient that is zero in both runs
# moves the parameter alike in both.) Such excused elements may be at most
# MESH_EXCUSED_SHARE of a rank's tensor: the geometric mean of
# --mesh-diagnostic's readings, 1.39e-7 without a fault ((2,1)) and 3.90e-5
# with the user table's gradient dropped on (2,2) (PERF.md §6).
MESH_FLOOR = 1e-8
MESH_EXCUSED_SHARE = 2.3e-6
# TF32 on (the configured compute_dtype bfloat16) on both sides: TF32 keeps
# 10 bits of each GEMM input's mantissa, so inputs that differ in float32's
# last bits (a 200-row block, a split contraction) may round apart; the
# share of each rank's tensor past MESH_PARAMS is held under
# MESH_TF32_SHARE, the geometric mean of --mesh-diagnostic's readings on
# (2,2): 2.728e-4 without a fault, 8.766e-3 with the user table's gradient
# dropped (PERF.md §6)
MESH_TF32 = (2, 2)
MESH_TF32_SHARE = 1.5e-3
MESH_CLOSE = 1.01e-4           # one unit of the metrics' 4-decimal rounding
MESH_TIE = 1e-5                # a swapped pair's single-process score gap
MESH_RANK_TIMEOUT = 420        # every rank exits by then, or is killed
MESH_CKPT = (2, 2)


def fingerprint(torch, t):
    """Two int64 sums of a tensor's bit patterns (plain and position
    weighted): equal fingerprints of equal-shape tensors mean equal bits
    short of a deliberate collision."""
    t = t.detach().contiguous().reshape(-1)
    bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    b = bits.long()
    w = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return [int(b.sum()), int((b * w).sum())]


def compare_ids(ids, ref):
    """(tie pairs, other differences) of top-k ids against a single-process
    run's ``ref`` ({"ids", "scores"}): a differing position is a tie pair
    when the single process scored its two ids within MESH_TIE."""
    ties = bad = 0
    for r, j in (ids.cpu() != ref["ids"]).nonzero().tolist():
        gap = abs(float(ref["scores"][r, ids[r, j]])
                  - float(ref["scores"][r, ref["ids"][r, j]]))
        ties, bad = (ties + 1, bad) if gap < MESH_TIE else (ties, bad + 1)
    return ties, bad


def mesh_config(root, tmp, **kw):
    from gdmcf_torch.config import load_config

    meta = json.load(open(os.path.join(tmp, "mesh_inputs.json")))
    return load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                       dict(meta["cfg"], **kw))


def floor_bits(torch, g, s):
    """Step ``s``'s bits of a gradient: bit s where it is under MESH_FLOOR,
    bit 3 + s where it is exactly zero."""
    tiny = (g.abs() < MESH_FLOOR).to(torch.uint8) << s
    return tiny | ((g == 0).to(torch.uint8) << (3 + s))


def at_floor(torch, single, mesh):
    """Elements at the rounding floor at one of the steps, from both runs'
    ``floor_bits``: under the floor in both, not zero in both."""
    out = torch.zeros_like(single, dtype=torch.bool)
    for s in range(MESH_STEPS):
        tiny = ((single >> s) & (mesh >> s) & 1).bool()
        zero = ((single >> (3 + s)) & (mesh >> (3 + s)) & 1).bool()
        out |= tiny & ~zero
    return out


def mesh_reference(torch, trainer, data, users, tmp, tag, bits: bool):
    """MESH_STEPS single-process steps on the card: writes the parameters
    after them (``ref_<tag>.pt``) and, with ``bits``, each gradient's
    ``floor_bits`` (``bits_<tag>.pt``); returns the losses."""
    state = trainer.init_state()
    losses, codes = [], {}
    for s in range(MESH_STEPS):
        loss, grads, lt = trainer.loss_and_grads(
            state, torch.from_numpy(data.gather_packed(users[s])),
            torch.from_numpy(users[s]))
        if bits:
            for k, g in grads.items():
                b = floor_bits(torch, g, s)
                codes[k] = codes[k] | b if k in codes else b
        state = trainer.apply_grads(state, grads, lt)
        losses.append(float(loss))
    torch.save({k: p.detach().cpu() for k, p in state.params.items()},
               os.path.join(tmp, f"ref_{tag}.pt"))
    if bits:
        torch.save({k: c.cpu() for k, c in codes.items()},
                   os.path.join(tmp, f"bits_{tag}.pt"))
    return losses


def mesh_steps(torch, trainer, cfg, tmp, tag, dp, mp, rank, fault="",
               noise=None):
    """MESH_STEPS train steps of this rank's dp block of the single-process
    batches, then each trainable tensor against the single-process run's
    (``ref_<tag>.pt``): [elements past MESH_PARAMS, elements, largest
    difference in lr, and with ``bits_<tag>.pt``: those past it not at the
    floor, those at the floor]. ``fault`` plants one for --mesh-diagnostic:
    ``lookup`` drops the user table's gradient, ``dp`` leaves
    ``in_layers.0.weight``'s gradient out of the dp all-reduce. ``noise``:
    (name, tensor) -> a mask of elements whose gradient is rounding noise
    in exact arithmetic, left out of the count and reported as their
    largest difference in lr (``noise_lr``)."""
    import scipy.sparse as sp

    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.parallel import collectives
    from gdmcf_torch.parallel.sharding import local_block, shard_of

    users = np.load(os.path.join(tmp, "mesh_users.npy"))
    data = NativeCSR.from_scipy(sp.load_npz(os.path.join(tmp, "train.npz")))
    block = cfg.batch_size // dp
    lo = (rank // mp) * block
    state = trainer.init_state()

    def mine(t, p):   # this rank's block of a whole tensor, on the card
        if shard_of(p) is not None:
            t = local_block(t, shard_of(p))
        return t.to(p.device)

    with_bits = os.path.exists(os.path.join(tmp, f"bits_{tag}.pt"))
    if with_bits:
        ref_bits = torch.load(os.path.join(tmp, f"bits_{tag}.pt"), mmap=True,
                              weights_only=True)
        ref_bits = {k: mine(ref_bits[k], p) for k, p in state.params.items()}
        bits = {}
    if fault == "dp":
        shape = state.params["in_layers.0.weight"].shape
        reduce = collectives.all_reduce_
        collectives.all_reduce_ = (
            lambda x, group, op=torch.distributed.ReduceOp.SUM:
            None if x.shape == shape else reduce(x, group, op))
    losses, launches, step_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for s in range(MESH_STEPS):
        u = users[s][lo:lo + block]
        x = torch.from_numpy(data.gather_packed(u))
        FA.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, lt = trainer.loss_and_grads(state, x,
                                                 torch.from_numpy(u))
        if fault == "lookup":
            grads["embedding_user"].zero_()
        state = trainer.apply_grads(state, grads, lt)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(FA.LAUNCHES["fused_adamw"])
        if with_bits:
            for k, g in grads.items():
                b = floor_bits(torch, g, s)
                bits[k] = bits[k] | b if k in bits else b
        del grads
    ref = torch.load(os.path.join(tmp, f"ref_{tag}.pt"), mmap=True,
                     weights_only=True)
    share, report, noise_lr = 0.0, {}, 0.0
    for k, p in state.params.items():
        want = mine(ref[k], p)
        diff = (p.detach() - want).abs()
        ratio = diff / (MESH_PARAMS["atol"]
                        + MESH_PARAMS["rtol"] * want.abs())
        if noise is not None:
            mask = noise(k, p)
            if bool(mask.any()):
                noise_lr = max(noise_lr, float(diff[mask].max()) / cfg.lr)
            ratio = ratio.masked_fill(mask, 0.0)
        share = max(share, float(ratio.max()))
        past = ratio >= 1
        report[k] = [int(past.sum()), p.numel(), float(diff.max()) / cfg.lr]
        if with_bits:
            floor = at_floor(torch, ref_bits[k], bits[k])
            report[k] += [int((past & ~floor).sum()), int(floor.sum())]
    return dict(losses=losses, launches=launches, step_ms=step_ms,
                local_tensors=len(state.params), param_share=share,
                param_report=report, noise_lr=noise_lr,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30), state


def mesh_worker(argv) -> int:
    """One rank of a phase-19 world (``--mesh-worker KIND DP MP DIR
    [FAULT]``), started under the env contract of
    ``multihost.initialize``; writes ``DIR/<KIND>_<DP>x<MP>_rank<r>.json``.
    KIND: ``flagship`` (float32: placements, evaluations, steps, the
    checkpoint), ``f32`` or ``tf32`` (the steps alone, in float32 or at the
    configured compute_dtype bfloat16) or ``lightgcn``."""
    import faulthandler

    kind, dp, mp, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    fault = argv[4] if len(argv) > 4 else ""
    faulthandler.dump_traceback_later(MESH_RANK_TIMEOUT, exit=True)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import scipy.sparse as sp
    import torch

    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.parallel import multihost
    from gdmcf_torch.parallel.sharding import describe, full_tensor, shard_of
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    multihost.initialize(backend="gloo", device="cuda")
    rank, world = multihost.process_index(), multihost.process_count()
    torch.cuda.set_device(0)
    meta = json.load(open(os.path.join(tmp, "mesh_inputs.json")))
    train = sp.load_npz(os.path.join(tmp, "train.npz")).tocsr()
    out = {"rank": rank}
    cfg_kw = dict(mesh_dp=dp, mesh_mp=mp, device="cuda:0")
    if kind == "lightgcn":
        cfg = mesh_config(root, tmp, backbone="lightGCN",
                          compute_dtype="bfloat16", **cfg_kw)
        S.reset_launch_counts()
        trainer = Trainer(cfg, N_USER, N_ITEM, train_csr=train)
        out["startup_launches"] = dict(S.LAUNCHES)
        users = np.load(os.path.join(tmp, "lgn_users.npy"))
        rows = torch.from_numpy(NativeCSR.from_scipy(train).gather_packed(
            users)).cuda()
        gen = torch.Generator("cuda").manual_seed(cfg.random_seed + 12345)
        ids = trainer.eval_step(rows, torch.from_numpy(users).cuda(), rows,
                                sampling_steps=cfg.sampling_steps,
                                top_k=100, generator=gen)
        ties, bad = compare_ids(ids, torch.load(
            os.path.join(tmp, "lgn_ref.pt"), weights_only=True))
        out.update(tie_pairs=ties, other_differences=bad,
                   frozen_user_local=list(trainer.model.frozen_lgn_user.shape))
    elif kind in ("f32", "tf32"):
        cfg = mesh_config(root, tmp, **cfg_kw, compute_dtype={
            "f32": "float32", "tf32": "bfloat16"}[kind])
        trainer = Trainer(cfg, N_USER, N_ITEM)
        steps, _ = mesh_steps(torch, trainer, cfg, tmp, kind, dp, mp, rank,
                              fault)
        out.update(steps)
    else:
        cfg = mesh_config(root, tmp, **cfg_kw)
        trainer = Trainer(cfg, N_USER, N_ITEM)
        out["placements"] = {
            k: f"{describe(v)} local {list(trainer.model.state_dict()[k].shape)}"
            for k, v in trainer.placements.items()}
        # evaluation at the seeded init, dp-sharded then replicated
        valid = sp.load_npz(os.path.join(tmp, "valid.npz")).tocsr()
        n_eval = meta["eval_users"]
        tr_e = NativeCSR.from_scipy(train[:n_eval])
        va_e = NativeCSR.from_scipy(valid[:n_eval], strict=False)
        for name, repl in (("eval_sharded", False), ("eval_replicated", True)):
            trainer.cfg.eval_replicated = repl
            t0 = time.perf_counter()
            out[name] = trainer.evaluate_streaming(None, [tr_e], va_e, [tr_e],
                                                   cfg.topN)
            out[name + "_s"] = time.perf_counter() - t0
        trainer.cfg.eval_replicated = False
        # one eval batch of 400 users at the init: this rank's dp block
        # under its row block, the ids gathered over dp
        from gdmcf_torch.parallel.collectives import all_gather_list
        from gdmcf_torch.parallel.mesh import axis_group

        users = np.load(os.path.join(tmp, "lgn_users.npy"))
        block = len(users) // dp
        u = users[(rank // mp) * block:(rank // mp + 1) * block]
        rows = torch.from_numpy(NativeCSR.from_scipy(train).gather_packed(
            u)).cuda()
        gen = torch.Generator("cuda").manual_seed(cfg.random_seed + 12345)
        ids = trainer.eval_step(rows, torch.from_numpy(u).cuda(), rows,
                                sampling_steps=cfg.sampling_steps,
                                top_k=100, generator=gen,
                                block=trainer.row_block(block))
        ids = torch.cat(all_gather_list(ids, axis_group(trainer.mesh, "dp")))
        out["eval_ties"], out["eval_other"] = compare_ids(ids, torch.load(
            os.path.join(tmp, "flagship_ref.pt"), weights_only=True))
        # float64 host vectors travel bit-exactly
        vec = np.array([rank + 1.0 / 3.0, 5e-324, -0.0, 1e300 * (rank + 1),
                        np.pi * rank])
        got = multihost.allgather_host_vectors(vec)
        want = np.stack([np.array([r + 1.0 / 3.0, 5e-324, -0.0,
                                   1e300 * (r + 1), np.pi * r])
                         for r in range(world)])
        out["host_vectors_bit_exact"] = (got.view(np.uint64).tolist()
                                         == want.view(np.uint64).tolist())
        # the single-process run's batches: this rank's dp block of each
        steps, state = mesh_steps(torch, trainer, cfg, tmp, "f32", dp, mp,
                                  rank, fault)
        out.update(steps)
        if [dp, mp] == list(MESH_CKPT):
            Checkpointer(os.path.join(tmp, "ckpt"), max_to_keep=1).save(state)
            fps = {"step": state.step,
                   "lt_history": fingerprint(torch, state.lt.history),
                   "lt_count": fingerprint(torch, state.lt.count)}
            for k, p in state.params.items():
                sh = shard_of(p)
                fps[f"params.{k}"] = fingerprint(torch, full_tensor(p))
                fps[f"mu.{k}"] = fingerprint(
                    torch, full_tensor(state.opt_state.mu[k], sh))
                fps[f"nu.{k}"] = fingerprint(
                    torch, full_tensor(state.opt_state.nu[k], sh))
            out["fingerprints"] = fps
    with open(os.path.join(tmp, f"{kind}_{dp}x{mp}_rank{rank}.json"),
              "w") as fh:
        json.dump(out, fh)
    multihost.sync_hosts()
    torch.distributed.destroy_process_group()
    return 0


def start_world(kind, dp, mp, tmp, fault=""):
    """Start the dp * mp ranks of a world; returns their processes."""
    port = free_port()
    procs = []
    for rank in range(dp * mp):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(dp * mp), PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="2")
        logf = open(os.path.join(tmp, f"{kind}_{dp}x{mp}_rank{rank}.log"),
                    "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-worker",
             kind, str(dp), str(mp), tmp, fault], env=env, stdout=logf,
            stderr=subprocess.STDOUT))
        logf.close()
    return procs


def finish_world(kind, dp, mp, tmp, procs):
    """Wait for a world (every rank is killed past the timeout) and return
    the ranks' results; a failed rank prints every rank's log and raises."""
    deadline = time.time() + MESH_RANK_TIMEOUT + 30
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        for r in range(len(procs)):
            with open(os.path.join(tmp, f"{kind}_{dp}x{mp}_rank{r}.log")) as fh:
                log(f"--- {kind} ({dp},{mp}) rank {r} "
                    f"(exit {procs[r].returncode}):\n{fh.read()[-4000:]}")
        raise RuntimeError(f"mesh world {kind} ({dp},{mp}) failed")
    return [json.load(open(os.path.join(
        tmp, f"{kind}_{dp}x{mp}_rank{r}.json"))) for r in range(len(procs))]


def mesh_inputs(csr, tmp):
    """The phase-19 inputs in ``tmp``: the splits, the batches' users, the
    config overrides; returns (train, valid, users, lgn_users)."""
    import scipy.sparse as sp

    train, valid, _ = amazon_splits(csr)
    sp.save_npz(os.path.join(tmp, "train.npz"), train, compressed=False)
    sp.save_npz(os.path.join(tmp, "valid.npz"), valid, compressed=False)
    rng = np.random.default_rng(19)
    users = rng.choice(N_USER, MESH_STEPS * 400, replace=False).reshape(
        MESH_STEPS, 400).astype(np.int64)
    np.save(os.path.join(tmp, "mesh_users.npy"), users)
    lgn_users = np.sort(rng.choice(N_USER, 400, replace=False))
    np.save(os.path.join(tmp, "lgn_users.npy"), lgn_users)
    with open(os.path.join(tmp, "mesh_inputs.json"), "w") as fh:
        # float32 unless a world asks for the configured bfloat16 (TF32)
        json.dump({"cfg": {"host_dense": False,
                           "compute_dtype": "float32"},
                   "eval_users": MESH_EVAL_USERS}, fh)
    return train, valid, users, lgn_users


def tf32_report(ranks):
    """(largest share of a tensor's elements past MESH_PARAMS over the
    ranks, {tensor: [past, elements] summed over the ranks})."""
    summed = {}
    for r in ranks:
        for k, v in r["param_report"].items():
            a = summed.setdefault(k, [0, 0])
            a[0] += v[0]
            a[1] += v[1]
    return max(v[0] / v[1] for r in ranks
               for v in r["param_report"].values()), summed


def mesh_phase(root, card, torch, csr):
    """Phase 19: the flagship at the Amazon-Book width on meshes (2,1),
    (1,2) and (2,2) in float32, (2,2) again at the configured TF32, and
    lightGCN on (1,2), each a world of ranks sharing the one card over
    gloo, against single-process runs on the card. Returns the launch
    counts for the kernel line."""
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.serve import Recommender
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gdmcf_mesh_")
    try:
        train, valid, users, lgn_users = mesh_inputs(csr, tmp)

        # the single-process runs on the card
        t0 = time.perf_counter()
        cfg = mesh_config(root, tmp, device="cuda")
        trainer = Trainer(cfg, N_USER, N_ITEM)
        tr_e = NativeCSR.from_scipy(train[:MESH_EVAL_USERS])
        va_e = NativeCSR.from_scipy(valid[:MESH_EVAL_USERS], strict=False)
        ref_eval = trainer.evaluate_streaming(None, [tr_e], va_e, [tr_e],
                                              cfg.topN)
        data = NativeCSR.from_scipy(train)
        rows = torch.from_numpy(data.gather_packed(lgn_users)).cuda()
        gen = torch.Generator("cuda").manual_seed(cfg.random_seed + 12345)
        ids, scores = trainer.eval_step(
            rows, torch.from_numpy(lgn_users).cuda(), rows,
            sampling_steps=cfg.sampling_steps, top_k=100, generator=gen,
            return_scores=True)
        torch.save({"ids": ids.cpu(), "scores": scores.cpu()},
                   os.path.join(tmp, "flagship_ref.pt"))
        del rows, ids, scores
        ref_losses = mesh_reference(torch, trainer, data, users, tmp, "f32",
                                    bits=True)
        del trainer
        trainer = Trainer(mesh_config(root, tmp, device="cuda",
                                      compute_dtype="bfloat16"),
                          N_USER, N_ITEM)
        tf32_losses = mesh_reference(torch, trainer, data, users, tmp,
                                     "tf32", bits=False)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        cfg_l = mesh_config(root, tmp, device="cuda", backbone="lightGCN",
                            compute_dtype="bfloat16")
        trainer = Trainer(cfg_l, N_USER, N_ITEM, train_csr=train)
        rows = torch.from_numpy(data.gather_packed(lgn_users)).cuda()
        gen = torch.Generator("cuda").manual_seed(cfg_l.random_seed + 12345)
        ids, scores = trainer.eval_step(
            rows, torch.from_numpy(lgn_users).cuda(), rows,
            sampling_steps=cfg_l.sampling_steps, top_k=100, generator=gen,
            return_scores=True)
        torch.save({"ids": ids.cpu(), "scores": scores.cpu()},
                   os.path.join(tmp, "lgn_ref.pt"))
        del trainer, rows, ids, scores
        gc.collect()
        torch.cuda.empty_cache()
        log(f"mesh phase single-process runs: losses {ref_losses} (TF32 "
            f"{tf32_losses}), eval {ref_eval[1]} (recall@{cfg.topN}), "
            f"{time.perf_counter() - t0:.1f} s")

        # the worlds: (2,1) beside (1,2), then (2,2), then TF32 (2,2)
        # beside lightGCN
        t0 = time.perf_counter()
        first = [(m, start_world("flagship", *m, tmp)) for m in MESHES[:2]]
        results = {m: finish_world("flagship", *m, tmp, p) for m, p in first}
        results[MESHES[2]] = finish_world(
            "flagship", *MESHES[2], tmp, start_world("flagship", *MESHES[2],
                                                     tmp))
        last = [("tf32", MESH_TF32, start_world("tf32", *MESH_TF32, tmp)),
                ("lightgcn", (1, 2), start_world("lightgcn", 1, 2, tmp))]
        tf32, lgn = (finish_world(kind, *m, tmp, p) for kind, m, p in last)
        worlds_s = time.perf_counter() - t0

        launches = {}
        for (dp, mp), ranks in results.items():
            tag = f"({dp},{mp})"
            for name, place in ranks[0]["placements"].items():
                log(f"mesh {tag} {name}: {place}")
            launches[f"{dp}x{mp}"] = [r["launches"] for r in ranks]
            p50 = float(np.median([ms for r in ranks
                                   for ms in r["step_ms"][1:]]))
            counts = {}   # [past, at the floor, elements] over the ranks
            for r in ranks:
                for k, v in r["param_report"].items():
                    c = counts.setdefault(k, [0, 0, 0])
                    c[0], c[1], c[2] = c[0] + v[0], c[1] + v[4], c[2] + v[1]
            excused = max((v[0] - v[3]) / v[1] for r in ranks
                          for v in r["param_report"].values())
            log(f"mesh {tag}: {MESH_STEPS} steps of 400 on the single-process "
                f"batches, TF32 off, losses {ranks[0]['losses']} "
                f"(single-process {ref_losses}, rtol {MESH_LOSS_RTOL}); "
                f"parameters after the steps within rtol "
                f"{MESH_PARAMS['rtol']} / atol {MESH_PARAMS['atol']} but "
                f"for elements at float32's rounding floor (both runs' "
                f"gradients under AdamW's eps {MESH_FLOOR} at one step, "
                f"not both zero), excused, at most {MESH_EXCUSED_SHARE} of "
                f"a rank's tensor (largest share {excused:.3g}); by tensor "
                f"over all ranks [past, at the floor, elements] "
                f"{ {k: c for k, c in counts.items() if c[0] or c[1]} }; "
                f"largest share of the tolerance "
                f"{max(r['param_share'] for r in ranks):.3f}; fused_adamw "
                f"launches per rank per step {ranks[0]['launches']} = the "
                f"rank's {ranks[0]['local_tensors']} trainable tensors; "
                f"evaluate_streaming of {MESH_EVAL_USERS} users dp-sharded "
                f"{ranks[0]['eval_sharded'][1]} and replicated "
                f"{ranks[0]['eval_replicated'][1]} (recall), within "
                f"{MESH_CLOSE} of each other and of the single process "
                f"({ranks[0]['eval_sharded_s']:.2f} / "
                f"{ranks[0]['eval_replicated_s']:.2f} s); the eval ids of "
                f"{len(lgn_users)} users equal the single process's except "
                f"{ranks[0]['eval_ties']} swapped pairs scored within "
                f"{MESH_TIE}; allgather_host_vectors bit-exact")
            log(f"mesh {tag}, {dp * mp} ranks sharing one card over gloo "
                f"(not a scaling number): step p50 {p50:.1f} ms (steps 2-3 "
                f"of every rank), peak memory by rank "
                f"{[round(r['peak_gib'], 2) for r in ranks]} GiB [{card}]")
        share, summed = tf32_report(tf32)
        tf32_lr = max(v[2] for r in tf32 for v in r["param_report"].values())
        log(f"mesh {MESH_TF32} at compute_dtype bfloat16 (TF32 on both "
            f"sides): losses {tf32[0]['losses']} (single-process "
            f"{tf32_losses}, rtol {MESH_LOSS_RTOL}); parameters past rtol "
            f"{MESH_PARAMS['rtol']} / atol {MESH_PARAMS['atol']} by tensor "
            f"over all ranks [past, elements] "
            f"{ {k: v for k, v in summed.items() if v[0]} }, the largest "
            f"share of a rank's tensor {share:.3g} (limit "
            f"{MESH_TF32_SHARE}); largest difference in lr {tf32_lr:.3f}")
        for (dp, mp), ranks in results.items():
            tag = f"({dp},{mp})"
            for r in ranks:
                for s, (a, b) in enumerate(zip(r["losses"], ref_losses)):
                    assert abs(a - b) <= MESH_LOSS_RTOL * abs(b), \
                        f"{tag} rank {r['rank']} step {s}: {a} vs {b}"
                rep = r["param_report"]
                bad = {k: v for k, v in rep.items() if v[3]}
                assert not bad, (tag, r["rank"], "past, not at the floor",
                                 bad)
                wide = {k: v for k, v in rep.items()
                        if v[0] - v[3] > MESH_EXCUSED_SHARE * v[1]}
                assert not wide, (tag, r["rank"], "excused", wide)
                assert r["launches"] == [r["local_tensors"]] * MESH_STEPS, \
                    (tag, r["launches"], r["local_tensors"])
                assert r["host_vectors_bit_exact"], tag
                assert r["eval_other"] == 0, (tag, r["rank"], r["eval_other"])
                for key in ("eval_sharded", "eval_replicated"):
                    got = np.asarray(r[key])
                    for other in (np.asarray(ref_eval),
                                  np.asarray(r["eval_replicated"])):
                        assert np.abs(got - other).max() <= MESH_CLOSE, \
                            (tag, key, got.tolist(), other.tolist())
        for r in tf32:
            for s, (a, b) in enumerate(zip(r["losses"], tf32_losses)):
                assert abs(a - b) <= MESH_LOSS_RTOL * abs(b), \
                    f"TF32 rank {r['rank']} step {s}: {a} vs {b}"
            assert r["launches"] == [r["local_tensors"]] * MESH_STEPS
        assert share <= MESH_TF32_SHARE, ("TF32", share, summed)
        for r in lgn:
            assert r["startup_launches"] == {"spmm_rows_fwd": 2,
                                             "spmm_rows_t": 2}, r
            assert r["other_differences"] == 0, r
        log(f"mesh (1,2) lightGCN: start-up launches per rank "
            f"{[r['startup_launches'] for r in lgn]}, frozen user table "
            f"block {lgn[0]['frozen_user_local']}; eval ids of "
            f"{len(lgn_users)} users equal the single process's except "
            f"{lgn[0]['tie_pairs']} swapped pairs whose single-process "
            f"scores differ by less than {MESH_TIE}")

        # the (2,2) checkpoint into a single-process Trainer, then serving
        fps = results[MESH_CKPT][0]["fingerprints"]
        cfg = mesh_config(root, tmp, device="cuda")
        trainer = Trainer(cfg, N_USER, N_ITEM)
        state = Checkpointer(os.path.join(tmp, "ckpt")).restore(
            trainer.init_state())
        got = {"step": state.step,
               "lt_history": fingerprint(torch, state.lt.history),
               "lt_count": fingerprint(torch, state.lt.count)}
        for k, p in state.params.items():
            got[f"params.{k}"] = fingerprint(torch, p)
            got[f"mu.{k}"] = fingerprint(torch, state.opt_state.mu[k])
            got[f"nu.{k}"] = fingerprint(torch, state.opt_state.nu[k])
        assert got == fps, [k for k in fps if got.get(k) != fps[k]]
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
        FA.reset_launch_counts()
        rec = Recommender.from_checkpoint(cfg, os.path.join(tmp, "ckpt"),
                                          train, serve_batch=256, k_max=100)
        check_requests(rec, train, N_ITEM, "mesh (2,2) checkpoint served")
        assert FA.LAUNCHES["fused_adamw"] == 0
        log(f"mesh (2,2) checkpoint: {len(fps) - 3} tensors and the Lt ring "
            f"bitwise equal to the mesh run's full_tensor() after restore "
            f"into a single-process Trainer; worlds {worlds_s:.1f} s, phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        return {"fused_adamw": launches,
                "spmm": [r["startup_launches"] for r in lgn]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gemm_rounding(torch, train):
    """How cuBLAS rounds the flagship's first GEMM ([400, 94,959] rows
    against a [1024, 94,959] weight) whole, as two 200-row blocks (a dp
    block) and as two contraction halves summed (an mp split), with TF32
    on and off: {mode: largest difference relative to the largest
    output}."""
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops.bitpack import unpack_rows

    g = torch.Generator("cuda").manual_seed(0)
    x = unpack_rows(torch.from_numpy(NativeCSR.from_scipy(train).gather_packed(
        np.arange(400))).cuda(), N_ITEM)
    x = torch.cat([x, torch.randn(400, 10, device="cuda", generator=g)], 1)
    w = torch.randn(1024, x.shape[1], device="cuda", generator=g) * 0.01
    out = {}
    for mode in ("highest", "high"):
        torch.set_float32_matmul_precision(mode)
        whole = x @ w.T
        rows = torch.cat([x[:200] @ w.T, x[200:] @ w.T])
        k = x.shape[1] // 2
        parts = x[:, :k] @ w[:, :k].T + x[:, k:] @ w[:, k:].T
        exact = (x.double() @ w.double().T)
        top = float(exact.abs().max())
        out["TF32 on" if mode == "high" else "TF32 off"] = {
            "dp rows vs whole": float((rows - whole).abs().max()) / top,
            "mp halves vs whole": float((parts - whole).abs().max()) / top,
            "whole vs float64": float((whole - exact).abs().max()) / top}
    torch.set_float32_matmul_precision("highest")
    return out


def mesh_diagnostic(root, card, torch, csr):
    """--mesh-diagnostic: what phase 19's parameter limits rest on. The
    first GEMM's rounding by shape with TF32 on and off, then (2,2) worlds
    of MESH_STEPS steps against single-process runs: at TF32 without a
    fault, and with a planted fault (the user table's gradient dropped; a
    tensor's gradient left out of the dp all-reduce) at TF32 and in
    float32. Prints each world's per-tensor readings and writes them to
    chiprun_out/mesh_diagnostic.json."""
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="gdmcf_mesh_")
    try:
        train, _, users, _ = mesh_inputs(csr, tmp)
        found = {"card": card, "gemm": gemm_rounding(torch, train)}
        log(f"mesh diagnostic: first GEMM rounding {found['gemm']}")
        data = NativeCSR.from_scipy(train)
        for tag, dtype in (("f32", "float32"), ("tf32", "bfloat16")):
            trainer = Trainer(mesh_config(root, tmp, device="cuda",
                                          compute_dtype=dtype),
                              N_USER, N_ITEM)
            found[f"single_{tag}"] = mesh_reference(
                torch, trainer, data, users, tmp, tag, bits=tag == "f32")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        for kind, fault in (("tf32", ""), ("tf32", "lookup"), ("tf32", "dp"),
                            ("f32", "lookup"), ("f32", "dp")):
            t0 = time.perf_counter()
            ranks = finish_world(kind, 2, 2, tmp,
                                 start_world(kind, 2, 2, tmp, fault))
            share, summed = tf32_report(ranks)
            floor, excused = {}, 0.0
            if kind == "f32":
                for r in ranks:
                    for k, v in r["param_report"].items():
                        c = floor.setdefault(k, [0, 0])
                        c[0], c[1] = c[0] + v[3], c[1] + v[4]
                        excused = max(excused, (v[0] - v[3]) / v[1])
            found[f"{kind} {fault or 'none'}"] = {
                "losses": [r["losses"] for r in ranks],
                "largest_share_past": share, "past_by_tensor": summed,
                "unexplained_and_at_floor_by_tensor": floor,
                "largest_share_excused": excused,
                "reports": [r["param_report"] for r in ranks]}
            log(f"mesh diagnostic (2,2) {kind}, fault {fault or 'none'}: "
                f"losses {ranks[0]['losses']}; largest share of a rank's "
                f"tensor past rtol {MESH_PARAMS['rtol']} / atol "
                f"{MESH_PARAMS['atol']}: {share:.4g}; [past, elements] "
                f"{ {k: v for k, v in summed.items() if v[0]} }; [past not "
                f"at the floor, at the floor] "
                f"{ {k: v for k, v in floor.items() if v[0] or v[1]} }, "
                f"largest share of a rank's tensor excused {excused:.4g}; "
                f"{time.perf_counter() - t0:.1f} s")
        os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
        with open(os.path.join(root, "chiprun_out",
                               "mesh_diagnostic.json"), "w") as fh:
            json.dump(found, fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 21: serving on a (dp, mp) mesh and the options that read across
# batch rows on a mesh
SERVE_MESH = (2, 2)
SERVE_MESH_USERS = 512         # two 256-user dispatches held to one process
SERVE_MESH_TIMED = 20          # 256-user dispatches timed one after another
SERVE_MESH_CLIENTS = {1: 40, 16: 8}   # clients -> 1-user requests each
SERVE_MESH_RELOAD_S = 8.0      # the 16-client load around the SIGHUP reload
SERVE_MESH_TIMEOUT = 600       # a world's ranks are killed past it
OPTION_MESH = (2, 1)
OPTION_GATES = {"oh1": "G9_oh1", "tr": "G7_DNNOneHotTransformer"}
# the transformer: ReLU kinks (a row's pre-activation rounding to either
# side of zero) and gradients spanning 1e5 put a few elements past
# MESH_PARAMS that are not at phase 19's floor; each may be at most 2 lr a
# step apart (Adam's normalized step) and they at most MESH_EXCUSED_SHARE
# of a rank's tensor, at the floor or not. Set after the first card run of
# phase 21 read one such element, 0.417 lr apart (PERF.md section 6)


def serve_config(root, **kw):
    """The flagship recipe for phase 21, in float32 (TF32 off, so that a
    mesh's ids are held to one process's as phase 19 holds them)."""
    from gdmcf_torch.config import load_config

    return load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                       dict(dict(compute_dtype="float32", host_dense=False),
                            **kw))


def option_config(tag, **kw):
    """A round-3 gate's recipe (phase 16's G9 or G7) in float32."""
    gate = {g[0]: g[2] for g in BACKBONE_GATES}[OPTION_GATES[tag]]
    return golden_config(0, **dict(gate, compute_dtype="float32", **kw))


def key_bias(name, p):
    """The transformer's attention key bias (the middle third of each
    ``qkv`` bias): zero gradient in exact arithmetic, so its float32
    gradient is rounding noise that Adam turns into +-lr a step
    (tests/test_torch_onehot_modes.py)."""
    import torch
    mask = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    if name.endswith("qkv.bias"):
        d = p.shape[0] // 3
        mask[d:2 * d] = True
    return mask


def serve_reference(torch, rec, users):
    """One process's answers to ``users`` in dispatches of ``serve_batch``
    after its warm-up: {"ids": [n, k_max], "scores": [n, n_item]} on the
    host, each dispatch's scores from the generator state it started
    from."""
    rec.warmup()
    ids, scores = [], []
    for lo in range(0, len(users), rec.serve_batch):
        u = np.asarray(users[lo:lo + rec.serve_batch], np.int64)
        flags = np.ones(len(u), bool)
        state = rec._generator.get_state()
        ids.append(torch.from_numpy(rec.recommend_batch(u, flags)))
        pad = rec.serve_batch - len(u)
        padded = np.concatenate([u, np.zeros(pad, np.int64)])
        rows, mask = rec._rows(padded, np.concatenate(
            [flags, np.zeros(pad, bool)]))
        gen = torch.Generator(rec.trainer.device).set_state(state)
        dev = rec.trainer.device
        _, sc = rec.trainer.eval_step(
            torch.from_numpy(rows).to(dev), torch.from_numpy(padded).to(dev),
            torch.from_numpy(mask).to(dev),
            sampling_steps=rec.trainer.cfg.sampling_steps, top_k=rec.k_max,
            generator=gen, return_scores=True)
        scores.append(sc[:len(u)].cpu())
    return {"ids": torch.cat(ids), "scores": torch.cat(scores)}


def serve_mesh_worker(argv) -> int:
    """One rank of a phase-21 world (``--serve-mesh-worker KIND DP MP
    DIR``), started under the env contract of ``multihost.initialize``;
    writes ``DIR/<KIND>_<DP>x<MP>_rank<r>.json``. KIND: ``flagship`` or
    ``lightgcn`` (``build_recommender`` on the mesh, the main rank's
    dispatches against one process's, the others following; the
    flagship's from the checkpoint in ``DIR/ckpt``, its 256-user dispatches
    timed), ``sym`` (the flagship under symmetric_gcn: the steps of
    ``mesh_steps``) or ``options`` (OneHotMatrix 1 and the transformer at
    the round-3 set)."""
    import faulthandler

    kind, dp, mp, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3]
    faulthandler.dump_traceback_later(SERVE_MESH_TIMEOUT, exit=True)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import scipy.sparse as sp
    import torch

    from gdmcf_torch.parallel import multihost

    out = {}
    mesh = dict(mesh_dp=dp, mesh_mp=mp, device="cuda:0")
    if kind in ("flagship", "lightgcn"):
        from gdmcf_torch.ops import spmm as S
        from gdmcf_torch.serve import build_recommender

        lgn = kind == "lightgcn"
        train = sp.load_npz(os.path.join(
            tmp, "train.npz" if lgn else "served.npz")).tocsr()
        cfg = (serve_config(root, backbone="lightGCN",
                            compute_dtype="bfloat16", **mesh) if lgn
               else serve_config(root, **mesh))
        S.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # the entry point starts the process group from the env contract
        rec = build_recommender(cfg, None if lgn else os.path.join(
            tmp, "ckpt"), train, N_USER, N_ITEM, serve_batch=256, k_max=100)
        out["startup_launches"] = dict(S.LAUNCHES)
        if rec.is_main:
            users = np.load(os.path.join(
                tmp, "lgn_users.npy" if lgn else "served_users.npy"))
            ids, _ = rec.recommend(users, k=100)
            out["tie_pairs"], out["other_differences"] = compare_ids(
                torch.from_numpy(ids), torch.load(os.path.join(
                    tmp, f"{kind}_serve_ref.pt"), weights_only=True))
            if not lgn:   # 256-user dispatches, one after another
                excl = np.ones(256, bool)
                ms = []
                for _ in range(SERVE_MESH_TIMED):
                    t0 = time.perf_counter()
                    rec.recommend_batch(users[:256], excl)
                    ms.append((time.perf_counter() - t0) * 1e3)
                out["dispatch_ms"] = ms
            rec.stop()
        else:
            rec.follow()
        out["launches_after"] = dict(S.LAUNCHES)
        if lgn:
            out["frozen_user_local"] = list(
                rec.trainer.model.frozen_lgn_user.shape)
    else:
        from gdmcf_torch.train.trainer import Trainer

        multihost.initialize(backend="gloo", device="cuda")
        torch.cuda.set_device(0)
        rank = multihost.process_index()
        if kind == "sym":
            cfg = mesh_config(root, tmp, symmetric_gcn=True, **mesh)
            trainer = Trainer(cfg, N_USER, N_ITEM)
            out["sym"], _ = mesh_steps(torch, trainer, cfg, tmp, "sym", dp,
                                       mp, rank)
        else:
            train = sp.load_npz(os.path.join(tmp, "train.npz")).tocsr()
            for tag in OPTION_GATES:
                cfg = option_config(tag, **mesh)
                trainer = Trainer(cfg, *train.shape)
                out[tag], _ = mesh_steps(
                    torch, trainer, cfg, tmp, tag, dp, mp, rank,
                    noise=key_bias if tag == "tr" else None)
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
    rank = multihost.process_index()
    out["rank"] = rank
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(tmp, f"{kind}_{dp}x{mp}_rank{rank}.json"),
              "w") as fh:
        json.dump(out, fh)
    multihost.sync_hosts()
    torch.distributed.destroy_process_group()
    return 0


def start_serve_world(kind, dp, mp, tmp):
    port = fixed_port()
    procs = []
    for rank in range(dp * mp):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   NUM_PROCESSES=str(dp * mp), PROCESS_ID=str(rank),
                   DIST_BACKEND="gloo", OMP_NUM_THREADS="2")
        logf = open(os.path.join(tmp, f"{kind}_{dp}x{mp}_rank{rank}.log"),
                    "w")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--serve-mesh-worker", kind, str(dp), str(mp), tmp], env=env,
            stdout=logf, stderr=subprocess.STDOUT))
        logf.close()
    return procs


def check_steps(label, ranks, ref_losses, transformer=False):
    """Phase 19's limits on a world's MESH_STEPS steps: the losses within
    MESH_LOSS_RTOL, the parameters within MESH_PARAMS but for elements at
    the rounding floor (at most MESH_EXCUSED_SHARE of a rank's tensor);
    one K1 launch per rank per step for each of the rank's tensors. The
    ``transformer``: its key bias within 2 lr a step, and the elements
    past MESH_PARAMS excused at the floor or not (see the note above
    OPTION_MESH). Returns (largest excused share, [past, at the floor,
    elements] by tensor)."""
    counts = {}
    for r in ranks:
        for s, (a, b) in enumerate(zip(r["losses"], ref_losses)):
            assert abs(a - b) <= MESH_LOSS_RTOL * abs(b), \
                f"{label} rank {r['rank']} step {s}: {a} vs {b}"
        rep = r["param_report"]
        if transformer:
            far = {k: v for k, v in rep.items()
                   if v[0] and v[2] > 2 * MESH_STEPS * 1.0001}
            assert not far, (label, r["rank"], "past 2 lr a step", far)
            assert r["noise_lr"] <= 2 * MESH_STEPS * 1.0001, \
                (label, r["noise_lr"])
        else:
            bad = {k: v for k, v in rep.items() if v[3]}
            assert not bad, (label, r["rank"], "past, not at the floor",
                             bad)
        # every element still past MESH_PARAMS is an excused one
        wide = {k: v for k, v in rep.items()
                if v[0] > MESH_EXCUSED_SHARE * v[1]}
        assert not wide, (label, r["rank"], "excused", wide)
        assert r["launches"] == [r["local_tensors"]] * MESH_STEPS, \
            (label, r["launches"], r["local_tensors"])
        for k, v in rep.items():
            c = counts.setdefault(k, [0, 0, 0])
            c[0], c[1], c[2] = c[0] + v[0], c[1] + v[4], c[2] + v[1]
    excused = max(v[0] / v[1] for r in ranks
                  for v in r["param_report"].values())
    return excused, {k: c for k, c in counts.items() if c[0] or c[1]}


def fixed_port() -> int:
    """A free port below the kernel's ephemeral range: the ranks of a world
    open many sockets while the server starts (gloo's pairs, the store's
    clients), and one of them may take a port that ``free_port`` released
    back to that range."""
    import random
    import socket
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            low = int(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    for _ in range(200):
        port = random.randrange(max(1024, low - 8000), low)
        with socket.socket() as probe:
            try:
                probe.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free port below the ephemeral range")


def tie_check(rows, users, ref, pos):
    """compare_ids for answers ``rows`` ([n, k] lists) of ``users`` against
    a reference held by user position ``pos`` (user -> row of ``ref``)."""
    import torch
    k = len(rows[0])
    at = [pos[int(u)] for u in users]
    return compare_ids(torch.tensor(rows), {
        "ids": ref["ids"][at, :k], "scores": ref["scores"][at]})


def serve_mesh_daemon(root, card, tmp, data_dir, ck, ck_next, refs, users):
    """`python -m gdmcf_torch.serve_http` on SERVE_MESH: four ranks sharing
    the card over gloo, the main rank binding the port. Its answers against
    one process's (``refs``: the checkpoint in ``ck``, then the one that
    ``ck_next`` moves in), 1 and 16 clients of 1-user requests, a SIGHUP
    reload under 16 clients and SIGTERM."""
    import signal

    dp, mp = SERVE_MESH
    port = coord = fixed_port()
    while coord == port:
        coord = fixed_port()
    base = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "gdmcf_torch.serve_http", "-c",
           os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
           "--device", "cuda:0", "--compute_dtype", "float32",
           "--mesh_dp", str(dp), "--mesh_mp", str(mp), "--data_path",
           data_dir, "--ckpt_dir_serve", ck, "--host", "127.0.0.1",
           "--port", str(port), "--serve_batch", "256", "--k_max", "100"]
    procs, logs = [], []
    t0 = time.perf_counter()
    for rank in range(dp * mp):
        env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2",
                   COORDINATOR_ADDRESS=f"127.0.0.1:{coord}",
                   NUM_PROCESSES=str(dp * mp), PROCESS_ID=str(rank),
                   DIST_BACKEND="gloo", HEARTBEAT_TIMEOUT_S="300")
        logs.append(os.path.join(tmp, f"daemon_{dp}x{mp}_rank{rank}.log"))
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=fh,
                                          stderr=subprocess.STDOUT))
    pos = {int(u): i for i, u in enumerate(users)}

    def stats():
        return get_json(base + "/healthz")[1]["stats"]

    def post(u, k):
        code, body = get_json(base + "/recommend", json.dumps(
            {"users": [int(x) for x in u], "k": k}).encode())
        assert code == 200, body
        return body["items"]

    try:
        wait_healthz(base, procs[0], limit=SERVE_MESH_TIMEOUT)
        up_s = time.perf_counter() - t0
        got = post(users[:256], 100) + post(users[256:], 100)
        ties, bad = tie_check(got, users, refs[0], pos)
        assert bad == 0, ("mesh ids", ties, bad)
        loads = {}
        for clients, count in SERVE_MESH_CLIENTS.items():
            s0 = stats()
            res = finish_load(start_load(base, clients, count, 0, users))
            s1 = stats()
            reqs = res["requests"]
            errors = [r[4] for r in reqs if r[4] is not None]
            assert not errors, (clients, errors[:3])
            lt = [0, 0]
            for u, _t, _ms, items, _e in reqs:
                t_, b_ = tie_check([items], [u], refs[0], pos)
                lt = [lt[0] + t_, lt[1] + b_]
            assert lt[1] == 0, (clients, lt)
            ms = np.array([r[2] for r in reqs])
            loads[clients] = dict(
                requests=len(reqs), rps=len(reqs) / res["wall_s"],
                p50=float(np.percentile(ms, 50)),
                p90=float(np.percentile(ms, 90)),
                p99=float(np.percentile(ms, 99)), ties=lt[0],
                rows_per_dispatch=(s1["rows"] - s0["rows"])
                / max(s1["dispatches"] - s0["dispatches"], 1))
        # a newer checkpoint in the served directory, then SIGHUP under
        # 16 clients
        name = os.listdir(ck_next)
        for f in name:
            os.replace(os.path.join(ck_next, f), os.path.join(ck, f))
        load = start_load(base, 16, 0, SERVE_MESH_RELOAD_S, users)
        time.sleep(1.5)
        t_hup = time.time()
        procs[0].send_signal(signal.SIGHUP)
        deadline = time.time() + 300
        while stats()["params_version"] != 1:
            assert time.time() < deadline, "SIGHUP did not reload"
            time.sleep(0.05)
        reload_s = time.time() - t_hup
        res = finish_load(load)
        reqs = res["requests"]
        errors = [r[4] for r in reqs if r[4] is not None]
        assert not errors, ("reload", len(errors), errors[:3])
        for u, _t, _ms, items, _e in reqs:
            assert any(tie_check([items], [u], ref, pos)[1] == 0
                       for ref in refs), ("reload", u)
        during = [r[2] for r in reqs
                  if r[1] <= t_hup + reload_s and r[1] + r[2] / 1e3 >= t_hup]
        after = post(users[:256], 100) + post(users[256:], 100)
        ties2, bad2 = tie_check(after, users, refs[1], pos)
        assert bad2 == 0, ("after the reload", ties2, bad2)
        procs[0].send_signal(signal.SIGTERM)
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=120))
            except subprocess.TimeoutExpired:
                rcs.append(None)
        assert rcs == [0] * (dp * mp), ("SIGTERM exits", rcs)
    except BaseException:
        for r, path in enumerate(logs):
            with open(path) as fh:
                log(f"--- daemon rank {r}:\n{fh.read()[-3000:]}")
        raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    log(f"serve mesh ({dp},{mp}) daemon: python -m gdmcf_torch.serve_http "
        f"on {dp * mp} ranks sharing one card over gloo (not a scaling "
        f"number), the flagship from a checkpoint of fit's layout, float32:"
        f" launch to the first /healthz {up_s:.2f} s; the ids of "
        f"{len(users)} users in 256-user requests equal one process's "
        f"except {ties} swapped pairs scored within {MESH_TIE} [{card}]")
    for c, v in loads.items():
        log(f"serve mesh ({dp},{mp}) http {c} client(s): {v['requests']} "
            f"1-user GET /recommend?k=20, {v['rps']:.1f} requests/s; "
            f"latency p50 {v['p50']:.3f} ms, p90 {v['p90']:.3f} ms, p99 "
            f"{v['p99']:.3f} ms; {v['rows_per_dispatch']:.2f} rows a "
            f"dispatch; every answer one process's ({v['ties']} tie pairs) "
            f"[{card}]")
    log(f"serve mesh ({dp},{mp}) reload: SIGHUP to the main rank under 16 "
        f"clients: every rank swapped in {reload_s:.2f} s (params_version "
        f"1), {len(reqs)} requests, 0 failed, the longest during the "
        f"reload {max(during) if during else 0.0:.3f} ms; the ids after it "
        f"the new checkpoint's ({ties2} tie pairs); SIGTERM: every rank "
        f"exited 0 [{card}]")
    return dict(up_s=up_s, reload_s=reload_s,
                longest_during_reload_ms=max(during) if during else 0.0,
                http={c: {k: v[k] for k in ("p50", "p90", "p99", "rps")}
                      for c, v in loads.items()})


def serve_mesh_phase(root, card, torch, csr):
    """Phase 21: serving on a (dp, mp) mesh and the options that read
    across batch rows on a mesh, each world of ranks sharing the card over
    gloo against single-process runs on the card. Returns the launch
    counts for the kernel line."""
    import scipy.sparse as sp

    from gdmcf_torch.data.loader import (data_load, data_load_dir,
                                         generate_synthetic_dataset)
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.serve import Recommender, build_recommender
    from gdmcf_torch.train.checkpoint import Checkpointer
    from gdmcf_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="gdmcf_serve_mesh_")
    try:
        train, _valid, users, lgn_users = mesh_inputs(csr, tmp)
        data = NativeCSR.from_scipy(train)
        r3 = os.path.join(tmp, "round3")
        os.makedirs(r3)
        paths = generate_synthetic_dataset(os.path.join(r3, "data"),
                                           **ROUND3_GATE_SET)
        r3_train = data_load(*paths)[0].tocsr()
        sp.save_npz(os.path.join(r3, "train.npz"), r3_train,
                    compressed=False)
        r3_users = np.random.default_rng(21).choice(
            r3_train.shape[0], MESH_STEPS * 400, replace=False).reshape(
            MESH_STEPS, 400).astype(np.int64)
        np.save(os.path.join(r3, "mesh_users.npy"), r3_users)
        r3_data = NativeCSR.from_scipy(r3_train)

        # the single-process runs on the card
        t0 = time.perf_counter()
        trainer = Trainer(mesh_config(root, tmp, device="cuda",
                                      symmetric_gcn=True), N_USER, N_ITEM)
        sym_ref = mesh_reference(torch, trainer, data, users, tmp, "sym",
                                 bits=True)
        del trainer
        opt_ref = {}
        for tag in OPTION_GATES:
            trainer = Trainer(option_config(tag, device="cuda"),
                              *r3_train.shape)
            opt_ref[tag] = mesh_reference(torch, trainer, r3_data, r3_users,
                                          r3, tag, bits=True)
            del trainer
        gc.collect()
        torch.cuda.empty_cache()
        rec = build_recommender(serve_config(root, backbone="lightGCN",
                                             compute_dtype="bfloat16",
                                             device="cuda"),
                                None, train, N_USER, N_ITEM, warmup=False,
                                serve_batch=256, k_max=100)
        torch.save(serve_reference(torch, rec, lgn_users),
                   os.path.join(tmp, "lightgcn_serve_ref.pt"))
        del rec
        # the flagship's checkpoints in fit's layout and one process's
        # answers from each
        data_dir = daemon_data(tmp, train)
        served = data_load_dir(data_dir)[0]
        sp.save_npz(os.path.join(tmp, "served.npz"), served,
                    compressed=False)
        ck, ck_next = os.path.join(tmp, "ckpt"), os.path.join(tmp, "next")
        s_users = np.random.default_rng(23).choice(
            N_USER, SERVE_MESH_USERS, replace=False)
        np.save(os.path.join(tmp, "served_users.npy"), s_users)
        refs = []
        for seed, step, directory in ((0, 0, ck), (1, 1, ck_next)):
            trainer = Trainer(serve_config(root, device="cuda",
                                           random_seed=seed), N_USER, N_ITEM)
            state = trainer.init_state()
            state.step = step
            c = Checkpointer(directory, max_to_keep=2)
            c.save(state)
            c.close()
            del state
            rec = Recommender.from_state(trainer, None, served,
                                         serve_batch=256, k_max=100)
            refs.append(serve_reference(torch, rec, s_users))
            del rec, trainer
            if seed == 0:
                torch.save(refs[0], os.path.join(tmp,
                                                 "flagship_serve_ref.pt"))
            gc.collect()
            torch.cuda.empty_cache()
        log(f"serve mesh phase single-process runs: symmetric_gcn losses "
            f"{sym_ref}; OneHotMatrix 1 {opt_ref['oh1']}; transformer "
            f"{opt_ref['tr']}; lightGCN and two flagship checkpoints served"
            f" ({time.perf_counter() - t0:.1f} s)")

        # the worlds: lightGCN (1,2), the round-3 options (2,1) and
        # symmetric_gcn (2,2) side by side (none of them timed but for step
        # times that are not scaling numbers), then each timed (2,2) world
        # alone: the flagship served in this script's ranks (its
        # dispatches timed), the daemon
        t0 = time.perf_counter()
        first = [("lightgcn", (1, 2), tmp, start_serve_world(
                      "lightgcn", 1, 2, tmp)),
                 ("options", OPTION_MESH, r3, start_serve_world(
                     "options", *OPTION_MESH, r3)),
                 ("sym", SERVE_MESH, tmp, start_serve_world(
                     "sym", *SERVE_MESH, tmp))]
        lgn, opts, sym = (finish_world(kind, *m, d, p)
                          for kind, m, d, p in first)
        flag = finish_world("flagship", *SERVE_MESH, tmp, start_serve_world(
            "flagship", *SERVE_MESH, tmp))
        daemon = serve_mesh_daemon(root, card, tmp, data_dir, ck, ck_next,
                                   refs, s_users)
        worlds_s = time.perf_counter() - t0

        assert flag[0]["other_differences"] == 0, flag[0]
        for r in flag:
            assert r["launches_after"] == {"spmm_rows_fwd": 0,
                                           "spmm_rows_t": 0}, r
        ms = flag[0]["dispatch_ms"]
        dispatch = dict(p50=float(np.percentile(ms, 50)),
                        p90=float(np.percentile(ms, 90)))
        log(f"serve mesh {SERVE_MESH} flagship: build_recommender from the "
            f"checkpoint on each rank, float32; the ids of "
            f"{SERVE_MESH_USERS} users in 256-user dispatches equal one "
            f"process's except {flag[0]['tie_pairs']} swapped pairs scored "
            f"within {MESH_TIE}; 256-user dispatch ({SERVE_MESH_TIMED} in "
            f"turn) p50 {dispatch['p50']:.3f} ms, p90 {dispatch['p90']:.3f}"
            f" ms; peak memory by rank "
            f"{[round(r['peak_gib'], 2) for r in flag]} GiB (ranks sharing "
            f"one card over gloo, not a scaling number) [{card}]")

        for r in lgn:
            assert r["startup_launches"] == {"spmm_rows_fwd": 2,
                                             "spmm_rows_t": 2}, r
            assert r["launches_after"] == r["startup_launches"], r
        assert lgn[0]["other_differences"] == 0, lgn[0]
        log(f"serve mesh (1,2) lightGCN: build_recommender on each rank, "
            f"start-up launches per rank "
            f"{[r['startup_launches'] for r in lgn]}, none by the "
            f"dispatches; frozen user table block "
            f"{lgn[0]['frozen_user_local']}; the ids of {len(lgn_users)} "
            f"users equal one process's except {lgn[0]['tie_pairs']} "
            f"swapped pairs scored within {MESH_TIE}; peak memory by rank "
            f"{[round(r['peak_gib'], 2) for r in lgn]} GiB [{card}]")
        launches = {"spmm": [r["startup_launches"] for r in lgn],
                    "fused_adamw": {}}
        for tag, ranks, ref, mesh, noise in (
                ("sym", [r["sym"] for r in sym], sym_ref, SERVE_MESH, False),
                ("oh1", [r["oh1"] for r in opts], opt_ref["oh1"],
                 OPTION_MESH, False),
                ("tr", [r["tr"] for r in opts], opt_ref["tr"], OPTION_MESH,
                 True)):
            for r, src in zip(ranks, sym if tag == "sym" else opts):
                r["rank"] = src["rank"]
            excused, counts = check_steps(tag, ranks, ref, noise)
            label = {"sym": "symmetric_gcn (flagship, Amazon-Book width)",
                     "oh1": "OneHotMatrix 1 (G9's DNN, round-3 set)",
                     "tr": "the transformer (G7, round-3 set)"}[tag]
            p50 = float(np.median([ms for r in ranks
                                   for ms in r["step_ms"][1:]]))
            launches["fused_adamw"][f"{tag}_{mesh[0]}x{mesh[1]}"] = [
                r["launches"] for r in ranks]
            extra = (f"; key bias (rounding noise) within "
                     f"{max(r['noise_lr'] for r in ranks):.3f} lr of one "
                     f"process" if noise else "")
            log(f"serve mesh {mesh} {label}: {MESH_STEPS} steps of 400, TF32"
                f" off, losses {ranks[0]['losses']} (single-process {ref}, "
                f"rtol {MESH_LOSS_RTOL}); parameters within rtol "
                f"{MESH_PARAMS['rtol']} / atol {MESH_PARAMS['atol']} but for"
                f" elements at the rounding floor, at most "
                f"{MESH_EXCUSED_SHARE} of a rank's tensor (largest share "
                f"{excused:.3g}; [past, at the floor, elements] {counts})"
                f"{extra}; fused_adamw launches per rank per step "
                f"{ranks[0]['launches']} = the rank's "
                f"{ranks[0]['local_tensors']} tensors; step p50 {p50:.1f} ms,"
                f" peak memory by rank "
                f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (ranks "
                f"sharing one card, not a scaling number) [{card}]")
        log(f"serve mesh phase: worlds {worlds_s:.1f} s, phase "
            f"{time.perf_counter() - t_phase:.1f} s")
        launches["dispatch"] = dispatch
        launches["daemon"] = daemon
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 22: recovery from a killed process, one process at the Amazon-Book
# width and a (dp, mp) mesh of ranks sharing the card; debug_nans on the card
FAULT_EPOCHS = 3               # the one-process CLI: epochs 1-3 asked
FAULT_MESH = (2, 2)
FAULT_MESH_EPOCHS = 4          # the mesh: killed at the top of epoch 3
FAULT_HEARTBEAT_S = 30         # HEARTBEAT_TIMEOUT_S of the mesh's ranks
FAULT_PROC_TIMEOUT = 420       # a phase-22 process is killed past it


def fault_emit(**kw):
    """One phase-22 event, a JSON line appended to the process's file
    FAULT_EVENTS (its log holds the CLI's output and the native
    libraries' warnings, which may break into a line)."""
    with open(os.environ["FAULT_EVENTS"], "a") as fh:
        fh.write(json.dumps(kw) + "\n")


def fault_events(log_path):
    """The events of the process that logs to ``log_path``."""
    path = log_path + ".events"
    if not os.path.exists(path):
        return []
    with open(path) as fh:   # a line still being written has no "\n"
        return [json.loads(ln) for ln in fh.read().split("\n")[:-1]]


def k1_on_state(FA, torch, state, lr):
    """K1 held against adamw_reference as in phase 5, on clones of the
    state's tensors with a seeded gradient: (largest error, elements over
    update_bounds). Its launches are comparisons, not the path's."""
    gen = torch.Generator(state.opt_state.count.device).manual_seed(22)
    count = state.opt_state.count + 1
    c = FA.step_scalars(count, lr)
    worst, over = 0.0, 0
    for name, param in state.params.items():
        p = param.detach().clone()
        mu = state.opt_state.mu[name].clone()
        nu = state.opt_state.nu[name].clone()
        g = 1e-3 * torch.randn(p.shape, generator=gen, device=p.device)
        want = FA.adamw_reference(p, g, mu, nu, c)
        bounds = FA.update_bounds(p, g, mu, nu, c)
        FA.adamw_update_(p, g, mu, nu, c)
        torch.cuda.synchronize()
        e, o = leaf_errors((p, mu, nu), want, bounds)
        worst, over = max(worst, e), over + o
        del p, mu, nu, g, want, bounds
    return worst, over


def fault_cli(argv) -> int:
    """A training process of phase 22 (``--fault-cli`` + the CLI's own
    flags): ``gdmcf_torch.cli.main`` as a user runs it, instrumented
    through the environment. FAULT_STEPS: steps an epoch; FAULT_KILL_EPOCH
    E: at the top of epoch E, once the periodic checkpoint of epoch E - 1
    has committed in FAULT_CKPT, SIGKILL this process; FAULT_K1: after each
    epoch hold K1 against its plain version on the state's tensors;
    FAULT_STOP: exit 0 once the first step has run. Events
    go out as ``fault_emit`` lines: the checkpoint snapshot and write, the
    restore (held bitwise against the file on the host), the first step
    (wall clock), each epoch (steps, K1 launches, loss), the evaluations."""
    import signal

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gdmcf_torch import cli
    from gdmcf_torch.config import parse_args
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.parallel.multihost import process_index
    from gdmcf_torch.parallel.sharding import local_block, shard_of
    from gdmcf_torch.train import checkpoint as C
    from gdmcf_torch.train.trainer import Trainer

    spe = int(os.environ["FAULT_STEPS"])
    kill_epoch = int(os.environ.get("FAULT_KILL_EPOCH", "0"))
    ckpt_dir = os.environ["FAULT_CKPT"]
    k1 = os.environ.get("FAULT_K1") == "1"
    stop = os.environ.get("FAULT_STOP") == "1"
    seen = {"first": False}

    save, write, restore = (C.Checkpointer.save, C.Checkpointer._write,
                            C.Checkpointer.restore)

    def timed_save(self, state, step=None, extra=None, block=True):
        t0 = time.perf_counter()
        save(self, state, step, extra, block)
        fault_emit(event="save", rank=process_index(), step=state.step,
                   block=block, s=time.perf_counter() - t0)

    def timed_write(self, step, payload):
        t0 = time.perf_counter()
        write(self, step, payload)
        fault_emit(event="committed", step=step, t=time.time(),
                   write_s=time.perf_counter() - t0,
                   error=repr(self._error) if self._error else None)

    def checked_restore(self, template, step=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(self, template, step)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        data = torch.load(self._path(out.step), map_location="cpu",
                          weights_only=True, mmap=True)
        opt, n = out.opt_state, 0
        for key, live in (("params", out.params), ("mu", opt.mu),
                          ("nu", opt.nu), ("master", opt.master or {})):
            for name, t in live.items():
                src = data[key][name]
                shard = shard_of(out.params[name])
                if shard is not None:
                    src = local_block(src, shard)
                assert torch.equal(t.detach().cpu(), src), (key, name)
                n += 1
        for name, a, b in (("count", opt.count, data["count"]),
                           ("lt_history", out.lt.history, data["lt_history"]),
                           ("lt_count", out.lt.count, data["lt_count"]),
                           ("generator", out.generator.get_state(),
                            data["generator"])):
            assert torch.equal(a.cpu(), b), name
            n += 1
        assert out.step == int(data["step"])
        fault_emit(event="restore", rank=process_index(), step=out.step,
                   epoch=out.step // spe, tensors=n, restore_s=t1 - t0,
                   check_s=time.perf_counter() - t1,
                   path=os.path.relpath(self._path(out.step), ckpt_dir))
        return out

    step = Trainer.train_step

    def first_step(self, *a, **kw):
        out = step(self, *a, **kw)
        if not seen["first"]:
            torch.cuda.synchronize()
            seen["first"] = True
            fault_emit(event="first_step", rank=process_index(),
                       step=out[0].step, t=time.time(),
                       loss=float(out[1]),
                       launches=FA.LAUNCHES["fused_adamw"])
            if stop:
                fault_emit(event="done", rank=process_index())
                os._exit(0)
        return out

    train_epoch = Trainer.train_epoch

    def epoch_hook(self, state, dataset, rng):
        epoch = state.step // spe + 1
        if epoch == kill_epoch:
            path = os.path.join(ckpt_dir, "periodic",
                                f"ckpt_{(epoch - 1) * spe}.pt")
            deadline = time.time() + 120
            while not os.path.exists(path) and time.time() < deadline:
                time.sleep(0.05)
            fault_emit(event="kill", rank=process_index(), epoch=epoch,
                       t=time.time(), committed=os.path.exists(path))
            os.kill(os.getpid(), signal.SIGKILL)
        FA.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_epoch(self, state, dataset, rng)
        torch.cuda.synchronize()
        ev = dict(event="epoch", rank=process_index(), epoch=epoch,
                  steps=state.step - (epoch - 1) * spe,
                  launches=FA.LAUNCHES["fused_adamw"], loss=loss,
                  s=time.perf_counter() - t0, tensors=len(state.params))
        if k1:
            ev["k1_max_abs_err"], ev["k1_over"] = k1_on_state(
                FA, torch, state, self.cfg.lr)
        fault_emit(**ev)
        return state, loss

    evaluate = Trainer.evaluate

    def eval_hook(self, *a, **kw):
        out = evaluate(self, *a, **kw)
        fault_emit(event="eval", rank=process_index(),
                   results=[list(map(float, g)) for g in out])
        return out

    C.Checkpointer.save = timed_save
    C.Checkpointer._write = timed_write
    C.Checkpointer.restore = checked_restore
    Trainer.train_step = first_step
    Trainer.train_epoch = epoch_hook
    Trainer.evaluate = eval_hook
    cli.main(parse_args(argv))
    fault_emit(event="done", rank=process_index())
    return 0


def fault_start(root, args, log_path, env=None):
    """Start one ``--fault-cli`` process writing to ``log_path``."""
    logf = open(log_path, "w")
    p = subprocess.Popen(
        [sys.executable, os.path.join(root, "chip_smoke.py"), "--fault-cli",
         *args], cwd=root,
        env=dict(os.environ, PYTHONPATH=root, FAULT_EVENTS=log_path +
                 ".events", **(env or {})),
        stdout=logf, stderr=subprocess.STDOUT)
    logf.close()
    return p


def fault_fail(msg, logs):
    for path in logs:
        with open(path) as fh:
            log(f"--- {os.path.basename(path)}:\n{fh.read()[-4000:]}")
    raise AssertionError(msg)


def on_disk(directory):
    """[name, bytes] of every file under ``directory``."""
    out = []
    for base, _, files in os.walk(directory):
        for f in sorted(files):
            path = os.path.join(base, f)
            out.append([os.path.relpath(path, directory),
                        os.path.getsize(path)])
    return sorted(out)


def write_amazon_npy(csr, data_dir):
    """The phase-9 splits of the graph as the CLI's ``{train,valid,
    test}_list.npy``; the grid's last cell is put in train, so the CLI
    infers the whole 108,822 x 94,949 grid from it."""
    import scipy.sparse as sp

    train, valid, test = amazon_splits(csr)
    corner = sp.csr_matrix(([1.0], ([N_USER - 1], [N_ITEM - 1])),
                           shape=csr.shape, dtype=np.float32)
    train = ((train + corner) > 0).astype(np.float32)
    valid = valid - valid.multiply(train)
    test = test - test.multiply(train)
    os.makedirs(data_dir, exist_ok=True)
    for name, m in (("train", train), ("valid", valid), ("test", test)):
        coo = m.tocoo()
        keep = coo.data > 0
        np.save(os.path.join(data_dir, f"{name}_list.npy"),
                np.stack([coo.row[keep], coo.col[keep]], 1).astype(np.int64))
    return train.nnz


def fault_one_process(root, card, csr, tmp):
    """Phase 22 (a): the flagship through ``python -m gdmcf_torch.cli`` at
    the Amazon-Book width with a periodic checkpoint every epoch, killed in
    the middle of the epoch-2 write, resumed (K1 held against its plain
    version after the resumed epoch), killed between the epoch-2 commit and
    its sidecar, resumed again up to its first step. Returns K1's launches
    in the resumed epoch and in the last resume's first step, and the
    relaunch-to-first-step times."""
    data_dir = os.path.join(tmp, "amazon")
    nnz = write_amazon_npy(csr, data_dir)
    ckpt = os.path.join(tmp, "ckpt")
    periodic = os.path.join(ckpt, "periodic")
    spe = N_USER // 400
    flags = ["-c", os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
             "--device", "cuda", "--data_path", data_dir, "--dataset",
             "amazon", "--log_name", os.path.join(tmp, "log"), "--host_dense",
             "false", "--epochs", str(FAULT_EPOCHS), "--eval_every", "100",
             "--ckpt_dir", ckpt, "--ckpt_every", "1", "--resume", "true",
             "--debug", "true"]
    env = {"FAULT_STEPS": str(spe), "FAULT_CKPT": ckpt}
    logs = [os.path.join(tmp, f"cli_{i}.log") for i in (1, 2, 3)]
    log(f"fault (a): {N_USER} x {N_ITEM}, {nnz} train edges written as .npy;"
        f" python -m gdmcf_torch.cli -c configs/amazonOneEmbGcn.yaml "
        f"--host_dense false --epochs {FAULT_EPOCHS} --ckpt_every 1 "
        f"--eval_every 100 --resume true, {spe} steps an epoch")

    # kill 1: the epoch-1 checkpoint has committed and the epoch-2 .tmp-
    # file is growing
    t0 = time.time()
    p = fault_start(root, flags, logs[0], env)
    tmp_name, sizes = None, []
    while p.poll() is None and time.time() - t0 < FAULT_PROC_TIMEOUT:
        names = os.listdir(periodic) if os.path.isdir(periodic) else []
        grow = [n for n in names if n.startswith(f"ckpt_{2 * spe}.pt.tmp-")]
        if f"ckpt_{spe}.pt" in names and grow:
            size = os.path.getsize(os.path.join(periodic, grow[0]))
            sizes.append(size)
            if len(sizes) >= 2 and 0 < sizes[-2] < size:
                p.kill()
                tmp_name = grow[0]
                break
        time.sleep(0.02)
    p.wait()
    if tmp_name is None:
        p.kill()
        fault_fail("kill 1: the epoch-2 write was never seen growing",
                   logs[:1])
    left = on_disk(ckpt)
    ev1 = fault_events(logs[0])
    write1 = [e for e in ev1 if e["event"] == "committed"]
    snap1 = [e for e in ev1 if e["event"] == "save"]
    assert write1 and write1[0]["step"] == spe and not write1[0]["error"]
    log(f"fault (a) kill 1: SIGKILL {time.time() - t0:.1f} s after launch, "
        f"the epoch-2 file growing ({sizes[-2]} -> {sizes[-1]} B); the "
        f"epoch-1 checkpoint's snapshot {snap1[0]['s']:.2f} s, write "
        f"{write1[0]['write_s']:.2f} s; left on disk {left} [{card}]")
    assert [f for f, _ in left if f.endswith(".pt")] == [
        f"periodic/ckpt_{spe}.pt"]

    def resumed(i, want_step, kill2):
        # the first resume trains its epoch and holds K1 against its plain
        # version once; the second stops after its first step
        t_launch = time.time()
        p = fault_start(root, flags, logs[i], dict(
            env, **({"FAULT_K1": "1"} if kill2 else {"FAULT_STOP": "1"})))
        killed_at = None
        while p.poll() is None and time.time() - t_launch < \
                FAULT_PROC_TIMEOUT:
            if kill2:
                ev = fault_events(logs[i])
                if any(e["event"] == "committed" and e["step"] == 2 * spe
                       for e in ev):
                    p.kill()
                    killed_at = time.time()
                    break
            time.sleep(0.02)
        if p.poll() is None:
            p.kill()
        p.wait()
        ev = fault_events(logs[i])
        if kill2 and killed_at is None:
            fault_fail("kill 2: the epoch-2 commit was never seen",
                       logs[i:i + 1])
        if not kill2 and p.returncode != 0:
            fault_fail(f"resume {i} exited {p.returncode}", logs[i:i + 1])
        (rest,) = [e for e in ev if e["event"] == "restore"]
        first = [e for e in ev if e["event"] == "first_step"][0]
        assert rest["step"] == want_step, (rest, want_step)
        assert first["step"] == want_step + 1, first
        assert np.isfinite(first["loss"]) and first["launches"] == 13, first
        to_step = first["t"] - t_launch - rest["check_s"]
        restored = (f"restored step {rest['step']} (epoch {rest['epoch']}) "
                    f"from {rest['path']}, {rest['tensors']} tensors bitwise "
                    f"equal to the file read on the host (restore "
                    f"{rest['restore_s']:.2f} s, check {rest['check_s']:.2f} "
                    f"s); relaunch to the first resumed step {to_step:.2f} s "
                    f"(the check left out)")
        if not kill2:
            assert any(e["event"] == "done" for e in ev)
            log(f"fault (a) resume {i - 1}: {restored}; step "
                f"{first['step']}: loss {first['loss']:.4f}, fused_adamw "
                f"launches {first['launches']}; stopped there [{card}]")
            return ev, first["launches"], None, to_step
        epochs = [e for e in ev if e["event"] == "epoch"]
        assert epochs, f"resume {i}: no epoch trained"
        e = epochs[0]
        assert e["epoch"] == want_step // spe + 1 and e["steps"] == spe
        assert np.isfinite(e["loss"]) and e["launches"] == 13 * spe, e
        assert e["k1_over"] == 0, e
        log(f"fault (a) resume {i - 1}: {restored}; epoch {e['epoch']}: "
            f"{e['steps']} steps in {e['s']:.2f} s, loss {e['loss']:.4f}, "
            f"fused_adamw launches {e['launches']} = 13 x {spe}; K1 against "
            f"adamw_reference on the state's 13 tensors: max abs err "
            f"{e['k1_max_abs_err']:.3e}, 0 over update_bounds [{card}]")
        return ev, e["launches"], killed_at, to_step

    ev2, launches2, killed, to_step2 = resumed(1, spe, True)
    meta = os.path.join(periodic, "train_meta.json")
    left = on_disk(ckpt)
    commit2 = [e for e in ev2 if e["event"] == "committed"][0]
    log(f"fault (a) kill 2: SIGKILL {killed - commit2['t']:.3f} s after the "
        f"epoch-2 commit (write {commit2['write_s']:.2f} s), before its "
        f"sidecar; train_meta.json "
        f"{json.load(open(meta)) if os.path.exists(meta) else 'absent'}; "
        f"left on disk {left} [{card}]")
    assert f"periodic/ckpt_{2 * spe}.pt" in [f for f, _ in left]
    _, launches3, _, to_step3 = resumed(2, 2 * spe, False)
    log(f"fault (a): on disk {on_disk(ckpt)}; unfinished files are left in "
        f"place, as the JAX package's Orbax manager leaves its own [{card}]")
    return [launches2, launches3], [to_step2, to_step3]


def fault_mesh(root, card, tmp):
    """Phase 22 (b): the flagship in float32 at the round-3 set on (2,2),
    four CLI ranks sharing the card over gloo with HEARTBEAT_TIMEOUT_S;
    rank 3 kills itself at the top of epoch 3 once the epoch-2 checkpoint
    has committed; every survivor must exit non-zero within the heartbeat
    plus 15 s; then the gang restarts, restores epoch 2, trains epochs 3-4
    and every rank reports the same evaluation. Returns K1's launches per
    rank per step."""
    from gdmcf_torch.data.loader import generate_synthetic_dataset

    data_dir = os.path.join(tmp, "round3")
    generate_synthetic_dataset(data_dir, **ROUND3_GATE_SET)
    dp, mp = FAULT_MESH
    world = dp * mp
    ckpt = os.path.join(tmp, "mesh_ckpt")
    # the golden recipe of the round-3 gates, the flagship, in float32 (as
    # phase 21's option_config); JSON is YAML, so it is the CLI's preset
    cfg = golden_config(0, compute_dtype="float32", **ROUND3)
    recipe = os.path.join(tmp, "round3_flagship.yaml")
    with open(recipe, "w") as fh:
        json.dump(cfg.to_dict(), fh)
    spe = (ROUND3_GATE_SET["n_user"] // dp) // (cfg.batch_size // dp)
    flags = ["-c", recipe, "--device", "cuda:0", "--data_path", data_dir,
             "--dataset", "round3", "--log_name",
             os.path.join(tmp, "mesh_log"),
             "--epochs", str(FAULT_MESH_EPOCHS), "--eval_every", "2",
             "--ckpt_dir", ckpt, "--ckpt_every", "1", "--resume", "true",
             "--mesh_dp", str(dp), "--mesh_mp", str(mp), "--debug", "true"]

    def gang(tag, kill):
        port = fixed_port()
        procs, logs = [], []
        for rank in range(world):
            env = {"COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                   "NUM_PROCESSES": str(world), "PROCESS_ID": str(rank),
                   "DIST_BACKEND": "gloo", "OMP_NUM_THREADS": "2",
                   "HEARTBEAT_TIMEOUT_S": str(FAULT_HEARTBEAT_S),
                   "FAULT_STEPS": str(spe), "FAULT_CKPT": ckpt}
            if kill and rank == world - 1:
                env["FAULT_KILL_EPOCH"] = "3"
            logs.append(os.path.join(tmp, f"mesh_{tag}_rank{rank}.log"))
            procs.append(fault_start(root, flags, logs[-1], env))
        ends = [None] * world
        t0 = time.time()
        while None in ends and time.time() - t0 < FAULT_PROC_TIMEOUT:
            for r, p in enumerate(procs):
                if ends[r] is None and p.poll() is not None:
                    ends[r] = time.time()
            time.sleep(0.02)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        hung = [r for r, e in enumerate(ends) if e is None]
        if hung:
            fault_fail(f"mesh {tag}: ranks {hung} hung", logs)
        return t0, procs, logs, ends

    t0, procs, logs, ends = gang("fault", True)
    evs = [fault_events(p) for p in logs]
    kills = [e for e in evs[-1] if e["event"] == "kill"]
    if not kills or procs[-1].returncode != -9:
        fault_fail("mesh fault: rank 3 did not kill itself", logs)
    died = kills[0]["t"]
    assert kills[0]["committed"], "the epoch-2 checkpoint had not committed"
    detect = [ends[r] - died for r in range(world - 1)]
    for r in range(world - 1):
        done = [e["epoch"] for e in evs[r] if e["event"] == "epoch"]
        if procs[r].returncode in (0, None) or 3 in done or done[-1:] != [2]:
            fault_fail(f"mesh fault: survivor {r} exited "
                       f"{procs[r].returncode} after epochs {done}", logs)
    assert max(detect) <= FAULT_HEARTBEAT_S + 15.0, detect
    steps = [e for ev in evs for e in ev if e["event"] == "epoch"]
    per_step = sorted({e["launches"] // e["steps"] for e in steps})
    log(f"fault (b) mesh {FAULT_MESH}: the flagship in float32 at the "
        f"round-3 set (ranks sharing the card over gloo, "
        f"HEARTBEAT_TIMEOUT_S {FAULT_HEARTBEAT_S}); rank 3 SIGKILLed "
        f"itself at the top of epoch 3, {died - t0:.1f} s after launch, "
        f"the epoch-2 checkpoint committed; survivors exited "
        f"{[procs[r].returncode for r in range(world - 1)]} after "
        f"{[round(d, 2) for d in detect]} s (limit "
        f"{FAULT_HEARTBEAT_S + 15.0:.0f} s), none past epoch 2; fused_adamw"
        f" launches per rank per step {per_step} [{card}]")

    t0, procs, logs, ends = gang("resume", False)
    evs = [fault_events(p) for p in logs]
    if any(p.returncode != 0 for p in procs):
        fault_fail(f"mesh resume exited {[p.returncode for p in procs]}",
                   logs)
    results, firsts = set(), []
    for r, ev in enumerate(evs):
        (rest,) = [e for e in ev if e["event"] == "restore"]
        assert rest["step"] == 2 * spe and rest["epoch"] == 2, rest
        done = [e["epoch"] for e in ev if e["event"] == "epoch"]
        assert done == [3, 4], (r, done)
        assert all(np.isfinite(e["loss"]) for e in ev
                   if e["event"] == "epoch")
        evals = [e["results"] for e in ev if e["event"] == "eval"]
        results.add(json.dumps(evals[-2:]))
        firsts.append([e["t"] for e in ev if e["event"] == "first_step"][0])
    assert len(results) == 1, results
    log(f"fault (b) gang restart: every rank restored step {2 * spe} "
        f"(epoch 2; {rest['tensors']} tensors a rank bitwise equal to its "
        f"blocks of the file), trained epochs 3-4 and reported the same "
        f"evaluation {json.loads(results.pop())}; restart to the first "
        f"resumed step {max(firsts) - t0:.2f} s (the slowest rank) [{card}]")
    steps += [e for ev in evs for e in ev if e["event"] == "epoch"]
    return sorted({e["launches"] // e["steps"] for e in steps}), detect, \
        max(firsts) - t0


def debug_nans_phase(root, card, torch, csr):
    """Phase 22 (d): the flagship at the Amazon-Book width on the card
    under debug_nans: a NaN planted in a parameter raises at the loss, an
    infinite gradient raises after K1's update and names the tensor; the
    flag off, the same steps do not raise; clean step times with the flag
    on and off."""
    from gdmcf_torch.config import load_config
    from gdmcf_torch.data.native import NativeCSR
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.train.trainer import Trainer

    cfg = load_config(os.path.join(root, "configs", "amazonOneEmbGcn.yaml"),
                      {"device": "cuda", "debug_nans": True})
    trainer = Trainer(cfg, N_USER, N_ITEM)
    state = trainer.init_state()
    batches = train_stream(NativeCSR.from_scipy(csr), cfg.batch_size, seed=5)

    def step():
        x, idx = next(batches)
        return trainer.train_step(state, torch.from_numpy(x),
                                  torch.from_numpy(idx))

    times = {}
    for on in (False, True, False, True):
        cfg.debug_nans = on
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times.setdefault(on, []).extend(ms[1:])
    name = "in_layers2.0.weight"
    param = state.params[name]
    with torch.no_grad():
        saved = param[0, 0].clone()
        param[0, 0] = float("nan")
    cfg.debug_nans = True
    FA.reset_launch_counts()
    try:
        step()
        raise AssertionError("debug_nans: a NaN parameter did not raise")
    except FloatingPointError as e:
        raised_param = str(e)
    launches_param = FA.LAUNCHES["fused_adamw"]
    with torch.no_grad():
        param[0, 0] = saved
    # an infinite gradient: finite loss and backward, non-finite after K1
    x, idx = next(batches)
    loss, grads, lt = trainer.loss_and_grads(state, torch.from_numpy(x),
                                             torch.from_numpy(idx))
    snapshot = {k: p.detach().clone() for k, p in state.params.items()}
    opt0 = {k: (state.opt_state.mu[k].clone(), state.opt_state.nu[k].clone())
            for k in state.params}
    count0 = state.opt_state.count.clone()
    grads["emb_layer.bias"][0] = float("inf")
    FA.reset_launch_counts()
    try:
        trainer.apply_grads(state, grads, lt)
        raise AssertionError("debug_nans: an infinite gradient did not raise")
    except FloatingPointError as e:
        raised_grad = str(e)
    launches_grad = FA.LAUNCHES["fused_adamw"]
    assert "emb_layer.bias" in raised_grad and launches_grad == 13
    # the flag off: the same two steps run through
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(snapshot[k])
            state.opt_state.mu[k].copy_(opt0[k][0])
            state.opt_state.nu[k].copy_(opt0[k][1])
        state.opt_state.count.copy_(count0)
    cfg.debug_nans = False
    trainer.apply_grads(state, grads, lt)
    off_grad = bool(torch.isfinite(state.params["emb_layer.bias"]).all())
    with torch.no_grad():
        param[0, 0] = float("nan")
    _, loss_off = step()
    log(f"debug_nans (flagship, Amazon-Book width, cuda): a NaN in {name} "
        f"raised FloatingPointError ({raised_param!r}; K1 launches before it "
        f"{launches_param}); an infinite gradient of emb_layer.bias raised "
        f"after K1's {launches_grad} launches ({raised_grad!r}); the flag "
        f"off: neither raised (loss {loss_off.item()}, emb_layer.bias "
        f"finite {off_grad}); clean step p50 {np.median(times[False]):.2f} "
        f"ms off, {np.median(times[True]):.2f} ms on [{card}]")
    assert not np.isfinite(loss_off.item()) and not off_grad
    del trainer, state, snapshot, opt0, grads
    gc.collect()
    torch.cuda.empty_cache()
    return float(np.median(times[False])), float(np.median(times[True]))


def fault_phase(root, card, torch, csr):
    """Phase 22: (a), (b) and (d); returns what the kernel line takes."""
    tmp = tempfile.mkdtemp(prefix="gdmcf_fault_")
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        launches, to_step = fault_one_process(root, card, csr, tmp)
        log(f"fault (a): {time.perf_counter() - t0:.1f} s")
        shutil.rmtree(os.path.join(tmp, "ckpt"), ignore_errors=True)
        t0 = time.perf_counter()
        mesh_launches, detect, restart = fault_mesh(root, card, tmp)
        log(f"fault (b): {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    off_ms, on_ms = debug_nans_phase(root, card, torch, csr)
    log(f"debug_nans (d): {time.perf_counter() - t0:.1f} s")
    log(f"fault phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_fault_resumed_epoch": launches[0],
            "launches_fault_resumed_first_step": launches[1],
            "launches_fault_mesh_per_rank_step": mesh_launches,
            "fault_relaunch_to_step_s": to_step,
            "fault_mesh_detection_s": detect,
            "fault_mesh_restart_to_step_s": restart,
            "debug_nans_step_ms_off_on": [off_ms, on_ms]}


def main() -> int:
    import argparse

    if sys.argv[1:2] == ["--http-client"]:   # phase 17's load generator
        return http_client(sys.argv[2:])
    if sys.argv[1:2] == ["--mesh-worker"]:   # a rank of phase 19
        return mesh_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--serve-mesh-worker"]:   # a rank of phase 21
        return serve_mesh_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--fault-cli"]:   # a training process of phase 22
        return fault_cli(sys.argv[2:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="FILE", default=None,
                        help="write torch.profiler tables of 5 lightGCN "
                             "dispatches, 5 flagship train steps, 5 "
                             "flagship dispatches and 5 BPR steps, and time "
                             "the SpMM kernel at several segment lengths")
    parser.add_argument("--fresh-seed-gates", action="store_true",
                        help="run only the LightGCN gate at seeds 6-8 and "
                             "G4 at seeds 3-8 and report their verdicts")
    parser.add_argument("--precision-pairs", action="store_true",
                        help="run only G4 at seeds 0-5 and the legacy gate "
                             "at seeds 0-2 with TF32 on and off, paired")
    parser.add_argument("--mesh-phase", action="store_true",
                        help="run only phase 19 (the meshes of ranks "
                             "sharing the card) and report it")
    parser.add_argument("--precision-phase", action="store_true",
                        help="run only phases 5, 6 and 20 (the AdamW "
                             "kernel, the float32 flagship epoch and "
                             "bfloat16 storage with float32 masters)")
    parser.add_argument("--serve-mesh-phase", action="store_true",
                        help="run only phase 21 (serving on a mesh of "
                             "ranks sharing the card, and the options that "
                             "read across batch rows on a mesh)")
    parser.add_argument("--fault-phase", action="store_true",
                        help="run only phase 22 (recovery from a killed "
                             "process, one process and a mesh, and "
                             "debug_nans on the card)")
    parser.add_argument("--mesh-diagnostic", action="store_true",
                        help="print what phase 19's parameter limits rest "
                             "on: GEMM rounding by shape, TF32 and planted "
                             "faults on (2,2)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gdmcf_torch.ops import fused_adamw as FA
    from gdmcf_torch.ops import spmm as S
    from gdmcf_torch.serve import build_recommender
    from gdmcf_torch.train.trainer import matmul_precision

    root = os.path.dirname(os.path.abspath(__file__))
    card = card_line()
    t_start = time.perf_counter()
    if args.mesh_diagnostic:
        FA.build_kernel()
        log(card)
        mesh_diagnostic(root, card, torch, power_law_graph(0))
        log(f"chip_smoke (mesh diagnostic only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if args.mesh_phase:
        S.build_kernels()
        FA.build_kernel()
        log(card)
        launches = mesh_phase(root, card, torch, power_law_graph(0))
        log(f"mesh launches {json.dumps(launches)}")
        log(f"chip_smoke (phase 19 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if args.serve_mesh_phase:
        S.build_kernels()
        FA.build_kernel()
        log(card)
        launches = serve_mesh_phase(root, card, torch, power_law_graph(0))
        log(f"serve mesh launches {json.dumps(launches)}")
        log(f"chip_smoke (phase 21 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if args.fault_phase:
        FA.build_kernel()
        log(card)
        fault = fault_phase(root, card, torch, power_law_graph(0))
        log(f"fault launches {json.dumps(fault)}")
        log(f"chip_smoke (phase 22 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if args.precision_phase:
        FA.build_kernel()
        log(card)
        csr = power_law_graph(0)
        trainer, _ = flagship_train(args, root, card, torch, csr,
                                    adamw_phase(FA, torch))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        entry, _ = precision_phase(root, card, torch, csr)
        log(json.dumps(entry))
        log(f"chip_smoke (phases 5, 6 and 20 only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if args.fresh_seed_gates or args.precision_pairs:
        S.build_kernels()
        FA.build_kernel()
        log(card)
        (fresh_seed_gates if args.fresh_seed_gates
         else precision_pairs)(root, card, torch)
        log(f"chip_smoke (one option's gates only): "
            f"{time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0

    # 1. build
    t0 = time.perf_counter()
    S.build_kernels()
    log(f"nvcc build: {time.perf_counter() - t0:.1f} s")
    for line in S.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("ptxas:", line.strip())
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 2. SpMM kernel phase (TF32 off on the plain side)
    with matmul_precision(tf32=False):
        errors = kernel_phase(S, torch)

    # 3-4. lightGCN serving, then free it
    kernels, csr = serve_lightgcn(args, root, card, torch, errors)
    gc.collect()
    torch.cuda.empty_cache()

    # 5. AdamW kernel phase
    t0 = time.perf_counter()
    FA.build_kernel()
    worst = adamw_phase(FA, torch)
    log(f"adamw phase (Triton build included): "
        f"{time.perf_counter() - t0:.1f} s")

    # 6. flagship training
    torch.cuda.reset_peak_memory_stats()
    trainer, entry = flagship_train(args, root, card, torch, csr, worst)
    kernels.append(entry)

    # 7. flagship serving from the trained trainer
    FA.reset_launch_counts()
    S.reset_launch_counts()
    t0 = time.perf_counter()
    rec = build_recommender(trainer.cfg, None, csr, N_USER, N_ITEM,
                            trainer=trainer, serve_batch=256, k_max=100)
    log(f"flagship build_recommender: {time.perf_counter() - t0:.1f} s")
    users_b = check_requests(rec, csr, N_ITEM, "flagship")
    assert FA.LAUNCHES["fused_adamw"] == 0 and not any(S.LAUNCHES.values())
    users = users_b[:256]
    excl = request_times(rec, users, card, "flagship")
    log(f"flagship request matmul work: {trainer.cfg.steps} forwards of "
        f"{flagship_matmul_flops(trainer.cfg, N_ITEM, 256, False):.4e} flop "
        f"from shapes")
    if args.profile:
        write_profile(args.profile, card, "5 flagship dispatches of 256 users",
                      lambda: [rec.recommend_batch(users, excl)
                               for _ in range(5)], torch, mode="a")
    del rec, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the flagship golden gate
    from gdmcf_torch.data.loader import generate_synthetic_dataset
    data_dir = tempfile.mkdtemp(prefix="gdmcf_golden_")
    try:
        generate_synthetic_dataset(data_dir, seed=0)
        t0 = time.perf_counter()
        entry["launches_golden"] = golden_phase(root, card, data_dir)
        log(f"golden phase: {time.perf_counter() - t0:.1f} s")

        # 9. fit at the Amazon-Book width
        torch.cuda.reset_peak_memory_stats()
        entry["launches_fit_amazon"] = fit_amazon_phase(root, card, torch,
                                                        csr)
        log(f"peak device memory of phase 9 "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        # 10. resume, then the CLI
        resume_phase(card, torch, data_dir)
        cli_phase(root, data_dir)

        # 11. gradients through the SpMM kernel (TF32 off)
        with matmul_precision(tf32=False):
            grad_err, grad_launches = gradient_phase(torch)
        for k in kernels[:2]:
            k["launches_gradient"] = grad_launches[k["name"]]
            k["max_abs_err_gradient"] = grad_err

        # 12. LightGCN pretraining at the Amazon-Book size
        t0 = time.perf_counter()
        spmm, adamw, bwd, stats, sample_ms = pretrain_phase(args, card,
                                                            torch, csr)
        for k in kernels[:2]:
            k["launches_pretrain_epoch"] = spmm[k["name"]]
            k["backward_ms"] = bwd[k["name"]]
        entry["launches_pretrain_epoch"] = adamw
        entry["pretrain_step_ms_p50"] = stats["excluded"][0]
        log(f"pretrain phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()

        # 13. the LightGCN golden gate, dense and hybrid
        t0 = time.perf_counter()
        gate = lightgcn_gate_phase(root, card, torch)
        for k in kernels[:2]:
            k["launches_lightgcn_gate"] = gate["hybrid"][k["name"]]
        entry["launches_lightgcn_gate"] = (gate["dense"]["fused_adamw"]
                                           + gate["hybrid"]["fused_adamw"])
        log(f"lightgcn gate phase: {time.perf_counter() - t0:.1f} s")

        # 14. the pretraining CLI
        pretrain_cli_phase(root, data_dir)

        # 15. DNN at OneHotMatrix 0 at the Amazon-Book width
        t0 = time.perf_counter()
        entry["launches_dnn_epoch"], dnn_err = dnn_phase(root, card, torch,
                                                         csr)
        entry["max_abs_err"] = max(entry["max_abs_err"], dnn_err)
        log(f"DNN phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()

        # 16. the backbone golden gates
        t0 = time.perf_counter()
        gates = backbone_gates_phase(root, card, data_dir)
        entry["launches_backbone_gates"] = sum(gates.values())
        entry["launches_by_gate"] = gates
        log(f"backbone gates phase: {time.perf_counter() - t0:.1f} s")

        # 17. HTTP serving, lightGCN and the flagship
        t0 = time.perf_counter()
        _, http_launches = http_phase(root, card, torch, csr)
        for k in kernels[:2]:
            k["launches_http_startup"] = http_launches[k["name"]]
            k["launches_http_requests_and_reloads"] = 0
        log(f"http phase: {time.perf_counter() - t0:.1f} s")

        # 18. the legacy and ablation gates, then their Amazon-width epochs
        t0 = time.perf_counter()
        entry["launches_variant_gates"] = variant_gates_phase(
            root, card, data_dir)
        entry["launches_variant_epochs"] = variant_epochs_phase(
            root, card, torch, csr)
        close_gate_pool()   # phase 18 trains the last gate
        log(f"variant phase: {time.perf_counter() - t0:.1f} s")

        # 19. the meshes: ranks sharing the card over gloo
        t0 = time.perf_counter()
        mesh = mesh_phase(root, card, torch, csr)
        entry["launches_mesh_steps_by_rank"] = mesh["fused_adamw"]
        for k in kernels[:2]:
            k["launches_mesh_lightgcn_startup_by_rank"] = [
                r[k["name"]] for r in mesh["spmm"]]
        log(f"mesh phase: {time.perf_counter() - t0:.1f} s")

        # 20. bfloat16 storage with float32 masters at the Amazon-Book width
        t0 = time.perf_counter()
        master_entry, plain_launches = precision_phase(root, card, torch,
                                                       csr)
        entry["launches_bf16_epochs"] = plain_launches
        kernels.append(master_entry)
        log(f"precision phase: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()

        # 21. serving on a mesh; the options that read across batch rows
        t0 = time.perf_counter()
        served = serve_mesh_phase(root, card, torch, csr)
        entry["launches_serve_mesh_steps_by_rank"] = served["fused_adamw"]
        for k in kernels[:2]:
            k["launches_serve_mesh_lightgcn_startup_by_rank"] = [
                r[k["name"]] for r in served["spmm"]]
        log(f"serve mesh phase: {time.perf_counter() - t0:.1f} s")

        # 22. recovery from a killed process; debug_nans on the card
        entry.update(fault_phase(root, card, torch, csr))
        del csr
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)

    # 23. results
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s of phases 1-22")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        close_gate_pool()
    sys.exit(rc)
