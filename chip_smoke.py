"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the Hopper kernels from ampnet_tpu_torch/ops/hopper/csrc, holds each
against its plain torch version on the card at the main path's shapes
(K1 edge_attention_sums, K2 edge_attention_layer, K3 edge_attention_bwd_dq,
K4 edge_attention_bwd_dkv, the edge-group sums K6 edge_attention_sums_mm
and K9 edge_attention_sums_v1 and the receiver-chunked sums K8
edge_attention_sums_chunked on the tensor cores in 3xTF32, each also held
against and timed in turns with its CUDA-core body, K2's two launches also
apart, K8's CUDA-core body also by its piece of a chunk; K5
edge_attention_bwd_stream on the tensor cores too, with its pass B and the
chunked fold; K7 edge_attention_layer_mm, whose attention launch is K6's
and whose projection launches are K2's tiled product, its three launches
also apart; K6, K8 and K9 also against K1's sums, K7 against K2's layer on
the same inputs), drives AMPConv at the shapes beyond the tensor-core range
(`routes`, with K1, K6 or K9 forward and K3 + K4 or K5 backward, and K8
on the chunked layout: the CUDA-core bodies, their working set in device
memory where it exceeds a block's shared memory, each against float64 on
the CPU), then drives the port at full width on the Cora-shaped surrogate,
where every launch of K1-K9 must run the tensor-core body. Every step runs
as the entry points run it on the card: a captured CUDA graph
(train/graphs.py), one per training step, one per 10 steps of path C, one
per 8-draw eval; launch counts are the replays' (each replay adds what its
capture recorded). Each path also runs its eager body from the same state
beside it: warm host ms, device ms and busy share, peak memory of both, the
capture's one-off ms, and the two results held together (losses at the
model limits):

  A  inference, the recommended recipe (S=40, tfidf, gcn2 head), 8-draw
     make_eval_step: K1 twice per draw;
  B  inference, the reference recipe's S=20: K2 twice per draw;
  C  training, the recommended recipe: create_train_state +
     train_full_batch (Adam with L2, clip 1.0, best-validation selection
     every 10 epochs with the 8-draw eval, 10 epochs per chunk), cut to
     TRAIN_EPOCHS of the recipe's 150. Each
     training step launches 2 K1 + 2 K3 + 2 K4 and no K2. One step's
     gradients (dropout rates 0, fixed sampled_idx) are held against
     float64 autograd on the CPU through the plain oracle, every parameter;
     the loss must be finite and fall;
  D  a few training steps at S=20 (row stride SP=24 > S): the training
     forward runs K1 where inference runs K2;
  native  the sampler of E and F (8 roots x 150 steps, coverage 100, seed
     1) built on the native core (data/native.py, g++ at first use) and on
     the numpy core in turns: build seconds and ms a subgraph of each; two
     native builds array-equal; every induced edge inside its node set,
     their count the numpy recount's;
  E  GraphSAINT training, the stabilized recipe (S=40, tfidf, gcn2 head, no
     edge dropout; the native sampler of 8 roots x 150 steps, coverage 100; lr 3e-3
     cosine over the run, clip 1.0, saint_loss='mean', selection every epoch
     with the 8-draw full-graph eval) through train_saint, cut to
     SAINT_EPOCHS x SAINT_STEPS: subgraphs share one per-tile edge budget,
     each step launches 2 K1 + 2 K3 + 2 K4; the loss must fall;
  F  the same sampler's subgraphs through make_pallas_train_step with
     compute_layout(sender_layout=False): each step launches 2 K1 + 2 K5 and
     no K3 / K4. One step's gradients are held against float64 autograd on
     the CPU and against path E's backward (K3 + K4) on the same subgraph
     and draw; the loss must fall; one more step runs on the full graph, so
     that K5 runs at the size of its kernel phase;
  G  the evals of A and B with MM_SCATTER_DEFAULT set: K6 twice per draw at
     S=40, K7 twice per draw at S=20; the fixed draw's logits also against
     path A's / B's own;
  H  a few training steps of the recommended recipe with MM_SCATTER_DEFAULT
     set: 2 K6 + 2 K3 + 2 K4 per step and no K1, gradients checked as in C;
     then the steps of D (S=20) with it: K6 where D runs K1;
  I  the eval of A with DMA_V1_DEFAULT set: K9 twice per draw and no K1.
  K  the synthetic XOR recipe (experiments/synthetic_training_modular.py:
     duplicated-feature XOR, 400 + 400 nodes, get_model('AMPNet') at D=32,
     H=2, S=20 with use_pallas, Adam 5e-3, clip 1.0): all 200 epochs as
     captured steps (2 K1 + 2 K3 + 2 K4, tensor cores) and one-draw evals of
     the test graph (2 K1 or 2 K2, whichever the route picks); one step's
     gradients and an eval against float64, the captured step against the
     eager body bit for bit; then its GraphSAINT variant, 50 epochs of 10
     subgraphs from native samplers (the node_norm-weighted sum), each
     step's and each eval's launches exact. K1-K4 then get kernel rows at
     K's shape (D=32, H=2, S=20 on its graphs), whose launches are K's.
  synthetic_models  GCN, GCNOneLayer (PCA table), LinearLayer,
     TwoLayerSigmoid and AMPNetClassifier (on the fused kernels) through
     get_model, 3 captured steps each on the XOR graph and a forward against
     float64; an RPG and a cyclic-CA graph through AMPGCN.
  tokenizers  AMPGCN evals through the pca frontend, balanced sampling and
     no downsampling (feature_repeats 1 and 5), launches by body, each
     against float64.
  serving  the recommended recipe's model, trained a few steps and saved
     with save_params, served by a Predictor (default buckets of 512 nodes
     and 4096 edges): 6 requests in 3 buckets (the whole surrogate and
     induced subgraphs), one captured graph per bucket, each answer equal to
     the eager forward bit for bit, K1 twice per request on the whole
     surrogate's bucket and K2 twice on the subgraphs' (the JAX predicate's
     route at each padded size), one answer against float64; a hot swap (Predictor.load_params) that changes the answers
     without a new capture; a Predictor at S=20 (K1 at the whole graph's
     bucket, where the JAX predicate finds v6 too large, K2 at a 1,024-node
     bucket) and a transformer-block + CLS model at S=40 (41 tokens, K1).
  bf16  the bf16 tensor-core bodies (K1-K9 on bf16 rows; K1, K2, K6 and K7
     also on f32 rows under mxu_bf16), each at the shape its path gives
     it (K8 at S=40 and S=20 through its public wrapper), against its
     plain version and timed in turns with its 3xTF32 body;
     path C in compute_dtype='bfloat16'; stream_bf16 and mxu_bf16 on the f32
     recipes; bf16 Predictors; path F on a bf16 model and under stream_bf16
     (2 K1 + 2 K5 a step on tc_bf16, captured = eager bit for bit, the
     gradients against float64, the final accuracy beside the f32 model's
     after the same steps); G, H and I on bf16 models, and G and H under
     mxu_bf16 at S=20.
  bf16_wide  every `routes` shape (and two S=20, H=8 evals, whose forward
     is K2, or K7 under MM_SCATTER_DEFAULT) as a bf16 conv, and where the
     JAX body honours mxu_bf16 as an f32 conv under it: the CUDA-core bf16
     bodies ('simt_bf16', K1-K9) beyond the tensor cores' range and on bf16
     rows the 16-byte copies cannot take (D=100), their working set in
     device memory where the f32 bodies' is; each conv against the same
     conv through the kernels' plain versions on the card and against
     float64 on the CPU, launches by body; K8 on bf16 rows at the chunked
     routes' shapes; the named bodies that still refuse (they launch
     nothing).
  J  the recommended recipe at S=64 (experiments/token_scale_tuning.py's
     default) as a bf16 model through train_full_batch: 2 K1 + 2 K3 + 2 K4
     a step, all three on 'tc_bf16' (a block per node and head); gradients
     against float64, 3 captured steps = eager bit for bit, an 8-draw eval
     against float64, the f32 model's step (K1, K3 and K4 on 'tc') in
     turns. Then each 'simt_bf16' body's kernel row at a shape bf16_wide
     ran it, timed in turns with the f32 CUDA-core body, and K1's, K3's and
     K4's tensor-core rows at S=64 ('tc_bf16' and 'tc'), timed in turns
     with their CUDA-core bodies.
  ssl  SSLPretrainer (train/ssl.py) in both modes on the recommended
     recipe's backbone through the fused op: make_ssl_train_step's captured
     step (2 K1 + 2 K3 + 2 K4, tensor cores; the negatives drawn inside the
     graph), 10 steps against the eager body bit for bit (losses,
     parameters, Adam's state, generator), 30 steps from a fresh state
     (launches exact, the loss falling, the classifier head moved by its
     L2 term alone), warm ms of both; one forward with the tokens and
     negatives injected and each mode's backward against float64 autograd
     on the CPU; a draw of negatives on the card, every one a valid node.
  drivers  the main path's drivers through their `train` functions:
     experiments/cora_benchmark_full --raw-residual for all 150 epochs
     (launches exact, the loss falling, test accuracy >= 0.80) and
     cora_benchmark_graphsaint --stabilized --fused --raw-residual
     --decay-lr cut to 3 epochs (launches exact); each history.csv written.
  interpret  visualize_cora_attn_coeffs's heatmaps (class pairs (0,0),
     (3,3), (0,3)) from the full driver's final checkpoint, the card's
     against a CPU float64 forward of the same params and draw; the
     activation stages and flattened gradients finite.
  entry  graft_entry.entry()'s fn (the flagship forward, a captured predict
     step; the plain path, no kernel launched): [768, 7], captured = eager
     bit for bit, against float64.
  experiments  (after interpret) every other driver of experiments/
     through its entry function (experiments_phase; the cuts in its line):
     eval_checkpoint on the full driver's checkpoint_best.pkl with --fused
     (16 K1, test accuracy >= 0.80), the seed and tuning drivers on the
     plain convs, the XOR drivers on the fused kernels (launches exact),
     grid_search in 2 children on the card, the freeze check (conv1 bit for
     bit), the MSE trainer, the RPG generator, the overfit harness, the
     linear baseline, the LR schedule, partitioned_graph1_timing (a
     one-rank NCCL group and a captured device loop: its ratio, its loss
     against the single-device step's), scaling_bench and
     halo_comm_accounting's counted bytes against the plan's on ranks
     sharing the card, halo_budget_run at the JAX driver's shape with both
     ranks on the card (HALO_BUDGET_FULL).
  parallel  (after release_graphs, before ssl) parallelism over
     torch.distributed, every rank a process of its own started by
     parallel.launch.spawn (their reports come back to this process; no rank
     prints a JSON line): (a) graft_entry.dryrun_multichip(4), data 2 x
     graph 2, four gloo ranks sharing the card at the cora scale (4,096 /
     32,768, D=128, H=4, S=20) with the halo exchange: a finite loss, the
     same on every rank, 2 K1 + 2 K3 + 2 K4 per rank on the tensor cores,
     N_all > N_loc; (b) the recommended recipe (dropout off) partitioned
     over graph=2 gloo ranks with the halo on the surrogate: the eval
     log-probs against the single-device port's eval on the same draw
     (MODEL_RTOL / MODEL_ATOL), one step's gradients through K3 + K4 and
     through K5 + pass B against the single-device step's (GRAD_RTOL of the
     largest entry), launches per rank, the eager step's ms; K1, K3, K4 and
     K5 + pass B at each rank's shape against their plain versions, ms and
     bound; (d) in the same group the head-parallel forward (heads 4 -> 2 +
     2) against the single-device plain forward, and the distributed
     GraphSAINT driver (DRIVER_EPOCHS x DRIVER_STEPS, its loss falling);
     (c) a one-rank NCCL group: the data x graph = 1 x 1 step's gradients
     against the single-device step's. The gloo collectives the card takes
     on CUDA tensors run on them; the point-to-point halo is staged through
     host memory (the line's `staged` counts).
K8 has no caller on the model path (as in the JAX package): its phase calls
the public wrapper on the chunked layout of the same graph, its counts set
to 0 just before and read just after. The `captured` phase holds captured
against eager bit for bit on A's 8-draw eval, 10 steps of C (one 10-step
graph), 3 subgraphs of E and F's 3 steps (pass B sums in a fixed order);
`profile_steps` trains path C with profile_steps=3 and
requires K1, K3 and K4 in the trace it writes.

Each path's launch counts are set to 0 just before it runs and read right
after; for A and B one draw with a fixed sampled_idx is checked against the
same model and draw on the CPU in float64; where that check fails, the
raw residual's operands and stage outputs are kept in EVIDENCE_DIR. Weights
are random, made from --seed. Prints the card's name and power limit, a
`kernels` JSON line, and last {"ok": true, "device": ...}. Exits non-zero
when any phase fails or there is no CUDA device.

All float32 math runs at IEEE precision: TF32 on the card (cuBLAS, cuDNN)
and reduced-precision float32 in oneDNN on the host are switched off, so
that neither the environment nor a library default can loosen the checks.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# read by cuBLAS/cuDNN when they load: TF32 off whatever the environment says
os.environ["NVIDIA_TF32_OVERRIDE"] = "0"

import torch  # noqa: E402

# Kernel vs plain version on the card, both f32: the kernel sums in
# in-edge order per receiver, the plain version with index_add_ after
# batched matmuls, so results differ by rounding only.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# Card (f32) vs the same forward in f64 on the CPU, whole model (two
# convs, two GCN hops, head; log-probs): the card's f32 rounding only.
MODEL_RTOL, MODEL_ATOL = 1e-4, 2e-4
# One training step's gradients, card (f32, K1 + K3 + K4) vs float64 autograd
# on the CPU through the plain oracle: per parameter, max abs error against
# GRAD_RTOL times the gradient's largest entry (f32 sums over 2708 x S token
# rows taken in another order; measured ~1e-6 of the largest entry). The
# float64 forward takes each ReLU's branch as the card took it: of the 14 M
# activations a few lie within f32 rounding of 0, and one that takes the
# other branch in float64 moves a bias gradient by ~1e-3 of its largest
# entry, which says nothing about the kernels.
GRAD_RTOL = 1e-4
# modules whose output goes straight into a ReLU
RELU_INPUTS = ("conv1", "conv2", "raw_residual_proj", "raw_residual_conv1",
               "raw_residual_conv2")
# epochs of path C (of the recipe's 150) and of the short paths D and H
TRAIN_EPOCHS, SHORT_EPOCHS = 50, 3
# paths E and F: the recipe's 50 epochs x 200 subgraphs cut to this depth
SAINT_EPOCHS, SAINT_STEPS = 2, 30
# the chunked fold of the stream backward, against the unchunked one
FOLD_BUDGET = 128 * 1024 * 1024
KERNELS = ("edge_attention_sums", "edge_attention_layer", "edge_attention_bwd_dq",
           "edge_attention_bwd_dkv", "edge_attention_bwd_stream",
           "edge_attention_sums_mm", "edge_attention_layer_mm",
           "edge_attention_sums_chunked", "edge_attention_sums_v1")
K1_, K2_, K3_, K4_, K5_, K6_, K7_, K8_, K9_ = KERNELS
# K8's chunk: build_chunked_csr's default
CHUNK_EDGES = 8
# modules whose outputs are compared stage by stage when the logits disagree
# (a GCN layer's product alone as its ``.lin``)
STAGES = ("tokenizer", "conv1", "conv2", "raw_residual_proj", "raw_residual_conv1.lin",
          "raw_residual_conv1", "raw_residual_conv2.lin", "raw_residual_conv2",
          "final_linear_out")
# H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores, TF32 on
# the tensor cores, HBM3. The tensor-core kernels (K1-K4) compute each f32
# product as three TF32 products (3xTF32): their operations are priced at
# three times the FLOP over the TF32 peak.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the bf16 phase. A bf16 body against its plain version on the card,
# relative to the largest entry of the output: one bf16 step (2**-8). The
# products are exact in f32 and both round their operands at the same
# points, so they differ in the order of f32 sums, and where that moves a
# softmax weight or dS (K2: its mean) across a bf16 rounding boundary, one
# term moves by a bf16 step of its own size (measured 1.5e-3 for K1 at
# S=40); K2's bf16 output is rounded itself: two steps.
BF16_KERNEL_LIMIT, BF16_OUTPUT_LIMIT = 2.0 ** -8, 2 * 2.0 ** -8
# one bf16 training step's gradients against float64 autograd on the CPU,
# per parameter, of its largest entry: every product's operands, the
# projected rows, the layer's output and the dsum rows round to bf16
# (measured 6.6e-3, conv2.w_out)
BF16_GRAD_RTOL = 2e-2
# stream_bf16 against the f32 step on the same weights and draw, as the JAX
# package's own test holds them (tests/test_stream_bf16.py): the loss to
# 2e-2 relative, every gradient entry to rtol 5e-2 / atol 5e-2. That atol
# passes a zero gradient where the largest entry is below it (conv2.b_out's
# is ~1.6e-2), so each stream_bf16 gradient is also held against float64
# autograd at BF16_GRAD_RTOL of its own largest entry (measured 1.9e-3,
# conv2.w_qkv, on an H100), where a zero or wrong gradient reads ~1
STREAM_LOSS_RTOL, STREAM_GRAD_RTOL, STREAM_GRAD_ATOL = 2e-2, 5e-2, 5e-2
# mxu_bf16's eval (the attention's operands rounded) against float64 on the
# CPU, log-probs, absolute (measured 4.8e-4 at S=20)
MXU_LOGITS_ATOL = 5e-3
# a bf16 model's served log-probs (K2 at S=40, the 1,024-node bucket)
# against the CPU float64 forward, of the reference's largest entry: one
# bf16 step (measured 1.7e-4 on an H100)
BF16_LOGITS_RTOL = 2.0 ** -8
# the bf16 libraries (K1; K2 with its bf16 projection; K3; K4)
BF16_LIBS = ("edge_attention_tc_bf16", "edge_attention_layer_tc_bf16",
             "edge_attention_bwd_dq_tc_bf16", "edge_attention_bwd_tc_bf16")
# the libraries of the tensor-core bodies (K1-K5; K6 and K9; K8; K7's
# projection launches are K2's library's)
TENSOR_CORE_LIBS = ("edge_attention_tc", "edge_attention_layer_tc", "edge_attention_bwd_dq_tc",
                    "edge_attention_bwd_tc", "edge_attention_bwd_stream_tc",
                    "edge_attention_groups_tc", "edge_attention_chunked_tc")
# the `routes` phase: AMPConv at shapes beyond the tensor-core range (S, D,
# H, training, the body K1-K4 (K6, K9) must run (one for all, or by
# kernel: K1, K3 and K4 take 48 < S <= 64 on the tensor cores, the others
# do not), the kernels whose working set must be in device memory, the
# forward route: K1, or K6 under MM_SCATTER_DEFAULT, or K9 under
# DMA_V1_DEFAULT). An eval runs on a graph
# of Cora's node count (the JAX gather rule then picks K1, not K2, from S=29
# on: 'dma', so K6 and K9 too) with every 10th of its edges, a training step
# on the edges among its first ROUTE_NODES nodes: the float64 reference on
# the host is the phase's cost.
MM, V1 = "MM_SCATTER_DEFAULT", "DMA_V1_DEFAULT"
# a training case on a layout without a sender side: K5 for K3 + K4
STREAM = "sender_layout=False"
ROUTES = (
    (40, 128, 1, True, "simt", (), None),     # D/H = 128
    (40, 128, 2, True, "simt", (), None),     # D/H = 64
    (20, 128, 8, True, "simt", (), None),     # 16 warps where S <= 24 takes 8
    (40, 128, 8, True, "simt", (), None),     # 24 warps; K4's CUDA-core body at 225,920 B
    (49, 128, 4, False, "tc", (), None),      # K1 at a seventh key tile: a block per head
    (40, 3, 1, True, "simt", (), None),       # odd D: no 16-byte copies
    (40, 100, 4, True, "tc", (), None),       # dh = 25: stays on the tensor cores
    (96, 128, 4, False, "simt", ("edge_attention_sums",), None),    # 345 KB a block
    (49, 128, 4, True, "tc", (), None),       # K1, K3 and K4 a block per head
    (65, 128, 4, True, "simt", (K3_, K4_), None),  # beyond S=64: 319 KB and 353 KB a block
    (96, 128, 4, False, "simt", ("edge_attention_sums_mm",), MM),   # K6 at group 1: 345 KB
    (96, 128, 4, False, "simt", ("edge_attention_sums_v1",), V1),   # K9: 296 KB
    (49, 128, 4, True, {K6_: "simt", K3_: "tc", K4_: "tc"}, (), MM),  # K6 beyond the tcs
    (40, 128, 8, True, "simt", (), MM),       # K6 beyond the warp limit
    (49, 128, 4, True, {K1_: "tc", K5_: "simt"}, (), STREAM),  # K5 beyond them: 216,880 B
)
ROUTE_NODES = 768
# where a failed model check keeps its operands and stage outputs (in a
# directory .gitignore lists), and at most how many such files
EVIDENCE_DIR = Path(__file__).resolve().parent / "chiprun_out" / "path_a_evidence"
EVIDENCE_KEEP = 3
# K8 (no AMPConv route reaches it) beyond the tensor cores, on the eval
# graph's chunked layout: (S, whether its working set must be in device
# memory)
CHUNKED_ROUTES = ((96, True),     # 345 KB a block even at a piece of one edge
                  (49, False))    # a seventh key tile; 144 KB at a piece of one edge


START = time.perf_counter()


def emit(report: dict) -> None:
    """Print one phase's JSON line, with the seconds since the start."""
    print(json.dumps({**report, "t_s": time.perf_counter() - START}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def launches(k1=0, k2=0, k3=0, k4=0, k5=0, k6=0, k7=0, k8=0, k9=0) -> dict:
    """Launch counts by wrapper, as launch_counts() reports them."""
    return dict(zip(KERNELS, (k1, k2, k3, k4, k5, k6, k7, k8, k9)))


@contextlib.contextmanager
def dispatch_flag(name):
    """A dispatch constant of the fused op (an environment default) set for
    the block."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    before = getattr(eaf, name)
    setattr(eaf, name, True)
    try:
        yield
    finally:
        setattr(eaf, name, before)


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def pin_ieee_f32() -> None:
    """Full float32 precision in every matmul and convolution, card and host."""
    if hasattr(torch.backends, "fp32_precision"):   # torch >= 2.9
        torch.backends.fp32_precision = "ieee"
        for b in (torch.backends.cuda.matmul, torch.backends.cudnn,
                  torch.backends.mkldnn, torch.backends.mkldnn.matmul):
            b.fp32_precision = "ieee"
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def precision_state() -> dict:
    """The precision settings and environment this run computed under."""
    state = {"torch": torch.__version__, "cuda": torch.version.cuda,
             "cpu_threads": torch.get_num_threads()}
    try:
        state["matmul_precision"] = torch.get_float32_matmul_precision()
    except RuntimeError as e:     # the backends were set apart through the new API
        state["matmul_precision"] = str(e)[:80]
    if hasattr(torch.backends, "fp32_precision"):
        state["fp32_precision"] = {
            "global": torch.backends.fp32_precision,
            "cuda.matmul": torch.backends.cuda.matmul.fp32_precision,
            "cudnn": torch.backends.cudnn.fp32_precision,
            "mkldnn.matmul": torch.backends.mkldnn.matmul.fp32_precision}
    state["env"] = {k: v for k, v in sorted(os.environ.items())
                    if re.search(r"TF32|ONEDNN|DNNL|MKL|^OMP_|CUBLAS|^TORCH|^PYTORCH", k)}
    return state


def stage_outputs(model, graph, sidx, layout):
    """Log-probs of one fixed draw, and each stage's output, on the CPU."""
    outs = {}
    modules = dict(model.named_modules())
    hooks = [modules[name].register_forward_hook(
        lambda mod, i, o, name=name: outs.__setitem__(
            name, (o[0] if isinstance(o, tuple) else o).detach().cpu().double()))
        for name in STAGES if name in modules]
    try:
        with torch.no_grad():
            logp = model(graph, sampled_idx=sidx, edge_layout=layout)
    finally:
        for h in hooks:
            h.remove()
    return logp.detach().cpu(), outs


def cpu_f64_reference(model, graph, sidx):
    """The same model and draw on the CPU in float64, its convs on the plain
    oracle (the fused op computes in float32 only). Float64 throughout: the
    raw residual's GCN layers normalize in the features' type
    (ops/gcn.py), so no step of the reference runs through the host's
    float32 kernels, whose 1/sqrt came out at ~12 bits in some processes."""
    ref = copy.deepcopy(model).to("cpu", torch.float64)
    for conv in (ref.conv1, ref.conv2):
        conv.use_pallas, conv.dtype = False, None
    g = graph.to("cpu")
    g.x = g.x.double()
    return stage_outputs(ref, g, sidx.cpu(), None)


def raw_residual_product(model, graph, card_lin) -> dict:
    """Where the raw residual's first product (raw_residual_conv1.lin's card
    output ``card_lin``, on the CPU in float64) leaves float64: against the
    CPU's float64 product, the card's float64 product, the same F.linear
    taken again on the card (with the kernels it ran), the product with a
    contiguous W^T (another cuBLAS layout), and ONE TF32 product of the same
    f32 operands (rounded to 10 mantissa bits, the product exact). Near the
    TF32 product and far from both float64 products: that product ran in
    TF32; the card's products agreeing and the CPU's apart: the reference
    is at fault."""
    import torch.nn.functional as F
    from ampnet_tpu_torch.ops.tokenize import standardize

    def tf32(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    def err(a, b):
        return float((a.cpu().double() - b.cpu().double()).abs().max())

    with torch.no_grad():
        x = standardize(graph.x, mean=model.scaler_mean, std=model.scaler_std,
                        node_mask=graph.node_mask)
        w = model.raw_residual_conv1.lin.weight.detach()
        cpu_f64 = x.cpu().double() @ w.cpu().double().T
        card_f64 = x.double() @ w.double().T
        again = {}
        kernels = device_kernels(lambda: again.update(y=F.linear(x, w))) if x.is_cuda else \
            again.update(y=F.linear(x, w))
        nn_layout = x @ w.T.contiguous()
        one_tf32 = tf32(x.cpu()).double() @ tf32(w.cpu()).double().T
    return dict(vs_cpu_f64=err(card_lin, cpu_f64), vs_card_f64=err(card_lin, card_f64),
                card_f64_vs_cpu_f64=err(card_f64, cpu_f64),
                again_vs_card_f64=err(again["y"], card_f64), again_kernels=kernels,
                nn_layout_vs_card_f64=err(nn_layout, card_f64),
                vs_one_tf32_product=err(card_lin, one_tf32),
                cpu_f64_vs_one_tf32_product=err(cpu_f64, one_tf32))


def save_evidence(model, graph, card_stages, ref_stages, second_stages, kernels) -> str:
    """On a failed model check: the raw residual's operands and each GCN
    stage's card output, kept for study after the process has exited, in
    EVIDENCE_DIR (gitignored): the standardized x, W and b of both GCN
    layers, each layer's .lin output and aggregate output on the card (the
    first forward's and the second's), the aggregate's inputs (the edge
    lists and mask), the float64 reference's stages, cuBLAS's own second
    product of the same operands, and the kernels the second forward ran.
    At most EVIDENCE_KEEP files (x alone is 15.8 MB); returns the path, or
    why nothing was written."""
    import torch.nn.functional as F
    from ampnet_tpu_torch.ops.tokenize import standardize

    if not hasattr(model, "raw_residual_conv2"):
        return "not written: the model has no GCN raw residual"
    EVIDENCE_DIR.mkdir(parents=True, exist_ok=True)
    if len(list(EVIDENCE_DIR.glob("*.pt"))) >= EVIDENCE_KEEP:
        return f"not written: {EVIDENCE_KEEP} files in {EVIDENCE_DIR} already"
    gcn = [k for k in STAGES if k.startswith("raw_residual_conv") or k == "final_linear_out"]
    with torch.no_grad():
        x = standardize(graph.x, mean=model.scaler_mean, std=model.scaler_std,
                        node_mask=graph.node_mask)
        w1 = model.raw_residual_conv1.lin.weight
        evidence = dict(
            x=x.cpu(), w1=w1.cpu(), b1=model.raw_residual_conv1.bias.cpu(),
            w2=model.raw_residual_conv2.lin.weight.cpu(),
            b2=model.raw_residual_conv2.bias.cpu(),
            lin_again=F.linear(x, w1).cpu(),
            senders=graph.senders.cpu(), receivers=graph.receivers.cpu(),
            edge_mask=graph.edge_mask.cpu(), num_nodes=graph.num_nodes_padded,
            card={k: card_stages[k].float() for k in gcn if k in card_stages},
            card_second={k: second_stages[k].float() for k in gcn if k in second_stages},
            reference_f64={k: ref_stages[k] for k in gcn if k in ref_stages},
            second_forward_kernels=kernels, precision=precision_state(),
            device=torch.cuda.get_device_name(0))
    path = EVIDENCE_DIR / f"path_a_{os.getpid()}_{time.time_ns()}.pt"
    torch.save(evidence, path)
    return str(path)


def device_kernels(fn) -> dict:
    """The kernels one call of fn launches on the card, by name in launch
    order, with their counts (torch.profiler; {} where it sees no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)),
                    key=lambda e: e.time_range.start):
        names[e.name] = names.get(e.name, 0) + 1
    return names


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the device functions of the port's kernels, as a profiler names them
PORT_KERNEL_FUNCTIONS = (
    "sums_tc_kernel", "mean_out_tc_kernel", "projection_tc_kernel", "dq_tc_kernel",
    "dkv_tc_kernel", "stream_tc_kernel", "groups_tc_kernel", "chunked_tc_kernel",
    "edge_attention_kernel", "edge_attention_bwd_kernel", "edge_group_kernel",
    "edge_chunk_kernel", "projection_kernel", "sums_bf16_kernel", "dq_bf16_kernel",
    "dkv_bf16_kernel", "projection_bf16_kernel", "chunked_bf16_kernel", "dq_tc_wide_kernel",
    "dq_bf16_wide_kernel")
_PORT_KERNEL_WORDS = {fn: re.compile(rf"(?<![A-Za-z0-9_]){fn}(?![A-Za-z0-9_])")
                      for fn in PORT_KERNEL_FUNCTIONS}


def port_kernels(names) -> dict:
    """How many of ``names`` (kernels a profiler recorded) are each of the
    port's device functions; the ones never named are left out."""
    counts = {fn: sum(bool(w.search(n)) for n in names) for fn, w in _PORT_KERNEL_WORDS.items()}
    return {fn: c for fn, c in counts.items() if c}


def device_profile(fn, reps: int = 3) -> dict:
    """torch.profiler over ``reps`` calls of fn (after one to warm up): the
    card's kernel time per call and the kernels that take most of it. With
    the host-timed call beside it, this is the device's busy share; an
    empty trace (no CUPTI on the machine) reports device_ms None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # a measurement, not a check: say why it is missing
        return dict(device_ms=None, error=str(e)[:200])
    # kernels, copies and fills on the card; not the ranges that annotate them
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_kernel = {}
    for e in on_card:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3 / reps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return dict(device_ms=sum(by_kernel.values()) if by_kernel else None,
                kernels_per_call=len(on_card) / reps,
                port_kernels_per_call={k: c / reps for k, c in port_kernels(
                    [e.name for e in on_card]).items()},
                top_kernels_ms=[[name[:80], ms] for name, ms in top])


def busy_share(profile_report: dict, warm_ms: float) -> dict:
    """The profile with the device's busy share of the unprofiled warm step."""
    if profile_report["device_ms"] is not None:
        profile_report["busy_share"] = profile_report["device_ms"] / warm_ms
    return profile_report


def bound_ms(nbytes: float, flops: float, tensor_cores: bool = False):
    """(ms, what bounds it): the larger of the bytes over the memory rate and
    the f32 operations over the CUDA cores' rate, or, for f32 products the
    card can run on its tensor cores in 3xTF32, three TF32 products per f32
    product over theirs."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 3 * flops / PEAK_TF32_FLOPS if tensor_cores else flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bf16_bound_ms(nbytes: float, flops: float):
    """(ms, what bounds it): bytes over the memory rate, or bf16 products
    over the tensor cores' bf16 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_of(stem: str, *words: str) -> dict:
    """Registers and spill bytes of the kernel in csrc/<stem>.cu's ptxas log
    whose mangled name holds every word (the bf16 libraries instantiate one
    template for bf16 and for f32 rows, which build.parse_ptxas keys alike)."""
    from ampnet_tpu_torch.ops.hopper import build

    log = build.build_all()[stem].with_suffix(".log").read_text()
    found = [dict(regs=int(r), spills=int(st) + int(ld))
             for name, st, ld, r in build._PTXAS_ENTRY.findall(log)
             if all(w in name for w in words)]
    if len(found) != 1:
        fail(f"ptxas of {stem}: {len(found)} kernels named with {words}")
    return found[0]


def in_turns(old, new, iters: int = 10):
    """(new ms, old ms): old, new, new, old on the same inputs, each the mean
    of ``iters`` launches; each result the mean of its two turns."""
    t = [cuda_ms(fn, iters) for fn in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def tensor_core_row(row, lib, info_fn, nt, s, d, h, old, new, ptxas, also=None):
    """A tensor-core kernel's row: its time in turns with its CUDA-core body
    (``prev_ms``), and what its launch runs with (registers, spills from
    ptxas, blocks per SM, ring stages). ``spills`` counts every kernel of
    the library that the launch runs: the instantiation at S, and the
    kernels whose names contain ``also`` (K2: its projection)."""
    from ampnet_tpu_torch.ops.hopper.launch import kernel_info

    ms, prev_ms = in_turns(old, new)
    info = kernel_info(lib, info_fn, nt, s, d, h)
    report = ptxas[(lib, -(-s // 8))]
    spills = report["spill_stores"] + report["spill_loads"]
    spills += sum(r["spill_stores"] + r["spill_loads"] for (stem, key), r in ptxas.items()
                  if stem == lib and also and isinstance(key, str) and also in key)
    row.update(ms=ms, prev_ms=prev_ms, speedup=prev_ms / ms, regs=info["regs"],
               spills=spills, blocks_per_sm=info["blocks_per_sm"], stages=info["stages"],
               smem_bytes=info["smem_bytes"], precision="3xtf32")
    return row


def compare(name, got, ref, what="its plain version"):
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        fail(f"{name}: kernel disagrees with {what} (max abs err {err:.3g})")
    return err


def cora(seed: int, device):
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.data.planetoid import synthetic_cora

    d = synthetic_cora(seed)
    g = from_arrays(d.x, d.edge_index, y=d.y, train_mask=d.train_mask,
                    val_mask=d.val_mask, test_mask=d.test_mask,
                    pad_nodes_to=2752, pad_edges_to=10624)
    return d, g.to(device)


def pass_b_index_add(stream, tile_senders, take, out, s, sp):
    """Pass B as it was summed before its fixed order: ``index_add_`` (float
    atomics in no fixed order), the rows not taken spread over the nodes."""
    rows = stream.view(-1, sp, stream.shape[1])[:, :s]
    spread = torch.arange(rows.shape[0], device=rows.device) % out.shape[0]
    senders = torch.where(take, tile_senders.reshape(-1)[: rows.shape[0]].long(), spread)
    return out.index_add_(0, senders, torch.where(take[:, None, None], rows, 0.0))


def pass_b_report(stream, tile_senders, take, out, s, sp) -> dict:
    """Pass B (``stream_to_senders``, the sorted fixed-order sum) over the
    whole stream: two runs bit for bit, against the ``index_add_`` sum at
    the kernel limits, and timed in turns with it."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb

    def fixed():
        return sb.stream_to_senders(stream, tile_senders, take, 0, out.zero_(), s=s, sp=sp)

    first, second = fixed().clone(), fixed().clone()
    if not torch.equal(first, second):
        fail(f"pass B S={s}: a second run differs from the first")
    err = compare(f"pass B S={s}", first, pass_b_index_add(
        stream, tile_senders, take, torch.zeros_like(out), s, sp), "the index_add_ sum")
    ms, atomic_ms = in_turns(
        lambda: pass_b_index_add(stream, tile_senders, take, out.zero_(), s, sp), fixed)
    return dict(pass_b_ms=ms, pass_b_index_add_ms=atomic_ms, pass_b_vs_index_add_max_abs_err=err)


def kernel_phases(graph, layout, gen, dev, ptxas):
    """K1, K3, K4, K5, K6, K8 and K9 at S=40 and S=20, K2 and K7 at S=20, each
    against its plain version (K6, K8, K9 also against K1's sums, K7 against
    K2's layer; each kernel's CUDA-core body too, timed in turns with its
    tensor-core body); K5's pass B and chunked fold beside it. Returns the
    rows and K8's launches in its driven phase."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
    from ampnet_tpu_torch.ops.hopper.format import (chunk_slot_valid,
                                                    compute_chunked_layout,
                                                    edge_slot_valid, snd_slot_valid)
    from ampnet_tpu_torch.ops.segment import segment_count

    d, h = 128, 4
    n = graph.num_nodes_padded
    nt = layout.recv_ptr.numel() - 1
    # a runtime mask that drops every 50th live edge
    mask = graph.edge_mask.clone()
    mask[torch.nonzero(mask)[::50, 0]] = False
    valid = edge_slot_valid(layout, mask)
    idx = (layout.tile_senders, valid, layout.recv_ptr, layout.recv_slots)
    snd_valid = snd_slot_valid(layout, mask)
    snd_idx = (layout.snd_receivers, snd_valid, layout.snd_ptr, layout.snd_slots)
    live_edges = int(valid.sum())
    if int(snd_valid.sum()) != live_edges:
        fail("the sender side's runtime validity counts other edges than the receiver side's")
    snd_index_bytes = 4 * (2 * layout.snd_receivers.numel() + layout.snd_ptr.numel()
                           + layout.snd_slots.numel())
    count = segment_count(graph.receivers, n, mask)
    index_bytes = 4 * (2 * layout.tile_senders.numel() + layout.recv_ptr.numel()
                       + layout.recv_slots.numel())
    # what the slot-walking kernels (K6, K7, K9) and the chunked one (K8) read
    tn = layout.tile_nodes
    slots = (layout.tile_senders, layout.tile_recv, valid)
    slot_bytes = 4 * 3 * layout.tile_senders.numel()
    chunked = compute_chunked_layout(graph, chunk_edges=CHUNK_EDGES)
    chunk_valid = chunk_slot_valid(chunked, mask)
    if int(chunk_valid.sum()) != live_edges:
        fail("the chunked layout's runtime validity counts other edges than the tiled one's")
    chunk_args = (chunked.senders, chunk_valid, chunked.chunk_start, chunked.chunk_count)
    chunk_bytes = 4 * (2 * chunked.senders.numel() + 2 * chunked.chunk_start.numel())
    k8_launches = 0
    rows = {}
    for s in (40, 20):
        sp = -(-s // 8) * 8
        qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=dev)
        kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
        got = eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw)
        ref = eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *idx, **kw)
        old = eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw, body="simt")
        torch.cuda.synchronize()
        err = compare(f"edge_attention_sums S={s}", got, ref)
        prev_err = compare(f"edge_attention_sums (CUDA cores) S={s}", old, ref)
        if not torch.equal(got, eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw)):
            fail(f"edge_attention_sums S={s}: a second launch differs from the first")
        k1_sums = got
        del old
        b, by = bound_ms(4 * d * n * s * 4 + index_bytes, 4 * s * s * d * live_edges, True)
        rows[f"edge_attention_sums_s{s}"] = tensor_core_row(dict(
            name="edge_attention_sums", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_tc.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_fused.py:"
                     + ("942" if s == 40 else "691"),
            max_abs_err=err, prev_max_abs_err=prev_err,
            plain_ms=cuda_ms(lambda: eaf.edge_attention_sums_plain(
                qkv[:, :d], qkv[:, d:], *idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None),
            "edge_attention_tc", "ampnet_edge_attention_sums_info", nt, s, d, h,
            lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw, body="simt"),
            lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw), ptxas)

        # K6, K9, K8 on the same rows: against their plain versions and K1's sums
        q, kv = qkv[:, :d], qkv[:, d:]
        rows_bytes, flops = 4 * d * n * s * 4, 4 * s * s * d * live_edges

        def variant_row(name, replaces, source, run, plain, index_bytes, tensor_cores=False):
            """The row of K6, K8 or K9 without its time."""
            got, ref = run(), plain()
            torch.cuda.synchronize()
            b, by = bound_ms(rows_bytes + index_bytes, flops, tensor_cores)
            return dict(
                name=name, route="cuda",
                source=f"ampnet_tpu_torch/ops/hopper/csrc/{source}",
                replaces=f"ampnet_tpu/ops/pallas/edge_attention_fused.py:{replaces}",
                max_abs_err=compare(f"{name} S={s}", got, ref),
                k1_max_abs_err=compare(f"{name} S={s}", got, k1_sums, "K1's sums"),
                plain_ms=cuda_ms(plain, 3), bound_ms=b, bound_by=by, library_ms=None,
                **({"f32_bound_ms": bound_ms(rows_bytes + index_bytes, flops)[0]}
                   if tensor_cores else {}))

        # K6 and K9 on the tensor cores: their CUDA-core bodies held against
        # the plain versions too, and timed in turns with them
        mm = dict(**kw, tile_nodes=tn)
        tiles, emax = layout.tile_senders.shape
        for name, replaces, run, plain, index_bytes, group in (
                ("edge_attention_sums_mm", 1126 if s == 40 else 731,
                 lambda body=None, g=None: eav.edge_attention_sums_mm(
                     q, kv, *slots, layout.tile_counts, **mm, group=g, body=body),
                 lambda: eav.edge_attention_sums_mm_plain(q, kv, *slots, layout.tile_counts,
                                                          **mm, group=eav.MM_GROUP),
                 slot_bytes + 4 * layout.tile_counts.numel(), eav.MM_GROUP),
                ("edge_attention_sums_v1", 186 if s == 40 else 294,
                 lambda body=None, g=None: eav.edge_attention_sums_v1(
                     q, kv, *slots, **mm, group=8, gather="dma" if s == 40 else "vmem",
                     body=body),
                 lambda: eav.edge_attention_sums_v1_plain(q, kv, *slots, **mm, group=8),
                 slot_bytes, 8)):
            row = variant_row(name, replaces, "edge_attention_groups_tc.cu", run, plain,
                              index_bytes, tensor_cores=True)
            old, ref = run("simt"), plain()
            row["prev_max_abs_err"] = compare(f"{name} (CUDA cores) S={s}", old, ref)
            row["prev_k1_max_abs_err"] = compare(f"{name} (CUDA cores) S={s}", old, k1_sums,
                                                 "K1's sums")
            del old, ref
            rows[f"{name}_s{s}"] = tensor_core_row(
                row, "edge_attention_groups_tc", "ampnet_edge_attention_groups_info",
                tiles * -(-emax // group), s, d, h, lambda: run("simt"), run, ptxas)
            rows[f"{name}_s{s}"]["group"] = group
        # K6's group: how many slots a run of register sums may span (the
        # JAX group, 768 // SP, last)
        rows[f"edge_attention_sums_mm_s{s}"]["by_group_ms"] = {
            g: cuda_ms(lambda: eav.edge_attention_sums_mm(
                q, kv, *slots, layout.tile_counts, **mm, group=g), 10)
            for g in (1, 4, 8, 768 // sp)}
        for gather in ("dma", "vmem"):     # one kernel, held under both names
            compare(f"edge_attention_sums_v1 S={s} gather={gather}",
                    eav.edge_attention_sums_v1(q, kv, *slots, **mm, group=8, gather=gather),
                    k1_sums, "K1's sums")
        ck = dict(**kw, chunk=CHUNK_EDGES)
        k8 = lambda body=None, piece=None: eav.edge_attention_sums_chunked(  # noqa: E731
            q, kv, *chunk_args, **ck, piece=piece, body=body)
        eaf.reset_launch_counts()          # K8's phase of its own
        got = k8()
        torch.cuda.synchronize()
        counts = eaf.launch_counts()
        tensor_cores_only(f"K8 S={s}", counts)
        k8_launches += counts["edge_attention_sums_chunked"]
        if not torch.equal(got, k8()):
            fail(f"edge_attention_sums_chunked S={s}: a second launch differs from the first")
        del got
        row = variant_row(
            "edge_attention_sums_chunked", 1225, "edge_attention_chunked_tc.cu", k8,
            lambda: eav.edge_attention_sums_chunked_plain(q, kv, *chunk_args, **ck),
            chunk_bytes, tensor_cores=True)
        old = k8("simt")
        row["prev_max_abs_err"] = compare(f"edge_attention_sums_chunked (CUDA cores) S={s}",
                                          old, eav.edge_attention_sums_chunked_plain(
                                              q, kv, *chunk_args, **ck))
        row["prev_k1_max_abs_err"] = compare(f"edge_attention_sums_chunked (CUDA cores) S={s}",
                                             old, k1_sums, "K1's sums")
        del old
        rows[f"edge_attention_sums_chunked_s{s}"] = tensor_core_row(
            row, "edge_attention_chunked_tc", "ampnet_edge_attention_sums_chunked_info",
            nt, s, d, h, lambda: k8("simt"), k8, ptxas)
        # the CUDA-core body's piece of a chunk (its default: as many as fit)
        rows[f"edge_attention_sums_chunked_s{s}"].update(
            chunk=CHUNK_EDGES, live_chunks=int(chunked.chunk_count.sum()),
            chunk_slots=chunked.senders.numel(), by_piece_ms={p: cuda_ms(
                lambda: k8("simt", p), 10) for p in ((1, 2) if s == 40 else (1, 2, 3, 4, 7))})
        del k1_sums

        # K3 / K4 on the same rows, dsum random: [Q | dsum] packed per row
        qdm = torch.cat([qkv[:, :d], torch.randn(nt * sp, d, generator=gen, device=dev)], 1)
        q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
        got = bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw)
        ref = bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *idx, **kw)
        old = bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw, body="simt")
        torch.cuda.synchronize()
        err = compare(f"edge_attention_bwd_dq S={s}", got, ref)
        prev_err = compare(f"edge_attention_bwd_dq (CUDA cores) S={s}", old, ref)
        if not torch.equal(got, bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw)):
            fail(f"edge_attention_bwd_dq S={s}: a second launch differs from the first")
        del old
        # q, dsum, k|v read and dq written once; 3 products of 2*S*S*D per edge
        b, by = bound_ms(5 * d * n * s * 4 + index_bytes, 6 * s * s * d * live_edges, True)
        rows[f"edge_attention_bwd_dq_s{s}"] = tensor_core_row(dict(
            name="edge_attention_bwd_dq", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd_dq_tc.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:"
                     + ("211" if s == 40 else "167"),
            max_abs_err=err, prev_max_abs_err=prev_err,
            plain_ms=cuda_ms(lambda: bwd.edge_attention_bwd_dq_plain(
                q, kv, dsum, *idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None),
            "edge_attention_bwd_dq_tc", "ampnet_edge_attention_bwd_dq_info", nt, s, d, h,
            lambda: bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw, body="simt"),
            lambda: bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw), ptxas)
        got = bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw)
        ref = bwd.edge_attention_bwd_dkv_plain(qdm, kv, *snd_idx, **kw)
        old = bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw, body="simt")
        torch.cuda.synchronize()
        err = compare(f"edge_attention_bwd_dkv S={s}", got, ref)
        prev_err = compare(f"edge_attention_bwd_dkv (CUDA cores) S={s}", old, ref)
        if not torch.equal(got, bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw)):
            fail(f"edge_attention_bwd_dkv S={s}: a second launch differs from the first")
        del old
        # q|dsum, k|v read and dk|dv written once; 4 products per edge
        b, by = bound_ms(6 * d * n * s * 4 + snd_index_bytes, 8 * s * s * d * live_edges, True)
        rows[f"edge_attention_bwd_dkv_s{s}"] = tensor_core_row(dict(
            name="edge_attention_bwd_dkv", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd_tc.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:"
                     + ("319" if s == 40 else "280"),
            max_abs_err=err, prev_max_abs_err=prev_err,
            plain_ms=cuda_ms(lambda: bwd.edge_attention_bwd_dkv_plain(
                qdm, kv, *snd_idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None),
            "edge_attention_bwd_tc", "ampnet_edge_attention_bwd_dkv_info", nt, s, d, h,
            lambda: bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw, body="simt"),
            lambda: bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw), ptxas)

        # K5 on the same rows: dq as K3, and the per-edge dk|dv stream on the
        # slots the walk visits (the others are never written); its
        # CUDA-core body against the plain version too, and timed in turns
        walked = layout.recv_slots.long()
        per_slot = (-1, sp, 2 * d)

        def k5(body=None):
            """K5's dQ rows and the stream rows of the walked slots."""
            dq, stream = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw, body=body)
            return dq, stream.view(per_slot)[walked]

        (dq, walked_rows), (dq_ref, stream_ref) = k5(), sb.edge_attention_bwd_stream_plain(
            q, kv, dsum, *idx, **kw)
        stream_ref = stream_ref.view(per_slot)[walked]
        dq_old, walked_old = k5("simt")
        torch.cuda.synchronize()
        err = max(compare(f"edge_attention_bwd_stream S={s} dq", dq, dq_ref),
                  compare(f"edge_attention_bwd_stream S={s} stream", walked_rows, stream_ref))
        prev_err = max(
            compare(f"edge_attention_bwd_stream (CUDA cores) S={s} dq", dq_old, dq_ref),
            compare(f"edge_attention_bwd_stream (CUDA cores) S={s} stream", walked_old,
                    stream_ref))
        dq_again, walked_again = k5()
        if not (torch.equal(dq, dq_again) and torch.equal(walked_rows, walked_again)):
            fail(f"edge_attention_bwd_stream S={s}: a second launch differs from the first")
        del dq_ref, stream_ref, dq_old, walked_old, dq_again, walked_again, walked_rows
        # K3's bytes plus the stream's S rows per walked slot, written once; 5
        # products of 2*S*S*D per live edge, on the tensor cores in 3xTF32
        stream_bytes = walked.numel() * s * 2 * d * 4
        k5_bytes = 5 * d * n * s * 4 + index_bytes + stream_bytes
        b, by = bound_ms(k5_bytes, 10 * s * s * d * live_edges, True)
        _, stream = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw)
        dkv = torch.zeros(nt, s, 2 * d, device=dev)
        take = sb.walked_slots(layout.tile_senders, layout.recv_ptr,
                               (0, layout.tile_senders.shape[0]))
        rows[f"edge_attention_bwd_stream_s{s}"] = tensor_core_row(dict(
            name="edge_attention_bwd_stream", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd_stream_tc.cu "
                   "+ ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd_dq_tc.cuh",
            replaces="ampnet_tpu/ops/pallas/edge_attention_bwd.py:"
                     + ("694" if s == 40 else "178"),
            max_abs_err=err, prev_max_abs_err=prev_err,
            plain_ms=cuda_ms(lambda: sb.edge_attention_bwd_stream_plain(
                q, kv, dsum, *idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None,
            f32_bound_ms=bound_ms(k5_bytes, 10 * s * s * d * live_edges)[0],
            stream_bytes=stream.numel() * 4, walked_stream_bytes=stream_bytes,
            **pass_b_report(stream, layout.tile_senders, take, dkv, s, sp)),
            "edge_attention_bwd_stream_tc", "ampnet_edge_attention_bwd_stream_info", nt, s, d,
            h, lambda: sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw, body="simt"),
            lambda: sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw), ptxas)
        del stream, dkv
        # pass A + pass B, one launch against tile chunks under FOLD_BUDGET,
        # and both against K4's per-sender sums
        dq_1, dkv_1 = sb.stream_backward(q, kv, dsum, *idx, **kw)
        before = sb.edge_attention_bwd_stream.launches
        dq_c, dkv_c = sb.stream_backward(q, kv, dsum, *idx, **kw, chunk_bytes=FOLD_BUDGET)
        torch.cuda.synchronize()
        chunks = sb.edge_attention_bwd_stream.launches - before
        if s == 40 and chunks < 3:
            fail(f"the chunked fold at S=40 ran {chunks} chunks under {FOLD_BUDGET} B")
        if not torch.equal(dq_c, dq_1):
            fail(f"chunked fold S={s}: dq differs from the unchunked run")
        k4 = bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw).view(nt, sp, 2 * d)[:, :s]
        rows[f"edge_attention_bwd_stream_s{s}"].update(
            fold_chunks=chunks,
            fold_max_abs_err=compare(f"chunked fold S={s}", dkv_c, dkv_1),
            fold_vs_pass_s_max_abs_err=compare(f"stream backward vs pass S, S={s}", dkv_1, k4),
            fold_ms=cuda_ms(lambda: sb.stream_backward(q, kv, dsum, *idx, **kw), 5),
            fold_chunked_ms=cuda_ms(lambda: sb.stream_backward(
                q, kv, dsum, *idx, **kw, chunk_bytes=FOLD_BUDGET), 5))
        del dq_1, dkv_1, dq_c, dkv_c, k4

    s, sp = 20, 24
    conv = AMPConv(d, h, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        conv.b_qkv.normal_(0.0, 0.1, generator=gen)
        conv.b_out.normal_(0.0, 0.1, generator=gen)
    w = [t.detach().contiguous() for t in conv.params()]
    x_rows = torch.randn(nt * sp, d, generator=gen, device=dev)
    invdeg = torch.where(count > 0, 1.0 / count.clamp_min(1.0), torch.zeros_like(count))
    invdeg = torch.nn.functional.pad(invdeg, (0, nt - n))
    kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
    got = eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw)
    ref = eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *idx, **kw)
    old = eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw, body="simt")
    torch.cuda.synchronize()
    err = compare("edge_attention_layer S=20", got, ref)
    prev_err = compare("edge_attention_layer (CUDA cores) S=20", old, ref)
    if not torch.equal(got, eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw)):
        fail("edge_attention_layer S=20: a second launch differs from the first")
    if not (got.view(nt, sp, d)[:n][count == 0] == 0).all():
        fail("edge_attention_layer S=20: a receiver without a live edge is not exactly 0")
    del old
    live_recv = int((count > 0).sum())
    flops = (2 * n * s * d * 3 * d + 4 * s * s * d * live_edges
             + 2 * s * d * d * live_recv)
    nbytes = 4 * (2 * n * s * d + 4 * d * d + 4 * d + nt) + index_bytes
    b, by = bound_ms(nbytes, flops, True)
    # its two launches alone, each body in turns with the other's
    qkv = eav.layer_projection(x_rows, w[0], w[1], "tc")
    compare("edge_attention_layer projection S=20", qkv, x_rows @ w[0] + w[1], "x @ w_qkv + b_qkv")
    projection_ms, prev_projection_ms = in_turns(
        lambda: eav.layer_projection(x_rows, w[0], w[1], "simt"),
        lambda: eav.layer_projection(x_rows, w[0], w[1], "tc"))
    # one library call computes the projection: f32 cuBLAS (TF32 off)
    projection_library_ms = in_turns(
        lambda: eav.layer_projection(x_rows, w[0], w[1], "tc"),
        lambda: torch.addmm(w[1], x_rows, w[0]))[0]
    attention_ms, prev_attention_ms = in_turns(
        lambda: eaf._layer_attention(qkv, *w[2:], invdeg, *idx, **kw, body="simt"),
        lambda: eaf._layer_attention(qkv, *w[2:], invdeg, *idx, **kw, body="tc"))
    staged_w = staged_w_attention(qkv, w, invdeg, idx, nt, kw)
    rows["edge_attention_layer_s20"] = tensor_core_row(dict(
        name="edge_attention_layer", route="cuda",
        source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_layer_tc.cu "
               "+ ampnet_tpu_torch/ops/hopper/csrc/edge_attention_tc.cuh",
        replaces="ampnet_tpu/ops/pallas/edge_attention_fused.py:763",
        max_abs_err=err, prev_max_abs_err=prev_err,
        plain_ms=cuda_ms(lambda: eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *idx, **kw), 3),
        bound_ms=b, bound_by=by, library_ms=None,
        projection_ms=projection_ms, prev_projection_ms=prev_projection_ms,
        projection_library_ms=projection_library_ms,
        attention_ms=attention_ms, prev_attention_ms=prev_attention_ms, staged_w=staged_w,
        projection_bound_ms=bound_ms(4 * (n * s * 4 * d + 3 * d * d + 3 * d),
                                     2 * n * s * d * 3 * d, True)[0]),
        "edge_attention_layer_tc", "ampnet_edge_attention_layer_info", nt, s, d, h,
        lambda: eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw, body="simt"),
        lambda: eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw), ptxas,
        also="20projection_tc_kernel")

    # K7 on the same rows and weights: against its plain version and K2's
    # layer; all three launches in turns with the CUDA-core body's, and apart:
    # the projection (K2's launch on the same rows: its times above), the
    # attention launch (K6's) and the out-projection
    mm = dict(**kw, tile_nodes=tn)
    k7 = lambda body=None: eav.edge_attention_layer_mm(  # noqa: E731
        x_rows, *w, invdeg, *slots, layout.tile_counts, **mm, body=body)
    got7, ref7 = k7(), eav.edge_attention_layer_mm_plain(
        x_rows, *w, invdeg, *slots, layout.tile_counts, **mm, group=eav.MM_GROUP)
    torch.cuda.synchronize()
    if not (got7.view(nt, sp, d)[:n][count == 0] == 0).all():
        fail("edge_attention_layer_mm S=20: a receiver without a live edge is not exactly 0")
    # K2's work (projection, attention, out-projection) at the tensor cores'
    # rate, as K2 is priced: the card runs all of these f32 products there
    k7_bytes = nbytes - index_bytes + slot_bytes + 4 * layout.tile_counts.numel()
    b, by = bound_ms(k7_bytes, flops, True)
    ms, prev_ms = in_turns(lambda: k7("simt"), k7)
    attention = {b_: (lambda b_=b_: eav._launch_groups(
        "edge_attention_sums_mm", b_, (qkv.data_ptr(), 3 * d, qkv.data_ptr() + 4 * d, 3 * d),
        *slots, layout.tile_counts, s=s, sp=sp, d=d, num_heads=h, softmax=True,
        tile_nodes=tn, group=eav._mm_group(b_, s, d, h, None))) for b_ in ("tc", "simt")}
    attention_ms, prev_attention_ms = in_turns(attention["simt"], attention["tc"])
    sums = attention["tc"]()
    out = {b_: (lambda b_=b_: eav._layer_mm_out_projection(sums, invdeg, *w[2:], s=s, sp=sp,
                                                           body=b_)) for b_ in ("tc", "simt")}
    compare("edge_attention_layer_mm out-projection S=20", out["tc"](), out["simt"](),
            "its CUDA-core body")
    out_projection_ms, prev_out_projection_ms = in_turns(out["simt"], out["tc"])
    # registers and spills of the two tiled products (kernels that are no
    # template: ptxas keys them by their mangled names)
    gemms = {re.search(r"\d+([a-z_]+_kernel)E", key).group(1): r
             for (stem, key), r in ptxas.items()
             if stem == "edge_attention_layer_tc" and isinstance(key, str)}
    del qkv, sums
    rows["edge_attention_layer_mm_s20"] = dict(
        name="edge_attention_layer_mm", route="cuda",
        source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_groups_tc.cu "
               "+ ampnet_tpu_torch/ops/hopper/csrc/edge_attention_layer_tc.cu "
               "+ ampnet_tpu_torch/ops/hopper/csrc/projection_tc.cuh",
        replaces="ampnet_tpu/ops/pallas/edge_attention_fused.py:865",
        max_abs_err=compare("edge_attention_layer_mm S=20", got7, ref7),
        k2_max_abs_err=compare("edge_attention_layer_mm S=20", got7, got, "K2's layer"),
        prev_max_abs_err=compare("edge_attention_layer_mm (CUDA cores) S=20", k7("simt"), ref7),
        ms=ms, prev_ms=prev_ms, speedup=prev_ms / ms,
        projection_ms=projection_ms, prev_projection_ms=prev_projection_ms,
        projection_library_ms=projection_library_ms,
        attention_ms=attention_ms, prev_attention_ms=prev_attention_ms,
        out_projection_ms=out_projection_ms, prev_out_projection_ms=prev_out_projection_ms,
        gemm_ptxas=gemms, precision="3xtf32",
        plain_ms=cuda_ms(lambda: eav.edge_attention_layer_mm_plain(
            x_rows, *w, invdeg, *slots, layout.tile_counts, **mm, group=eav.MM_GROUP), 3),
        bound_ms=b, bound_by=by, library_ms=None,
        f32_bound_ms=bound_ms(k7_bytes, flops)[0])
    return rows, k8_launches


def staged_w_attention(qkv, w, invdeg, idx, nt, kw):
    """K2's attention launch with w_out staged in shared memory once per
    block, against the launch that reads it from L2: the same bits, the two
    timed in turns, and what each runs with."""
    from ampnet_tpu_torch.ops.hopper import build
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.launch import entry, kernel_info, stream

    s, sp, h, d = kw["s"], kw["sp"], kw["num_heads"], w[2].shape[0]
    lib, staged = entry("edge_attention_layer_tc", "ampnet_edge_attention_layer_staged_w",
                        eaf._SIGNATURES["ampnet_edge_attention_layer"])

    def run():
        out = torch.empty(nt * sp, d, device=qkv.device)
        build.check(lib, staged(qkv.data_ptr(), qkv.stride(0), *(t.data_ptr() for t in idx),
                                invdeg.data_ptr(), w[2].data_ptr(), w[3].data_ptr(),
                                out.data_ptr(), nt, s, sp, d, h, int(kw["softmax"]), stream()),
                    "edge_attention_layer (staged w_out)")
        return out

    l2 = lambda: eaf._layer_attention(qkv, *w[2:], invdeg, *idx, **kw, body="tc")  # noqa: E731
    if not torch.equal(run(), l2()):
        fail("edge_attention_layer: staging w_out in shared memory changed the result")
    ms, l2_ms = in_turns(l2, run)
    info = {k: kernel_info("edge_attention_layer_tc", fn, nt, s, d, h)["blocks_per_sm"]
            for k, fn in (("staged", "ampnet_edge_attention_layer_staged_w_info"),
                          ("l2", "ampnet_edge_attention_layer_info"))}
    return dict(attention_ms=ms, l2_attention_ms=l2_ms, blocks_per_sm=info["staged"],
                l2_blocks_per_sm=info["l2"])


def route_graphs(data, dev):
    """The graphs of the routes phases: {training: (graph, runtime mask,
    layout)} (an eval graph of Cora's node count with every 10th edge, a
    training graph of the edges among the first ROUTE_NODES nodes, every 7th
    live edge dropped at run time), and the training graph's layout without
    a sender side."""
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.ops.hopper.format import compute_layout

    ei = data.edge_index
    small = ei[:, (ei < ROUTE_NODES).all(0)]
    graphs = {}
    for train, (x_feat, edges) in ((False, (data.x, ei[:, ::10])),
                                   (True, (data.x[:ROUTE_NODES], small))):
        g = from_arrays(x_feat, edges).to(dev)
        mask = g.edge_mask.clone()
        mask[torch.nonzero(mask)[::7, 0]] = False             # dropped at run time
        graphs[train] = (g, mask, compute_layout(g))
    return graphs, compute_layout(graphs[True][0], sender_layout=False)


def want_of(want, kernel) -> str:
    """A ROUTES row's body for ``kernel``: one for all, or by kernel."""
    return want[kernel] if isinstance(want, dict) else want


def route_phase(data, gen, dev):
    """AMPConv at the shapes of ROUTES, forward and (training) one backward
    with dropout 0 on the card, each against the same layer in float64 on
    the CPU through the plain oracle: the output at the model limits, every
    gradient (x's too) within GRAD_RTOL of its largest entry. The launches
    must show the body that ran; the report names the kernels whose
    working set was in device memory."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    graphs, no_sender_side = route_graphs(data, dev)
    report = []
    for s, d, h, train, want, want_device_memory, flag in ROUTES:
        graph, mask, layout = graphs[train]
        if flag == STREAM:
            layout = no_sender_side
        n = graph.num_nodes_padded
        name = f"S={s} D={d} H={h} {'training' if train else 'eval'}" + (f" {flag}" if flag else "")
        conv = AMPConv(d, h, use_pallas=True, generator=torch.Generator().manual_seed(s + d + h))
        conv = conv.to(dev)
        with torch.no_grad():
            conv.b_qkv.normal_(0.0, 0.1, generator=gen)
            conv.b_out.normal_(0.0, 0.1, generator=gen)
        x = torch.randn(n, s, d, generator=gen, device=dev)
        gout = torch.randn(n, s, d, generator=gen, device=dev)

        def run(layer, xx, lay, args):
            xx = xx.detach().requires_grad_(train)
            with torch.set_grad_enabled(train):
                out, _ = layer(xx, *args, return_weights=False, layout=lay)
                if train:
                    (out * gout.to(out)).sum().backward()
            grads = {"x": xx.grad} if train else {}
            grads.update({k: p.grad for k, p in layer.named_parameters() if train})
            return out.detach(), grads

        eaf.reset_launch_counts()
        t0 = time.perf_counter()
        with dispatch_flag(flag) if flag in (MM, V1) else contextlib.nullcontext():
            out, grads = run(conv, x, layout, (graph.senders, graph.receivers, mask))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts, bodies = eaf.launch_counts(), eaf.body_launch_counts()
        forward = dict(k6=1) if flag == MM else dict(k9=1) if flag == V1 else dict(k1=1)
        backward = dict(k5=1) if flag == STREAM else dict(k3=1, k4=1)
        expected = launches(**forward, **backward) if train else launches(**forward)
        if counts != expected:
            fail(f"routes {name}: launched {counts}; expected {expected}")
        ran = {k: b for k, b in bodies.items() if counts[k]}
        if any(b[want_of(want, k)] != counts[k] for k, b in ran.items()):
            fail(f"routes {name}: the kernels ran the bodies {ran}, expected {want}")
        in_device_memory = eaf.device_memory_launch_counts()
        device_memory = tuple(k for k in ran if in_device_memory.get(k))
        if device_memory != want_device_memory:
            fail(f"routes {name}: working sets in device memory {device_memory}, "
                 f"expected {want_device_memory}")

        ref_conv = copy.deepcopy(conv).to("cpu", torch.float64)
        ref_conv.use_pallas = False
        g = graph.to("cpu")
        ref, ref_grads = run(ref_conv, x.cpu().double(), None,
                             (g.senders, g.receivers, mask.cpu()))
        out_err = float((out.cpu().double() - ref).abs().max())
        if not torch.isfinite(out).all() or not torch.allclose(
                out.cpu().double(), ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"routes {name}: the output disagrees with float64 on the CPU "
                 f"(max abs err {out_err:.3g})")
        rel = {}
        for k, r in ref_grads.items():
            scale = float(r.abs().max())
            rel[k] = float((grads[k].cpu().double() - r).abs().max()) / max(scale, 1e-30)
            if not rel[k] <= GRAD_RTOL:
                fail(f"routes {name}: gradient of {k} disagrees with float64 autograd "
                     f"({rel[k]:.3g} of its largest entry {scale:.3g})")
        report.append(dict(case=name, body=want, launches={k: v for k, v in counts.items() if v},
                           working_set_in_device_memory=device_memory, out_max_abs_err=out_err,
                           grad_max_rel_err=max(rel.values()) if rel else None, card_ms=ms))
        del x, gout, out, grads, ref, ref_grads
    report += chunked_routes(graphs[False], gen, dev)
    return dict(graphs={("training" if t else "eval"): dict(
        nodes=g.num_nodes_padded, edges=int(g.edge_mask.sum()), live_edges=int(m.sum()))
        for t, (g, m, _) in graphs.items()}, cases=report)


def chunked_routes(eval_graph, gen, dev):
    """K8 at the shapes of CHUNKED_ROUTES on the chunked layout of the eval
    graph (its runtime mask too), D=128, H=4: its CUDA-core body, against
    K1's plain sums over the tiled layout of the same rows and mask in
    float64 on the CPU, at the model limits."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
    from ampnet_tpu_torch.ops.hopper.format import (chunk_slot_valid, compute_chunked_layout,
                                                    edge_slot_valid)

    graph, mask, layout = eval_graph
    chunked = compute_chunked_layout(graph, chunk_edges=CHUNK_EDGES)
    chunk_args = (chunked.senders, chunk_slot_valid(chunked, mask), chunked.chunk_start,
                  chunked.chunk_count)
    idx = [t.cpu() for t in (layout.tile_senders, edge_slot_valid(layout, mask),
                             layout.recv_ptr, layout.recv_slots)]
    nt, d, h = chunked.chunk_start.numel(), 128, 4
    if nt != layout.recv_ptr.numel() - 1:
        fail(f"routes K8: the chunked layout has {nt} receiver rows, the tiled one "
             f"{layout.recv_ptr.numel() - 1}")
    report = []
    for s, want_device_memory in CHUNKED_ROUTES:
        sp = -(-s // 8) * 8
        name = f"K8 S={s} D={d} H={h} eval"
        kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
        qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=dev)
        eaf.reset_launch_counts()
        t0 = time.perf_counter()
        out = eav.edge_attention_sums_chunked(qkv[:, :d], qkv[:, d:], *chunk_args, **kw,
                                              chunk=CHUNK_EDGES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts, bodies = eaf.launch_counts(), eaf.body_launch_counts()
        if counts != launches(k8=1) or bodies["edge_attention_sums_chunked"]["simt"] != 1:
            fail(f"routes {name}: launched {counts} on the bodies "
                 f"{bodies['edge_attention_sums_chunked']}; expected one on the CUDA cores")
        in_device_memory = bool(eaf.device_memory_launch_counts().get(
            "edge_attention_sums_chunked"))
        if in_device_memory != want_device_memory:
            fail(f"routes {name}: working set in device memory {in_device_memory}, "
                 f"expected {want_device_memory}")
        ref = eaf.edge_attention_sums_plain(qkv[:, :d].cpu().double(),
                                            qkv[:, d:].cpu().double(), *idx, **kw)
        out_err = float((out.cpu().double() - ref).abs().max())
        if not torch.isfinite(out).all() or not torch.allclose(
                out.cpu().double(), ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"routes {name}: the sums disagree with float64 on the CPU "
                 f"(max abs err {out_err:.3g})")
        report.append(dict(case=name, body="simt", launches={k: v for k, v in counts.items() if v},
                           working_set_in_device_memory=(
                               ("edge_attention_sums_chunked",) if in_device_memory else ()),
                           out_max_abs_err=out_err, grad_max_rel_err=None, card_ms=ms))
        del qkv, out, ref
    return report


def tensor_cores_only(name, counts, allowed=("tc", "tc_bf16")):
    """Fail where a path ran a body other than ``allowed`` (at the recipes'
    shapes: a CUDA-core body)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    bodies = eaf.body_launch_counts()
    if any(n for b in bodies.values() for k, n in b.items() if k not in allowed):
        fail(f"path {name}: a kernel ran a body other than {allowed} ({bodies}; "
             f"launches {counts})")
    return bodies


def recipe_model(cfg, data, seed, dev):
    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.tokenize import fit_scaler

    stats = fit_scaler(data.x) if cfg.scaler == "precomputed" else None
    return AMPGCN(cfg, scaler_stats=stats,
                  generator=torch.Generator().manual_seed(seed), device=dev)


def first_call(fn):
    """(fn's result, host ms, peak allocated bytes) of one call ending in a
    synchronise: for a captured step's first call, its capture and replay."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated()


def sync_ms(fn, reps: int) -> float:
    """Host ms of one call of fn: the mean of ``reps`` calls ending in a
    synchronise, after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def step_costs(fn, reps: int) -> dict:
    """One way of running a step: its warm host ms, its device time from
    CUDA events around ``reps`` calls and from torch.profiler (kernels by
    name, the busy share of the warm step), and the peak of allocated
    device memory while it runs (beside what the allocator holds)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = sync_ms(fn, reps)
    report = dict(warm_ms=ms, event_ms=cuda_ms(fn, reps),
                  max_memory_allocated=torch.cuda.max_memory_allocated(),
                  memory_reserved=torch.cuda.memory_reserved())
    report["profile"] = busy_share(device_profile(fn), ms)
    return report


def same_kernels(name, eager: dict, captured: dict, again) -> None:
    """Where the profiler saw the card, fail unless a replay launched each of
    the port's kernels as often as the eager body: the launch counters only
    add what the capture recorded, the profiler sees what ran. Every replay
    of a graph runs the same kernels, but the profiler has been seen to
    drop a replay's records (once in ~30 profiles: a third of C's K1
    launches); ``again()`` profiles both once more (the eager body first,
    as many calls each), and only a difference that repeats three times
    fails. ``captured["kernel_census_profiles"]`` says how many it took."""
    for attempt in range(1, 4):
        seen = [c["profile"].get("port_kernels_per_call") for c in (eager, captured)]
        if None in seen or seen[0] == seen[1]:
            captured["kernel_census_profiles"] = attempt
            return
        print(json.dumps({"kernel_census_differs": name, "eager": seen[0],
                          "captured": seen[1]}), flush=True)
        if attempt < 3:
            eager["profile"], captured["profile"] = again()
    fail(f"path {name}: a replay launches {seen[1]} of the port's kernels, "
         f"the eager body {seen[0]} (three profiles each)")


def eager_and_captured(name, eager, captured, reps: int, first_ms: float) -> dict:
    """Both ways of running one step, each as many times (so that training
    states stay in step): step_costs of the eager body, then of the
    captured step, and the capture's one-off ms (its first call, capture
    and replay, less a warm replay); ``same_kernels`` holds them."""
    out = {"eager": step_costs(eager, reps), "captured": step_costs(captured, reps)}
    same_kernels(name, out["eager"], out["captured"], lambda: tuple(
        busy_share(device_profile(fn), out[k]["warm_ms"])
        for k, fn in (("eager", eager), ("captured", captured))))
    out["capture_ms"] = first_ms - out["captured"]["warm_ms"]
    return out


def near(name, what, got, want):
    """Max abs difference of two lists of floats; fail beyond the model limits."""
    got, want = torch.tensor(got, dtype=torch.float64), torch.tensor(want, dtype=torch.float64)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL):
        fail(f"path {name}: captured {what} disagree with the eager body's "
             f"(max abs err {err:.3g})")
    return err


def drive_path(name, cfg, data, graph, layout, seed, dev, same_as=None):
    """One 8-draw eval step through make_eval_step (a captured graph),
    counts read around its first call (the capture and one replay); its
    losses against the eager body's from the same seed (model limits: K6,
    K7 and K9 sum with atomics), both timed; then one fixed draw on the
    card against the same forward on the CPU (and against ``same_as``,
    another route's logits of that draw). Returns the counts, the report and
    the draw's logits."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import sample_present_features, tfidf_sample_features
    from ampnet_tpu_torch.train import make_eval_step
    from ampnet_tpu_torch.train.state import _eval_step_body

    model = recipe_model(cfg, data, seed, dev)
    step, eager = make_eval_step(model, num_eval_samples=8), _eval_step_body(model, 8)
    eaf.reset_launch_counts()
    metrics, first_ms, first_peak = first_call(
        lambda: step(graph, torch.Generator(device=dev).manual_seed(seed), layout))
    counts = eaf.launch_counts()
    tensor_cores_only(name, counts)
    metrics = {k: float(v) for k, v in metrics.items()}
    if not finite(metrics.values()):
        fail(f"path {name}: non-finite metrics {metrics}")
    want = {k: float(v) for k, v in eager(
        graph, torch.Generator(device=dev).manual_seed(seed), layout).items()}
    losses = sorted(k for k in want if k.endswith("_loss"))
    vs_eager = near(name, "eval losses", [metrics[k] for k in losses], [want[k] for k in losses])
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    costs = eager_and_captured(name, lambda: eager(graph, gen, layout),
                               lambda: step(graph, gen, layout), 5, first_ms)

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    sampler = (tfidf_sample_features if cfg.token_sampling == "tfidf"
               else sample_present_features)
    kw = {"node_mask": graph.node_mask} if cfg.token_sampling == "tfidf" else {}
    sidx = sampler(graph.x, cfg.num_sampled_vectors, generator=gen, **kw)
    card, card_stages = stage_outputs(model, graph, sidx, layout)
    ref, ref_stages = cpu_f64_reference(model, graph, sidx)
    if not torch.isfinite(card).all() or card.shape != (graph.num_nodes_padded, cfg.output_dim):
        fail(f"path {name}: logits of shape {tuple(card.shape)}, finite={bool(torch.isfinite(card).all())}")
    err = float((card.double() - ref).abs().max())
    stage_err = {k: float((card_stages[k] - ref_stages[k]).abs().max()) for k in ref_stages}
    if not torch.allclose(card.double(), ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
        # for whoever reads the failure: does a second card forward of the same
        # draw repeat the first, which stage leaves the reference first, and
        # which kernels (cuBLAS's choice among them) the second forward ran
        again = {}
        kernels = device_kernels(lambda: again.update(
            zip(("logits", "stages"), stage_outputs(model, graph, sidx, layout))))
        evidence = save_evidence(model, graph, card_stages, ref_stages, again["stages"], kernels)
        print(json.dumps({
            "evidence": evidence,
            "stage_max_abs_err": stage_err,
            "second_card_forward_max_abs_err": float(
                (again["logits"].double() - ref).abs().max()),
            "second_card_forward_stage_max_abs_err": {
                k: float((again["stages"][k] - ref_stages[k]).abs().max()) for k in ref_stages},
            "second_card_forward_kernels": kernels,
            "raw_residual_product": raw_residual_product(
                model, graph, card_stages["raw_residual_conv1.lin"])
            if "raw_residual_conv1.lin" in card_stages else None,
            "precision": precision_state()}), file=sys.stderr)
        fail(f"path {name}: card logits disagree with the CPU float64 forward "
             f"(max abs err {err:.3g})")
    report = dict(path=name, metrics=metrics, eval_step_first_ms=first_ms,
                  first_call_max_memory_allocated=first_peak,
                  eval_step_warm_ms=costs["captured"]["warm_ms"],
                  eager_eval_step_warm_ms=costs["eager"]["warm_ms"],
                  capture_ms=costs["capture_ms"], capture_parts=step.graphs.timings()[0],
                  eager_vs_captured_loss_max_abs_err=vs_eager,
                  cpu_f64_max_abs_err=err, stage_max_abs_err=stage_err)
    report["profile"] = costs["captured"]["profile"]
    report["eager"], report["captured"] = costs["eager"], costs["captured"]
    if same_as is not None:
        report["other_route_max_abs_err"] = float((card - same_as).abs().max())
        if not torch.allclose(card, same_as, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"path {name}: logits disagree with the default route's "
                 f"(max abs err {report['other_route_max_abs_err']:.3g})")
    return counts, report, card


def relu_branch_hooks(model, branches, flips=None):
    """With flips None: record, per module that feeds a ReLU, where its
    output is > 0. Else: move each output that lies on the other side of 0
    than recorded across it (by twice its own size, ~1e-7; the gradient
    passes unchanged) and count those in flips."""
    def hook(mod, args, out, name):
        y = out[0] if isinstance(out, tuple) else out
        if flips is None:
            branches[name] = (y > 0).cpu()
            return None
        wrong = branches[name] != (y > 0)
        flips[name] = int(wrong.sum())
        fixed = y - (2 * y * wrong).detach() + (wrong & branches[name]) * 1e-30
        return (fixed, *out[1:]) if isinstance(out, tuple) else fixed

    return [getattr(model, n).register_forward_hook(
        lambda mod, args, out, n=n: hook(mod, args, out, n))
        for n in RELU_INPUTS if hasattr(model, n)]


def gradient_check(name, model, graph, layout, seed, want=None, loss_mode="full",
                   fused=False, also=None, grad_rtol=GRAD_RTOL):
    """One training forward + backward with dropout rates 0 and a fixed
    sampled_idx: the card's gradients against float64 autograd on the CPU
    through the plain oracle (a bf16 model's convs in float64 too), every
    parameter, within ``grad_rtol`` of each one's largest entry. ``want``: the launches of
    that one forward + backward (default 2 K1 + 2 K3 + 2 K4). ``fused``:
    the convs run through make_fused_fns closures over ``layout`` (the
    make_pallas_train_step route) instead of edge_layout. ``also`` = (layout,
    launches): the card's gradients through that other layout's backward
    must agree too."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import tfidf_sample_features
    from ampnet_tpu_torch.train.pallas_step import make_fused_fns
    from ampnet_tpu_torch.train.state import training_loss

    cfg = model.config
    gen = torch.Generator(device=graph.x.device).manual_seed(seed + 3)
    sidx = tfidf_sample_features(graph.x, cfg.num_sampled_vectors,
                                 node_mask=graph.node_mask, generator=gen)

    branches, flips = {}, {}

    def grads(m, g, idx, lay, record, fused_fns=False):
        m.config = dataclasses.replace(cfg, dropout_rate=0.0, dropout_adj_rate=0.0)
        hooks = relu_branch_hooks(m, branches, None if record else flips)
        try:
            m.zero_grad(set_to_none=True)
            conv = (dict(fused_fns=make_fused_fns(m, g, lay)) if fused_fns
                    else dict(edge_layout=lay))
            logits = m(g, deterministic=False, sampled_idx=idx, **conv)
            loss = training_loss(loss_mode, logits, g)
            loss.backward()
        finally:
            m.config = cfg
            for h in hooks:
                h.remove()
        out = {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return float(loss.detach()), out

    def card_grads(lay, want_counts, fused_fns):
        eaf.reset_launch_counts()
        loss, out = grads(model, graph, sidx, lay, True, fused_fns)
        torch.cuda.synchronize()
        counts = eaf.launch_counts()
        if counts != want_counts:
            fail(f"path {name}: one forward + backward launched {counts}, "
                 f"expected {want_counts}")
        return loss, out

    loss_card, card = card_grads(layout, want or launches(k1=2, k3=2, k4=2), fused)
    ref_model = copy.deepcopy(model).to("cpu", torch.float64)
    for conv in (ref_model.conv1, ref_model.conv2):
        conv.use_pallas, conv.dtype = False, None
    g = graph.to("cpu")
    g.x = g.x.double()
    loss_ref, ref = grads(ref_model, g, sidx.cpu(), None, False)

    def worst_rel_err(got, what):
        rel = {}
        for k in ref:
            scale = float(ref[k].abs().max())
            if scale == 0.0 or not torch.isfinite(got[k]).all():
                fail(f"path {name}: gradient of {k}: reference max {scale}, "
                     f"card finite={bool(torch.isfinite(got[k]).all())}")
            rel[k] = float((got[k] - ref[k]).abs().max()) / scale
        worst = max(rel, key=rel.get)
        if rel[worst] > grad_rtol:
            print(json.dumps({"grad_rel_err": rel, "relu_branches_moved": flips,
                              "precision": precision_state()}),
                  file=sys.stderr)
            fail(f"path {name}: gradient of {worst} {what} disagrees with float64 "
                 f"autograd on the CPU (max abs err {rel[worst]:.3g} of its largest entry)")
        return worst, rel[worst]

    worst, err = worst_rel_err(card, "")
    report = dict(loss_card=loss_card, loss_cpu_f64=loss_ref, parameters=len(ref),
                  grad_max_rel_err=err, grad_worst_parameter=worst,
                  relu_branches_moved=flips)
    if also is not None:
        _, other = card_grads(also[0], also[1], False)
        _, report["other_backward_grad_max_rel_err"] = worst_rel_err(
            other, "through the other backward")
        # the two backwards against each other, on the same draw
        report["between_backwards_max_rel_err"] = max(
            float((card[k] - other[k]).abs().max()) / float(ref[k].abs().max())
            for k in ref)
        if report["between_backwards_max_rel_err"] > GRAD_RTOL:
            fail(f"path {name}: the two backwards disagree "
                 f"({report['between_backwards_max_rel_err']:.3g})")
    return report


def state_gap(name, step, eager, st, st_e, graph, layout) -> dict:
    """Two training states that took the same steps, one captured and one
    eager: the largest parameter difference (relative to the parameter's
    largest entry), reported, not held: where a kernel sums with atomics
    (F, H) the two runs drift apart step by step, Adam moving an entry
    whose gradient is rounding noise by ~lr either way. Then the eager
    state takes the captured one's values (parameters, Adam's tensors,
    generator, counts), and one more step of each from that same state
    gives losses held at the model limits: what one step's atomics leave."""
    with torch.no_grad():
        gap = max(float((p - q).abs().max() / q.abs().max().clamp_min(1e-30))
                  for p, q in zip(st.model.parameters(), st_e.model.parameters()))
        st_e.model.load_state_dict(st.model.state_dict())
        for p, q in zip(st.optimizer.params, st_e.optimizer.params):
            for k, t in st.optimizer.adam.state[p].items():
                st_e.optimizer.adam.state[q][k].copy_(t)
    st_e.generator.set_state(st.generator.get_state())
    st_e.step, st_e.optimizer.count = st.step, st.optimizer.count
    loss = float(step(st, graph, layout)[1]["loss"])
    loss_e = float(eager(st_e, graph, layout)[1]["loss"])
    return dict(param_max_rel_diff=gap,
                next_loss_abs_diff=near(name, "training losses", [loss], [loss_e]))


def drive_training(name, cfg, tcfg, data, graph, seed, dev, check_gradients,
                   want_step=None, grad_rtol=GRAD_RTOL, allowed=("tc", "tc_bf16")):
    """create_train_state + train_full_batch (captured steps), counts read
    around it; before that, on models of their own, the gradient check, one
    captured step's launch counts (``want_step``, default 2 K1 + 2 K3 + 2
    K4), and the captured step against the eager body from the same
    initial state (step_costs of both, and where their states stand after
    the same steps). Every launch runs one of the ``allowed`` bodies."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import (Logfile, create_train_state, make_optimizer,
                                        make_scan_train_step, make_train_step,
                                        train_full_batch)
    from ampnet_tpu_torch.train.loop import dispatch_chunk
    from ampnet_tpu_torch.train.state import _train_step_body

    layout = compute_layout(graph)
    probe = recipe_model(cfg, data, seed, dev)
    report = dict(path=name)
    want_step = want_step or launches(k1=2, k3=2, k4=2)
    if check_gradients:
        report["gradient_check"] = gradient_check(name, probe, graph, layout, seed,
                                                  want=want_step, grad_rtol=grad_rtol)

    def state_of(model):
        return create_train_state(model, make_optimizer(
            model.parameters(), tcfg.learning_rate, weight_decay=tcfg.weight_decay,
            cosine_t0=tcfg.cosine_t0, grad_clip=tcfg.grad_clip), seed=seed)

    twin = recipe_model(cfg, data, seed, dev)
    state, state_e = state_of(probe), state_of(twin)
    step, eager = make_train_step(probe), _train_step_body(twin)
    eaf.reset_launch_counts()
    _, first_ms, report["first_call_max_memory_allocated"] = first_call(
        lambda: step(state, graph, layout))
    per_step = eaf.launch_counts()
    if per_step != want_step:
        fail(f"path {name}: one training step launched {per_step}, expected {want_step}")
    tensor_cores_only(name, per_step, allowed)
    eager(state_e, graph, layout)
    costs = eager_and_captured(name, lambda: eager(state_e, graph, layout),
                               lambda: step(state, graph, layout), 10, first_ms)
    report.update(train_step_first_ms=first_ms,
                  train_step_warm_ms=costs["captured"]["warm_ms"],
                  eager_train_step_warm_ms=costs["eager"]["warm_ms"],
                  capture_ms=costs["capture_ms"], capture_parts=step.graphs.timings()[0],
                  profile=costs["captured"]["profile"],
                  eager=costs["eager"], captured=costs["captured"],
                  vs_eager=state_gap(name, step, eager, state, state_e, graph, layout))

    model = recipe_model(cfg, data, seed, dev)
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_full_batch(model, graph, tcfg, log=Logfile())
    torch.cuda.synchronize()
    report["train_full_batch_s"] = time.perf_counter() - t0
    counts = eaf.launch_counts()
    tensor_cores_only(name, counts, allowed)
    history, final = result["history"], result["final_metrics"]
    losses = [row["loss"] for row in history]
    if len(history) != tcfg.epochs or not finite(losses + list(final.values())):
        fail(f"path {name}: {len(history)} epochs of {tcfg.epochs}, or a "
             f"non-finite loss or metric ({final})")
    tail = losses[-min(10, len(losses) - 1):]
    if not sum(tail) / len(tail) < losses[0]:
        fail(f"path {name}: the loss did not fall: first epoch {losses[0]:.4f}, "
             f"mean of the last {len(tail)} {sum(tail) / len(tail):.4f}")
    report.update(epochs=len(history), loss_first=losses[0],
                  loss_last_mean=sum(tail) / len(tail),
                  final_test_acc=final.get("test_acc"), final_val_acc=final.get("val_acc"),
                  per_step_launches=per_step, launches=counts)
    k = dispatch_chunk(tcfg)
    if k > 1:
        # the loop's k-step graph, captured alone from a fresh state: where
        # its one-off cost goes
        st = state_of(recipe_model(cfg, data, seed, dev))
        scan = make_scan_train_step(st.model, "full", k)
        _, ms, _ = first_call(lambda: scan(st, graph, layout))
        report["scan_capture"] = dict(steps=k, first_call_ms=ms, **scan.graphs.timings()[0])
    return counts, report


class StepLog:
    """A Logfile that also keeps the per-step loss of train_saint's rows and
    the budget lines."""

    def __init__(self):
        self.losses, self.budget_lines = [], []

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        m = re.search(r"Train loss: ([-0-9.einfa]+)", msg)
        if m:
            self.losses.append(float(m.group(1)))
        if "budget regrown" in msg:
            self.budget_lines.append(msg)


def loss_fell(name, losses, k=10):
    head, tail = sum(losses[:k]) / k, sum(losses[-k:]) / k
    if not finite(losses) or not tail < head:
        fail(f"path {name}: the loss did not fall: mean of the first {k} steps "
             f"{head:.4f}, of the last {k} {tail:.4f}")
    return dict(steps=len(losses), loss_first_mean=head, loss_last_mean=tail)


def saint_sampler(data, seed_steps, use_native=True):
    """The recipe's sampler on the Cora surrogate: 8 roots x 150 steps,
    coverage 100, seed 1, on the native core (the JAX recipe's default)
    unless ``use_native`` is False."""
    from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler

    return GraphSaintRandomWalkSampler(
        data.x, data.edge_index, y=data.y, train_mask=data.train_mask,
        val_mask=data.val_mask, test_mask=data.test_mask, batch_size=8,
        walk_length=150, num_steps=seed_steps, sample_coverage=100, seed=1,
        use_native=use_native)


def sampler_core(sampler) -> str:
    return "native" if sampler.use_native else "numpy"


def warm_steps_ms(step, state, subs, layouts, passes=5):
    """Host time of one step over prepared subgraphs (already on the card,
    layouts built), after one pass over them to warm up: the median pass's
    mean step, with the fastest and the slowest pass."""
    times = []
    for i in range(passes + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g, lay in zip(subs, layouts):
            step(state, g, lay)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3 / len(subs))
    times.sort()
    return times[len(times) // 2], [times[0], times[-1]]


def pass_profile(step, state, subs, layouts, warm_ms):
    """device_profile of one pass over the prepared subgraphs, per step, and
    the busy share of the warm step."""
    report = device_profile(lambda: [step(state, g, lay) for g, lay in zip(subs, layouts)])
    if report["device_ms"] is not None:
        report["device_ms"] /= len(subs)
        report["kernels_per_call"] /= len(subs)
        report["port_kernels_per_call"] = {
            k: c / len(subs) for k, c in report["port_kernels_per_call"].items()}
        report["top_kernels_ms"] = [[k, ms / len(subs)] for k, ms in report["top_kernels_ms"]]
    return busy_share(report, warm_ms)


def saint_costs(step, state, subs, layouts) -> dict:
    """step_costs for a GraphSAINT step, per step of passes over the
    prepared subgraphs: warm ms (median pass, with the range), device time
    and busy share, peak allocated memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, spread = warm_steps_ms(step, state, subs, layouts)
    return dict(warm_ms=ms, warm_ms_range=spread,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                memory_reserved=torch.cuda.memory_reserved(),
                profile=pass_profile(step, state, subs, layouts, ms))


def saint_subgraphs(data, budget, dev, count=10) -> dict:
    """``count`` subgraphs of a sampler of their own, prepared once: both
    fixed-capacity layouts on the host (timed, ms a layout), everything
    moved to the card."""
    from ampnet_tpu_torch.ops.hopper.format import compute_layout

    host = list(saint_sampler(data, count))
    t0 = time.perf_counter()
    with_snd = [compute_layout(g, edges_per_tile=budget) for g in host]
    t1 = time.perf_counter()
    without = [compute_layout(g, edges_per_tile=budget, sender_layout=False)
               for g in host]
    t2 = time.perf_counter()
    return dict(subs=[g.to(dev) for g in host], with_snd=[lay.to(dev) for lay in with_snd],
                without=[lay.to(dev) for lay in without],
                host_layout_ms=(t1 - t0) * 1e3 / count,
                host_layout_ms_f=(t2 - t1) * 1e3 / count,
                nodes_edges=[[g.num_nodes, g.num_edges] for g in host])


def saint_config(seed):
    from ampnet_tpu_torch.core.config import TrainConfig

    total = SAINT_EPOCHS * SAINT_STEPS
    return TrainConfig(learning_rate=3e-3, weight_decay=5e-4, epochs=SAINT_EPOCHS,
                       seed=seed, cosine_t0=total, cosine_t_mult=1, grad_clip=1.0,
                       checkpoint_every=0, select_best_every=1, num_eval_samples=8,
                       log_every_steps=1, saint_loss="mean")


def saint_state(model, tcfg, seed):
    from ampnet_tpu_torch.train import create_train_state, make_optimizer

    return create_train_state(model, make_optimizer(
        model.parameters(), tcfg.learning_rate, weight_decay=tcfg.weight_decay,
        cosine_t0=tcfg.cosine_t0, cosine_t_mult=1, grad_clip=tcfg.grad_clip), seed=seed)


def captured_against_eager(name, make_step, make_eager, cfg, data, seed, dev, tcfg,
                           subs, layouts, want) -> dict:
    """A captured GraphSAINT step against its eager body, on models and
    states of their own from one initial state: the first call's launch
    counts (``want``), saint_costs of both, where the states stand after."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    probe, twin = recipe_model(cfg, data, seed, dev), recipe_model(cfg, data, seed, dev)
    state, state_e = saint_state(probe, tcfg, seed), saint_state(twin, tcfg, seed)
    step, eager = make_step(probe), make_eager(twin)
    eaf.reset_launch_counts()
    _, first_ms, peak = first_call(lambda: step(state, subs[0], layouts[0]))
    per_step = eaf.launch_counts()
    if per_step != want:
        fail(f"path {name}: one step launched {per_step}, expected {want}")
    tensor_cores_only(name, per_step)
    eager(state_e, subs[0], layouts[0])
    eager_costs = saint_costs(eager, state_e, subs, layouts)
    captured = saint_costs(step, state, subs, layouts)
    same_kernels(name, eager_costs, captured, lambda: (
        pass_profile(eager, state_e, subs, layouts, eager_costs["warm_ms"]),
        pass_profile(step, state, subs, layouts, captured["warm_ms"])))
    return dict(train_step_first_ms=first_ms, first_call_max_memory_allocated=peak,
                train_step_warm_ms=captured["warm_ms"],
                train_step_warm_ms_range=captured["warm_ms_range"],
                eager_train_step_warm_ms=eager_costs["warm_ms"],
                capture_ms=first_ms - captured["warm_ms"],
                capture_parts=step.graphs.timings()[0], profile=captured["profile"],
                eager=eager_costs, captured=captured, per_step_launches=per_step,
                vs_eager=state_gap(name, step, eager, state, state_e, subs[0], layouts[0]))


def drive_saint(cfg, data, graph, seed, dev):
    """Paths E and F: GraphSAINT subgraph training of the stabilized recipe
    through train_saint (layouts with the sender side: K1 + K3 + K4) and
    through make_pallas_train_step on layouts without one (K1 + K5), every
    step a CUDA-graph replay on fixed-capacity layouts. Returns the counts
    and reports of both, and the prepared subgraphs."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import make_train_step, train_saint
    from ampnet_tpu_torch.train.loop import _saint_layout_budget
    from ampnet_tpu_torch.train.pallas_step import fused_forward, make_pallas_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    total = SAINT_EPOCHS * SAINT_STEPS
    tcfg = saint_config(seed)
    t0 = time.perf_counter()
    sampler = saint_sampler(data, SAINT_STEPS)
    budget = _saint_layout_budget(sampler)
    name_e = "E S=40 GraphSAINT, train_saint"
    report_e = dict(path=name_e, cut=f"{SAINT_EPOCHS} epochs x {SAINT_STEPS} subgraphs "
                                     f"of the recipe's 50 x 200",
                    sampler_core=sampler_core(sampler),
                    sampler_build_s=time.perf_counter() - t0,
                    pad_nodes_to=sampler.pad_nodes_to, pad_edges_to=sampler.pad_edges_to,
                    edge_budget=budget)
    prep = saint_subgraphs(data, budget, dev)
    subs, with_snd, without = prep["subs"], prep["with_snd"], prep["without"]
    report_e.update(host_layout_ms=prep["host_layout_ms"],
                    subgraph_nodes_edges=prep["nodes_edges"])
    report_e.update(captured_against_eager(
        name_e, lambda m: make_train_step(m, loss_mode="saint_mean"),
        lambda m: _train_step_body(m, "saint_mean"), cfg, data, seed, dev, tcfg, subs,
        with_snd, launches(k1=2, k3=2, k4=2)))

    model = recipe_model(cfg, data, seed, dev)
    log = StepLog()
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_saint(model, sampler, graph, tcfg, log=log)
    torch.cuda.synchronize()
    report_e["train_saint_s"] = time.perf_counter() - t0
    counts_e = eaf.launch_counts()
    tensor_cores_only(name_e, counts_e)
    final = result["final_metrics"]
    if len(result["history"]) != SAINT_EPOCHS or len(log.losses) != total \
            or not finite(final.values()):
        fail(f"path {name_e}: {len(result['history'])} epochs, {len(log.losses)} step "
             f"rows, final metrics {final}")
    report_e.update(loss_fell(name_e, log.losses), budget_regrown=log.budget_lines,
                    final_test_acc=final.get("test_acc"),
                    final_val_acc=final.get("val_acc"), launches=counts_e)
    evals = SAINT_EPOCHS + 1                               # selection + final, 8 draws
    want_e = launches(k1=2 * total + 2 * 8 * evals, k3=2 * total, k4=2 * total)
    if counts_e != want_e:
        fail(f"path {name_e} launched {counts_e}, expected {want_e}")

    # ---- path F
    name_f = "F S=40 GraphSAINT, make_pallas_train_step without a sender side"
    report_f = dict(path=name_f, cut=f"{total} subgraphs",
                    host_layout_ms=prep["host_layout_ms_f"])
    report_f.update(captured_against_eager(
        name_f, lambda m: make_pallas_train_step(m, loss_mode="saint_mean"),
        lambda m: _train_step_body(m, "saint_mean", forward=fused_forward(m)), cfg, data,
        seed, dev, tcfg, subs, without, launches(k1=2, k5=2)))
    # after the timing: the float64 reference keeps the host's cores busy
    report_f["gradient_check"] = gradient_check(
        name_f, recipe_model(cfg, data, seed, dev), subs[0], without[0], seed,
        want=launches(k1=2, k5=2), loss_mode="saint_mean", fused=True,
        also=(with_snd[0], launches(k1=2, k3=2, k4=2)))

    model = recipe_model(cfg, data, seed, dev)
    state = saint_state(model, tcfg, seed)
    step_f = make_pallas_train_step(model, loss_mode="saint_mean")
    sampler = saint_sampler(data, total)
    report_f["sampler_core"] = sampler_core(sampler)
    losses = []
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    for sub in sampler.prefetch():
        lay = compute_layout(sub, edges_per_tile=budget, sender_layout=False)
        state, metrics = step_f(state, sub.to(dev), lay.to(dev))
        losses.append(metrics["loss"])
    losses = [float(v) for v in losses]
    # one step on the full graph: K5 at the size of its kernel phase
    full_layout = compute_layout(graph, sender_layout=False)
    _, metrics = make_pallas_train_step(model, loss_mode="full")(state, graph, full_layout)
    torch.cuda.synchronize()
    report_f["steps_s"] = time.perf_counter() - t0
    counts_f = eaf.launch_counts()
    tensor_cores_only(name_f, counts_f)
    if not finite([float(metrics["loss"])]):
        fail(f"path {name_f}: the full-graph step's loss is {float(metrics['loss'])}")
    report_f.update(loss_fell(name_f, losses), full_graph_step_loss=float(metrics["loss"]),
                    launches=counts_f)
    want_f = launches(k1=2 * (total + 1), k5=2 * (total + 1))
    if counts_f != want_f:
        fail(f"path {name_f} launched {counts_f}, expected {want_f}")
    return counts_e, report_e, counts_f, report_f, prep


def bit_for_bit(name, pairs) -> dict:
    """(captured, eager) tensor pairs by name: the largest difference of
    each; fail unless every pair is equal bit for bit."""
    diffs = {k: float((a.double() - b.double()).abs().max()) for k, (a, b) in pairs.items()}
    if not all(torch.equal(a, b) for a, b in pairs.values()):
        fail(f"captured phase, path {name}: captured and eager differ "
             f"({ {k: v for k, v in diffs.items() if v} })")
    return max(diffs.values())


def captured_phase(recipe, saint_cfg, data, graph, layout, prep, seed, dev) -> dict:
    """The captured steps against the eager bodies on the card, one process:
    path A's 8-draw eval at a fixed seed (metrics and mean logits), 10
    steps of path C from one initial state as one 10-step graph against 10
    eager steps, 3 subgraphs of path E: each bit for bit (the metrics,
    every parameter, the logits of one fixed draw after the steps; K1-K5,
    pass B and the GCN head's segment sums repeat bit for bit, and the draws
    come from the same generator state), and path F's 3 steps the same way."""
    from ampnet_tpu_torch.core.config import TrainConfig
    from ampnet_tpu_torch.ops.tokenize import tfidf_sample_features
    from ampnet_tpu_torch.train import (create_train_state, graphs, make_eval_step,
                                        make_optimizer, make_scan_train_step,
                                        make_train_step)
    from ampnet_tpu_torch.train.pallas_step import fused_forward, make_pallas_train_step
    from ampnet_tpu_torch.train.state import _eval_step_body, _train_step_body, eval_logits

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    report = {}
    # A: metrics through make_eval_step, mean logits through the same capture
    model = recipe_model(recipe, data, seed, dev)
    got = make_eval_step(model, 8)(graph, gen(seed), layout)
    want = _eval_step_body(model, 8)(graph, gen(seed), layout)
    own = gen(seed)

    @torch.no_grad()
    def mean_logits(g, lay, generator):
        return eval_logits(model, g, generator, lay, 8)

    cap = graphs.Captured(lambda g, lay: mean_logits(g, lay, own), (graph, layout),
                          generator=own, what="path A's mean logits")
    own.set_state(gen(seed).get_state())
    logits = cap.replay((graph, layout)).clone()
    pairs = {k: (got[k], want[k]) for k in want}
    pairs["logits"] = (logits, mean_logits(graph, layout, gen(seed)))
    report["A"] = dict(max_abs_diff=bit_for_bit("A", pairs), compared=sorted(pairs))
    del cap

    sidx = tfidf_sample_features(graph.x, recipe.num_sampled_vectors,
                                 node_mask=graph.node_mask, generator=gen(seed + 5))

    def final_logits(m, g, lay, idx):
        with torch.no_grad():
            return m(g, sampled_idx=idx, edge_layout=lay)

    # C: one 10-step graph against 10 eager steps
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-3, grad_clip=1.0, cosine_t0=None)
    pair = [recipe_model(recipe, data, seed, dev) for _ in range(2)]
    states = [create_train_state(m, make_optimizer(
        m.parameters(), tcfg.learning_rate, weight_decay=tcfg.weight_decay,
        grad_clip=tcfg.grad_clip), seed=seed) for m in pair]
    _, stacked = make_scan_train_step(pair[0], "full", 10)(states[0], graph, layout)
    body = _train_step_body(pair[1])
    rows = [body(states[1], graph, layout)[1] for _ in range(10)]
    pairs = {k: (stacked[k], torch.stack([r[k] for r in rows])) for k in stacked}
    pairs.update({k: (p, q) for (k, p), q in zip(pair[0].named_parameters(),
                                                 pair[1].parameters())})
    pairs["logits"] = tuple(final_logits(m, graph, layout, sidx) for m in pair)
    pairs["generator"] = (states[0].generator.get_state(), states[1].generator.get_state())
    report["C"] = dict(steps=10, max_abs_diff=bit_for_bit("C", pairs), compared=len(pairs))

    # E and F: 3 subgraphs, the captured step against the eager body
    subs = prep["subs"][:3]
    for name, layouts, make, make_eager in (
            ("E", prep["with_snd"], lambda m: make_train_step(m, "saint_mean"),
             lambda m: _train_step_body(m, "saint_mean")),
            ("F", prep["without"], lambda m: make_pallas_train_step(m, "saint_mean"),
             lambda m: _train_step_body(m, "saint_mean", forward=fused_forward(m)))):
        pair = [recipe_model(saint_cfg, data, seed, dev) for _ in range(2)]
        states = [saint_state(m, saint_config(seed), seed) for m in pair]
        step, body = make(pair[0]), make_eager(pair[1])
        got = [step(states[0], g, lay)[1] for g, lay in zip(subs, layouts)]
        want = [body(states[1], g, lay)[1] for g, lay in zip(subs, layouts)]
        pairs = {f"{k}_{i}": (a[k], b[k]) for i, (a, b) in enumerate(zip(got, want))
                 for k in a}
        pairs.update({k: (p, q) for (k, p), q in zip(pair[0].named_parameters(),
                                                     pair[1].parameters())})
        pairs["logits"] = tuple(final_logits(m, graph, layout, sidx) for m in pair)
        report[name] = dict(steps=3, max_abs_diff=bit_for_bit(name, pairs),
                            compared=len(pairs))
    return report


# kernel-name fragments of K1, K3 and K4 in a profiler trace (the
# __global__ functions of edge_attention_tc.cuh, edge_attention_bwd_dq_tc.cu
# and edge_attention_bwd_tc.cu)
# each of path C's steps launches K1, K3 and K4 once a layer, and no other
# kernel of the port
TRACE_KERNELS = {"K1": "sums_tc_kernel", "K3": "dq_tc_kernel", "K4": "dkv_tc_kernel"}
PROFILE_DIR = Path(__file__).resolve().parent / "chiprun_out" / "profile_steps"


def profile_steps_phase(cfg, tcfg, data, graph, seed, dev, steps: int = 3) -> dict:
    """train_full_batch with profile_steps=3 into a run_dir of its own: the
    trace must exist and hold exactly the kernels of 3 replayed steps: K1,
    K3 and K4 twice a step (once a layer), no other kernel of the port.
    The profiler may drop records (``same_kernels``), never add them: a
    trace with fewer launches runs again, twice at most; more, or another
    kernel, fails at once."""
    from ampnet_tpu_torch.train import Logfile, train_full_batch

    run = dataclasses.replace(tcfg, epochs=5, profile_steps=steps, run_dir=str(PROFILE_DIR),
                              select_best_every=0, checkpoint_every=0)
    want = dict.fromkeys(TRACE_KERNELS, 2 * steps)
    t0 = time.perf_counter()
    for attempt in range(1, 4):
        shutil.rmtree(PROFILE_DIR, ignore_errors=True)
        train_full_batch(recipe_model(cfg, data, seed, dev), graph, run, log=Logfile())
        path = PROFILE_DIR / "profile" / "trace.json"
        if not path.is_file():
            fail(f"profile_steps: no trace at {path}")
        events = json.loads(path.read_text())["traceEvents"]
        names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        counted = port_kernels(names)
        found = {k: counted.pop(fn, 0) for k, fn in TRACE_KERNELS.items()}
        wrong = (f"profile_steps: the trace of {steps} steps holds {found} and {counted} "
                 f"of the port's kernels, not {want} and nothing else ({len(names)} "
                 f"kernels in it)")
        if counted or any(found[k] > n for k, n in want.items()):
            fail(wrong)
        if found == want:
            break
        print(json.dumps({"profile_steps_trace_short": found}), flush=True)
    else:
        fail(wrong + " (three runs)")
    return dict(trace=str(path.relative_to(PROFILE_DIR.parent.parent)),
                trace_bytes=path.stat().st_size, kernels_in_trace=len(names),
                launches_by_name=found, runs=attempt, graph_launches=sum(
                    "cudaGraphLaunch" in e.get("name", "") for e in events),
                seconds=time.perf_counter() - t0)


SERVING_DIR = Path(__file__).resolve().parent / "chiprun_out" / "serving"
# induced subgraphs of the surrogate served beside the whole graph: (nodes,
# requests of that size); with the whole graph twice, 6 requests, 3 buckets
SERVING_SUBGRAPHS = ((400, 2), (900, 2))


def induced_subgraph(data, nodes: int, rng):
    """(x, edge_index, real node ids) of the subgraph on ``nodes`` nodes
    drawn from ``rng``, with every edge of the surrogate between them."""
    import numpy as np

    keep = np.sort(rng.choice(data.x.shape[0], nodes, replace=False))
    local = np.full(data.x.shape[0], -1)
    local[keep] = np.arange(nodes)
    src, dst = local[data.edge_index[0]], local[data.edge_index[1]]
    inside = (src >= 0) & (dst >= 0)
    return data.x[keep], np.stack([src[inside], dst[inside]]), keep


def serving_route(pred, x, edge_index) -> dict:
    """The route the fused op takes for a request's bucket, by the JAX
    package's predicate (mirrored in edge_attention_fused), at the tile
    rows of the layout the Predictor builds for it: the whole layer (K2)
    where v6 is usable at the bucket's padded node count, else K1;
    ``want``: the launches of one request (two convs)."""
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    cfg = pred.model.config
    n_pad, e_pad = pred._bucket(x.shape[0], edge_index.shape[1])
    tn = pred.layout(from_arrays(x, edge_index, pad_nodes_to=n_pad,
                                 pad_edges_to=e_pad)).tile_nodes
    # the convs' compute type: their x and weights (bf16 rows align to 16)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    itemsize = dtype.itemsize
    tokens = cfg.num_sampled_vectors + (0 if cfg.average_pooling else 1)
    align = eaf._stream_align(dtype, eaf.STREAM_BF16_DEFAULT)
    sp, d = -(-tokens // align) * align, cfg.embedding_dim
    gather = eaf._resolve_gather("auto", n_pad * sp, d,
                                 2 if eaf.STREAM_BF16_DEFAULT else itemsize, tile_rows=tn * sp)
    v6 = eaf._v6_usable(n_pad, n_pad, sp, d, itemsize, tn, eaf._auto_group(sp), gather)
    return dict(gather=gather, v6_usable=v6,
                want=launches(k2=2) if v6 else launches(k1=2))


def serve(pred, name, x, edge_index, dev, want, check_f64=False, profile=False,
          f64_rtol=None) -> dict:
    """One request through ``Predictor.predict`` (counts set to 0 just
    before it, read just after): its answer against the eager forward from
    the same generator state on the same graph and layout, bit for bit;
    its launches exact (``want``) and on the tensor cores; host wall ms,
    the layout's host ms (built from the host graph, as ``predict`` builds
    it), the device ms of a replay (CUDA events), and the capture's
    timings where the request captured its bucket's graph. With
    ``check_f64`` the padded answer of that draw (its sampled_idx taken
    from return_aux=True) against the CPU float64 forward (within
    MODEL_RTOL / MODEL_ATOL; with ``f64_rtol``, within that share of the
    reference's largest entry: a bf16 model); with
    ``profile`` the profiler's kernel census of a replay against the eager
    forward's (``same_kernels``)."""
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    model = pred.model
    state = pred.generator.get_state()
    held = {id(t) for t in pred.step.graphs.timings()}
    eaf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answer = pred.predict(x, edge_index)
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = eaf.launch_counts()
    bodies = {k: {b: c for b, c in v.items() if c}
              for k, v in tensor_cores_only(f"serving {name}", counts).items() if counts[k]}
    if counts != want:
        fail(f"serving {name}: a request launched {counts}, expected {want}")
    captured = [t for t in pred.step.graphs.timings() if id(t) not in held]
    n = x.shape[0]
    bucket = pred._bucket(n, edge_index.shape[1])
    host = from_arrays(x, edge_index, pad_nodes_to=bucket[0], pad_edges_to=bucket[1])
    t0 = time.perf_counter()
    layout = pred.layout(host)
    layout_ms = (time.perf_counter() - t0) * 1e3
    g = host.to(dev)

    def at(gen_state):
        gen = torch.Generator(device=dev)
        gen.set_state(gen_state)
        return gen

    gen = at(state)
    with torch.no_grad():
        eager = model(g, generator=gen, edge_layout=layout)
    if not (answer.shape == (n, model.config.output_dim) and
            torch.equal(torch.from_numpy(answer), eager[:n].cpu())):
        err = float((torch.from_numpy(answer) - eager[:n].cpu()).abs().max())
        fail(f"serving {name}: the answer differs from the eager forward (max abs err {err:.3g})")
    if not torch.equal(pred.generator.get_state(), gen.get_state()):
        fail(f"serving {name}: the Predictor's generator advanced otherwise than the eager draw")
    step = pred.step
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    step(g, at(state), layout)
    end.record()
    end.synchronize()
    report = dict(request=name, nodes=n, edges=int(edge_index.shape[1]), bucket=list(bucket),
                  launches={k: v for k, v in counts.items() if v}, bodies=bodies,
                  wall_ms=wall_ms,
                  layout_ms=layout_ms, device_ms=start.elapsed_time(end),
                  edges_per_tile=int(layout.tile_senders.shape[1]),
                  capture=captured[0] if captured else None,
                  equals_eager=True, finite=bool(torch.isfinite(eager[:n]).all()))
    if not report["finite"]:
        fail(f"serving {name}: non-finite log-probs")
    if check_f64:
        with torch.no_grad():
            out = model(g, generator=at(state), edge_layout=layout, return_aux=True)
        padded = step(g, at(state), layout).cpu()
        ref, _ = cpu_f64_reference(model, g, out.aux["sampled_idx"])
        err = float((padded.double() - ref).abs().max())
        if f64_rtol is None:
            ok = torch.allclose(padded.double(), ref, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        else:
            report["cpu_f64_rel_err"] = err / float(ref.abs().max())
            report["cpu_f64_limit"] = f64_rtol
            ok = report["cpu_f64_rel_err"] <= f64_rtol
        if not ok:
            fail(f"serving {name}: the answer disagrees with the CPU float64 forward "
                 f"(max abs err {err:.3g})")
        report["cpu_f64_max_abs_err"] = err
    if profile:
        def replay():
            step(g, at(state), layout)

        def eager_call():
            with torch.no_grad():
                model(g, generator=at(state), edge_layout=layout)

        costs = {"eager": {"profile": device_profile(eager_call, 1)},
                 "captured": {"profile": device_profile(replay, 1)}}
        same_kernels(f"serving {name}", costs["eager"], costs["captured"], lambda: (
            device_profile(eager_call, 1), device_profile(replay, 1)))
        report["profile"] = costs["captured"]["profile"]
    return report


def serving_phase(recipe, reference, data, graph, seed, dev) -> dict:
    """The serving path: the recommended recipe's model trained a few steps
    (make_train_step) and saved with save_params, read back with
    load_params into the model a Predictor (default buckets, use_pallas)
    serves; 6 requests in 3 buckets (the whole surrogate twice, induced
    subgraphs of SERVING_SUBGRAPHS' sizes drawn from ``seed``), each through
    ``serve``, one against float64; each bucket on the JAX predicate's route
    (``serving_route``); exactly one capture per bucket, made by the
    bucket's first request; a hot swap to a later checkpoint
    (save_checkpoint after more steps) that changes the answers, captures
    nothing and equals the eager forward with the new weights. Then a
    Predictor at S=20 on its buckets' routes, and a transformer-block + CLS
    model at S=40 (41 tokens) on K1 against float64."""
    import numpy as np
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.serving import Predictor
    from ampnet_tpu_torch.train import (create_train_state, load_params, make_optimizer,
                                        make_train_step, save_checkpoint, save_params)

    t_phase = time.perf_counter()
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    trained = recipe_model(recipe, data, seed, dev)
    state = create_train_state(trained, make_optimizer(
        trained.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=seed)
    train_step, layout = make_train_step(trained), compute_layout(graph)
    for _ in range(3):
        train_step(state, graph, layout)
    params_path = save_params(str(SERVING_DIR / "params_step3.pt"), trained)
    for _ in range(3):
        train_step(state, graph, layout)
    swap_path = save_checkpoint(str(SERVING_DIR / "checkpoint_step6.pkl"), state, epoch=5)
    del train_step, state

    model = load_params(params_path, recipe_model(recipe, data, seed + 1, dev))
    pred = Predictor(model, seed=seed)
    x_full, ei_full = data.x, data.edge_index
    rng = np.random.default_rng(seed)
    subs = [(f"induced {n} nodes #{i}", *induced_subgraph(data, n, rng)[:2])
            for n, k in SERVING_SUBGRAPHS for i in range(k)]
    requests = [("whole surrogate", x_full, ei_full), *subs, ("whole surrogate again",
                                                               x_full, ei_full)]
    routes = [serving_route(pred, x, ei) for _, x, ei in requests]
    served = [dict(serve(pred, name, x, ei, dev, r["want"], check_f64=(i == 0),
                         profile=(i in (0, 1))), gather=r["gather"], v6_usable=r["v6_usable"])
              for i, ((name, x, ei), r) in enumerate(zip(requests, routes))]
    buckets = sorted({tuple(r["bucket"]) for r in served})
    captures = pred.step.graphs.timings()
    capturing = [tuple(r["bucket"]) for r in served if r["capture"]]
    if len(captures) != len(buckets) or sorted(capturing) != buckets:
        fail(f"serving: {len(captures)} captures for buckets {buckets} "
             f"(captured by requests of {capturing})")

    # hot swap: the same draw before and after, no new capture
    state = pred.generator.get_state()
    before = pred.predict(x_full, ei_full)
    pred.load_params(swap_path)
    pred.generator.set_state(state)
    swapped = serve(pred, "whole surrogate after the hot swap", x_full, ei_full, dev,
                    routes[0]["want"])
    pred.generator.set_state(state)
    after = pred.predict(x_full, ei_full)
    if np.array_equal(before, after):
        fail("serving: the hot swap left the answers as they were")
    if {id(t) for t in pred.step.graphs.timings()} != {id(t) for t in captures}:
        fail("serving: the hot swap captured again")
    swap = dict(answers_max_abs_change=float(np.abs(after - before).max()),
                new_captures=len(pred.step.graphs.timings()) - len(captures),
                equals_eager=True, request=swapped)

    # S=20: the route of each bucket is the JAX predicate's (K2 where v6 fits)
    pred20 = Predictor(recipe_model(reference, data, seed, dev), seed=seed)
    sub20 = induced_subgraph(data, 900, np.random.default_rng(seed + 20))
    routes20 = []
    for name, x, ei in (("whole surrogate", x_full, ei_full), ("induced 900 nodes",) + sub20[:2]):
        route = serving_route(pred20, x, ei)
        routes20.append(dict(serve(pred20, name, x, ei, dev, route["want"], profile=True),
                             gather=route["gather"], v6_usable=route["v6_usable"]))

    # the transformer block and CLS pooling at S=40: 41 tokens, on K1
    block = dataclasses.replace(recipe, transformer_block=True, average_pooling=False)
    pred_block = Predictor(recipe_model(block, data, seed, dev), seed=seed)
    route = serving_route(pred_block, x_full, ei_full)
    block_report = serve(pred_block, "whole surrogate, transformer block + CLS", x_full,
                         ei_full, dev, route["want"], check_f64=True, profile=True)
    if block_report["launches"] != {KERNELS[0]: 2}:
        fail(f"serving: the transformer block + CLS at 41 tokens launched "
             f"{block_report['launches']}, expected K1 twice")
    return dict(
        requests=served, buckets=[list(b) for b in buckets],
        captures={f"{r['bucket'][0]}x{r['bucket'][1]}": r["capture"]
                  for r in served if r["capture"]},
        hot_swap=swap, s20=routes20, transformer_block_cls=block_report,
        captures_total=sum(len(p.step.graphs.timings()) for p in (pred, pred20, pred_block)),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- the bf16 phase


def bf16_only(name, kernels=("edge_attention_sums", "edge_attention_bwd_dq",
                             "edge_attention_bwd_dkv"), body="tc_bf16"):
    """Fail unless every launch of ``kernels`` since the counts were set to 0
    ran the bf16 ``body`` (default the tensor cores'; or a body by kernel, a
    dict), and every kernel that ran it ran no other; returns the counts on
    each kernel's body."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    bodies = eaf.body_launch_counts()
    want = body if isinstance(body, dict) else dict.fromkeys(bodies, body)
    wrong = {k: b for k, b in bodies.items()
             if any(n for x, n in b.items() if x != want.get(k))
             and (k in kernels or b.get(want.get(k), 0))}
    if wrong or not all(bodies[k][want[k]] for k in kernels):
        fail(f"{name}: launches off the bf16 body {body} ({bodies})")
    return {k: b[want[k]] for k, b in bodies.items() if k in want and b[want[k]]}


def bf16_body_row(name, source, replaces, run, plain, tf32, limit, nbytes, flops, lib,
                  info_fn, s, words, precision, *, nt, d=128, h=4, items=None,
                  repeats=True, timed=None, **extra):
    """A bf16 body's row at the shapes the main path gives it: its output
    against its plain version on the card within ``limit`` of the largest
    entry (``run`` and ``plain`` may return a tuple of parts, each held
    against its own largest entry), launched twice and equal bit for bit
    where the body uses no atomics (``repeats``), timed in turns with the
    3xTF32 body ``tf32`` (``timed``: the launch alone, where ``run`` also
    gathers what it compares), its bound at bf16 widths and the bf16 rate,
    registers, spills, blocks per SM and stages (``kernel_info`` over
    ``items`` blocks of work: nodes, or K6's and K9's (tile, group) items)."""
    from ampnet_tpu_torch.ops.hopper.launch import kernel_info

    def parts(out):
        return out if isinstance(out, tuple) else (out,)

    got, again, ref = parts(run()), parts(run()), parts(plain())
    torch.cuda.synchronize()
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
    rel = [e / float(b.float().abs().max()) for e, b in zip(errs, ref)]
    if not max(rel) <= limit:
        fail(f"{name} ({precision}) S={s}: the bf16 body disagrees with its plain "
             f"version (max abs err {max(errs):.3g}, {max(rel):.3g} of the largest entry)")
    if repeats and not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name} ({precision}) S={s}: a second launch differs from the first")
    del got, again, ref
    ms, tf32_ms = in_turns(tf32, timed or run)
    info = kernel_info(lib, info_fn, nt if items is None else items, s, d, h)
    b, by = bf16_bound_ms(nbytes, flops)
    return dict(name=name, route="cuda", source=f"ampnet_tpu_torch/ops/hopper/csrc/{source}",
                replaces=replaces, max_abs_err=max(errs), rel_err=max(rel), limit=limit,
                ms=ms, tf32_ms=tf32_ms, speedup_vs_tf32=tf32_ms / ms,
                plain_ms=cuda_ms(plain, 3), bound_ms=b, bound_by=by, library_ms=None,
                regs=info["regs"], spills=ptxas_of(lib, *words)["spills"],
                blocks_per_sm=info["blocks_per_sm"], stages=info["stages"],
                smem_bytes=info["smem_bytes"], precision=precision, s=s, **extra)


def bf16_kernel_rows(graph, layout, gen, dev) -> dict:
    """Each bf16 body at the shapes the main path gives it (K1, K3, K4 at
    S=40, the bf16 training step; K3 and K4 at S=20, H's S=20 steps; K5 at
    S=40, path F; K6 and K9 at S=40, G, H and I; K7 at S=20, G; K2 at S=40
    and S=20, the bf16 Predictor's; K1, K2, K6 and K7 also on f32 rows
    under mxu_bf16 at S=20, where the S=20 training steps and evals run
    them) against its plain version on the card, launched twice and equal
    bit for bit where it uses no atomics, timed in turns with the 3xTF32
    body at the same S (its own f32 rows and stride), with its bound at
    bf16 widths and the bf16 rate, registers, spills, blocks per SM and
    stages. K2's projection also beside one bf16 cuBLAS addmm."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
    from ampnet_tpu_torch.ops.hopper.format import (chunk_slot_valid, compute_chunked_layout,
                                                    edge_slot_valid, snd_slot_valid)
    from ampnet_tpu_torch.ops.segment import segment_count

    bf = torch.bfloat16
    d, h = 128, 4
    n = graph.num_nodes_padded
    nt = layout.recv_ptr.numel() - 1
    mask = graph.edge_mask.clone()
    mask[torch.nonzero(mask)[::50, 0]] = False
    idx = (layout.tile_senders, edge_slot_valid(layout, mask), layout.recv_ptr,
           layout.recv_slots)
    snd_idx = (layout.snd_receivers, snd_slot_valid(layout, mask), layout.snd_ptr,
               layout.snd_slots)
    live_edges = int(idx[1].sum())
    index_bytes = 4 * (2 * layout.tile_senders.numel() + layout.recv_ptr.numel()
                       + layout.recv_slots.numel())
    snd_index_bytes = 4 * (2 * layout.snd_receivers.numel() + layout.snd_ptr.numel()
                           + layout.snd_slots.numel())

    def row(*args, **extra):
        return bf16_body_row(*args, nt=nt, **extra)

    def inputs(s, sp, sp32):
        """bf16 q|k|v and dsum rows at SP=sp (pad token rows of dsum 0, as
        the op makes them), f32 ones at sp32 for the 3xTF32 body."""
        q16 = torch.randn(nt * sp, 3 * d, generator=gen, device=dev).to(bf)
        q32 = torch.randn(nt * sp32, 3 * d, generator=gen, device=dev)
        dsum16 = torch.randn(nt, sp, d, generator=gen, device=dev)
        dsum16[:, s:] = 0.0
        dsum16 = dsum16.reshape(nt * sp, d).to(bf)
        qdm16 = torch.cat([q16[:, :d], dsum16], 1)
        qdm32 = torch.cat([q32[:, :d], torch.randn(nt * sp32, d, generator=gen, device=dev)],
                          1)
        return (q16, dsum16, qdm16, q32, qdm32, dict(s=s, sp=sp, num_heads=h, softmax=True),
                dict(s=s, sp=sp32, num_heads=h, softmax=True))

    def k3_k4(key, s, q16, dsum16, qdm16, q32, qdm32, kw, kw32):
        nkt = f"ILi{-(-s // 8)}E"
        rows["k3_" + key] = row(
            "edge_attention_bwd_dq", "edge_attention_bwd_dq_tc_bf16.cu",
            "ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:211",
            lambda: bwd.edge_attention_bwd_dq(q16[:, :d], q16[:, d:], dsum16, *idx, **kw),
            lambda: bwd.edge_attention_bwd_dq_plain(q16[:, :d], q16[:, d:], dsum16, *idx,
                                                    **kw),
            lambda: bwd.edge_attention_bwd_dq(q32[:, :d], q32[:, d:], qdm32[:, d:], *idx,
                                              **kw32),
            BF16_KERNEL_LIMIT, 4 * d * n * s * 2 + d * n * s * 4 + index_bytes,
            6 * s * s * d * live_edges, "edge_attention_bwd_dq_tc_bf16",
            "ampnet_edge_attention_bwd_dq_bf16_info", s, ("dq_bf16_kernel", nkt), "bf16")
        rows["k4_" + key] = row(
            "edge_attention_bwd_dkv", "edge_attention_bwd_tc_bf16.cu",
            "ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:319",
            lambda: bwd.edge_attention_bwd_dkv(qdm16, q16[:, d:], *snd_idx, **kw),
            lambda: bwd.edge_attention_bwd_dkv_plain(qdm16, q16[:, d:], *snd_idx, **kw),
            lambda: bwd.edge_attention_bwd_dkv(qdm32, q32[:, d:], *snd_idx, **kw32),
            BF16_KERNEL_LIMIT, 4 * d * n * s * 2 + 2 * d * n * s * 4 + snd_index_bytes,
            8 * s * s * d * live_edges, "edge_attention_bwd_tc_bf16",
            "ampnet_edge_attention_bwd_dkv_bf16_info", s, ("dkv_bf16_kernel", nkt), "bf16")

    # K8 on the chunked layout of the same graph and mask; no model path
    # reaches it, so its launches are its public wrapper's, one call at each
    # S with the counts set to 0 just before and read just after
    chunked = compute_chunked_layout(graph, chunk_edges=CHUNK_EDGES)
    chunks = (chunked.senders, chunk_slot_valid(chunked, mask), chunked.chunk_start,
              chunked.chunk_count)
    chunk_bytes = 4 * (2 * chunked.senders.numel() + 2 * chunked.chunk_start.numel())

    def k8(key, s, q16, q32, kw, kw32):
        nkt = f"ILi{-(-s // 8)}E"
        ck, ck32 = dict(kw, chunk=CHUNK_EDGES), dict(kw32, chunk=CHUNK_EDGES)
        eaf.reset_launch_counts()
        eav.edge_attention_sums_chunked(q16[:, :d], q16[:, d:], *chunks, **ck)
        torch.cuda.synchronize()
        launched = bf16_only(f"K8 bf16 S={s}", ("edge_attention_sums_chunked",))
        rows[key] = row(
            "edge_attention_sums_chunked",
            "edge_attention_chunked_tc_bf16.cu + edge_attention_tc_bf16.cuh",
            "ampnet_tpu/ops/pallas/edge_attention_fused.py:1225",
            lambda: eav.edge_attention_sums_chunked(q16[:, :d], q16[:, d:], *chunks, **ck),
            lambda: eav.edge_attention_sums_chunked_plain(q16[:, :d], q16[:, d:], *chunks,
                                                          **ck),
            lambda: eav.edge_attention_sums_chunked(q32[:, :d], q32[:, d:], *chunks, **ck32),
            BF16_KERNEL_LIMIT, 3 * d * n * s * 2 + d * n * s * 4 + chunk_bytes,
            4 * s * s * d * live_edges, "edge_attention_chunked_tc_bf16",
            "ampnet_edge_attention_sums_chunked_bf16_info", s, ("chunked_bf16_kernel", nkt),
            "bf16", launches=launched["edge_attention_sums_chunked"])

    rows = {}
    s, sp, sp32 = 40, 48, 40
    q16, dsum16, qdm16, q32, qdm32, kw, kw32 = inputs(s, sp, sp32)
    nkt = f"ILi{-(-s // 8)}E"
    rows["k1_bf16"] = row(
        "edge_attention_sums", "edge_attention_tc_bf16.cu + edge_attention_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:942",
        lambda: eaf.edge_attention_sums(q16[:, :d], q16[:, d:], *idx, **kw),
        lambda: eaf.edge_attention_sums_plain(q16[:, :d], q16[:, d:], *idx, **kw),
        lambda: eaf.edge_attention_sums(q32[:, :d], q32[:, d:], *idx, **kw32),
        BF16_KERNEL_LIMIT, 3 * d * n * s * 2 + d * n * s * 4 + index_bytes,
        4 * s * s * d * live_edges, "edge_attention_tc_bf16",
        "ampnet_edge_attention_sums_bf16_info", s,
        ("sums_bf16_kernel", nkt + "Lb0E13__nv_bfloat16"), "bf16")
    k3_k4("bf16", s, q16, dsum16, qdm16, q32, qdm32, kw, kw32)

    # K5 (path F's pass A) at S=40: dQ, and the stream's dK and dV on the
    # walked slots, each against its own largest entry; pass B on the f32
    # stream it writes
    walked = layout.recv_slots.long()

    def k5(q, kv, dsum, kw_):
        dq, stream = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw_)
        per_slot = stream.view(-1, kw_["sp"], 2 * d)[walked]
        return dq, per_slot[..., :d], per_slot[..., d:]

    def k5_plain():
        dq, stream = sb.edge_attention_bwd_stream_plain(q16[:, :d], q16[:, d:], dsum16, *idx,
                                                        **kw)
        per_slot = stream.view(-1, sp, 2 * d)[walked]
        return dq, per_slot[..., :d], per_slot[..., d:]

    _, stream = sb.edge_attention_bwd_stream(q16[:, :d], q16[:, d:], dsum16, *idx, **kw)
    dkv = torch.zeros(nt, s, 2 * d, device=dev)
    take = sb.walked_slots(layout.tile_senders, layout.recv_ptr,
                           (0, layout.tile_senders.shape[0]))
    pass_b = pass_b_report(stream, layout.tile_senders, take, dkv, s, sp)
    del stream, dkv
    rows["k5_bf16"] = row(
        "edge_attention_bwd_stream",
        "edge_attention_bwd_stream_tc_bf16.cu + edge_attention_bwd_dq_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_bwd.py:694",
        lambda: k5(q16[:, :d], q16[:, d:], dsum16, kw), k5_plain,
        lambda: sb.edge_attention_bwd_stream(q32[:, :d], q32[:, d:], qdm32[:, d:], *idx,
                                             **kw32),
        BF16_KERNEL_LIMIT,
        4 * d * n * s * 2 + d * n * s * 4 + walked.numel() * s * 2 * d * 4 + index_bytes,
        10 * s * s * d * live_edges, "edge_attention_bwd_stream_tc_bf16",
        "ampnet_edge_attention_bwd_stream_bf16_info", s, ("stream_bf16_kernel", nkt), "bf16",
        timed=lambda: sb.edge_attention_bwd_stream(q16[:, :d], q16[:, d:], dsum16, *idx, **kw),
        **pass_b)

    # K6 (G and H at S=40: JAX's 'dma' body v8, which ignores mxu_bf16) and
    # K9 (I) on bf16 rows; f32 atomics across warps: no bit-for-bit repeat
    slots = (layout.tile_senders, layout.tile_recv, idx[1])
    tiles, emax = layout.tile_senders.shape
    slot_bytes = 4 * 3 * layout.tile_senders.numel()
    v1_group = 8 if emax % 8 == 0 else 1
    mm16, mm32 = dict(kw, tile_nodes=layout.tile_nodes), dict(kw32, tile_nodes=layout.tile_nodes)
    rows["k6_bf16"] = row(
        "edge_attention_sums_mm", "edge_attention_groups_tc_bf16.cu + edge_attention_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:1126",
        lambda: eav.edge_attention_sums_mm(q16[:, :d], q16[:, d:], *slots, layout.tile_counts,
                                           **mm16),
        lambda: eav.edge_attention_sums_mm_plain(q16[:, :d], q16[:, d:], *slots,
                                                 layout.tile_counts, **mm16,
                                                 group=eav.MM_GROUP),
        lambda: eav.edge_attention_sums_mm(q32[:, :d], q32[:, d:], *slots, layout.tile_counts,
                                           **mm32),
        BF16_KERNEL_LIMIT,
        3 * d * n * s * 2 + d * n * s * 4 + slot_bytes + 4 * tiles,
        4 * s * s * d * live_edges, "edge_attention_groups_tc_bf16",
        "ampnet_edge_attention_groups_bf16_info", s,
        ("groups_bf16_kernel", nkt + "13__nv_bfloat16"), "bf16",
        items=tiles * -(-emax // eav.MM_GROUP), repeats=False)
    rows["k9_bf16"] = row(
        "edge_attention_sums_v1", "edge_attention_groups_tc_bf16.cu + edge_attention_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:186",
        lambda: eav.edge_attention_sums_v1(q16[:, :d], q16[:, d:], *slots, **mm16,
                                           group=v1_group),
        lambda: eav.edge_attention_sums_v1_plain(q16[:, :d], q16[:, d:], *slots, **mm16,
                                                 group=v1_group),
        lambda: eav.edge_attention_sums_v1(q32[:, :d], q32[:, d:], *slots, **mm32,
                                           group=v1_group),
        BF16_KERNEL_LIMIT, 3 * d * n * s * 2 + d * n * s * 4 + slot_bytes,
        4 * s * s * d * live_edges, "edge_attention_groups_tc_bf16",
        "ampnet_edge_attention_groups_bf16_info", s,
        ("groups_bf16_kernel", nkt + "13__nv_bfloat16"), "bf16",
        items=tiles * (emax // v1_group), repeats=False)
    k8("k8_bf16", s, q16, q32, kw, kw32)
    del q16, q32, dsum16, qdm16, qdm32
    # K3 and K4 where H's S=20 steps run them on a bf16 model (SP=32; the
    # 3xTF32 body on f32 rows at SP=24); K8 at S=20
    s20 = inputs(20, 32, 24)
    k3_k4("bf16_s20", 20, *s20)
    k8("k8_bf16_s20", 20, s20[0], s20[3], s20[5], s20[6])
    del s20

    # K1 under mxu_bf16 where the main path runs it: the S=20 training
    # step's f32 'vmem' rows (SP=24; at S=40 the JAX 'dma' body ignores the
    # flag, so K1 keeps its 3xTF32 body there)
    s, sp32 = 20, 24
    nkt = f"ILi{-(-s // 8)}E"
    q32 = torch.randn(nt * sp32, 3 * d, generator=gen, device=dev)
    kw32 = dict(s=s, sp=sp32, num_heads=h, softmax=True)
    rows["k1_mxu"] = row(
        "edge_attention_sums", "edge_attention_tc_bf16.cu + edge_attention_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:691",
        lambda: eaf.edge_attention_sums(q32[:, :d], q32[:, d:], *idx, **kw32, mxu_bf16=True),
        lambda: eaf.edge_attention_sums_plain(q32[:, :d], q32[:, d:], *idx, **kw32,
                                              mxu_bf16=True),
        lambda: eaf.edge_attention_sums(q32[:, :d], q32[:, d:], *idx, **kw32),
        BF16_KERNEL_LIMIT, 4 * d * n * s * 4 + index_bytes, 4 * s * s * d * live_edges,
        "edge_attention_tc_bf16", "ampnet_edge_attention_sums_mxu_info", s,
        ("sums_bf16_kernel", nkt + "Lb0EfE"), "bf16 products of f32 rows (mxu_bf16)")
    # K6 under mxu_bf16 where the main path runs it: H's S=20 training step
    # (the 'vmem' gather's v2_mm honours the flag)
    mm32 = dict(kw32, tile_nodes=layout.tile_nodes)
    rows["k6_mxu"] = row(
        "edge_attention_sums_mm", "edge_attention_groups_tc_bf16.cu + edge_attention_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:731",
        lambda: eav.edge_attention_sums_mm(q32[:, :d], q32[:, d:], *slots, layout.tile_counts,
                                           **mm32, mxu_bf16=True),
        lambda: eav.edge_attention_sums_mm_plain(q32[:, :d], q32[:, d:], *slots,
                                                 layout.tile_counts, **mm32,
                                                 group=eav.MM_GROUP, mxu_bf16=True),
        lambda: eav.edge_attention_sums_mm(q32[:, :d], q32[:, d:], *slots, layout.tile_counts,
                                           **mm32),
        BF16_KERNEL_LIMIT, 4 * d * n * s * 4 + slot_bytes + 4 * tiles,
        4 * s * s * d * live_edges, "edge_attention_groups_tc_bf16",
        "ampnet_edge_attention_groups_mxu_info", s, ("groups_bf16_kernel", nkt + "fE"),
        "bf16 products of f32 rows (mxu_bf16)", items=tiles * -(-emax // eav.MM_GROUP),
        repeats=False)
    del q32

    # K2 where the bf16 Predictor runs it (S=40 at the 512- and 1,024-node
    # buckets, S=20 at every bucket) and under mxu_bf16 (eval B, S=20)
    conv = AMPConv(d, h, generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.no_grad():
        conv.b_qkv.normal_(0.0, 0.1, generator=gen)
        conv.b_out.normal_(0.0, 0.1, generator=gen)
    w = [t.detach().contiguous() for t in conv.params()]
    w16 = [t.to(bf).contiguous() for t in w]
    count = segment_count(graph.receivers, n, mask)
    invdeg = torch.where(count > 0, 1.0 / count.clamp_min(1.0), torch.zeros_like(count))
    invdeg = torch.nn.functional.pad(invdeg, (0, nt - n))
    live_recv = int((count > 0).sum())
    for key, s, sp, sp32 in (("k2_bf16_s40", 40, 48, 40), ("k2_bf16", 20, 32, 24)):
        nkt = f"ILi{-(-s // 8)}E"
        x16 = torch.randn(nt * sp, d, generator=gen, device=dev).to(bf)
        x32 = torch.randn(nt * sp32, d, generator=gen, device=dev)
        kw, kw32 = dict(s=s, sp=sp, num_heads=h, softmax=True), dict(s=s, sp=sp32, num_heads=h,
                                                                       softmax=True)
        tf32_k2 = lambda: eaf.edge_attention_layer(x32, *w, invdeg, *idx, **kw32)  # noqa: E731
        flops2 = 2 * n * s * d * 3 * d + 4 * s * s * d * live_edges + 2 * s * d * d * live_recv
        k2 = lambda: eaf.edge_attention_layer(x16, *w16, invdeg, *idx, **kw)  # noqa: E731
        got = k2()
        if not (got.view(nt, sp, d)[:n][count == 0] == 0).all():
            fail(f"edge_attention_layer (bf16) S={s}: a receiver without a live edge is not "
                 f"exactly 0")
        qkv16 = eav.layer_projection(x16, w16[0], w16[1], "tc_bf16")
        err_p = float((qkv16.float() - eaf.qkv_projection_plain(x16, w16[0], w16[1]).float())
                      .abs().max())
        projection_ms, projection_library_ms = in_turns(
            lambda: torch.addmm(w16[1], x16, w16[0]),
            lambda: eav.layer_projection(x16, w16[0], w16[1], "tc_bf16"))
        qkv32 = eav.layer_projection(x32, w[0], w[1], "tc")
        attention_ms, tf32_attention_ms = in_turns(
            lambda: eaf._layer_attention(qkv32, *w[2:], invdeg, *idx, **kw32, body="tc"),
            lambda: eaf._layer_attention(qkv16, *w16[2:], invdeg, *idx, **kw, body="tc_bf16"))
        del qkv32, qkv16
        rows[key] = row(
            "edge_attention_layer",
            "edge_attention_layer_tc_bf16.cu + edge_attention_tc_bf16.cuh",
            "ampnet_tpu/ops/pallas/edge_attention_fused.py:763", k2,
            lambda: eaf.edge_attention_layer_plain(x16, *w16, invdeg, *idx, **kw), tf32_k2,
            BF16_OUTPUT_LIMIT, 2 * (2 * n * s * d + 4 * d * d + 4 * d) + 4 * nt + index_bytes,
            flops2, "edge_attention_layer_tc_bf16", "ampnet_edge_attention_layer_bf16_info", s,
            ("sums_bf16_kernel", nkt + "Lb1E13__nv_bfloat16"), "bf16",
            projection_ms=projection_ms, projection_library_ms=projection_library_ms,
            projection_max_abs_err=err_p,
            projection_spills=ptxas_of("edge_attention_layer_tc_bf16",
                                       "projection_bf16_kernel")["spills"],
            attention_ms=attention_ms, tf32_attention_ms=tf32_attention_ms)
    # the loop's last shape: S=20, f32 rows at SP=24
    rows["k2_mxu"] = row(
        "edge_attention_layer", "edge_attention_layer_tc_bf16.cu + edge_attention_tc_bf16.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:763",
        lambda: eaf.edge_attention_layer(x32, *w, invdeg, *idx, **kw32, mxu_bf16=True),
        lambda: eaf.edge_attention_layer_plain(x32, *w, invdeg, *idx, **kw32, mxu_bf16=True),
        tf32_k2, BF16_KERNEL_LIMIT, 4 * (2 * n * s * d + 4 * d * d + 4 * d + nt) + index_bytes,
        flops2, "edge_attention_layer_tc_bf16", "ampnet_edge_attention_layer_mxu_info", s,
        ("sums_bf16_kernel", nkt + "Lb1EfE"), "bf16 products of f32 rows (mxu_bf16)")

    # K7 where G runs it at S=20 (a bf16 model's rows at SP=32; f32 rows at
    # SP=24 under mxu_bf16), by launch: the projection (K2's), the
    # attention (K6's body) and the out-projection, each in turns with its
    # 3xTF32 launch
    x16 = torch.randn(nt * sp, d, generator=gen, device=dev).to(bf)
    mm16, mm32 = dict(kw, tile_nodes=layout.tile_nodes), dict(kw32, tile_nodes=layout.tile_nodes)
    k7_bytes = 2 * (2 * n * s * d + 4 * d * d + 4 * d) + 4 * nt + slot_bytes + 4 * tiles
    items = tiles * -(-emax // eav.MM_GROUP)
    k7 = lambda: eav.edge_attention_layer_mm(  # noqa: E731
        x16, *w16, invdeg, *slots, layout.tile_counts, **mm16)
    tf32_k7 = lambda: eav.edge_attention_layer_mm(  # noqa: E731
        x32, *w, invdeg, *slots, layout.tile_counts, **mm32)
    got = k7()
    if got.dtype != bf or not (got.view(nt, sp, d)[:n][count == 0] == 0).all():
        fail(f"edge_attention_layer_mm (bf16) S={s}: {got.dtype} out, or a receiver without "
             f"a live edge is not exactly 0")
    qkv16 = eav.layer_projection(x16, w16[0], w16[1], "tc_bf16")
    qkv32 = eav.layer_projection(x32, w[0], w[1], "tc")
    projection_ms, tf32_projection_ms = in_turns(
        lambda: eav.layer_projection(x32, w[0], w[1], "tc"),
        lambda: eav.layer_projection(x16, w16[0], w16[1], "tc_bf16"))
    attention = {
        b_: (lambda b_=b_, qkv=qkv, sp_=sp_: eav._launch_groups(
            "edge_attention_sums_mm", b_,
            (qkv.data_ptr(), 3 * d, qkv.data_ptr() + d * qkv.element_size(), 3 * d), *slots,
            layout.tile_counts, s=s, sp=sp_, d=d, num_heads=h, softmax=True,
            tile_nodes=layout.tile_nodes, group=eav.MM_GROUP, dtype=qkv.dtype))
        for b_, qkv, sp_ in (("tc", qkv32, sp32), ("tc_bf16", qkv16, sp))}
    attention_ms, tf32_attention_ms = in_turns(attention["tc"], attention["tc_bf16"])
    sums16, sums32 = attention["tc_bf16"](), attention["tc"]()
    out_projection_ms, tf32_out_projection_ms = in_turns(
        lambda: eav._layer_mm_out_projection(sums32, invdeg, *w[2:], s=s, sp=sp32, body="tc"),
        lambda: eav._layer_mm_out_projection(sums16, invdeg, *w16[2:], s=s, sp=sp,
                                             body="tc_bf16"))
    del qkv16, qkv32, sums16, sums32, got
    rows["k7_bf16"] = row(
        "edge_attention_layer_mm",
        "edge_attention_groups_tc_bf16.cu + edge_attention_layer_tc_bf16.cu",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:865", k7,
        lambda: eav.edge_attention_layer_mm_plain(x16, *w16, invdeg, *slots, layout.tile_counts,
                                                  **mm16, group=eav.MM_GROUP),
        tf32_k7, BF16_OUTPUT_LIMIT, k7_bytes, flops2, "edge_attention_groups_tc_bf16",
        "ampnet_edge_attention_groups_bf16_info", s,
        ("groups_bf16_kernel", nkt + "13__nv_bfloat16"), "bf16", items=items, repeats=False,
        projection_ms=projection_ms, tf32_projection_ms=tf32_projection_ms,
        attention_ms=attention_ms, tf32_attention_ms=tf32_attention_ms,
        out_projection_ms=out_projection_ms, tf32_out_projection_ms=tf32_out_projection_ms,
        out_projection_spills=ptxas_of("edge_attention_layer_tc_bf16",
                                       "mean_out_bf16_kernel")["spills"])
    rows["k7_mxu"] = row(
        "edge_attention_layer_mm",
        "edge_attention_groups_tc_bf16.cu + edge_attention_layer_tc.cu",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:865",
        lambda: eav.edge_attention_layer_mm(x32, *w, invdeg, *slots, layout.tile_counts, **mm32,
                                            mxu_bf16=True),
        lambda: eav.edge_attention_layer_mm_plain(x32, *w, invdeg, *slots, layout.tile_counts,
                                                  **mm32, group=eav.MM_GROUP, mxu_bf16=True),
        tf32_k7, BF16_KERNEL_LIMIT,
        4 * (2 * n * s * d + 4 * d * d + 4 * d + nt) + slot_bytes + 4 * tiles, flops2,
        "edge_attention_groups_tc_bf16", "ampnet_edge_attention_groups_mxu_info", s,
        ("groups_bf16_kernel", nkt + "fE"), "bf16 products of f32 rows (mxu_bf16)",
        items=items, repeats=False)
    return rows


# ---- bf16 beyond the tensor cores: the CUDA-core bf16 bodies (bf16_wide, J)

# bf16_wide's evals beyond the warp limit at S=20 (16 warps where S <= 24
# takes 8), whose forward is the whole layer (the JAX predicate: v6 fits at
# S=20 on the 'vmem' gather): K2, and K7 under MM_SCATTER_DEFAULT, so that
# both run their CUDA-core bf16 bodies on a model path
WIDE_EVALS = ((20, 128, 8, False, "simt", (), None), (20, 128, 8, False, "simt", (), MM))
# a conv's output against float64 on the CPU on the same inputs (a bf16
# conv's inputs and weights rounded to bf16 on both sides), of its largest
# entry. The bodies round where the JAX bodies round, and those roundings
# are the distance to float64: an f32 output (mxu_bf16; K8's sums) carries
# its messages' rounded operands (q times the scale, k, the weights, v:
# half a step each), 0.5-1.2 steps where every dot product has few terms
# (D=3, measured on an H100), so two steps; a bf16 conv's output is a bf16
# tensor, rounded again after its mean and its q, k and v rows were,
# 1.1-2.3 steps, so four
WIDE_F64_LIMIT = 2 * 2.0 ** -8
WIDE_BF16_F64_LIMIT = 4 * 2.0 ** -8
# a conv's gradients through the kernels against the same conv through
# their plain versions on the card, of each gradient's largest entry: both
# round at the same points, so they differ where a value near a bf16
# rounding boundary (the dsum rows, the weights, the gradients themselves,
# each rounded to bf16) falls on the other side after f32 sums taken in
# another order, and that step passes through the next product
BF16_WIDE_GRAD_LIMIT = 4 * 2.0 ** -8


def release_graphs() -> dict:
    """Drop what earlier phases left behind before a phase that needs room:
    a captured graph keeps its memory pool until it is collected, and the
    steps that own them sit in reference cycles. Returns the bytes the
    allocator holds after."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(memory_reserved=torch.cuda.memory_reserved(),
                memory_allocated=torch.cuda.memory_allocated())


@contextlib.contextmanager
def plain_versions():
    """The fused op's kernel wrappers (K1-K7, K9) replaced by their plain
    versions for the block: the same op with the same rounding points, torch
    products on the card in place of the kernels (bf16_wide's yardstick);
    nothing is launched or counted."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav

    def mm_group(group):
        return eav.MM_GROUP if group is None else group

    swaps = {
        (eaf, K1_): lambda *a, body=None, **k: eaf.edge_attention_sums_plain(*a, **k),
        (eaf, K2_): lambda *a, body=None, **k: eaf.edge_attention_layer_plain(*a, **k),
        (bwd, K3_): lambda *a, body=None, **k: bwd.edge_attention_bwd_dq_plain(*a, **k),
        (bwd, K4_): lambda *a, body=None, **k: bwd.edge_attention_bwd_dkv_plain(*a, **k),
        (sb, K5_): lambda *a, body=None, **k: sb.edge_attention_bwd_stream_plain(*a, **k),
        (eav, K6_): lambda *a, body=None, group=None, **k: eav.edge_attention_sums_mm_plain(
            *a, group=mm_group(group), **k),
        (eav, K7_): lambda *a, body=None, group=None, **k: eav.edge_attention_layer_mm_plain(
            *a, group=mm_group(group), **k),
        (eav, K9_): lambda *a, body=None, gather="dma", **k: eav.edge_attention_sums_v1_plain(
            *a, **k)}
    before = {key: getattr(*key) for key in swaps}
    try:
        for (mod, name), fn in swaps.items():
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in before.items():
            setattr(mod, name, fn)


def conv_forward(s, d, dtype, n, layout, flag, train) -> tuple:
    """(the forward kernel, the gather) of one AMPConv call on rows of
    ``dtype`` by the port's copy of the JAX predicates: the whole layer (K2,
    K7 under MM_SCATTER_DEFAULT) for an eval where v6 fits, K9 on the 'dma'
    gather under DMA_V1_DEFAULT, else K1 (K6 under MM_SCATTER_DEFAULT)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    x = torch.empty(n, s, d, dtype=dtype, device="meta")
    nt, sp, gather = eaf._grid(x, torch.empty(d, 3 * d, dtype=dtype, device="meta"),
                               layout.tile_senders, layout.recv_ptr, layout.tile_nodes,
                               "auto", False)
    if not train and eaf._v6_usable(n, nt, sp, d, x.element_size(), layout.tile_nodes,
                                    eaf._auto_group(sp), gather):
        return (K7_ if flag == MM else K2_), gather
    if gather != "vmem" and flag == V1:
        return K9_, gather
    return (K6_ if flag == MM else K1_), gather


def bf16_body_of(kernel, s, d, h, rows_bf16) -> str:
    """The bf16 body the route gives ``kernel`` on the q|k|v rows a conv
    projects: 'tc_bf16' within the tensor cores' range where the rows it
    gathers take 16-byte copies (K4 gathers its packed [Q | dsum] rows, 2D
    values apart; the others views of the q|k|v rows, 3D apart and D in),
    else 'simt_bf16'."""
    from ampnet_tpu_torch.ops.hopper import launch as hl

    if hl.tensor_core_range_error(s, d, h, kernel):
        return "simt_bf16"
    per_copy = 8 if rows_bf16 else 4
    aligned = (2 * d) % per_copy == 0 if kernel == K4_ else d % per_copy == 0
    return "tc_bf16" if aligned else "simt_bf16"


def rel_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()) / max(
        float(ref.double().abs().max()), 1e-30)


def bf16_wide(data, gen, dev) -> tuple:
    """AMPConv in bf16 products at every shape of ROUTES and WIDE_EVALS, as
    a bf16 conv (dtype bfloat16) and, where the JAX body honours mxu_bf16
    (the 'vmem' gather's K1 and K6, and the whole layer), as an f32 conv
    under it; forward and (training) one backward with dropout 0 on the
    card. Each against the same conv through the kernels' plain versions on
    the card (``plain_versions``; outputs within BF16_OUTPUT_LIMIT (bf16) or
    BF16_KERNEL_LIMIT (f32), gradients within BF16_WIDE_GRAD_LIMIT of each
    one's largest entry) and against float64 on the CPU through the plain
    oracle on the same bf16 values (output within WIDE_BF16_F64_LIMIT for a
    bf16 conv, WIDE_F64_LIMIT for an f32 one, gradients within
    BF16_GRAD_RTOL); the launches exact by kernel and by body (every
    kernel of a bf16 conv on its bf16 body, 'simt_bf16' beyond the tensor
    cores; an f32 conv's forward on its bf16 body and its backward on its
    f32 one), the device-memory launches as the f32 rows'. Then K8 on bf16
    rows at CHUNKED_ROUTES, against its plain version and K1's float64 sums;
    then the named bodies that still refuse, which must launch nothing.
    Returns (report, {(kernel, body, rows, S, D, H, training): launches})."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
    from ampnet_tpu_torch.ops.hopper.format import (chunk_slot_valid, compute_chunked_layout,
                                                    edge_slot_valid)

    t_phase = time.perf_counter()
    memory_at_start = release_graphs()
    bf = torch.bfloat16
    graphs, no_sender_side = route_graphs(data, dev)
    rows = ROUTES + WIDE_EVALS
    cases, ran, report = [], {}, []
    for mode in ("bf16", "mxu"):
        cases += [(row, mode) for row in rows]
    for (s, d, h, train, want, want_memory, flag), mode in cases:
        graph, mask, layout = graphs[train]
        if flag == STREAM:
            layout = no_sender_side
        n = graph.num_nodes_padded
        rows_bf16 = mode == "bf16"
        forward, gather = conv_forward(s, d, bf if rows_bf16 else torch.float32, n, layout,
                                       flag, train)
        if not rows_bf16 and not (forward in (K2_, K7_)
                                  or (gather == "vmem" and forward in (K1_, K6_))):
            continue                    # the JAX body ignores mxu_bf16 there
        name = (f"S={s} D={d} H={h} {'training' if train else 'eval'} {mode}"
                + (f" {flag}" if flag else ""))
        conv = AMPConv(d, h, use_pallas=True, dtype=bf if rows_bf16 else None,
                       generator=torch.Generator().manual_seed(s + d + h)).to(dev)
        with torch.no_grad():
            conv.b_qkv.normal_(0.0, 0.1, generator=gen)
            conv.b_out.normal_(0.0, 0.1, generator=gen)
        x = torch.randn(n, s, d, generator=gen, device=dev)
        gout = torch.randn(n, s, d, generator=gen, device=dev)

        def run(layer, xx, lay, args):
            xx = xx.detach().requires_grad_(train)
            layer.zero_grad(set_to_none=True)
            with torch.set_grad_enabled(train):
                out, _ = layer(xx, *args, return_weights=False, layout=lay)
                if train:            # in f32 (f64 for the float64 reference)
                    wide = torch.promote_types(out.dtype, torch.float32)
                    (out.to(wide) * gout.to(out.device, wide)).sum().backward()
            grads = {"x": xx.grad} if train else {}
            grads.update({k: p.grad for k, p in layer.named_parameters() if train})
            return out.detach(), grads

        args = (graph.senders, graph.receivers, mask)
        with contextlib.ExitStack() as flags:
            for f in ([flag] if flag in (MM, V1) else []) + ([] if rows_bf16 else
                                                             ["MXU_BF16_DEFAULT"]):
                flags.enter_context(dispatch_flag(f))
            eaf.reset_launch_counts()
            t0 = time.perf_counter()
            out, grads = run(conv, x, layout, args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            counts, bodies = eaf.launch_counts(), eaf.body_launch_counts()
            memory = eaf.device_memory_launch_counts()
            with plain_versions():
                out_p, grads_p = run(conv, x, layout, args)
            torch.cuda.synchronize()
        if eaf.launch_counts() != counts:
            fail(f"bf16_wide {name}: the plain versions launched a kernel")
        backward = (dict(k5=1) if flag == STREAM else dict(k3=1, k4=1)) if train else {}
        expected = {**launches(**backward), forward: 1}
        if counts != expected:
            fail(f"bf16_wide {name}: launched {counts}; expected {expected}")
        want_bodies = {k: (bf16_body_of(k, s, d, h, rows_bf16) if rows_bf16 or k == forward
                           else want_of(want, k)) for k, c in counts.items() if c}
        got_bodies = {k: {b: c for b, c in bodies[k].items() if c} for k in want_bodies}
        if any(got_bodies[k] != {b: counts[k]} for k, b in want_bodies.items()):
            fail(f"bf16_wide {name}: the kernels ran the bodies {got_bodies}, expected "
                 f"{want_bodies}")
        attention = K6_ if forward == K7_ else forward
        in_memory = tuple(k for k in (*want_bodies, attention) if memory.get(k))
        if set(in_memory) != set(want_memory):
            fail(f"bf16_wide {name}: working sets in device memory {in_memory}, expected "
                 f"{want_memory}")
        for k, b in want_bodies.items():
            key = (k, b, mode, s, d, h, train)
            ran[key] = ran.get(key, 0) + counts[k]

        limit = BF16_OUTPUT_LIMIT if rows_bf16 else BF16_KERNEL_LIMIT
        plain_err = rel_err(out, out_p)
        grad_plain = max((rel_err(grads[k], grads_p[k]) for k in grads), default=None)
        if not torch.isfinite(out).all() or plain_err > limit or (
                grad_plain is not None and grad_plain > BF16_WIDE_GRAD_LIMIT):
            fail(f"bf16_wide {name}: against the plain versions: output {plain_err:.3g} "
                 f"(limit {limit:.3g}), gradients {grad_plain} (limit "
                 f"{BF16_WIDE_GRAD_LIMIT:.3g}) of their largest entries")
        ref_conv = copy.deepcopy(conv).to("cpu", torch.float64)
        ref_conv.use_pallas, ref_conv.dtype = False, None
        x_ref = x.cpu()
        if rows_bf16:                   # the same bf16 values, in float64
            x_ref = x_ref.to(bf)
            with torch.no_grad():
                for p in ref_conv.parameters():
                    p.copy_(p.to(bf))
        g = graph.to("cpu")
        ref, ref_grads = run(ref_conv, x_ref.double(), None,
                             (g.senders, g.receivers, mask.cpu()))
        f64_err = rel_err(out.cpu(), ref)
        f64_limit = WIDE_BF16_F64_LIMIT if rows_bf16 else WIDE_F64_LIMIT
        grad_f64 = {k: rel_err(grads[k].cpu(), r) for k, r in ref_grads.items()}
        if f64_err > f64_limit or (grad_f64 and max(grad_f64.values()) > BF16_GRAD_RTOL):
            worst = max(grad_f64, key=grad_f64.get) if grad_f64 else None
            fail(f"bf16_wide {name}: against float64 on the CPU: output {f64_err:.3g} of its "
                 f"largest entry (limit {f64_limit:.3g}), gradient of {worst} "
                 f"{grad_f64.get(worst)} (limit {BF16_GRAD_RTOL})")
        report.append(dict(
            case=name, forward=forward, gather=gather, bodies=want_bodies,
            launches={k: v for k, v in counts.items() if v}, working_set_in_device_memory=in_memory,
            plain_rel_err=plain_err, plain_grad_rel_err=grad_plain, f64_rel_err=f64_err,
            f64_limit=f64_limit, f64_grad_rel_err=max(grad_f64.values()) if grad_f64 else None,
            card_ms=ms))
        print(json.dumps({"bf16_wide_case": report[-1]}), flush=True)
        del conv, x, gout, out, out_p, grads, grads_p, ref, ref_grads

    # K8 on bf16 rows, on the eval graph's chunked layout (its runtime mask too)
    graph, mask, layout = graphs[False]
    chunked = compute_chunked_layout(graph, chunk_edges=CHUNK_EDGES)
    chunk_args = (chunked.senders, chunk_slot_valid(chunked, mask), chunked.chunk_start,
                  chunked.chunk_count)
    idx = [t.cpu() for t in (layout.tile_senders, edge_slot_valid(layout, mask),
                             layout.recv_ptr, layout.recv_slots)]
    nt, d, h = chunked.chunk_start.numel(), 128, 4
    for s, want_memory in CHUNKED_ROUTES:
        sp = -(-s // 16) * 16
        name = f"K8 S={s} D={d} H={h} eval bf16"
        kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
        qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=dev).to(bf)
        eaf.reset_launch_counts()
        t0 = time.perf_counter()
        out = eav.edge_attention_sums_chunked(qkv[:, :d], qkv[:, d:], *chunk_args, **kw,
                                              chunk=CHUNK_EDGES)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts, body = eaf.launch_counts(), eaf.body_launch_counts()[K8_]
        if counts != launches(k8=1) or body["simt_bf16"] != 1:
            fail(f"bf16_wide {name}: launched {counts} on the bodies {body}; expected one on "
                 f"simt_bf16")
        in_memory = bool(eaf.device_memory_launch_counts().get(K8_))
        if in_memory != want_memory:
            fail(f"bf16_wide {name}: working set in device memory {in_memory}, expected "
                 f"{want_memory}")
        key = (K8_, "simt_bf16", "bf16", s, d, h, False)
        ran[key] = ran.get(key, 0) + 1
        plain_err = rel_err(out, eav.edge_attention_sums_chunked_plain(
            qkv[:, :d], qkv[:, d:], *chunk_args, **kw, chunk=CHUNK_EDGES))
        f64_err = rel_err(out.cpu(), eaf.edge_attention_sums_plain(
            qkv[:, :d].cpu().double(), qkv[:, d:].cpu().double(), *idx, **kw))
        if not torch.isfinite(out).all() or plain_err > BF16_KERNEL_LIMIT or \
                f64_err > WIDE_F64_LIMIT:
            fail(f"bf16_wide {name}: {plain_err:.3g} from its plain version, {f64_err:.3g} "
                 f"from K1's float64 sums, of the largest entry")
        report.append(dict(case=name, forward=K8_, bodies={K8_: "simt_bf16"},
                           launches={K8_: 1},
                           working_set_in_device_memory=(K8_,) if in_memory else (),
                           plain_rel_err=plain_err, f64_rel_err=f64_err, card_ms=ms))
        del qkv, out

    # the named bodies that do not take the call still raise, and launch nothing
    lay = graphs[True][2]
    nt = lay.recv_ptr.numel() - 1
    r_idx = (lay.tile_senders, lay.tile_valid, lay.recv_ptr, lay.recv_slots)
    slots = (lay.tile_senders, lay.tile_recv, lay.tile_valid)
    q65 = torch.zeros(nt * 80, 3 * d, dtype=bf, device=dev)
    f40 = torch.zeros(nt * 40, 3 * d, device=dev)
    kw65, kw40 = dict(s=65, sp=80, num_heads=4, softmax=True), dict(s=40, sp=40, num_heads=4,
                                                                    softmax=True)
    refusals = {}
    eaf.reset_launch_counts()
    for what, call in (
            ("K1 'tc_bf16' named beyond the tensor cores (S=65)", lambda: eaf.edge_attention_sums(
                q65[:, :d], q65[:, d:], *r_idx, **kw65, body="tc_bf16")),
            ("K1 'simt' named for bf16 rows", lambda: eaf.edge_attention_sums(
                q65[:, :d], q65[:, d:], *r_idx, **kw65, body="simt")),
            ("K3 'simt_bf16' named on f32 rows", lambda: bwd.edge_attention_bwd_dq(
                f40[:, :d], f40[:, d:], f40[:, :d], *r_idx, **kw40, body="simt_bf16")),
            ("K5 'tc_bf16' named on f32 rows", lambda: sb.edge_attention_bwd_stream(
                f40[:, :d], f40[:, d:], f40[:, :d], *r_idx, **kw40, body="tc_bf16")),
            ("K9 'simt_bf16' named on f32 rows", lambda: eav.edge_attention_sums_v1(
                f40[:, :d], f40[:, d:], *slots, **kw40, tile_nodes=lay.tile_nodes, group=1,
                body="simt_bf16")),
            ("K1 'simt' named under mxu_bf16", lambda: eaf.edge_attention_sums(
                f40[:, :d], f40[:, d:], *r_idx, **kw40, body="simt", mxu_bf16=True))):
        try:
            call()
        except ValueError as e:
            refusals[what] = str(e)[:160]
        else:
            fail(f"bf16_wide refusals: {what} did not raise")
    torch.cuda.synchronize()
    if any(eaf.launch_counts().values()):
        fail(f"bf16_wide refusals: a refused call launched {eaf.launch_counts()}")
    return dict(graphs={("training" if t else "eval"): dict(
        nodes=g.num_nodes_padded, edges=int(g.edge_mask.sum()), live_edges=int(m.sum()))
        for t, (g, m, _) in graphs.items()}, cases=report, refusals=refusals,
        memory_at_start=memory_at_start, phase_s=time.perf_counter() - t_phase), ran


# path J: the recipe at S=64 (experiments/token_scale_tuning.py's default)
# as a bf16 model, 20 epochs with selection every 10; K1, K3 and K4 on the
# tensor cores (a block per node and head), by body
J_S, J_EPOCHS = 64, 20
J_BODIES = {"edge_attention_sums": "tc_bf16", "edge_attention_bwd_dq": "tc_bf16",
            "edge_attention_bwd_dkv": "tc_bf16"}


def path_j(recipe, data, graph, layout, seed, dev) -> tuple:
    """Path J: the recommended recipe at S=64 in compute_dtype='bfloat16'
    through train_full_batch (J_EPOCHS, selection every 10). The JAX route
    by the port's mirrored predicates: bf16 K|V of 2,752 x 64 x 256 x 2 B
    exceed the 80 MiB budget, so the 'dma' gather (v4 forward, then
    _dq_kernel_dma and _dkv_kernel_dma), in the port K1, K3 and K4, all
    three on 'tc_bf16' (a block per node and head). One step's gradients
    against float64 autograd on the CPU (BF16_GRAD_RTOL), 3 captured steps =
    eager bit for bit (no atomics in these bodies), an 8-draw eval against
    float64 (BF16_LOGITS_RTOL), exact launch counts by body, and one
    captured step of the bf16 model and of the f32 one (K1, K3 and K4 on
    'tc') in turns. Returns (report, {(kernel, body): launches} of
    train_full_batch and of the f32 step)."""
    from ampnet_tpu_torch.core.config import TrainConfig
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import launch as hl
    from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    t_phase = time.perf_counter()
    memory_at_start = release_graphs()
    cfg = dataclasses.replace(recipe, num_sampled_vectors=J_S, compute_dtype="bfloat16")
    f32 = dataclasses.replace(recipe, num_sampled_vectors=J_S)
    forward, gather = conv_forward(J_S, cfg.embedding_dim, torch.bfloat16,
                                   graph.num_nodes_padded, layout, None, True)
    if (forward, gather) != (K1_, "dma"):
        fail(f"path J: the predicates route its training forward to {forward} on '{gather}', "
             f"expected K1 on 'dma'")
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-3, epochs=J_EPOCHS, seed=seed,
                       cosine_t0=None, grad_clip=1.0, select_best_every=10,
                       num_eval_samples=8, epochs_per_dispatch=10, log_every=10)
    name = f"J S={J_S} recommended recipe, bf16, training"
    counts, report = drive_training(name, cfg, tcfg, data, graph, seed, dev, True,
                                    grad_rtol=BF16_GRAD_RTOL, allowed=("tc_bf16", "simt_bf16"))
    evals = J_EPOCHS // tcfg.select_best_every + 1
    want = launches(k1=2 * J_EPOCHS + 2 * 8 * evals, k3=2 * J_EPOCHS, k4=2 * J_EPOCHS)
    if counts != want:
        fail(f"path J launched {counts}, expected {want}")
    # every launch since the loop's counts were set to 0 (the loop's, then
    # its 10-step graph captured alone) on its kernel's body in J_BODIES
    bodies = bf16_only(name, tuple(J_BODIES), J_BODIES)
    report.update(route=dict(forward=forward, gather=gather), bodies=bodies,
                  memory_at_start=memory_at_start)
    report["captured_equals_eager"] = captured_equals_eager(
        "J", cfg, data, graph, layout, seed, dev, want_step=launches(k1=2, k3=2, k4=2),
        body=J_BODIES)
    _, _, report["eval"] = bf16_eval("J S=64", cfg, data, graph, layout, seed, dev,
                                     rtol=BF16_LOGITS_RTOL, body="tc_bf16")
    # one captured step of each in turns, from states of their own; the f32
    # model runs the f32 bodies of J_BODIES
    ran = {(k, b): counts[k] for k, b in J_BODIES.items()}
    report["memory_before_turns"] = release_graphs()
    steps = {}
    for key, c in (("f32", f32), ("bf16", cfg)):
        model = recipe_model(c, data, seed, dev)
        st = create_train_state(model, make_optimizer(model.parameters(), 3e-3,
                                                      weight_decay=1e-3, grad_clip=1.0),
                                seed=seed)
        step = make_train_step(model)
        eaf.reset_launch_counts()
        step(st, graph, layout)
        torch.cuda.synchronize()
        want_bodies = {k: hl.f32_body(b) if key == "f32" else b for k, b in J_BODIES.items()}
        got = {k: {b: n for b, n in eaf.body_launch_counts()[k].items() if n}
               for k in want_bodies}
        if got != {k: {b: 2} for k, b in want_bodies.items()} or \
                eaf.launch_counts() != launches(k1=2, k3=2, k4=2):
            fail(f"path J {key} step: launched {eaf.body_launch_counts()}, expected 2 K1 + "
                 f"2 K3 + 2 K4 on {want_bodies}")
        if key == "f32":
            ran.update({(k, b): 2 for k, b in want_bodies.items()})
        steps[key] = (lambda step=step, st=st: step(st, graph, layout))
    t = [sync_ms(steps[k], 5) for k in ("f32", "bf16", "bf16", "f32")]
    e = [cuda_ms(steps[k], 5) for k in ("f32", "bf16", "bf16", "f32")]
    report["in_turns_with_f32"] = dict(
        f32_warm_ms=(t[0] + t[3]) / 2, bf16_warm_ms=(t[1] + t[2]) / 2,
        f32_event_ms=(e[0] + e[3]) / 2, bf16_event_ms=(e[1] + e[2]) / 2,
        bf16_profile=busy_share(device_profile(steps["bf16"]), (t[1] + t[2]) / 2),
        f32_profile=busy_share(device_profile(steps["f32"]), (t[0] + t[3]) / 2))
    del steps
    report["phase_s"] = time.perf_counter() - t_phase
    return report, ran


# Each kernel's 'simt_bf16' body at one shape where bf16_wide launched it:
# (row key, kernel, rows ('bf16', or f32 rows under mxu_bf16), S, D, H,
# graph: 'eval' or 'training' (the bf16_wide graphs; 'stream' the training
# graph without a sender side), the TPU kernel it replaces). K1, K3 and K4
# run S=64 on the tensor cores (WIDE_TC_ROWS, timed there in turns with
# these bodies at S=64); their rows here are beyond it.
SIMT_BF16_ROWS = (
    ("k1_simt_bf16", K1_, "bf16", 96, 128, 4, "eval", "edge_attention_fused.py:942"),
    ("k2_simt_bf16", K2_, "bf16", 20, 128, 8, "eval", "edge_attention_fused.py:763"),
    ("k3_simt_bf16", K3_, "bf16", 65, 128, 4, "training",
     "edge_attention_bwd_scatterfree.py:211"),
    ("k4_simt_bf16", K4_, "bf16", 65, 128, 4, "training",
     "edge_attention_bwd_scatterfree.py:319"),
    ("k5_simt_bf16", K5_, "bf16", 49, 128, 4, "stream", "edge_attention_bwd.py:178"),
    ("k6_simt_bf16", K6_, "bf16", 96, 128, 4, "eval", "edge_attention_fused.py:1126"),
    ("k7_simt_bf16", K7_, "bf16", 20, 128, 8, "eval", "edge_attention_fused.py:865"),
    ("k8_simt_bf16", K8_, "bf16", 96, 128, 4, "eval", "edge_attention_fused.py:1225"),
    ("k9_simt_bf16", K9_, "bf16", 96, 128, 4, "eval", "edge_attention_fused.py:186"),
    ("k1_simt_mxu", K1_, "mxu", 40, 128, 8, "training", "edge_attention_fused.py:691"),
    ("k2_simt_mxu", K2_, "mxu", 20, 128, 8, "eval", "edge_attention_fused.py:763"),
    ("k6_simt_mxu", K6_, "mxu", 40, 128, 8, "training", "edge_attention_fused.py:731"),
    ("k7_simt_mxu", K7_, "mxu", 20, 128, 8, "eval", "edge_attention_fused.py:865"))


def simt_bf16_rows(data, gen, dev, wide_ran) -> list:
    """The kernel rows of SIMT_BF16_ROWS: each 'simt_bf16' body on random
    rows at its shape and graph (runtime mask included) against its plain
    version on the card within BF16_KERNEL_LIMIT of the largest entry (K2
    and K7's bf16 outputs BF16_OUTPUT_LIMIT), launched twice and equal bit
    for bit where it uses no atomics (K1-K5, K8), timed in turns with the
    f32 CUDA-core body ('simt', f32 rows at the f32 row stride), its bound
    at bf16 widths and the bf16 rate, registers and spills (ptxas) of the
    instantiation it launched, whether its working set was in device
    memory; ``launches`` where bf16_wide launched it at that shape."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
    from ampnet_tpu_torch.ops.hopper.format import (chunk_slot_valid, compute_chunked_layout,
                                                    edge_slot_valid, snd_slot_valid)
    from ampnet_tpu_torch.ops.segment import segment_count

    bf = torch.bfloat16
    release_graphs()
    graphs, no_sender_side = route_graphs(data, dev)
    setting = {"eval": graphs[False], "training": graphs[True],
               "stream": (*graphs[True][:2], no_sender_side)}
    out = []
    for key, kernel, rows_mode, s, d, h, where, replaces in SIMT_BF16_ROWS:
        g, m, lay = setting[where]
        n, nt = g.num_nodes_padded, lay.recv_ptr.numel() - 1
        tn = lay.tile_nodes
        rows_bf16 = rows_mode == "bf16"
        sp = -(-s // 16) * 16 if rows_bf16 else -(-s // 8) * 8
        sp32 = -(-s // 8) * 8
        mxu = dict() if rows_bf16 else dict(mxu_bf16=True)
        valid = edge_slot_valid(lay, m)
        idx = (lay.tile_senders, valid, lay.recv_ptr, lay.recv_slots)
        slots = (lay.tile_senders, lay.tile_recv, valid)
        live = int(valid.sum())
        index_bytes = 4 * (2 * lay.tile_senders.numel() + lay.recv_ptr.numel()
                           + lay.recv_slots.numel())
        slot_bytes = 4 * 3 * lay.tile_senders.numel()
        width = 2 if rows_bf16 else 4

        def rand(rows, cols, stride):
            t = torch.randn(nt * stride, cols, generator=gen, device=dev)
            return t.to(bf) if rows_bf16 else t

        q, q32 = rand(nt, 3 * d, sp), torch.randn(nt * sp32, 3 * d, generator=gen, device=dev)
        kw, kw32 = dict(s=s, sp=sp, num_heads=h, softmax=True), dict(s=s, sp=sp32, num_heads=h,
                                                                     softmax=True)
        repeats, limit, extra = True, BF16_KERNEL_LIMIT, {}
        if kernel == K1_:
            run = lambda: eaf.edge_attention_sums(q[:, :d], q[:, d:], *idx, **kw, **mxu)  # noqa
            plain = lambda: eaf.edge_attention_sums_plain(q[:, :d], q[:, d:], *idx, **kw,  # noqa
                                                          **mxu)
            f32 = lambda: eaf.edge_attention_sums(q32[:, :d], q32[:, d:], *idx, **kw32,  # noqa
                                                  body="simt")
            nbytes, flops = 3 * d * n * s * width + d * n * s * 4 + index_bytes, \
                4 * s * s * d * live
            lib, fn, targs = "edge_attention", "edge_attention_kernel", "Lb0ELb{}E{}Lb1EE"
        elif kernel in (K3_, K4_, K5_):
            dsum = torch.randn(nt, sp, d, generator=gen, device=dev)
            dsum[:, s:] = 0.0
            dsum = dsum.reshape(nt * sp, d).to(bf)
            dsum32 = torch.randn(nt * sp32, d, generator=gen, device=dev)
            if kernel == K3_:
                run = lambda: bwd.edge_attention_bwd_dq(q[:, :d], q[:, d:], dsum, *idx,  # noqa
                                                        **kw)
                plain = lambda: bwd.edge_attention_bwd_dq_plain(  # noqa: E731
                    q[:, :d], q[:, d:], dsum, *idx, **kw)
                f32 = lambda: bwd.edge_attention_bwd_dq(  # noqa: E731
                    q32[:, :d], q32[:, d:], dsum32, *idx, **kw32, body="simt")
                nbytes, flops = 4 * d * n * s * 2 + d * n * s * 4 + index_bytes, \
                    6 * s * s * d * live
            elif kernel == K4_:
                s_idx = (lay.snd_receivers, snd_slot_valid(lay, m), lay.snd_ptr, lay.snd_slots)
                qdm, qdm32 = torch.cat([q[:, :d], dsum], 1), torch.cat([q32[:, :d], dsum32], 1)
                run = lambda: bwd.edge_attention_bwd_dkv(qdm, q[:, d:], *s_idx, **kw)  # noqa
                plain = lambda: bwd.edge_attention_bwd_dkv_plain(  # noqa: E731
                    qdm, q[:, d:], *s_idx, **kw)
                f32 = lambda: bwd.edge_attention_bwd_dkv(  # noqa: E731
                    qdm32, q32[:, d:], *s_idx, **kw32, body="simt")
                nbytes = 4 * d * n * s * 2 + 2 * d * n * s * 4 + 4 * (
                    2 * lay.snd_receivers.numel() + lay.snd_ptr.numel() + lay.snd_slots.numel())
                flops = 8 * s * s * d * live
            else:
                walked = lay.recv_slots.long()

                def run():
                    dq, stream = sb.edge_attention_bwd_stream(q[:, :d], q[:, d:], dsum, *idx,
                                                              **kw)
                    per_slot = stream.view(-1, sp, 2 * d)[walked]
                    return dq, per_slot[..., :d], per_slot[..., d:]

                def plain():
                    dq, stream = sb.edge_attention_bwd_stream_plain(q[:, :d], q[:, d:], dsum,
                                                                    *idx, **kw)
                    per_slot = stream.view(-1, sp, 2 * d)[walked]
                    return dq, per_slot[..., :d], per_slot[..., d:]

                f32 = lambda: sb.edge_attention_bwd_stream(  # noqa: E731
                    q32[:, :d], q32[:, d:], dsum32, *idx, **kw32, body="simt")
                nbytes = 4 * d * n * s * 2 + d * n * s * 4 + walked.numel() * s * 2 * d * 4 \
                    + index_bytes
                flops = 10 * s * s * d * live
            lib, fn = "edge_attention_bwd", "edge_attention_bwd_kernel"
            targs = "Li" + str((K3_, K4_, K5_).index(kernel)) + "ELb{}E13__nv_bfloat16EE"
        elif kernel in (K6_, K9_):
            mm, mm32 = dict(kw, tile_nodes=tn), dict(kw32, tile_nodes=tn)
            tiles, emax = lay.tile_senders.shape
            if kernel == K6_:
                run = lambda: eav.edge_attention_sums_mm(  # noqa: E731
                    q[:, :d], q[:, d:], *slots, lay.tile_counts, **mm, **mxu)
                plain = lambda: eav.edge_attention_sums_mm_plain(  # noqa: E731
                    q[:, :d], q[:, d:], *slots, lay.tile_counts, **mm, **mxu,
                    group=eav._mm_group("simt_bf16", s, d, h, None))
                f32 = lambda: eav.edge_attention_sums_mm(  # noqa: E731
                    q32[:, :d], q32[:, d:], *slots, lay.tile_counts, **mm32, body="simt")
                nbytes = 3 * d * n * s * width + d * n * s * 4 + slot_bytes + 4 * tiles
                extra["group"] = eav._mm_group("simt_bf16", s, d, h, None)
            else:
                group = 8 if emax % 8 == 0 else 1
                run = lambda: eav.edge_attention_sums_v1(  # noqa: E731
                    q[:, :d], q[:, d:], *slots, **mm, group=group)
                plain = lambda: eav.edge_attention_sums_v1_plain(  # noqa: E731
                    q[:, :d], q[:, d:], *slots, **mm, group=group)
                f32 = lambda: eav.edge_attention_sums_v1(  # noqa: E731
                    q32[:, :d], q32[:, d:], *slots, **mm32, group=group, body="simt")
                nbytes = 3 * d * n * s * width + d * n * s * 4 + slot_bytes
            flops, repeats = 4 * s * s * d * live, False
            lib, fn = "edge_attention_groups", "edge_group_kernel"
            targs = ("Lb1E" if kernel == K6_ else "Lb0E") + "Lb{}E{}Lb1EE"
        elif kernel == K8_:
            chunked = compute_chunked_layout(g, chunk_edges=CHUNK_EDGES)
            chunks = (chunked.senders, chunk_slot_valid(chunked, m), chunked.chunk_start,
                      chunked.chunk_count)
            ck, ck32 = dict(kw, chunk=CHUNK_EDGES), dict(kw32, chunk=CHUNK_EDGES)
            run = lambda: eav.edge_attention_sums_chunked(q[:, :d], q[:, d:], *chunks,  # noqa
                                                          **ck)
            plain = lambda: eav.edge_attention_sums_chunked_plain(  # noqa: E731
                q[:, :d], q[:, d:], *chunks, **ck)
            f32 = lambda: eav.edge_attention_sums_chunked(  # noqa: E731
                q32[:, :d], q32[:, d:], *chunks, **ck32, body="simt")
            nbytes = 3 * d * n * s * 2 + d * n * s * 4 + 4 * (
                2 * chunked.senders.numel() + 2 * chunked.chunk_start.numel())
            flops = 4 * s * s * d * live
            lib, fn, targs = "edge_attention_chunked", "edge_chunk_kernel", "Lb{}E13__nv_bfloat16EE"
        else:                           # K2, K7: the whole layer over x rows
            conv_w = [torch.randn(*shape, generator=gen, device=dev) * sc for shape, sc in (
                ((d, 3 * d), d ** -0.5), ((3 * d,), 0.1), ((d, d), d ** -0.5), ((d,), 0.1))]
            w = [t.to(bf).contiguous() for t in conv_w] if rows_bf16 else conv_w
            count = segment_count(g.receivers, n, m)
            invdeg = torch.nn.functional.pad(torch.where(
                count > 0, 1.0 / count.clamp_min(1.0), torch.zeros_like(count)), (0, nt - n))
            x = q[:, :d].contiguous()
            x32 = q32[:, :d].contiguous()
            live_recv = int((count > 0).sum())
            flops = 2 * n * s * d * 3 * d + 4 * s * s * d * live + 2 * s * d * d * live_recv
            nbytes = width * (2 * n * s * d + 4 * d * d + 4 * d) + 4 * nt
            if kernel == K2_:
                run = lambda: eaf.edge_attention_layer(x, *w, invdeg, *idx, **kw, **mxu)  # noqa
                plain = lambda: eaf.edge_attention_layer_plain(  # noqa: E731
                    x, *w, invdeg, *idx, **kw, **mxu)
                f32 = lambda: eaf.edge_attention_layer(  # noqa: E731
                    x32, *conv_w, invdeg, *idx, **kw32, body="simt")
                nbytes += index_bytes
                lib, fn, targs = "edge_attention", "edge_attention_kernel", "Lb1ELb{}E{}Lb1EE"
            else:
                mm, mm32 = dict(kw, tile_nodes=tn), dict(kw32, tile_nodes=tn)
                run = lambda: eav.edge_attention_layer_mm(  # noqa: E731
                    x, *w, invdeg, *slots, lay.tile_counts, **mm, **mxu)
                plain = lambda: eav.edge_attention_layer_mm_plain(  # noqa: E731
                    x, *w, invdeg, *slots, lay.tile_counts, **mm, **mxu,
                    group=eav._mm_group("simt_bf16", s, d, h, None))
                f32 = lambda: eav.edge_attention_layer_mm(  # noqa: E731
                    x32, *conv_w, invdeg, *slots, lay.tile_counts, **mm32, body="simt")
                nbytes += slot_bytes + 4 * lay.tile_senders.shape[0]
                repeats = False
                lib, fn, targs = "edge_attention_groups", "edge_group_kernel", "Lb1ELb{}E{}Lb1EE"
            limit = BF16_OUTPUT_LIMIT if rows_bf16 else BF16_KERNEL_LIMIT
            if rows_bf16:
                extra["projection_spills"] = ptxas_of(
                    "qkv_projection", "projection_kernelI" + (
                        "Lb0E" if kernel == K2_ else "Lb1E") + "13__nv_bfloat16EE")["spills"]

        def parts(o):
            return o if isinstance(o, tuple) else (o,)

        eaf.reset_launch_counts()
        got = parts(run())
        again = parts(run()) if repeats else None
        torch.cuda.synchronize()
        bodies = eaf.body_launch_counts()[kernel]
        in_memory = bool(eaf.device_memory_launch_counts())
        if bodies != dict(tc=0, simt=0, tc_bf16=0, simt_bf16=1 + repeats):
            fail(f"{key}: ran the bodies {bodies}, expected simt_bf16 alone")
        ref = parts(plain())
        errs = [float((a.double() - b.double()).abs().max()) for a, b in zip(got, ref)]
        rel = [e / max(float(b.double().abs().max()), 1e-30) for e, b in zip(errs, ref)]
        if not max(rel) <= limit or not all(torch.isfinite(a).all() for a in got):
            fail(f"{key} S={s}: the simt_bf16 body disagrees with its plain version "
                 f"({max(rel):.3g} of the largest entry, limit {limit:.3g})")
        if repeats and not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{key} S={s}: a second launch differs from the first")
        del got, again, ref
        ms, f32_ms = in_turns(f32, run)
        b, by = bf16_bound_ms(nbytes, flops)
        ptx = ptxas_of(lib, fn + "I" + targs.format(
            int(in_memory), "13__nv_bfloat16" if rows_bf16 else "f"))
        launched = wide_ran.get((kernel, "simt_bf16", rows_mode, s, d, h, where != "eval"), 0)
        out.append(dict(
            name=kernel, route="cuda", source=f"ampnet_tpu_torch/ops/hopper/csrc/{lib}.cu",
            replaces=f"ampnet_tpu/ops/pallas/{replaces}", launches=launched, s=s, d=d, h=h,
            body="simt_bf16", max_abs_err=max(errs), rel_err=max(rel), limit=limit, ms=ms,
            f32_simt_ms=f32_ms, speedup_vs_f32_simt=f32_ms / ms, plain_ms=cuda_ms(plain, 3),
            bound_ms=b, bound_by=by, library_ms=None, regs=ptx["regs"], spills=ptx["spills"],
            device_memory=in_memory, graph=where,
            precision=("bf16 on the CUDA cores" if rows_bf16 else
                       "bf16 products of f32 rows (mxu_bf16) on the CUDA cores"), **extra))
        if launched < 1:
            fail(f"{key}: no launch of the body at S={s} D={d} H={h} on a path")
    return out


# K1's, K3's and K4's tensor-core bodies at path J's S=64, D=128, H=4 (one
# block per node and head): (kernel, body, library, its launch-info entry
# point, the kernel's name in ptxas, the TPU kernel it replaces)
WIDE_TC_ROWS = (
    (K1_, "tc_bf16", "edge_attention_tc_bf16", "ampnet_edge_attention_sums_bf16_info",
     "sums_bf16_kernelILi8ELb0E13__nv_bfloat16", "edge_attention_fused.py:942"),
    (K3_, "tc_bf16", "edge_attention_bwd_dq_tc_bf16", "ampnet_edge_attention_bwd_dq_bf16_info",
     "dq_bf16_wide_kernelILi8E", "edge_attention_bwd_scatterfree.py:211"),
    (K4_, "tc_bf16", "edge_attention_bwd_tc_bf16", "ampnet_edge_attention_bwd_dkv_bf16_info",
     "dkv_bf16_kernelILi8E", "edge_attention_bwd_scatterfree.py:319"),
    (K1_, "tc", "edge_attention_tc", "ampnet_edge_attention_sums_info",
     "sums_tc_kernelILi8E", "edge_attention_fused.py:942"),
    (K3_, "tc", "edge_attention_bwd_dq_tc", "ampnet_edge_attention_bwd_dq_info",
     "dq_tc_wide_kernelILi8E", "edge_attention_bwd_scatterfree.py:211"),
    (K4_, "tc", "edge_attention_bwd_tc", "ampnet_edge_attention_bwd_dkv_info",
     "dkv_tc_kernelILi8E", "edge_attention_bwd_scatterfree.py:319"),
)


def wide_tc_rows(graph, layout, gen, dev, j_launches) -> list:
    """The rows of WIDE_TC_ROWS on path J's graph and layout (every 50th
    live edge masked at run time) at the row strides its models use (bf16
    rows 16, f32 rows 8): each body on random rows against its plain
    version on the card ('tc': KERNEL_RTOL / KERNEL_ATOL; 'tc_bf16':
    BF16_KERNEL_LIMIT of the largest entry), launched twice and equal bit
    for bit, every launch on the body; timed in turns with the CUDA-core
    body of the same rows ('simt_bf16', 'simt': ``prev_ms``); its bound (the
    rows' bytes once, the products at the bf16 rate, or at the TF32 rate
    three times over for 3xTF32), registers and spills (ptxas), blocks per
    SM, ring stages; ``launches`` from path J (bf16: train_full_batch; f32:
    its f32 step)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import edge_slot_valid, snd_slot_valid
    from ampnet_tpu_torch.ops.hopper.launch import kernel_info

    release_graphs()
    s, d, h = J_S, 128, 4
    mask = graph.edge_mask.clone()
    mask[torch.nonzero(mask)[::50, 0]] = False
    n, nt = graph.num_nodes_padded, layout.recv_ptr.numel() - 1
    r_idx = (layout.tile_senders, edge_slot_valid(layout, mask), layout.recv_ptr,
             layout.recv_slots)
    s_idx = (layout.snd_receivers, snd_slot_valid(layout, mask), layout.snd_ptr,
             layout.snd_slots)
    live = int(r_idx[1].sum())
    r_bytes = 4 * (2 * layout.tile_senders.numel() + layout.recv_ptr.numel()
                   + layout.recv_slots.numel())
    s_bytes = 4 * (2 * layout.snd_receivers.numel() + layout.snd_ptr.numel()
                   + layout.snd_slots.numel())
    out = []
    for kernel, body, lib, info_fn, ptx_name, replaces in WIDE_TC_ROWS:
        bf16 = body == "tc_bf16"
        width, sp = (2, -(-s // 16) * 16) if bf16 else (4, -(-s // 8) * 8)
        q = torch.randn(nt * sp, 3 * d, generator=gen, device=dev)
        dsum = torch.randn(nt, sp, d, generator=gen, device=dev)
        dsum[:, s:] = 0.0
        dsum = dsum.reshape(nt * sp, d)
        if bf16:
            q, dsum = q.to(torch.bfloat16), dsum.to(torch.bfloat16)
        kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
        if kernel == K1_:
            def run(b=None):
                return eaf.edge_attention_sums(q[:, :d], q[:, d:], *r_idx, **kw, body=b)

            def plain():
                return eaf.edge_attention_sums_plain(q[:, :d], q[:, d:], *r_idx, **kw)

            nbytes, flops = 3 * d * n * s * width + d * n * s * 4 + r_bytes, 4 * s * s * d * live
        elif kernel == K3_:
            def run(b=None):
                return bwd.edge_attention_bwd_dq(q[:, :d], q[:, d:], dsum, *r_idx, **kw, body=b)

            def plain():
                return bwd.edge_attention_bwd_dq_plain(q[:, :d], q[:, d:], dsum, *r_idx, **kw)

            nbytes, flops = 4 * d * n * s * width + d * n * s * 4 + r_bytes, 6 * s * s * d * live
        else:
            qdm = torch.cat([q[:, :d], dsum], 1)

            def run(b=None):
                return bwd.edge_attention_bwd_dkv(qdm, q[:, d:], *s_idx, **kw, body=b)

            def plain():
                return bwd.edge_attention_bwd_dkv_plain(qdm, q[:, d:], *s_idx, **kw)

            nbytes = 4 * d * n * s * width + 2 * d * n * s * 4 + s_bytes
            flops = 8 * s * s * d * live
        eaf.reset_launch_counts()
        got, again = run(), run()
        torch.cuda.synchronize()
        if eaf.body_launch_counts()[kernel] != {**dict.fromkeys(("tc", "simt", "tc_bf16",
                                                                 "simt_bf16"), 0), body: 2}:
            fail(f"{kernel} S={s} {body}: ran the bodies {eaf.body_launch_counts()[kernel]}")
        ref = plain()
        if bf16:
            err, limit = float((got - ref).abs().max()), BF16_KERNEL_LIMIT
            rel = err / max(float(ref.abs().max()), 1e-30)
            if not rel <= limit or not torch.isfinite(got).all():
                fail(f"{kernel} S={s} {body}: {rel:.3g} of the largest entry from its plain "
                     f"version (limit {limit:.3g})")
        else:
            err = compare(f"{kernel} S={s} {body}", got, ref)
            rel, limit = err / max(float(ref.abs().max()), 1e-30), None
        if not torch.equal(got, again):
            fail(f"{kernel} S={s} {body}: a second launch differs from the first")
        del got, again, ref
        ms, simt_ms = in_turns(lambda: run("simt_bf16" if bf16 else "simt"), run)
        b, by = bf16_bound_ms(nbytes, flops) if bf16 else bound_ms(nbytes, flops, True)
        info = kernel_info(lib, info_fn, nt, s, d, h)
        launched = j_launches.get((kernel, body), 0)
        if launched < 1:
            fail(f"{kernel} {body}: path J did not launch it at S={s}")
        out.append(dict(
            name=kernel, route="cuda", source=f"ampnet_tpu_torch/ops/hopper/csrc/{lib}.cu",
            replaces=f"ampnet_tpu/ops/pallas/{replaces}", launches=launched, s=s, d=d, h=h,
            body=body, max_abs_err=err, rel_err=rel, limit=limit, ms=ms, prev_ms=simt_ms,
            speedup=simt_ms / ms, plain_ms=cuda_ms(plain, 3), bound_ms=b, bound_by=by,
            library_ms=None, regs=info["regs"], spills=ptxas_of(lib, ptx_name)["spills"],
            blocks_per_sm=info["blocks_per_sm"], stages=info["stages"],
            smem_bytes=info["smem_bytes"], graph="J",
            precision="bf16 products on the tensor cores" if bf16 else "3xtf32"))
        del q, dsum
    return out


def card_gradients(model, graph, layout, sidx):
    """One training forward + backward with dropout rates 0 and the given
    draw, on the card: (loss, {parameter: gradient})."""
    from ampnet_tpu_torch.train.state import training_loss

    cfg = model.config
    model.config = dataclasses.replace(cfg, dropout_rate=0.0, dropout_adj_rate=0.0)
    try:
        model.zero_grad(set_to_none=True)
        loss = training_loss("full", model(graph, deterministic=False, sampled_idx=sidx,
                                           edge_layout=layout), graph)
        loss.backward()
    finally:
        model.config = cfg
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def captured_equals_eager(name, cfg, data, graph, layout, seed, dev, steps=3,
                          want_step=None, body="tc_bf16") -> dict:
    """``steps`` captured training steps against as many eager bodies from
    one initial state: every metric, parameter and Adam tensor bit for
    bit; each captured step's launches exact (``want_step``), on the bf16
    ``body``."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    def state():
        model = recipe_model(cfg, data, seed, dev)
        return create_train_state(model, make_optimizer(
            model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=seed)

    one, eager = state(), state()
    step, eager_body = make_train_step(one.model), _train_step_body(eager.model)
    losses = []
    for _ in range(steps):
        eaf.reset_launch_counts()
        got = step(one, graph, layout)[1]
        torch.cuda.synchronize()
        counts = eaf.launch_counts()
        if want_step is not None and counts != want_step:
            fail(f"{name}: a captured step launched {counts}, expected {want_step}")
        bodies = bf16_only(name, body=body)
        want = eager_body(eager, graph, layout)[1]
        for k in want:
            if not torch.equal(got[k], want[k]):
                fail(f"{name}: captured {k} differs from the eager body's")
        losses.append(float(got["loss"]))
    tensors = 0
    for (k, p), q in zip(one.model.named_parameters(), eager.model.parameters()):
        if p.dtype != torch.float32 or not torch.equal(p, q):
            fail(f"{name}: parameter {k} ({p.dtype}) differs from the eager body's")
        tensors += 1
    for p, q in zip(one.optimizer.params, eager.optimizer.params):
        for k, t in one.optimizer.adam.state[p].items():
            if not torch.equal(t, eager.optimizer.adam.state[q][k]):
                fail(f"{name}: Adam's {k} differs from the eager body's")
            tensors += 1
    return dict(steps=steps, bit_for_bit=True, tensors=tensors, losses=losses,
                per_step_bodies=bodies)


def bf16_serving(cfg, cfg20, data, seed, dev) -> dict:
    """A Predictor on a bf16 model trained 3 steps (save_params, load_params):
    the whole surrogate and two induced subgraphs, each on the JAX
    predicate's route for bf16 rows (K1 at the 3,072-node bucket, K2 at 512
    and 1,024), every launch on tc_bf16, answers = the eager forward bit
    for bit, the 900-node request also against the CPU float64 forward
    (BF16_LOGITS_RTOL), one capture per bucket; a hot swap to a checkpoint
    3 steps later changes the answers without a capture; a bf16 S=20 model
    on the whole surrogate runs K2 (the bucket where f32 runs K1: v6 fits
    bf16 rows)."""
    import numpy as np
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.serving import Predictor
    from ampnet_tpu_torch.train import (create_train_state, load_params, make_optimizer,
                                        make_train_step, save_checkpoint, save_params)

    path = SERVING_DIR / "bf16"
    shutil.rmtree(path, ignore_errors=True)
    trained = recipe_model(cfg, data, seed, dev)
    state = create_train_state(trained, make_optimizer(
        trained.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=seed)
    graph = cora(seed, dev)[1]
    train_step, layout = make_train_step(trained), compute_layout(graph)
    for _ in range(3):
        train_step(state, graph, layout)
    params_path = save_params(str(path / "params_step3.pt"), trained)
    for _ in range(3):
        train_step(state, graph, layout)
    swap_path = save_checkpoint(str(path / "checkpoint_step6.pkl"), state, epoch=5)
    del train_step, state, graph, layout

    pred = Predictor(load_params(params_path, recipe_model(cfg, data, seed + 1, dev)), seed=seed)
    rng = np.random.default_rng(seed + 12)
    requests = [("whole surrogate", data.x, data.edge_index)] + [
        (f"induced {k} nodes", *induced_subgraph(data, k, rng)[:2]) for k in (400, 900)]
    served = []
    for name, x, ei in requests:
        route = serving_route(pred, x, ei)
        served.append(dict(serve(pred, f"bf16 {name}", x, ei, dev, route["want"],
                                 check_f64=name == "induced 900 nodes",
                                 f64_rtol=BF16_LOGITS_RTOL),
                           gather=route["gather"], v6_usable=route["v6_usable"]))
    if [r["v6_usable"] for r in served] != [False, True, True]:
        fail(f"bf16 serving: routes {[r['v6_usable'] for r in served]}, expected K1 at the "
             f"whole surrogate's bucket and K2 at the subgraphs'")
    if any(set(b) != {"tc_bf16"} for r in served for b in r["bodies"].values()):
        fail(f"bf16 serving: launches off the bf16 body ({[r['bodies'] for r in served]})")
    buckets = sorted({tuple(r["bucket"]) for r in served})
    captures = pred.step.graphs.timings()
    if len(captures) != len(buckets) or sum(bool(r["capture"]) for r in served) != len(buckets):
        fail(f"bf16 serving: {len(captures)} captures for buckets {buckets}")
    gen_state = pred.generator.get_state()
    before = pred.predict(data.x, data.edge_index)
    pred.load_params(swap_path)
    pred.generator.set_state(gen_state)
    after = serve(pred, "bf16 whole surrogate after the hot swap", data.x, data.edge_index,
                  dev, serving_route(pred, data.x, data.edge_index)["want"])
    pred.generator.set_state(gen_state)
    if np.array_equal(before, pred.predict(data.x, data.edge_index)):
        fail("bf16 serving: the hot swap left the answers as they were")
    if len(pred.step.graphs.timings()) != len(captures):
        fail("bf16 serving: the hot swap captured again")
    pred20 = Predictor(recipe_model(cfg20, data, seed, dev), seed=seed)
    route = serving_route(pred20, data.x, data.edge_index)
    if not route["v6_usable"]:
        fail("bf16 serving: the S=20 bf16 model's whole-surrogate bucket is not on K2")
    s20 = serve(pred20, "bf16 S=20 whole surrogate", data.x, data.edge_index, dev,
                route["want"])
    if s20["bodies"] != {"edge_attention_layer": {"tc_bf16": 2}}:
        fail(f"bf16 serving: the S=20 request ran {s20['bodies']}, expected K2 twice on tc_bf16")
    # K2's bf16 launches of the requests, by S (the kernel rows' launches)
    k2_s40 = sum(r["bodies"].get("edge_attention_layer", {}).get("tc_bf16", 0) for r in served)
    return dict(requests=served, buckets=[list(b) for b in buckets], captures=len(captures),
                hot_swap=dict(new_captures=0, request=after), s20_whole_surrogate=s20,
                k2_launches={"40": k2_s40, "20": s20["bodies"]["edge_attention_layer"]["tc_bf16"]})


def forward_route(cfg, graph, layout) -> str:
    """The forward kernel an eval of ``cfg``'s model takes on ``graph`` by
    the port's copy of the JAX package's predicates (edge_attention_fused),
    for the dispatch constants as they stand: K2 / K7 where the whole layer
    fits (v6), K9 on the 'dma' gather under DMA_V1_DEFAULT, else K1 / K6."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    n, d, tn = graph.num_nodes_padded, cfg.embedding_dim, layout.tile_nodes
    nt = layout.tile_senders.shape[0] * tn
    align = eaf._stream_align(dtype, eaf.STREAM_BF16_DEFAULT)
    sp = -(-cfg.num_sampled_vectors // align) * align
    gather = eaf._resolve_gather("auto", max(n, nt) * sp, d,
                                 2 if eaf.STREAM_BF16_DEFAULT else dtype.itemsize,
                                 tile_rows=tn * sp)
    if eaf._v6_usable(n, nt, sp, d, dtype.itemsize, tn, eaf._auto_group(sp), gather):
        return "edge_attention_layer_mm" if eaf.MM_SCATTER_DEFAULT else "edge_attention_layer"
    if gather != "vmem" and eaf.DMA_V1_DEFAULT:
        return "edge_attention_sums_v1"
    return "edge_attention_sums_mm" if eaf.MM_SCATTER_DEFAULT else "edge_attention_sums"


# The forward kernel of each eval of bf16_routes (and path J) as the JAX
# package's predicates give it on the whole surrogate (2,752 nodes, D=128,
# H=4): S=40 and S=64 bf16 rows take the 'dma' gather and no whole-layer
# body, S=20 rows (bf16, or f32 under mxu_bf16) the 'vmem' gather and the
# whole layer (tests/test_torch_bf16.py::test_route_is_the_jax_predicates
# holds both packages' predicates to these on the CPU).
BF16_EVAL_ROUTES = {"G S=40": "edge_attention_sums_mm", "G S=20": "edge_attention_layer_mm",
                    "I S=40": "edge_attention_sums_v1",
                    "G S=20 mxu_bf16": "edge_attention_layer_mm",
                    "J S=64": "edge_attention_sums"}


def bf16_eval(name, cfg, data, graph, layout, seed, dev, rtol=None, atol=None,
              body="tc_bf16") -> tuple:
    """One 8-draw captured eval (counts set to 0 just before it, read just
    after): 16 launches of the kernel the port's predicates give
    (``forward_route``), which must be the JAX predicates' kernel
    (``BF16_EVAL_ROUTES[name]``), all on the bf16 ``body``; one fixed draw against the CPU
    float64 forward within ``rtol`` of the reference's largest entry (a
    bf16 model), or within ``atol`` (f32 rows under mxu_bf16). Returns
    (kernel, launches on ``body``, report)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import sample_present_features, tfidf_sample_features
    from ampnet_tpu_torch.train import make_eval_step

    kernel = forward_route(cfg, graph, layout)
    if kernel != BF16_EVAL_ROUTES[name]:
        fail(f"{name}: the port's predicates route the eval to {kernel}, the JAX package's "
             f"to {BF16_EVAL_ROUTES[name]}")
    model = recipe_model(cfg, data, seed, dev)
    step = make_eval_step(model, num_eval_samples=8)
    eaf.reset_launch_counts()
    metrics = step(graph, torch.Generator(device=dev).manual_seed(seed), layout)
    torch.cuda.synchronize()
    counts = eaf.launch_counts()
    bodies = bf16_only(name, (kernel,), body)
    if counts != {**launches(), kernel: 16} or bodies[kernel] != 16:
        fail(f"{name}: launched {counts} ({bodies} on {body}), expected 16 {kernel}")
    draw = torch.Generator(device=dev).manual_seed(seed + 2)
    sidx = (tfidf_sample_features(graph.x, cfg.num_sampled_vectors, node_mask=graph.node_mask,
                                  generator=draw)
            if cfg.token_sampling == "tfidf" else
            sample_present_features(graph.x, cfg.num_sampled_vectors, generator=draw))
    card, _ = stage_outputs(model, graph, sidx, layout)
    ref, _ = cpu_f64_reference(model, graph, sidx)
    if not torch.isfinite(card).all():
        fail(f"{name}: non-finite log-probs")
    err = float((card.double() - ref).abs().max())
    rel = err / float(ref.abs().max())
    if not (rel <= rtol if atol is None else err <= atol):
        fail(f"{name}: log-probs {err:.3g} from float64 on the CPU ({rel:.3g} of the "
             f"largest entry; limit rtol {rtol}, atol {atol})")
    return kernel, bodies[kernel], dict(
        kernel=kernel, launches={k: v for k, v in counts.items() if v}, bodies=bodies,
        cpu_f64_max_abs_err=err, cpu_f64_rel_err=rel, rtol=rtol, atol=atol,
        metrics={k: float(v) for k, v in metrics.items()})


def bf16_steps(name, cfg, data, graph, layout, seed, dev, want, kernels, steps=3) -> dict:
    """``steps`` captured training steps of ``cfg``'s model, each one's
    launches exact (``want``) with ``kernels`` on tc_bf16 alone; finite
    losses."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    model = recipe_model(cfg, data, seed, dev)
    state = create_train_state(model, make_optimizer(
        model.parameters(), 3e-3, weight_decay=1e-3, grad_clip=1.0), seed=seed)
    step = make_train_step(model)
    losses, bodies = [], {}
    for _ in range(steps):
        eaf.reset_launch_counts()
        metrics = step(state, graph, layout)[1]
        torch.cuda.synchronize()
        counts = eaf.launch_counts()
        if counts != want:
            fail(f"{name}: a step launched {counts}, expected {want}")
        bodies = {k: dict(v) for k, v in eaf.body_launch_counts().items() if sum(v.values())}
        bf16_only(name, kernels)
        losses.append(float(metrics["loss"]))
    if not finite(losses):
        fail(f"{name}: losses {losses}")
    return dict(steps=steps, losses=losses, per_step_launches={k: v for k, v in want.items()
                                                                if v},
                per_step_bodies=bodies)


def saint_bit_for_bit(name, cfg, data, seed, dev, subs, layouts) -> dict:
    """Path F's captured step (make_pallas_train_step, no sender side)
    against its eager body from one initial state over ``subs``: each
    captured step 2 K1 + 2 K5, both on tc_bf16; the metrics and every
    parameter bit for bit (K1, K5 and pass B's sorted sum use no atomics)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.train.pallas_step import fused_forward, make_pallas_train_step
    from ampnet_tpu_torch.train.state import _train_step_body

    pair = [recipe_model(cfg, data, seed, dev) for _ in range(2)]
    states = [saint_state(m, saint_config(seed), seed) for m in pair]
    step = make_pallas_train_step(pair[0], "saint_mean")
    body = _train_step_body(pair[1], "saint_mean", forward=fused_forward(pair[1]))
    got, bodies = [], {}
    for g, lay in zip(subs, layouts):
        eaf.reset_launch_counts()
        got.append(step(states[0], g, lay)[1])
        torch.cuda.synchronize()
        if eaf.launch_counts() != launches(k1=2, k5=2):
            fail(f"{name}: a captured step launched {eaf.launch_counts()}, expected 2 K1 + 2 K5")
        bodies = bf16_only(name, ("edge_attention_sums", "edge_attention_bwd_stream"))
    want = [body(states[1], g, lay)[1] for g, lay in zip(subs, layouts)]
    pairs = {f"{k}_{i}": (a[k], b[k]) for i, (a, b) in enumerate(zip(got, want)) for k in a}
    pairs.update({k: (p, q) for (k, p), q in zip(pair[0].named_parameters(),
                                                 pair[1].parameters())})
    if any(p.dtype != torch.float32 for p in pair[0].parameters()):
        fail(f"{name}: a parameter is not f32")
    return dict(steps=len(subs), max_abs_diff=bit_for_bit(name, pairs), compared=len(pairs),
                per_step_bodies=bodies, losses=[float(m["loss"]) for m in got])


def bf16_saint(saint_cfg, data, graph, seed, dev) -> tuple:
    """Path F in bf16: make_pallas_train_step on GraphSAINT subgraphs with
    layouts without a sender side (K1 + K5 + pass B), on a bf16 model and on
    the f32 model under stream_bf16: captured = eager bit for bit over 3
    subgraphs at exactly 2 K1 + 2 K5 on tc_bf16 a step; the bf16 model's
    gradients against float64 autograd on the CPU (BF16_GRAD_RTOL); then
    SAINT_EPOCHS x 10 subgraph steps of the bf16 model and of the f32 one
    from the same initial state (counts set to 0 just before, read just
    after), the loss falling, and each model's final test accuracy on the
    whole surrogate. Returns (report, K5's tc_bf16 launches at S=40)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import make_eval_step
    from ampnet_tpu_torch.train.loop import _saint_layout_budget
    from ampnet_tpu_torch.train.pallas_step import make_pallas_train_step

    bf16 = dataclasses.replace(saint_cfg, compute_dtype="bfloat16")
    prep = saint_subgraphs(data, _saint_layout_budget(saint_sampler(data, SAINT_STEPS)), dev)
    subs, without = prep["subs"], prep["without"]
    report = {"F bf16": saint_bit_for_bit("F bf16", bf16, data, seed, dev, subs[:3],
                                          without[:3])}
    with dispatch_flag("STREAM_BF16_DEFAULT"):
        report["F stream_bf16"] = saint_bit_for_bit("F stream_bf16", saint_cfg, data, seed,
                                                    dev, subs[:3], without[:3])
    report["F bf16"]["gradient_check"] = gradient_check(
        "F bf16", recipe_model(bf16, data, seed, dev), subs[0], without[0], seed,
        want=launches(k1=2, k5=2), loss_mode="saint_mean", fused=True,
        grad_rtol=BF16_GRAD_RTOL)
    tcfg = saint_config(seed)
    full_layout = compute_layout(graph)
    k5 = 0
    trained, steps = {}, {}
    for name, cfg in (("f32", saint_cfg), ("bf16", bf16)):
        model = recipe_model(cfg, data, seed, dev)
        state = saint_state(model, tcfg, seed)
        step = make_pallas_train_step(model, loss_mode="saint_mean")
        steps[name] = (step, state)
        losses = []
        eaf.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(SAINT_EPOCHS):
            for g, lay in zip(subs, without):
                state, metrics = step(state, g, lay)
                losses.append(metrics["loss"])
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        counts = eaf.launch_counts()
        total = SAINT_EPOCHS * len(subs)
        if counts != launches(k1=2 * total, k5=2 * total):
            fail(f"F {name}: {total} steps launched {counts}")
        if name == "bf16":
            k5 = bf16_only("F bf16", ("edge_attention_sums",
                                      "edge_attention_bwd_stream"))["edge_attention_bwd_stream"]
        final = make_eval_step(model, num_eval_samples=8)(
            graph, torch.Generator(device=dev).manual_seed(seed), full_layout)
        trained[name] = dict(loss_fell(f"F {name}", [float(v) for v in losses]),
                             steps_s=steps_s, launches={k: v for k, v in counts.items() if v},
                             final_test_acc=float(final["test_acc"]),
                             final_val_acc=float(final["val_acc"]))
    report["training"] = dict(cut=f"{SAINT_EPOCHS} passes over {len(subs)} subgraphs",
                              **trained)
    # the two captured steps in turns (f32, bf16, bf16, f32), each the median
    # pass's mean step over the prepared subgraphs; the bf16 step's device
    # time and busy share by the profiler
    t = [warm_steps_ms(*steps[k], subs, without, passes=3)[0]
         for k in ("f32", "bf16", "bf16", "f32")]
    report["in_turns_with_f32"] = dict(
        f32_warm_ms=(t[0] + t[3]) / 2, bf16_warm_ms=(t[1] + t[2]) / 2,
        bf16_profile=pass_profile(*steps["bf16"], subs, without, (t[1] + t[2]) / 2),
        f32_profile=pass_profile(*steps["f32"], subs, without, (t[0] + t[3]) / 2))
    return report, k5


def bf16_routes(recipe, reference, data, graph, layout, seed, dev) -> tuple:
    """G, H and I on bf16 models: A's and B's evals under MM_SCATTER_DEFAULT
    (K6 or K7, as the JAX predicates route bf16 rows), 3 training steps at
    S=40 and at S=20 under it (2 K6 + 2 K3 + 2 K4 a step), A's eval under
    DMA_V1_DEFAULT (16 K9), every launch on tc_bf16 and each eval within
    BF16_LOGITS_RTOL of float64's largest log-prob; then the f32 models
    under mxu_bf16 with MM_SCATTER_DEFAULT at S=20: B's eval (K7 by the
    predicates, its attention on tc_bf16; within MXU_LOGITS_ATOL of
    float64) and one training step (K6 on tc_bf16, K3 and K4 on their
    3xTF32 bodies). Returns (report, the launches of each bf16 kernel row,
    counted where they ran at the row's S)."""
    bf40 = dataclasses.replace(recipe, compute_dtype="bfloat16")
    bf20 = dataclasses.replace(reference, compute_dtype="bfloat16")
    mm_k = launches(k6=2, k3=2, k4=2)
    # (kernel, S, rows' type) -> the kernel row it counts for
    row_of = {("edge_attention_sums_mm", 40, "bf16"): "k6_bf16",
              ("edge_attention_layer_mm", 20, "bf16"): "k7_bf16",
              ("edge_attention_sums_v1", 40, "bf16"): "k9_bf16",
              ("edge_attention_bwd_dq", 20, "bf16"): "k3_bf16_s20",
              ("edge_attention_bwd_dkv", 20, "bf16"): "k4_bf16_s20",
              ("edge_attention_sums_mm", 20, "mxu"): "k6_mxu",
              ("edge_attention_layer_mm", 20, "mxu"): "k7_mxu"}
    counts = dict.fromkeys(row_of.values(), 0)

    def count(kernel, cfg, rows, n):
        key = row_of.get((kernel, cfg.num_sampled_vectors, rows))
        if key:
            counts[key] += n

    report = {}
    with dispatch_flag("MM_SCATTER_DEFAULT"):
        for key, cfg in (("G S=40", bf40), ("G S=20", bf20)):
            kernel, n, report[key] = bf16_eval(key, cfg, data, graph, layout, seed, dev,
                                               rtol=BF16_LOGITS_RTOL)
            count(kernel, cfg, "bf16", n)
        for key, cfg in (("H S=40", bf40), ("H S=20", bf20)):
            report[key] = bf16_steps(f"{key} bf16", cfg, data, graph, layout, seed, dev, mm_k,
                                     ("edge_attention_sums_mm", "edge_attention_bwd_dq",
                                      "edge_attention_bwd_dkv"))
            for kernel in ("edge_attention_sums_mm", "edge_attention_bwd_dq",
                           "edge_attention_bwd_dkv"):
                count(kernel, cfg, "bf16", 2 * report[key]["steps"])
    with dispatch_flag("DMA_V1_DEFAULT"):
        kernel, n, report["I S=40"] = bf16_eval("I S=40", bf40, data, graph, layout, seed, dev,
                                                rtol=BF16_LOGITS_RTOL)
        count(kernel, bf40, "bf16", n)
    with dispatch_flag("MM_SCATTER_DEFAULT"), dispatch_flag("MXU_BF16_DEFAULT"):
        kernel, n, report["G S=20 mxu_bf16"] = bf16_eval(
            "G S=20 mxu_bf16", reference, data, graph, layout, seed, dev,
            atol=MXU_LOGITS_ATOL)
        count(kernel, reference, "mxu", n)
        report["H S=20 mxu_bf16"] = bf16_steps(
            "H S=20 mxu_bf16", reference, data, graph, layout, seed, dev, mm_k,
            ("edge_attention_sums_mm",), steps=1)
        bodies = report["H S=20 mxu_bf16"]["per_step_bodies"]
        if any(bodies[k]["tc"] != 2 for k in ("edge_attention_bwd_dq", "edge_attention_bwd_dkv")):
            fail(f"H S=20 mxu_bf16: K3 and K4 left their 3xTF32 bodies ({bodies})")
        count("edge_attention_sums_mm", reference, "mxu", 2)
    return report, counts


def bf16_phase(recipe, reference, saint_cfg, tcfg, data, graph, layout, seed, dev,
               path_c) -> tuple:
    """The bf16 phase: the bodies (``bf16_kernel_rows``); the recommended
    recipe in compute_dtype='bfloat16' through train_full_batch (path C's
    depth; K1, K3 and K4 on tc_bf16, gradients against float64 at
    BF16_GRAD_RTOL, captured = eager bit for bit over 3 steps, the step
    timed in turns with path C's f32 step); 3 steps of the f32 recipe under
    stream_bf16 (the module constant the environment variable sets), bit
    for bit against eager, close to the f32 step and each gradient within
    BF16_GRAD_RTOL of float64's; the f32 evals A and B
    under mxu_bf16, and one S=20 training step under it; the Predictor on
    bf16 models; path F in bf16 (``bf16_saint``); G, H and I on bf16 models
    and under mxu_bf16 (``bf16_routes``); the refusals. Returns (report,
    kernel rows with their launches)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import sample_present_features, tfidf_sample_features
    from ampnet_tpu_torch.train import (create_train_state, make_eval_step, make_optimizer,
                                        make_train_step)

    t_phase = time.perf_counter()
    report = {}
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    rows = bf16_kernel_rows(graph, layout, gen, dev)
    report["kernels"] = rows

    # the recipe in bf16, through the entry points
    bf16 = dataclasses.replace(recipe, compute_dtype="bfloat16")
    counts, training = drive_training("C bf16 recommended recipe, training", bf16, tcfg, data,
                                      graph, seed, dev, True, grad_rtol=BF16_GRAD_RTOL)
    bodies = bf16_only("C bf16")
    evals = tcfg.epochs // tcfg.select_best_every + 1
    want = launches(k1=2 * tcfg.epochs + 2 * 8 * evals, k3=2 * tcfg.epochs, k4=2 * tcfg.epochs)
    if counts != want:
        fail(f"path C bf16 launched {counts}, expected {want}")
    training["bodies"] = bodies
    training["captured_equals_eager"] = captured_equals_eager(
        "C bf16", bf16, data, graph, layout, seed, dev, want_step=launches(k1=2, k3=2, k4=2))
    # one captured step of each in turns, from states of their own
    steps = {}
    for name, cfg in (("f32", recipe), ("bf16", bf16)):
        model = recipe_model(cfg, data, seed, dev)
        st = create_train_state(model, make_optimizer(model.parameters(), 3e-3,
                                                      weight_decay=1e-3, grad_clip=1.0),
                                seed=seed)
        step = make_train_step(model)
        step(st, graph, layout)
        steps[name] = (lambda step=step, st=st: step(st, graph, layout))
    t = [sync_ms(steps[k], 10) for k in ("f32", "bf16", "bf16", "f32")]
    e = [cuda_ms(steps[k], 10) for k in ("f32", "bf16", "bf16", "f32")]
    training["in_turns_with_path_c"] = dict(
        f32_warm_ms=(t[0] + t[3]) / 2, bf16_warm_ms=(t[1] + t[2]) / 2,
        f32_event_ms=(e[0] + e[3]) / 2, bf16_event_ms=(e[1] + e[2]) / 2,
        bf16_profile=busy_share(device_profile(steps["bf16"]), (t[1] + t[2]) / 2),
        path_c_final_test_acc=path_c["final_test_acc"],
        path_c_train_full_batch_s=path_c["train_full_batch_s"])
    del steps
    report["training"] = training
    k1_k3_k4 = counts

    # stream_bf16 on the f32 recipe: K1, K3 and K4 on bf16 rows
    with dispatch_flag("STREAM_BF16_DEFAULT"):
        stream = captured_equals_eager("stream_bf16", recipe, data, graph, layout, seed, dev,
                                       want_step=launches(k1=2, k3=2, k4=2))
        model = recipe_model(recipe, data, seed, dev)
        sidx = tfidf_sample_features(graph.x, recipe.num_sampled_vectors,
                                     node_mask=graph.node_mask,
                                     generator=torch.Generator(device=dev).manual_seed(seed + 3))
        loss16, g16 = card_gradients(model, graph, layout, sidx)
        # each gradient against float64 autograd (the ReLU branches the
        # card took), of its own largest entry: the JAX test's atol below
        # would pass a zero gradient of a parameter whose gradient is small
        stream["gradient_check"] = gradient_check("stream_bf16", model, graph, layout, seed,
                                                  grad_rtol=BF16_GRAD_RTOL)
    loss32, g32 = card_gradients(model, graph, layout, sidx)
    rel = {k: float((g16[k] - g32[k]).abs().max() / g32[k].abs().max().clamp_min(1e-30))
           for k in g32}
    worst = max(rel, key=rel.get)
    apart = [k for k in g32 if not torch.allclose(g16[k], g32[k], rtol=STREAM_GRAD_RTOL,
                                                  atol=STREAM_GRAD_ATOL)]
    if abs(loss16 - loss32) > STREAM_LOSS_RTOL * abs(loss32) or apart:
        fail(f"stream_bf16: loss {loss16} vs f32 {loss32}; gradients beyond the JAX test's "
             f"tolerances: {apart}")
    stream.update(loss=loss16, f32_loss=loss32, grad_max_rel_diff=rel[worst],
                  grad_worst_parameter=worst,
                  grad_max_abs_diff=max(float((g16[k] - g32[k]).abs().max()) for k in g32))
    report["stream_bf16"] = stream

    # mxu_bf16 on the f32 evals: A (S=40, 'dma': the JAX body keeps f32
    # products) and B (S=20: K2 on tc_bf16); one S=20 training step (K1 on
    # the 'vmem' gather: tc_bf16; K3, K4 f32)
    mxu = {}
    with dispatch_flag("MXU_BF16_DEFAULT"):
        for name, cfg, want, body in (("A S=40", recipe, launches(k1=16), "tc"),
                                      ("B S=20", reference, launches(k2=16), "tc_bf16")):
            model = recipe_model(cfg, data, seed, dev)
            step = make_eval_step(model, num_eval_samples=8)
            eaf.reset_launch_counts()
            metrics = step(graph, torch.Generator(device=dev).manual_seed(seed), layout)
            torch.cuda.synchronize()
            counts = eaf.launch_counts()
            bodies = eaf.body_launch_counts()
            kernel = next(k for k, v in want.items() if v)
            if counts != want or bodies[kernel][body] != want[kernel]:
                fail(f"mxu_bf16 eval {name}: launched {counts} ({bodies[kernel]}), "
                     f"expected {want} on {body}")
            draw = torch.Generator(device=dev).manual_seed(seed + 2)
            sidx = (tfidf_sample_features(graph.x, cfg.num_sampled_vectors,
                                          node_mask=graph.node_mask, generator=draw)
                    if cfg.token_sampling == "tfidf" else
                    sample_present_features(graph.x, cfg.num_sampled_vectors, generator=draw))
            card, _ = stage_outputs(model, graph, sidx, layout)
            ref, _ = cpu_f64_reference(model, graph, sidx)
            err = float((card.double() - ref).abs().max())
            if not err <= MXU_LOGITS_ATOL:
                fail(f"mxu_bf16 eval {name}: log-probs {err:.3g} from float64 on the CPU")
            mxu[name] = dict(launches={k: v for k, v in counts.items() if v}, body=body,
                             bodies=bodies[kernel], cpu_f64_max_abs_err=err,
                             limit=MXU_LOGITS_ATOL,
                             metrics={k: float(v) for k, v in metrics.items()})
        model = recipe_model(reference, data, seed, dev)
        st = create_train_state(model, make_optimizer(model.parameters(), 3e-3), seed=seed)
        eaf.reset_launch_counts()
        metrics = make_train_step(model)(st, graph, layout)[1]
        torch.cuda.synchronize()
        counts, bodies = eaf.launch_counts(), eaf.body_launch_counts()
        if (counts != launches(k1=2, k3=2, k4=2) or bodies["edge_attention_sums"]["tc_bf16"] != 2
                or bodies["edge_attention_bwd_dq"]["tc"] != 2):
            fail(f"mxu_bf16 S=20 training step: launched {counts} ({bodies})")
        mxu["D S=20 training step"] = dict(
            launches={k: v for k, v in counts.items() if v},
            k1_bodies=bodies["edge_attention_sums"], loss=float(metrics["loss"]))
    report["mxu_bf16"] = mxu
    k1_mxu = mxu["D S=20 training step"]["k1_bodies"]["tc_bf16"]
    k2_mxu = mxu["B S=20"]["bodies"]["tc_bf16"]

    # serving bf16 models
    bf16_20 = dataclasses.replace(reference, compute_dtype="bfloat16")
    eaf.reset_launch_counts()
    report["serving"] = bf16_serving(bf16, bf16_20, data, seed, dev)
    report["saint"], k5_bf16 = bf16_saint(saint_cfg, data, graph, seed, dev)
    report["routes"], route_launches = bf16_routes(recipe, reference, data, graph, layout,
                                                   seed, dev)
    report["phase_s"] = time.perf_counter() - t_phase

    # each row's launches ran at the row's own S
    k2_bf16 = report["serving"]["k2_launches"]
    kernel_rows = [
        dict(rows["k1_bf16"], launches=k1_k3_k4["edge_attention_sums"]),
        dict(rows["k1_mxu"], launches=k1_mxu),
        dict(rows["k2_bf16_s40"], launches=k2_bf16["40"]),
        dict(rows["k2_bf16"], launches=k2_bf16["20"]),
        dict(rows["k2_mxu"], launches=k2_mxu),
        dict(rows["k3_bf16"], launches=k1_k3_k4["edge_attention_bwd_dq"]),
        dict(rows["k4_bf16"], launches=k1_k3_k4["edge_attention_bwd_dkv"]),
        dict(rows["k5_bf16"], launches=k5_bf16),
        *(dict(rows[key], launches=route_launches[key])
          for key in ("k3_bf16_s20", "k4_bf16_s20", "k6_bf16", "k6_mxu", "k7_bf16",
                      "k7_mxu", "k9_bf16")),
        rows["k8_bf16"], rows["k8_bf16_s20"]]
    if any(r["launches"] < 1 for r in kernel_rows):
        fail(f"bf16: a body was never launched on its path "
             f"({[r['launches'] for r in kernel_rows]})")
    return report, kernel_rows


# ---- the native sampling core, the synthetic XOR recipe (path K), the
# classifiers and the tokenizer modes

# experiments/synthetic_training_modular.py's ARGS (:24-37) and model
# (:63-70): duplicated-feature XOR, 400 + 400 nodes, noise 0.3, 10 nearest
# neighbours, 5 repeats (10 features); AMPNet at D=32, H=2, S=20, dropout
# rates 0; Adam at 5e-3, clip 1.0, masked-mean NLL, 200 epochs
XOR_DATA = (400, 400, 0.3, 10, 5)
XOR_MODEL = dict(embedding_dim=32, num_heads=2, num_node_features=10, num_sampled_vectors=20,
                 output_dim=2, feat_emb_dim=31, val_emb_dim=1, dropout_rate=0.0,
                 dropout_adj_rate=0.0, use_pallas=True)
XOR_LR, XOR_EPOCHS = 5e-3, 200
# its GraphSAINT variant (synthetic_training_modular_graphsaint.py:30-53):
# one native sampler per split, the node_norm-weighted NLL sum, 50 epochs
XOR_SAINT = dict(batch_size=4, walk_length=20, num_steps=10, sample_coverage=20, seed=0)
XOR_SAINT_EPOCHS = 50


def native_phase(data, seed) -> dict:
    """The sampler of paths E and F (batch 8, walk 150, coverage 100, seed
    1) built on each core in turns (native, numpy, native): build seconds
    (pre-pass and pad probe) and host ms a subgraph of each; the two native
    builds array-equal (norms, pad sizes, 10 padded subgraphs); every
    induced edge of 20 native subgraphs inside its node set, no edge twice,
    and as many edges as a numpy recount finds."""
    import numpy as np

    from ampnet_tpu_torch.data import native

    t0 = time.perf_counter()
    native.build_native()
    report = {"library_build_s": time.perf_counter() - t0, "cores": {}}
    built = []
    for use_native in (True, False, True):
        t0 = time.perf_counter()
        sampler = saint_sampler(data, SAINT_STEPS, use_native)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        subs = [sampler.sample() for _ in range(10)]
        ms = (time.perf_counter() - t0) * 1e3 / len(subs)
        built.append((sampler, subs))
        report["cores"].setdefault(sampler_core(sampler), []).append(dict(
            sampler_build_s=build_s, ms_per_subgraph=ms,
            pad_nodes_to=sampler.pad_nodes_to, pad_edges_to=sampler.pad_edges_to,
            mean_nodes=float(np.mean([g.num_nodes for g in subs])),
            mean_edges=float(np.mean([g.num_edges for g in subs])),
            node_norm_mean=float(sampler.node_norm.mean())))
    (a, subs_a), _, (b, subs_b) = built
    same = (np.array_equal(a.node_norm, b.node_norm) and np.array_equal(a.edge_norm, b.edge_norm)
            and (a.pad_nodes_to, a.pad_edges_to) == (b.pad_nodes_to, b.pad_edges_to)
            and all(torch.equal(getattr(ga, f.name), getattr(gb, f.name))
                    for ga, gb in zip(subs_a, subs_b) for f in dataclasses.fields(ga)
                    if getattr(ga, f.name) is not None))
    if not same:
        fail("native: two builds of the native sampler differ for one seed")
    rng = np.random.default_rng(seed)
    edges = 0
    for _ in range(20):
        nodes, eids = a._subgraph(rng)
        inside = np.zeros(a.N, bool)
        inside[nodes] = True
        recount = int((inside[a.edge_index[0]] & inside[a.edge_index[1]]).sum())
        if (not inside[a.edge_index[:, eids]].all() or len(np.unique(eids)) != len(eids)
                or recount != len(eids)):
            fail(f"native: an induced subgraph of {len(nodes)} nodes has {len(eids)} edges, "
                 f"the numpy recount {recount}, or an edge with an end outside its nodes")
        edges += len(eids)
    report.update(builds_equal=True, induced_subgraphs_checked=20, induced_edges_checked=edges)
    return report


def xor_graphs(dev=None):
    """The recipe's (train, test) duplicated-XOR graphs, on ``dev``."""
    from ampnet_tpu_torch.data.synthetic import get_duplicated_xor_graphs

    graphs = get_duplicated_xor_graphs(*XOR_DATA, seed=0)
    return tuple(g.to(dev) for g in graphs) if dev is not None else graphs


def xor_model(seed, dev, **over):
    from ampnet_tpu_torch.models import get_model

    return get_model("AMPNet", **{**XOR_MODEL, **over},
                     generator=torch.Generator().manual_seed(seed), device=dev)


def xor_state(model, seed):
    from ampnet_tpu_torch.train import create_train_state, make_optimizer

    return create_train_state(model, make_optimizer(model.parameters(), XOR_LR, grad_clip=1.0),
                              seed=seed)


def f64_check(name, model, graph, layout, sampled_idx=None, limits=(MODEL_RTOL, MODEL_ATOL),
              **call):
    """One deterministic forward on the card (its draw ``sampled_idx``)
    against the same model and draw in float64 on the CPU, its AMPConvs on
    the plain oracle; fail beyond the model limits. Returns the max abs
    error."""
    with torch.no_grad():
        card = model(graph, sampled_idx=sampled_idx, edge_layout=layout, **call).cpu()
        ref = copy.deepcopy(model).to("cpu", torch.float64)
        for conv in (getattr(ref, "conv1", None), getattr(ref, "conv2", None)):
            if hasattr(conv, "use_pallas"):
                conv.use_pallas, conv.dtype = False, None
        g = graph.to("cpu")
        g.x = g.x.double()
        want = ref(g, sampled_idx=None if sampled_idx is None else sampled_idx.cpu(), **call)
    if not torch.isfinite(card).all():
        fail(f"{name}: non-finite output on the card")
    err = float((card.double() - want).abs().max())
    if not torch.allclose(card.double(), want, rtol=limits[0], atol=limits[1]):
        fail(f"{name}: the card's output disagrees with the CPU float64 forward "
             f"(max abs err {err:.3g})")
    return err


def used(bodies) -> dict:
    """body_launch_counts() without the bodies that did not run."""
    return {k: {b: n for b, n in v.items() if n} for k, v in bodies.items() if any(v.values())}


def eval_launches(name, evaluate, graph, layout, dev, seed):
    """The launches of one captured eval (its capture and one replay): 2 of
    K1 or 2 of K2, whichever the forward route picks, on the tensor cores."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    eaf.reset_launch_counts()
    metrics = evaluate(graph, torch.Generator(device=dev).manual_seed(seed), layout)
    counts = eaf.launch_counts()
    if counts not in (launches(k1=2), launches(k2=2)):
        fail(f"{name}: one eval launched {counts}, expected 2 K1 or 2 K2")
    if not finite([float(v) for v in metrics.values()]):
        fail(f"{name}: non-finite eval metrics {metrics}")
    return counts, used(tensor_cores_only(name, counts, ("tc",)))


def path_k(seed, dev) -> tuple:
    """Path K, the synthetic XOR recipe on the card: get_model('AMPNet'),
    make_train_step (a captured step: 2 K1 + 2 K3 + 2 K4, tensor cores) and
    make_eval_step on the test graph (one draw an epoch, as the script's
    PRNGKey(epoch)) for all 200 epochs; before that one step's gradients
    against float64 autograd, and the captured step against the eager body
    from one state (step costs of both; after the same steps, parameters,
    Adam's state and generator equal bit for bit); after it the test
    graph's logits of one draw against float64. Then the GraphSAINT
    variant through native samplers (per step the same launches, per eval
    one kernel's). Returns (the XOR recipe's launches, the GraphSAINT
    variant's, report)."""
    import numpy as np

    from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler
    from ampnet_tpu_torch.data.synthetic import create_duplicated_xor_data
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.ops.tokenize import sample_present_features
    from ampnet_tpu_torch.train import make_eval_step, make_train_step
    from ampnet_tpu_torch.train.loop import _saint_layout_budget
    from ampnet_tpu_torch.train.state import _train_step_body

    name = "K synthetic XOR recipe, D=32 H=2 S=20"
    train_g, test_g = xor_graphs(dev)
    lay_train, lay_test = compute_layout(train_g), compute_layout(test_g)
    report = dict(path=name, source="experiments/synthetic_training_modular.py:24-37,63-70",
                  nodes_edges=[[g.num_nodes, g.num_edges] for g in (train_g, test_g)])
    report["gradient_check"] = gradient_check(name, xor_model(seed, dev), train_g, lay_train,
                                              seed)

    probe, twin = xor_model(seed, dev), xor_model(seed, dev)
    state, state_e = xor_state(probe, seed), xor_state(twin, seed)
    step, eager = make_train_step(probe), _train_step_body(twin)
    eaf.reset_launch_counts()
    _, first_ms, peak = first_call(lambda: step(state, train_g, lay_train))
    per_step = eaf.launch_counts()
    if per_step != launches(k1=2, k3=2, k4=2):
        fail(f"path {name}: one training step launched {per_step}, expected 2 K1 + 2 K3 + 2 K4")
    step_bodies = used(tensor_cores_only(name, per_step, ("tc",)))
    eager(state_e, train_g, lay_train)
    costs = eager_and_captured(name, lambda: eager(state_e, train_g, lay_train),
                               lambda: step(state, train_g, lay_train), 10, first_ms)
    pairs = {k: (p, q) for (k, p), q in zip(probe.named_parameters(), twin.parameters())}
    for i, (p, q) in enumerate(zip(state.optimizer.params, state_e.optimizer.params)):
        for k, t in state.optimizer.adam.state[p].items():
            pairs[f"adam_{i}_{k}"] = (t, state_e.optimizer.adam.state[q][k])
    pairs["generator"] = (state.generator.get_state(), state_e.generator.get_state())
    report.update(train_step_first_ms=first_ms, first_call_max_memory_allocated=peak,
                  train_step_warm_ms=costs["captured"]["warm_ms"],
                  eager_train_step_warm_ms=costs["eager"]["warm_ms"],
                  capture_ms=costs["capture_ms"], profile=costs["captured"]["profile"],
                  eager=costs["eager"], captured=costs["captured"],
                  captured_equals_eager=dict(steps=state.step, compared=len(pairs),
                                             max_abs_diff=bit_for_bit("K", pairs)),
                  per_step_launches=per_step, per_step_bodies=step_bodies)

    model = xor_model(seed, dev)
    st = xor_state(model, seed)
    step, evaluate = make_train_step(model, loss_mode="full"), make_eval_step(model)
    report["per_eval_launches"], report["per_eval_bodies"] = eval_launches(
        name, evaluate, test_g, lay_test, dev, seed)
    rows = []
    eaf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(XOR_EPOCHS):
        st, m = step(st, train_g, lay_train)
        tm = evaluate(test_g, torch.Generator(device=dev).manual_seed(epoch), lay_test)
        rows.append((m["loss"], m["train_acc"], tm["train_acc"]))
    torch.cuda.synchronize()
    report["train_s"] = time.perf_counter() - t0
    counts = eaf.launch_counts()
    bodies = used(tensor_cores_only(name, counts, ("tc",)))
    want = {k: XOR_EPOCHS * (per_step[k] + report["per_eval_launches"][k]) for k in KERNELS}
    if counts != want:
        fail(f"path {name} launched {counts}, expected {want}")
    losses, train_acc, test_acc = ([float(r[i]) for r in rows] for i in range(3))
    report.update(epochs=XOR_EPOCHS, **loss_fell(name, losses), max_train_acc=max(train_acc),
                  max_test_acc=max(test_acc), final_test_acc=test_acc[-1], launches=counts,
                  bodies=bodies)
    sidx = sample_present_features(test_g.x, XOR_MODEL["num_sampled_vectors"],
                                   generator=torch.Generator(device=dev).manual_seed(seed + 2))
    report["eval_cpu_f64_max_abs_err"] = f64_check(name, model, test_g, lay_test, sidx)

    # the GraphSAINT variant: train and test streamed through native samplers
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    samplers = []
    for ns in XOR_DATA[:2]:
        x, y, _, ei = create_duplicated_xor_data(ns, *XOR_DATA[2:], rng)
        samplers.append(GraphSaintRandomWalkSampler(
            x, ei, y=y.astype(np.int32), train_mask=np.ones(ns, bool), **XOR_SAINT))
    train_s, test_s = samplers
    budgets = [_saint_layout_budget(s) for s in samplers]
    saint = dict(source="experiments/synthetic_training_modular_graphsaint.py:30-53",
                 sampler_core=sampler_core(train_s), sampler_build_s=time.perf_counter() - t0,
                 pad=[[s.pad_nodes_to, s.pad_edges_to] for s in samplers], edge_budget=budgets)
    model = xor_model(seed, dev)
    st = xor_state(model, seed)
    step, evaluate = make_train_step(model, loss_mode="saint"), make_eval_step(model)
    rows, per_eval = [], None
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    for epoch in range(XOR_SAINT_EPOCHS):
        for sub in train_s.prefetch():
            lay = compute_layout(sub, edges_per_tile=budgets[0])
            st, m = step(st, sub.to(dev), lay.to(dev))
        sub = test_s.sample()
        before = eaf.launch_counts()
        tm = evaluate(sub.to(dev), torch.Generator(device=dev).manual_seed(epoch),
                      compute_layout(sub, edges_per_tile=budgets[1]).to(dev))
        # every eval runs one subgraph of the test sampler's padded shape:
        # the same kernel, 2 K1 or 2 K2, each time
        one = {k: n - before[k] for k, n in eaf.launch_counts().items()}
        if per_eval is None and one in (launches(k1=2), launches(k2=2)):
            per_eval = one
        if one != per_eval:
            fail(f"path {name}, GraphSAINT: eval {epoch} launched {one}, expected "
                 f"{per_eval or '2 K1 or 2 K2'}")
        rows.append((m["loss"], m["train_acc"], tm["train_acc"]))
    torch.cuda.synchronize()
    saint["train_s"] = time.perf_counter() - t0
    counts_s = eaf.launch_counts()
    saint_bodies = used(tensor_cores_only(name, counts_s, ("tc",)))
    steps = XOR_SAINT_EPOCHS * XOR_SAINT["num_steps"]
    want = {k: steps * per_step[k] + XOR_SAINT_EPOCHS * per_eval[k] for k in KERNELS}
    if counts_s != want:
        fail(f"path {name}, GraphSAINT: launched {counts_s} in {steps} steps and "
             f"{XOR_SAINT_EPOCHS} evals, expected {want}")
    losses, train_acc, test_acc = ([float(r[i]) for r in rows] for i in range(3))
    if not finite(losses):
        fail(f"path {name}, GraphSAINT: a non-finite loss")
    saint.update(epochs=XOR_SAINT_EPOCHS, steps=steps, loss_first=losses[0],
                 loss_last=losses[-1], max_train_acc=max(train_acc), max_test_acc=max(test_acc),
                 per_eval_launches=per_eval, launches=counts_s, bodies=saint_bodies)
    report["graphsaint"] = saint
    return counts, counts_s, report


def xor_kernel_rows(seed, dev, counts_k, by_path) -> list:
    """K1, K3 and K4 on path K's training graph and K2 on its test graph,
    at the XOR model's D=32, H=2, S=20 (every edge live, as the recipe's
    graphs are): each against its plain version, its time, its plain
    version's and its bound. ``launches`` is path K's count (its 200 epochs
    ran at this shape); ``launches_by_path`` adds the slice's other paths,
    which ran the kernel at other shapes (GraphSAINT subgraphs, D=8, the
    tokenizer configs)."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import (compute_layout, edge_slot_valid,
                                                    snd_slot_valid)
    from ampnet_tpu_torch.ops.segment import segment_count

    d, h = XOR_MODEL["embedding_dim"], XOR_MODEL["num_heads"]
    s = XOR_MODEL["num_sampled_vectors"]
    sp = -(-s // 8) * 8
    kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []

    def row(name, graph_name, source, replaces, run, plain, nbytes, flops):
        eaf.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        tensor_cores_only(f"K {name}", eaf.launch_counts(), ("tc",))
        err = compare(f"{name} (path K's shape)", got, plain())
        if not torch.equal(got, run()):
            fail(f"{name} (path K's shape): a second launch differs from the first")
        b, by = bound_ms(nbytes, flops, True)
        paths = {k: c[name] for k, c in by_path.items() if c[name]}
        rows.append(dict(
            name=name, route="cuda", source=f"ampnet_tpu_torch/ops/hopper/csrc/{source}",
            replaces=replaces, launches=counts_k[name], launches_by_path=paths, s=s, d=d, h=h,
            graph=graph_name, max_abs_err=err, ms=cuda_ms(run, 20), plain_ms=cuda_ms(plain, 3),
            bound_ms=b, bound_by=by, library_ms=None, precision="3xtf32"))

    train_g, test_g = xor_graphs(dev)
    layout = compute_layout(train_g)
    n, nt = train_g.num_nodes_padded, layout.recv_ptr.numel() - 1
    idx = (layout.tile_senders, edge_slot_valid(layout, train_g.edge_mask), layout.recv_ptr,
           layout.recv_slots)
    snd_idx = (layout.snd_receivers, snd_slot_valid(layout, train_g.edge_mask),
               layout.snd_ptr, layout.snd_slots)
    live = int(idx[1].sum())
    index_bytes = 4 * (2 * layout.tile_senders.numel() + layout.recv_ptr.numel()
                       + layout.recv_slots.numel())
    snd_index_bytes = 4 * (2 * layout.snd_receivers.numel() + layout.snd_ptr.numel()
                           + layout.snd_slots.numel())
    qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=dev)
    q, kv = qkv[:, :d], qkv[:, d:]
    dsum = torch.randn(nt * sp, d, generator=gen, device=dev)
    qdm = torch.cat([q, dsum], 1)
    # the bytes and products as kernel_phases prices them at the Cora shapes
    row("edge_attention_sums", "XOR train", "edge_attention_tc.cu",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:691",
        lambda: eaf.edge_attention_sums(q, kv, *idx, **kw),
        lambda: eaf.edge_attention_sums_plain(q, kv, *idx, **kw),
        4 * d * n * s * 4 + index_bytes, 4 * s * s * d * live)
    row("edge_attention_bwd_dq", "XOR train", "edge_attention_bwd_dq_tc.cu",
        "ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:167",
        lambda: bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw),
        lambda: bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *idx, **kw),
        5 * d * n * s * 4 + index_bytes, 6 * s * s * d * live)
    row("edge_attention_bwd_dkv", "XOR train", "edge_attention_bwd_tc.cu",
        "ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:280",
        lambda: bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw),
        lambda: bwd.edge_attention_bwd_dkv_plain(qdm, kv, *snd_idx, **kw),
        6 * d * n * s * 4 + snd_index_bytes, 8 * s * s * d * live)
    del qkv, q, kv, dsum, qdm

    layout = compute_layout(test_g)
    n, nt = test_g.num_nodes_padded, layout.recv_ptr.numel() - 1
    idx = (layout.tile_senders, edge_slot_valid(layout, test_g.edge_mask), layout.recv_ptr,
           layout.recv_slots)
    live = int(idx[1].sum())
    index_bytes = 4 * (2 * layout.tile_senders.numel() + layout.recv_ptr.numel()
                       + layout.recv_slots.numel())
    conv = AMPConv(d, h, generator=torch.Generator().manual_seed(seed)).to(dev)
    with torch.no_grad():
        conv.b_qkv.normal_(0.0, 0.1, generator=gen)
        conv.b_out.normal_(0.0, 0.1, generator=gen)
    w = [t.detach().contiguous() for t in conv.params()]
    x_rows = torch.randn(nt * sp, d, generator=gen, device=dev)
    count = segment_count(test_g.receivers, n, test_g.edge_mask)
    invdeg = torch.where(count > 0, 1.0 / count.clamp_min(1.0), torch.zeros_like(count))
    invdeg = torch.nn.functional.pad(invdeg, (0, nt - n))
    live_recv = int((count > 0).sum())
    row("edge_attention_layer", "XOR test",
        "edge_attention_layer_tc.cu + ampnet_tpu_torch/ops/hopper/csrc/edge_attention_tc.cuh",
        "ampnet_tpu/ops/pallas/edge_attention_fused.py:763",
        lambda: eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw),
        lambda: eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *idx, **kw),
        4 * (2 * n * s * d + 4 * d * d + 4 * d + nt) + index_bytes,
        2 * n * s * d * 3 * d + 4 * s * s * d * live + 2 * s * d * d * live_recv)
    return rows


def two_class_forward(model):
    """A one-logit head's training forward as two-class log-probs
    [log(1 - sigmoid(z)), log sigmoid(z)]: their NLL is the BCE on z."""
    def forward(graph, layout, generator):
        z = model(graph, deterministic=False, generator=generator, edge_layout=layout)
        return torch.cat([torch.nn.functional.logsigmoid(-z),
                          torch.nn.functional.logsigmoid(z)], dim=1)
    return forward


def synthetic_models_phase(seed, dev) -> tuple:
    """The classifiers through get_model on the recipe's XOR training graph:
    3 captured training steps each (Adam 5e-3, clip 1.0; the one-logit MLPs
    on BCE, as two-class log-probs), finite losses, then one deterministic
    forward on the card against float64 on the CPU (GCNOneLayer on a fixed
    balanced draw). AMPNetClassifier on embed_features_old's tokens (S=10,
    D=8, H=2) through the fused kernels. Then one RPG and one cyclic-CA
    graph through AMPGCN (use_pallas) on the card: an eval and a fixed
    draw against float64. Returns (launches, report)."""
    import numpy as np

    from ampnet_tpu_torch.data.synthetic import make_cyclic_ca_graph, make_rpg_graph
    from ampnet_tpu_torch.models import get_model
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.ops.tokenize import (balanced_sample_features,
                                               pca_feature_embedding, sample_present_features)
    from ampnet_tpu_torch.train import make_eval_step, make_train_step
    from ampnet_tpu_torch.utils import embed_features_old

    host, _ = xor_graphs()
    x = host.x[: host.num_nodes].numpy()
    nf = XOR_MODEL["num_node_features"]
    tokens = np.zeros((host.x.shape[0], nf * 8), np.float32)
    tokens[: host.num_nodes] = embed_features_old(x, 7, 1)
    gen = torch.Generator().manual_seed(seed)
    cases = {
        "GCN": (dict(num_node_features=nf, feat_emb_dim=7, val_emb_dim=1, output_dim=2), host),
        "GCNOneLayer": (dict(pca_embedding=pca_feature_embedding(x, 7), num_node_features=nf,
                             num_sampled_vectors=5, output_dim=2, feat_emb_dim=7,
                             val_emb_dim=1), host),
        "LinearLayer": (dict(in_dim=nf), host),
        "TwoLayerSigmoid": (dict(in_dim=nf), host),
        "AMPNetClassifier": (dict(num_heads=2, embed_dim=8, n_original_features=nf, out_dim=2),
                             dataclasses.replace(host, x=torch.from_numpy(tokens))),
    }
    report, total = {}, launches()
    for name, (kw, g) in cases.items():
        g = g.to(dev)
        model = get_model(name, generator=gen, device=dev, **kw)
        layout = compute_layout(g) if name == "AMPNetClassifier" else None
        one_logit = name in ("LinearLayer", "TwoLayerSigmoid")
        step = make_train_step(model, "full", forward=two_class_forward(model)
                               if one_logit else None)
        st = xor_state(model, seed)
        eaf.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [float(step(st, g, layout)[1]["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        counts = eaf.launch_counts()
        want = launches(k1=6, k3=6, k4=6) if layout is not None else launches()
        if counts != want or not finite(losses):
            fail(f"synthetic_models, {name}: 3 steps launched {counts} (expected {want}), "
                 f"losses {losses}")
        sidx = (balanced_sample_features(g.x, 5, generator=torch.Generator(device=dev)
                                         .manual_seed(seed)) if name == "GCNOneLayer" else None)
        report[name] = dict(steps_s=time.perf_counter() - t0, losses=losses, launches=counts,
                            bodies=used(tensor_cores_only(name, counts, ("tc",))),
                            cpu_f64_max_abs_err=f64_check(name, model, g, layout, sidx))
        total = {k: total[k] + counts[k] for k in KERNELS}

    for name, g, classes in (
            ("RPG", make_rpg_graph(3, 100, rng=np.random.default_rng(seed)), 3),
            ("cyclic CA", make_cyclic_ca_graph(rng=np.random.default_rng(seed)), 6)):
        g = g.to(dev)
        layout = compute_layout(g)
        model = xor_model(seed, dev, num_node_features=3, num_sampled_vectors=8,
                          output_dim=classes)
        counts, bodies = eval_launches(name, make_eval_step(model), g, layout, dev, seed)
        sidx = sample_present_features(g.x, 8, generator=torch.Generator(device=dev)
                                       .manual_seed(seed))
        report[name] = dict(nodes_edges=[g.num_nodes, g.num_edges], eval_launches=counts,
                            bodies=bodies,
                            cpu_f64_max_abs_err=f64_check(name, model, g, layout, sidx))
        total = {k: total[k] + counts[k] for k in KERNELS}
    return total, report


def tokenizers_phase(seed, dev) -> tuple:
    """AMPGCN evals (use_pallas, a captured eval step) through the
    tokenizer's other modes: the pca frontend and balanced sampling on the
    recipe's XOR graph, and no downsampling on the XOR config of the verify
    notes (F=2, D=16, H=2, get_xor_graphs(64, 64)) at feature_repeats 1 and
    5; each with its launches by body and one draw against float64.
    Returns (launches, report)."""
    from ampnet_tpu_torch.data.synthetic import get_xor_graphs
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.ops.tokenize import (balanced_sample_features,
                                               pca_feature_embedding, sample_present_features)
    from ampnet_tpu_torch.train import make_eval_step

    host, _ = xor_graphs()
    x = host.x[: host.num_nodes].numpy()
    xor2 = get_xor_graphs(64, 64, seed=seed)[0]
    plain = dict(embedding_dim=16, feat_emb_dim=15, val_emb_dim=1, num_heads=2,
                 num_node_features=2, num_sampled_vectors=2, output_dim=2,
                 downsample_feature_vectors=False)
    cases = {
        "pca": (host, dict(embedding_dim=8, feat_emb_dim=7, frontend="pca"),
                dict(pca_embedding=pca_feature_embedding(x, 7))),
        # without replacement: S <= F
        "balanced_sampling": (host, dict(num_sampled_vectors=8), {}),
        "downsample=False, feature_repeats=1": (xor2, dict(plain, feature_repeats=1), {}),
        "downsample=False, feature_repeats=5": (xor2, dict(plain, feature_repeats=5), {}),
    }
    report, total = {}, launches()
    for name, (g, over, kw) in cases.items():
        g = g.to(dev)
        layout = compute_layout(g)
        model = xor_model(seed, dev, **over, **kw)
        if name == "balanced_sampling":
            model.tokenizer.config = dataclasses.replace(model.tokenizer.config,
                                                         balanced_sampling=True)
        counts, bodies = eval_launches(name, make_eval_step(model), g, layout, dev, seed)
        sidx = None
        if model.config.downsample_feature_vectors:
            draw = (balanced_sample_features if name == "balanced_sampling"
                    else sample_present_features)
            sidx = draw(g.x, model.config.num_sampled_vectors,
                        generator=torch.Generator(device=dev).manual_seed(seed))
        with torch.no_grad():
            out = model(g, sampled_idx=sidx, edge_layout=layout, return_aux=True)
        report[name] = dict(tokens=out.aux["attn_weights_1"].shape[-1], eval_launches=counts,
                            bodies=bodies,
                            cpu_f64_max_abs_err=f64_check(name, model, g, layout, sidx))
        total = {k: total[k] + counts[k] for k in KERNELS}
    return total, report


# ------------------------------------- SSL, the drivers, interpretation, graft entry

SSL_MODES = ("contrastive", "predictive")
SSL_STEPS, SSL_COMPARED = 30, 10
SSL_LR = 3e-3                    # the recipe's rate
RUNS_DIR = Path(__file__).resolve().parent / "runs" / "chip_smoke"
DRIVERS_DIR = Path(__file__).resolve().parent / "chiprun_out" / "drivers"
SAINT_DRIVER_EPOCHS = 3          # of the recipe's 50: the cut
JAX_FULL_BAND = (0.874, 0.023)   # the JAX package over 11 surrogate draws (README)
PORT_C_BAND = (0.857, 0.014)     # path C's recipe at 150 epochs, seeds 0-7 (PERF.md §6)
MIN_FULL_TEST_ACC = 0.80


def ssl_model(recipe, mode, data, seed, dev):
    from ampnet_tpu_torch.train.ssl import SSLPretrainer

    return SSLPretrainer(recipe_model(recipe, data, seed, dev), mode=mode,
                         num_features=recipe.num_node_features,
                         generator=torch.Generator().manual_seed(seed + 1))


def ssl_state(model, seed):
    from ampnet_tpu_torch.train import create_train_state, make_optimizer

    return create_train_state(model, make_optimizer(model.parameters(), SSL_LR,
                                                    weight_decay=1e-3, grad_clip=1.0), seed=seed)


def ssl_gradient_check(recipe, data, graph, layout, seed, dev):
    """One SSL forward with dropout rates 0, the tokens and the negatives
    injected, and the backward of each mode's loss: both heads on one
    backbone (its forward runs once, 2 K1; each loss's backward 2 K3 + 2
    K4). The card's gradients against float64 autograd on the CPU through
    the plain oracle, every parameter each loss reaches, within GRAD_RTOL
    of its largest entry (each ReLU's branch taken as the card took it, as
    in gradient_check)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import tfidf_sample_features
    from ampnet_tpu_torch.train.ssl import (SSLPretrainer, draw_negatives,
                                            predictive_masked_feature_loss, skipgram_loss)

    backbone = recipe_model(recipe, data, seed, dev)
    heads = {mode: SSLPretrainer(backbone, mode=mode, num_features=recipe.num_node_features,
                                 generator=torch.Generator().manual_seed(seed + 1))
             for mode in SSL_MODES}
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    sidx = tfidf_sample_features(graph.x, recipe.num_sampled_vectors, node_mask=graph.node_mask,
                                 generator=gen)
    neg = draw_negatives(gen, graph.senders.shape[0], heads["contrastive"].num_negatives,
                         graph.num_nodes_padded, graph.node_mask)
    if not bool(graph.node_mask[neg].all()):
        fail("ssl: a negative is not a valid node")
    branches, flips = {}, {}

    def grads(hs, g, idx, ng, lay, record):
        bb = hs["contrastive"].backbone
        bb.config = dataclasses.replace(recipe, dropout_rate=0.0, dropout_adj_rate=0.0)
        hooks = relu_branch_hooks(bb, branches, None if record else flips)
        try:
            pooled = bb(g, deterministic=False, sampled_idx=idx, edge_layout=lay,
                        generator=torch.Generator(device=g.x.device), return_aux=True,
                        attention_weights=False).aux["pooled"]
            losses = {"contrastive": skipgram_loss(
                          pooled, g.senders, g.receivers, g.edge_mask, None,
                          hs["contrastive"].num_negatives, g.node_mask, neg_idx=ng),
                      "predictive": predictive_masked_feature_loss(
                          pooled, g.x, g.node_mask, hs["predictive"].feature_predictor)}
            out = {}
            for mode, loss in losses.items():
                names, params = zip(*hs[mode].named_parameters())
                got = torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
                out[mode] = {k: v.detach().cpu().double() for k, v in zip(names, got)
                             if v is not None}
        finally:
            bb.config = recipe
            for h in hooks:
                h.remove()
        return {m: float(v.detach()) for m, v in losses.items()}, out

    eaf.reset_launch_counts()
    loss_card, card = grads(heads, graph, sidx, neg, layout, True)
    torch.cuda.synchronize()
    counts = eaf.launch_counts()
    if counts != launches(k1=2, k3=4, k4=4):
        fail(f"ssl: one forward and two backwards launched {counts}, "
             f"expected 2 K1 + 4 K3 + 4 K4")
    t0 = time.perf_counter()
    ref_heads = copy.deepcopy(heads)          # one backbone, shared as on the card
    for h in ref_heads.values():
        h.to("cpu", torch.float64)
    for conv in (ref_heads["contrastive"].backbone.conv1, ref_heads["contrastive"].backbone.conv2):
        conv.use_pallas, conv.dtype = False, None
    g = graph.to("cpu")
    g.x = g.x.double()
    loss_ref, ref = grads(ref_heads, g, sidx.cpu(), neg.cpu(), None, False)
    report = dict(cpu_f64_s=time.perf_counter() - t0, launches=counts,
                  relu_branches_moved=flips, negatives_valid=True)
    for mode in SSL_MODES:
        if set(card[mode]) != set(ref[mode]):
            fail(f"ssl {mode}: the card's gradients name "
                 f"{sorted(set(card[mode]) ^ set(ref[mode]))} apart from float64's")
        rel = {}
        for k, r in ref[mode].items():
            scale = float(r.abs().max())
            if scale == 0.0 or not torch.isfinite(card[mode][k]).all():
                fail(f"ssl {mode}: gradient of {k}: reference max {scale}")
            rel[k] = float((card[mode][k] - r).abs().max()) / scale
        worst = max(rel, key=rel.get)
        if rel[worst] > GRAD_RTOL:
            fail(f"ssl {mode}: gradient of {worst} disagrees with float64 autograd on the "
                 f"CPU ({rel[worst]:.3g} of its largest entry)")
        report[mode] = dict(
            loss_card=loss_card[mode], loss_cpu_f64=loss_ref[mode], parameters=len(ref[mode]),
            without_gradient=sorted(k for k, _ in heads[mode].named_parameters()
                                    if k not in ref[mode]),
            grad_max_rel_err=rel[worst], grad_worst_parameter=worst)
    return report


def ssl_phase(recipe, data, graph, layout, seed, dev) -> tuple:
    """SSLPretrainer in both modes on the recommended recipe's backbone (S=40
    tfidf, precomputed scaler, gcn2 head, dropout 0.3, edge dropout 0.1,
    the fused op on the surrogate's layout), Adam 3e-3 with L2 1e-3 and
    clip 1.0: a captured step launches exactly 2 K1 + 2 K3 + 2 K4 on the
    tensor cores; SSL_COMPARED captured steps equal as many eager bodies bit
    for bit (each loss, the parameters, Adam's state, the generator);
    SSL_STEPS captured steps from a fresh state, their launches exact and
    the loss falling; warm ms of both; one step's gradients against float64
    (``ssl_gradient_check``); the static-shape negative draw on the card
    only ever picks valid nodes. Returns ({mode: launches of the
    SSL_STEPS steps}, report)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.train.ssl import _ssl_step_body, draw_negatives, make_ssl_train_step

    step_want = launches(k1=2, k3=2, k4=2)
    report, counts_by_mode = {}, {}
    for mode in SSL_MODES:
        name = f"ssl {mode}"
        one, twin = ssl_model(recipe, mode, data, seed, dev), ssl_model(recipe, mode, data,
                                                                       seed, dev)
        state, state_e = ssl_state(one, seed), ssl_state(twin, seed)
        step, eager = make_ssl_train_step(one), _ssl_step_body(twin)
        eaf.reset_launch_counts()
        first, first_ms, peak = first_call(lambda: step(state, graph, layout))
        per_step = eaf.launch_counts()
        if per_step != step_want:
            fail(f"{name}: one captured step launched {per_step}, expected {step_want}")
        bodies = used(tensor_cores_only(name, per_step, ("tc",)))
        losses = []
        for i in range(SSL_COMPARED):
            got = first[1]["loss"] if i == 0 else step(state, graph, layout)[1]["loss"]
            if not torch.equal(got, eager(state_e, graph, layout)[1]["loss"]):
                fail(f"{name}: captured step {i} loss differs from the eager body's")
            losses.append(float(got))
        pairs = {k: (p.detach(), q.detach())
                 for (k, p), q in zip(one.named_parameters(), twin.parameters())}
        for i, (p, q) in enumerate(zip(state.optimizer.params, state_e.optimizer.params)):
            for k, t in state.optimizer.adam.state[p].items():
                pairs[f"adam_{i}_{k}"] = (t, state_e.optimizer.adam.state[q][k])
        pairs["generator"] = (state.generator.get_state(), state_e.generator.get_state())
        if state.step != state_e.step:
            fail(f"{name}: {state.step} captured steps against {state_e.step} eager")
        compared = dict(steps=state.step, compared=len(pairs),
                        max_abs_diff=bit_for_bit(name, pairs))
        warm = dict(captured_ms=sync_ms(lambda: step(state, graph, layout), 10),
                    eager_ms=sync_ms(lambda: eager(state_e, graph, layout), 10))

        fresh = ssl_model(recipe, mode, data, seed, dev)
        st = ssl_state(fresh, seed)
        train = make_ssl_train_step(fresh)
        head = fresh.backbone.final_linear_out.weight.detach().clone()
        eaf.reset_launch_counts()
        t0 = time.perf_counter()
        run = [train(st, graph, layout)[1]["loss"] for _ in range(SSL_STEPS)]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = eaf.launch_counts()
        want = {k: SSL_STEPS * n for k, n in step_want.items()}
        if counts != want:
            fail(f"{name}: {SSL_STEPS} captured steps launched {counts}, expected {want}")
        tensor_cores_only(name, counts, ("tc",))
        losses_run = [float(v) for v in run]
        head_moved = float((fresh.backbone.final_linear_out.weight - head).abs().max())
        if not head_moved > 0.0:
            fail(f"{name}: the classifier head (outside the loss) did not move under L2")
        counts_by_mode[mode] = counts
        report[mode] = dict(
            per_step_launches=per_step, per_step_bodies=bodies, first_call_ms=first_ms,
            first_call_max_memory_allocated=peak, captured_equals_eager=compared,
            compared_losses=losses, captured_step_warm_ms=warm["captured_ms"],
            eager_step_warm_ms=warm["eager_ms"], capture_ms=first_ms - warm["captured_ms"],
            train_s=train_s, launches=counts,
            **loss_fell(name, losses_run, k=5), head_max_abs_change=head_moved)
    report["gradient_check"] = ssl_gradient_check(recipe, data, graph, layout, seed, dev)
    # the draw alone, as the step makes it: only valid nodes, spread evenly
    gen = torch.Generator(device=dev).manual_seed(seed)
    neg = draw_negatives(gen, graph.senders.shape[0], 5, graph.num_nodes_padded,
                         graph.node_mask)
    if not bool(graph.node_mask[neg].all()):
        fail("ssl: a negative drawn on the card is not a valid node")
    per_node = torch.bincount(neg.reshape(-1), minlength=graph.num_nodes_padded)
    per_node = per_node[graph.node_mask].double()
    report["negatives"] = dict(draws=neg.numel(), valid_nodes=int(graph.node_mask.sum()),
                               per_node_min=int(per_node.min()), per_node_max=int(per_node.max()),
                               chi_square=float(((per_node - per_node.mean()) ** 2).sum()
                                                / per_node.mean()))
    return counts_by_mode, report


def driver_run(name, train, want, dev, falls, **kw) -> tuple:
    """One driver's ``train`` through its entry point, its launch counts set
    to 0 just before and read just after (exact: ``want``), the run's
    seconds, its loss falling from the first epoch's to the last's where
    ``falls``, its history.csv written in its run dir and copied to
    DRIVERS_DIR. Returns (launches, result, report)."""
    from ampnet_tpu_torch.interpret.curves import history_to_csv
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    eaf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = train(device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = eaf.launch_counts()
    if counts != want:
        fail(f"driver {name} launched {counts}, expected {want}")
    bodies = used(tensor_cores_only(name, counts, ("tc",)))
    history, final = result["history"], result["final_metrics"]
    losses = [row["loss"] for row in history]
    if not finite(losses + list(final.values())):
        fail(f"driver {name}: a non-finite loss or metric ({final})")
    if falls and not losses[-1] < losses[0]:
        fail(f"driver {name}: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})")
    csv = Path(history_to_csv(history, os.path.join(result["run_dir"], "history.csv")))
    DRIVERS_DIR.mkdir(parents=True, exist_ok=True)
    shutil.copy(csv, DRIVERS_DIR / f"{name}_history.csv")
    return counts, result, dict(
        seconds=seconds, epochs=len(history), loss_first=losses[0], loss_last=losses[-1],
        final_test_acc=final.get("test_acc"), final_val_acc=final.get("val_acc"),
        launches=counts, bodies=bodies, history_csv=str(csv.relative_to(RUNS_DIR.parents[1])))


def drivers_phase(dev) -> tuple:
    """The main path's drivers as a user runs them (on the card, the
    surrogate): cora_benchmark_full --raw-residual for its whole 150
    epochs (2 K1 + 2 K3 + 2 K4 a step, 8-draw evals every 10 epochs and at
    the end: test accuracy >= MIN_FULL_TEST_ACC), then
    cora_benchmark_graphsaint --stabilized --fused --raw-residual --decay-lr
    cut to SAINT_DRIVER_EPOCHS epochs of 200 subgraphs (an 8-draw eval an
    epoch and at the end). Returns ({driver: launches}, the full driver's
    run dir, report)."""
    from ampnet_tpu_torch.experiments import cora_benchmark_full as full
    from ampnet_tpu_torch.experiments import cora_benchmark_graphsaint as saint

    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    epochs = 150
    evals = epochs // 10 + 1
    want = launches(k1=2 * epochs + 16 * evals, k3=2 * epochs, k4=2 * epochs)
    counts_full, result, rep_full = driver_run(
        "cora_benchmark_full", full.train, want, dev, True, epochs=epochs, raw_residual=True,
        run_base=str(RUNS_DIR / "full"))
    acc = rep_full["final_test_acc"]
    if not acc >= MIN_FULL_TEST_ACC:
        fail(f"driver cora_benchmark_full --raw-residual: final test accuracy {acc:.4f} "
             f"below {MIN_FULL_TEST_ACC}")
    rep_full.update(command="cora_benchmark_full --raw-residual", train_full_batch_s=
                    rep_full["seconds"], jax_band=JAX_FULL_BAND, port_path_c_band=PORT_C_BAND)

    steps = SAINT_DRIVER_EPOCHS * 200
    want_s = launches(k1=2 * steps + 16 * (SAINT_DRIVER_EPOCHS + 1), k3=2 * steps, k4=2 * steps)
    counts_saint, _, rep_saint = driver_run(
        "cora_benchmark_graphsaint", saint.train, want_s, dev, False,
        epochs=SAINT_DRIVER_EPOCHS,
        stabilized=True, fused=True, raw_residual=True, decay_lr=True,
        run_base=str(RUNS_DIR / "saint"))
    rep_saint.update(command="cora_benchmark_graphsaint --stabilized --fused --raw-residual "
                             f"--decay-lr --epochs {SAINT_DRIVER_EPOCHS}",
                     cut=f"{SAINT_DRIVER_EPOCHS} of 50 epochs (200 subgraphs each)",
                     train_saint_s=rep_saint["seconds"], steps=steps,
                     per_step_launches=launches(k1=2, k3=2, k4=2),
                     per_eval_launches=launches(k1=16))
    return ({"cora_benchmark_full": counts_full, "cora_benchmark_graphsaint": counts_saint},
            result["run_dir"],
            {"cora_benchmark_full": rep_full, "cora_benchmark_graphsaint": rep_saint})


def interpret_phase(run_dir, data, graph, seed, dev) -> dict:
    """visualize_cora_attn_coeffs's numbers from the full driver's final
    checkpoint (its model flags: --stabilized --raw-residual gcn2, the
    plain convs, as in JAX): the heatmaps of class pairs (0,0), (3,3) and
    (0,3) from one card forward on the padded x and y, against the same
    heatmaps from a CPU float64 forward of the same params and
    sampled_idx, at the model limits; the activation stages of the card's
    aux and the flattened gradients of one training step, all finite."""
    import numpy as np

    from ampnet_tpu_torch.experiments import visualize_cora_attn_coeffs as viz
    from ampnet_tpu_torch.interpret.attention import attention_heatmaps
    from ampnet_tpu_torch.interpret.histograms import (_flatten_weight_grads,
                                                       activation_stages_from_aux)
    from ampnet_tpu_torch.train.state import training_loss

    model = viz.build_model(data, stabilized=True, raw_residual="gcn2",
                            checkpoint_path=os.path.join(run_dir, "checkpoint_final.pkl"),
                            device=dev)
    t0 = time.perf_counter()
    card = viz.attention_inputs(model, graph, seed=seed)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_model = copy.deepcopy(model).to("cpu", torch.float64)
    g64 = graph.to("cpu")
    g64.x = g64.x.double()
    ref = viz.attention_inputs(ref_model, g64, sampled_idx=torch.from_numpy(card["sampled_idx"]))
    ref_s = time.perf_counter() - t0
    heat = attention_heatmaps(**card, class_pairs=viz.CLASS_PAIRS)
    want = attention_heatmaps(**ref, class_pairs=viz.CLASS_PAIRS)
    pairs = {}
    for pair, (h, src_top, dst_top) in heat.items():
        w = want[pair][0]
        err = float(abs(h - w).max())
        if not (np.isfinite(h).all() and torch.allclose(
                torch.from_numpy(h), torch.from_numpy(w), rtol=MODEL_RTOL, atol=MODEL_ATOL)):
            fail(f"interpret: heatmap {pair} on the card disagrees with float64 ({err:.3g})")
        pairs[f"{pair[0]}->{pair[1]}"] = dict(max_abs_err=err, mean=float(h.mean()),
                                              max=float(h.max()), cells=int((h != 0).sum()))
    gdev = graph.to(dev)
    with torch.no_grad():
        out = model(gdev, generator=torch.Generator(device=dev).manual_seed(seed),
                    return_aux=True)
    stages = activation_stages_from_aux(out.aux, out.logits)
    model.zero_grad(set_to_none=True)
    logits = model(gdev, deterministic=False, generator=torch.Generator(device=dev)
                   .manual_seed(seed))
    training_loss("full", logits, gdev).backward()
    flat = _flatten_weight_grads({n: p.grad for n, p in model.named_parameters()})
    bad = [k for k, v in {**stages, **flat}.items() if not np.isfinite(v).all()]
    if bad or not flat or len(stages) != 7:
        fail(f"interpret: stages {sorted(stages)}, {len(flat)} flattened gradients, "
             f"non-finite: {bad}")
    return dict(checkpoint="checkpoint_final.pkl of cora_benchmark_full --raw-residual",
                heatmaps=pairs, card_forward_s=card_s, cpu_f64_s=ref_s, stages=sorted(stages),
                flattened_gradients=len(flat))


def entry_phase(dev) -> dict:
    """graft_entry.entry()'s fn on the card (the flagship forward, one
    captured predict graph): [768, 7] log-probs, no kernel launched (the
    JAX defaults: the plain path), captured = eager bit for bit from one
    generator state, and that draw against the CPU float64 forward at the
    model limits; warm ms of fn."""
    from ampnet_tpu_torch.graft_entry import entry
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    eaf.reset_launch_counts()
    fn, (g, gen) = entry(device=dev)
    start = gen.get_state()
    _, first_ms, _ = first_call(lambda: fn(g, gen))
    gen.set_state(start)
    out = fn(g, gen).clone()
    counts = eaf.launch_counts()
    if tuple(out.shape) != (768, 7) or not bool(torch.isfinite(out).all()):
        fail(f"entry: fn gave {tuple(out.shape)}, finite={bool(torch.isfinite(out).all())}")
    if any(counts.values()):
        fail(f"entry: the plain flagship launched {counts}")
    eager_gen = torch.Generator(device=g.x.device)
    eager_gen.set_state(start)
    with torch.no_grad():
        eager = fn.model(g, generator=eager_gen, return_aux=True)
    if not torch.equal(out, eager.logits):
        fail("entry: the captured forward differs from the eager one")
    if not torch.equal(gen.get_state(), eager_gen.get_state()):
        fail("entry: the captured forward advanced the generator unlike the eager one")
    err = f64_check("entry", fn.model, g, None, eager.aux["sampled_idx"])
    return dict(shape=list(out.shape), launches=counts, first_call_ms=first_ms,
                warm_ms=sync_ms(lambda: fn(g, gen), 10), captured_equals_eager=True,
                cpu_f64_max_abs_err=err, use_pallas=fn.model.config.use_pallas)


# ---------------------------------------------------------------- the experiments phase

# the remaining drivers of experiments/ through their entry functions on the
# card; each cut below is listed in the line (`cuts`)
EXP_EPOCHS = 20                   # the seed and tuning drivers: of their 300
EXP_SEEDS = (1, 2)                # seed_robustness, seed_ensemble: of (1, 2, 3)
XOR_SAINT_DRIVER_EPOCHS = 10      # synthetic_training_modular_graphsaint: of 50
GRID = dict(noise_stds=(0.3,), repeats=2, workers=2)   # of 6 x 5, 100 epochs each
LINEAR_EPOCHS = 2                 # cora_linear_layer_baseline: of 10
SCALING_SHARDS = 2                # scaling_bench: of 1, 2, 4, 8 ranks
HALO_MEASURED_SHARDS = 2          # halo_comm_accounting --measured: of 8 ranks
TIMING_ITERS = 10                 # partitioned_graph1_timing: its default
# halo_budget_run at the JAX driver's shape (1,048,576 nodes, 262,144 edges,
# window 8192) on its 2 ranks, both on this one card: the plain step with
# remat (the lean conv) holds a rank's peak near its halo K|V buffer; a
# rank over HALO_PEAK_LIMIT times its buffer fails (the design's floor is
# ~3.5: conv2's input, K|V, dsum, dK|V and the input's gradient)
HALO_BUDGET_FULL = dict(nodes=1_048_576, edges=262_144, window=8192)
HALO_PEAK_LIMIT = 3.8
OVERFIT_MIN_ACC = 0.95


def experiment_run(name, fn, want, dev, **kw) -> tuple:
    """One driver's entry function on the card, after the earlier phases'
    captured graphs are collected (``release_graphs``), its launch counts
    set to 0 just before and read just after (exact: ``want``; the plain
    drivers' none), on the tensor cores. Returns (result, report)."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    memory = release_graphs()
    eaf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = eaf.launch_counts()
    if counts != want:
        fail(f"experiments: {name} launched {counts}, expected {want}")
    bodies = used(tensor_cores_only(name, counts, ("tc",)))
    return result, dict(seconds=seconds, launches={k: n for k, n in counts.items() if n},
                        bodies=bodies, memory_reserved_before=memory["memory_reserved"])


def times(k: int, per: dict) -> dict:
    return {n: k * c for n, c in per.items()}


def plus(*counts) -> dict:
    return {n: sum(c[n] for c in counts) for n in KERNELS}


def experiments_phase(full_run, per_eval_k, per_eval_k_saint, dev) -> tuple:
    """Every driver of experiments/ that the earlier phases do not run,
    through its entry function (its cuts in EXP_* above): eval_checkpoint
    on the full driver's checkpoint_best.pkl (--stabilized --raw-residual
    gcn2 --fused: 16 K1, test accuracy >= MIN_FULL_TEST_ACC); the seed and
    tuning drivers on the plain convs (no launch); the XOR drivers on the
    fused kernels (launches exact: path K's per step and per eval);
    grid_search in a pool of 2 children on the card; the freeze check (conv1
    bit for bit); the MSE trainer; the RPG generator; the overfit harness
    (train accuracy >= OVERFIT_MIN_ACC); the linear baseline; the LR
    schedule; partitioned_graph1_timing (a one-rank NCCL group: its ratio,
    its first loss against the single-device step's, launches exact);
    scaling_bench and halo_comm_accounting's measured bytes on ranks
    sharing the card (the counted halo bytes against the plan's);
    halo_budget_run at HALO_BUDGET_FULL (a rank's peak within
    HALO_PEAK_LIMIT of its halo K|V buffer). Returns ({driver: launches},
    report)."""
    from ampnet_tpu_torch.experiments import (
        ampnet_freeze_check, cora_linear_layer_baseline, cora_overfit_one_subgraph,
        cosine_lr_scheduler_test, eval_checkpoint, grid_search, halo_budget_run,
        halo_comm_accounting, partitioned_graph1_timing, raw_residual_tuning, scaling_bench,
        seed_ensemble, seed_robustness, synthetic_rgb_generate, synthetic_training,
        synthetic_training_modular, synthetic_training_modular_graphsaint,
        token_scale_tuning, transformer_tuning)

    none = launches()
    step_k = launches(k1=2, k3=2, k4=2)
    report, by_driver = {}, {}
    report["cuts"] = dict(
        seed_and_tuning_epochs=f"{EXP_EPOCHS} of 300", seeds=f"{list(EXP_SEEDS)} of [1, 2, 3]",
        raw_residual_tuning="gcn2_drop0.3_adj0.1_wd1e-3 of 5 configs",
        transformer_tuning="drop0.3_adj0.2_wd1e-3 of 3 configs",
        synthetic_training_modular_graphsaint=f"{XOR_SAINT_DRIVER_EPOCHS} of 50 epochs",
        grid_search=f"noise {list(GRID['noise_stds'])} of 6 levels, {GRID['repeats']} of 5 "
                    f"repeats, {GRID['workers']} workers",
        cora_linear_layer_baseline=f"{LINEAR_EPOCHS} of 10 epochs",
        scaling_bench=f"1 and {SCALING_SHARDS} ranks of 1, 2, 4, 8",
        halo_comm_accounting=f"measured on {HALO_MEASURED_SHARDS} of 8 ranks")

    def record(name, result_report, counts=None):
        report[name] = result_report
        if counts is not None:
            by_driver[name] = counts

    # eval_checkpoint on the full driver's banked best
    res, rep = experiment_run("eval_checkpoint", eval_checkpoint.evaluate, launches(k1=16),
                              dev, path=full_run, stabilized=True, raw_residual="gcn2",
                              fused=True)
    if not res["test_acc"] >= MIN_FULL_TEST_ACC:
        fail(f"experiments: eval_checkpoint test accuracy {res['test_acc']:.4f} below "
             f"{MIN_FULL_TEST_ACC}")
    rep.update(checkpoint=os.path.basename(res["checkpoint"]), val_acc=res["val_acc"],
               test_acc=res["test_acc"], eval_s=res["eval_s"],
               command="eval_checkpoint <cora_benchmark_full run> --stabilized "
                       "--raw-residual gcn2 --fused")
    record("eval_checkpoint", rep, launches(k1=16))

    # the seed and tuning drivers: plain convs
    res, rep = experiment_run("seed_robustness", seed_robustness.run, none, dev,
                              epochs=EXP_EPOCHS, seeds=EXP_SEEDS)
    rep.update(test=res["test"], val=res["val"])
    record("seed_robustness", rep)
    res, rep = experiment_run("seed_ensemble", seed_ensemble.run, none, dev,
                              epochs=EXP_EPOCHS, seeds=EXP_SEEDS)
    rep.update({k: res[k] for k in ("val_acc", "test_acc", "single_test_accs")})
    record("seed_ensemble", rep)
    for name, mod, kw in (
            ("raw_residual_tuning", raw_residual_tuning,
             dict(configs="gcn2_drop0.3_adj0.1_wd1e-3")),
            ("token_scale_tuning", token_scale_tuning, dict(s="64")),
            ("transformer_tuning", transformer_tuning, dict(configs="drop0.3_adj0.2_wd1e-3"))):
        res, rep = experiment_run(name, mod.run, none, dev, epochs=EXP_EPOCHS, **kw)
        rep["rows"] = [{k: v for k, v in r.items() if k != "final_metrics"}
                       | {"test_acc": r["final_metrics"]["test_acc"],
                          "val_acc": r["final_metrics"]["val_acc"]} for r in res]
        if not finite([r["test_acc"] for r in rep["rows"]]):
            fail(f"experiments: {name} gave a non-finite accuracy")
        record(name, rep)

    # the XOR family on the fused kernels at path K's shape
    epochs = synthetic_training_modular.ARGS["epochs"]
    want = plus(times(epochs, step_k), times(epochs, per_eval_k))
    runs = RUNS_DIR / "experiments"
    res, rep = experiment_run("synthetic_training_modular", synthetic_training_modular.train,
                              want, dev, run_base=str(runs / "xor"))
    ckpts = sorted(p.name for p in Path(res["run_dir"]).glob("checkpoint_ep*.pkl"))
    if len(ckpts) != epochs // 20:
        fail(f"experiments: synthetic_training_modular wrote {ckpts}")
    rep.update(epochs=epochs, max_train_acc=res["max_train_acc"],
               max_test_acc=res["max_test_acc"], checkpoints=len(ckpts),
               loss_first=res["history"][0]["loss"], loss_last=res["history"][-1]["loss"])
    record("synthetic_training_modular", rep, want)
    steps = XOR_SAINT_DRIVER_EPOCHS * 10
    want = plus(times(steps, step_k), times(XOR_SAINT_DRIVER_EPOCHS, per_eval_k_saint))
    res, rep = experiment_run("synthetic_training_modular_graphsaint",
                              synthetic_training_modular_graphsaint.train, want, dev,
                              args={"epochs": XOR_SAINT_DRIVER_EPOCHS},
                              run_base=str(runs / "xor_saint"))
    rep.update(steps=steps, max_train_acc=res["max_train_acc"],
               max_test_acc=res["max_test_acc"])
    record("synthetic_training_modular_graphsaint", rep, want)
    res, rep = experiment_run("grid_search", grid_search.controller, none, dev,
                              run_base=str(runs / "grid"), **GRID)
    child = plus(times(grid_search.EPOCHS, step_k), times(grid_search.EPOCHS, per_eval_k))
    child = {k: n for k, n in child.items() if n}
    for where in res["where"]:
        if not where["device"].startswith("cuda") or where["launches"] != child:
            fail(f"experiments: a grid_search child trained on {where['device']} and "
                 f"launched {where['launches']}, expected cuda and {child}")
    if len({w["pid"] for w in res["where"]}) != GRID["workers"]:
        fail(f"experiments: grid_search ran in {res['where']}, not {GRID['workers']} children")
    if not (Path(res["run_base"]) / "grid_search.csv").exists():
        fail("experiments: grid_search wrote no grid_search.csv")
    rep.update(results=res["results"], children=res["where"])
    record("grid_search", rep, {k: sum(w["launches"].get(k, 0) for w in res["where"])
                                for k in KERNELS})

    # the sanity harnesses and baselines
    res, rep = experiment_run("ampnet_freeze_check", ampnet_freeze_check.train_model, none, dev)
    if res["conv1_max_delta"] != 0.0:
        fail(f"experiments: a frozen conv1 parameter moved by {res['conv1_max_delta']}")
    rep.update(conv1_max_delta=res["conv1_max_delta"], trainable=res["trainable"],
               loss_first=res["losses"][0], loss_last=res["losses"][-1],
               train_acc_last=res["train_accs"][-1])
    record("ampnet_freeze_check", rep)
    res, rep = experiment_run("synthetic_training", synthetic_training.train, none, dev,
                              run_base=str(runs / "mse"), draw=False)
    rep.update({k: res[k] for k in ("final_test_acc", "max_test_acc", "max_train_acc")})
    record("synthetic_training", rep)
    t0 = time.perf_counter()
    paths = synthetic_rgb_generate.main(["-o", str(runs / "rgb")])
    record("synthetic_rgb_generate", dict(seconds=time.perf_counter() - t0,
                                          splits=sorted(paths), host_only=True))
    res, rep = experiment_run("cora_overfit_one_subgraph", cora_overfit_one_subgraph.main,
                              none, dev)
    if not res["train_acc"] >= OVERFIT_MIN_ACC:
        fail(f"experiments: the overfit harness reached {res['train_acc']:.4f} train "
             f"accuracy, below {OVERFIT_MIN_ACC}")
    rep.update(train_acc=res["train_acc"], loss=res["loss"], nodes=res["nodes"],
               edges=res["edges"])
    record("cora_overfit_one_subgraph", rep)
    res, rep = experiment_run("cora_linear_layer_baseline", cora_linear_layer_baseline.main,
                              none, dev, epochs=LINEAR_EPOCHS)
    rep.update(test_acc=res["test_acc"], epoch_losses=res["epoch_losses"])
    if not finite([res["test_acc"], *res["epoch_losses"]]):
        fail("experiments: the linear baseline gave a non-finite loss or accuracy")
    record("cora_linear_layer_baseline", rep)
    rates = cosine_lr_scheduler_test.main()
    record("cosine_lr_scheduler_test", dict(rates=len(rates), first=rates[0], last=rates[-1],
                                            host_only=True))

    # partitioned timing and halo accounting, over parallel/*
    res, rep = experiment_run("partitioned_graph1_timing", partitioned_graph1_timing.run,
                              none, dev, iters=TIMING_ITERS)
    got = res["launches"]
    part = {k: n for k, n in plus(step_k).items() if n}
    want_t = {"single": {K1_: 2 * res["steps"], K5_: 2 * res["steps"]},
              "partitioned_fused": times(res["steps"], part),
              "partitioned_fused_deviceloop": times(res["loop_steps"], part),
              "partitioned_xla": {}, "partitioned_xla_deviceloop": {}}
    if got != want_t:
        fail(f"experiments: partitioned_graph1_timing launched {got}, expected {want_t}")
    gap = abs(res["loss_partitioned"] - res["loss_single"]) / abs(res["loss_single"])
    if not (res["loss_finite"] and gap <= MODEL_RTOL and res["backend"] == "nccl"):
        fail(f"experiments: partitioned_graph1_timing losses {res['loss_partitioned']} vs "
             f"{res['loss_single']} (backend {res['backend']})")
    rep.update({k: v for k, v in res.items() if k != "note"}, loss_rel_gap=gap,
               launches=got)
    record("partitioned_graph1_timing", rep, plus(
        launches(k1=2 * res["steps"], k5=2 * res["steps"]),
        times(res["steps"] + res["loop_steps"], step_k)))
    res, rep = experiment_run("scaling_bench", scaling_bench.main, none, dev,
                              max_shards=SCALING_SHARDS, use_halo=True)
    rep["shards"] = res
    record("scaling_bench", rep)
    t0 = time.perf_counter()
    table = halo_comm_accounting.analytic()
    analytic_s = time.perf_counter() - t0
    res, rep = experiment_run("halo_comm_accounting", halo_comm_accounting.measured, none,
                              dev, n_shards=HALO_MEASURED_SHARDS)
    plan_halo = res["plan_halo_bytes_per_conv"]
    for r in res["halo"]:
        if r["moved"].get("halo_exchange") != 2 * plan_halo or \
                r["moved"].get("halo_exchange_bwd") != 2 * plan_halo:
            fail(f"experiments: rank {r['rank']} moved {r['moved']} in the halo step, the "
                 f"plan says {plan_halo} bytes per conv each way")
    for r in res["allgather"]:
        if r["moved"].get("all_gather") != 2 * res["plan_allgather_bytes_per_conv"]:
            fail(f"experiments: rank {r['rank']} moved {r['moved']} in the all-gather step")
    rep.update(analytic_s=analytic_s, analytic=table, measured=res)
    record("halo_comm_accounting", rep)
    # halo_budget_run at the JAX shape, both ranks on this card
    res, rep = experiment_run("halo_budget_run", halo_budget_run.run, none, dev,
                              **HALO_BUDGET_FULL)
    if not res["ok"]:
        fail(f"experiments: halo_budget_run gave a non-finite loss ({res.get('loss')})")
    ranks = [dict({k: r.get(k) for k in ("rank", "n_loc", "halo_width", "seconds", "peak_gb",
                                         "spans", "moved", "staged", "loss", "prepare_s")},
                  peak_over_halo_kv=r["peak_gb"] / res["halo_kv_gb"]) for r in res["ranks"]]
    worst = max(r["peak_over_halo_kv"] for r in ranks)
    if worst > HALO_PEAK_LIMIT:
        fail(f"experiments: halo_budget_run's rank peaked at {worst:.3f} times its halo K|V "
             f"buffer ({res['halo_kv_gb']:.2f} GiB), limit {HALO_PEAK_LIMIT}")
    rep.update({k: v for k, v in res.items() if k not in ("ranks", "seconds")},
               step_s=res["seconds"], peak_over_halo_kv=worst, limit=HALO_PEAK_LIMIT,
               ranks=ranks)
    record("halo_budget_run", rep)
    shutil.rmtree(runs, ignore_errors=True)
    return by_driver, report


# ---------------------------------------------------------------- the parallel phase

# the recipe partitioned over graph=2 against the single-device port on the
# card: log-probs (MODEL_RTOL / MODEL_ATOL), one step's gradients (GRAD_RTOL
# of each gradient's largest entry); the halo's kernels at each rank's shape
# against their plain versions (KERNEL_RTOL / KERNEL_ATOL)
PARALLEL_TILE_NODES = 256
# the distributed GraphSAINT driver on 2 ranks: epochs x subgraphs per rank
# (the JAX driver's 30 x 10 cut to 3 x 10); its loss must fall from the first
# epoch's median to the last's (a subgraph's weighted loss can jump several
# fold: measured 0.41 among ~0.08 on an H100)
DRIVER_EPOCHS, DRIVER_STEPS = 3, 10


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _rank_launches(eaf) -> dict:
    """The launches by body of the kernels a partitioned step may run."""
    counts = eaf.body_launch_counts()
    return {k: {b: n for b, n in counts[k].items() if n}
            for k in (K1_, K3_, K4_, K5_) if eaf.launch_counts()[k]}


def _grads(model) -> dict:
    return {k: p.grad.detach().cpu().numpy().copy() for k, p in model.named_parameters()}


def _partitioned_kernel_rows(rank, mesh, lay, plan, pg, s, d, h) -> dict:
    """K1, K3, K4 and K5 + pass B at this rank's partitioned shape (queries
    its N_loc rows, K|V its N_loc + halo rows), random rows, against their
    plain versions on the same card tensors; ms (20 launches after one), the
    plain version's ms, the bound by PERF.md's rule."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    index = (mesh.index("graph"),)
    loc = lay.local(index, mesh.device)
    walk = (loc.tile_senders, loc.tile_valid, loc.recv_ptr, loc.recv_slots)
    snd = (loc.snd_receivers, loc.snd_valid, loc.snd_ptr, loc.snd_slots)
    n_loc, n_all = pg.x.shape[1], pg.x.shape[1] + plan.halo_width
    nt, ntg = loc.recv_ptr.numel() - 1, loc.snd_ptr.numel() - 1
    sp = -(-s // 8) * 8
    gen = torch.Generator(device=mesh.device).manual_seed(100 + rank)
    q = torch.randn(nt * sp, d, generator=gen, device=mesh.device)
    dsum = torch.randn(nt * sp, d, generator=gen, device=mesh.device)
    kv = torch.randn(ntg * sp, 2 * d, generator=gen, device=mesh.device)
    kv_all = kv[: n_all * sp]
    qdm = torch.cat([q, dsum], dim=1)
    kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
    edges = int(loc.recv_ptr[-1])
    index_bytes = 4 * (2 * loc.tile_senders.numel() + loc.recv_ptr.numel()
                       + loc.recv_slots.numel())
    snd_index_bytes = 4 * (2 * loc.snd_receivers.numel() + loc.snd_ptr.numel()
                           + loc.snd_slots.numel())
    q_bytes, kv_bytes = 4 * d * n_loc * s, 4 * 2 * d * n_all * s
    take = sb.walked_slots(loc.tile_senders, loc.recv_ptr, (0, loc.tile_senders.shape[0]))

    def pass_b_plain():
        dq_p, stream = sb.edge_attention_bwd_stream_plain(q, kv_all, dsum, *walk, **kw)
        out = torch.zeros(n_all, s, 2 * d, device=mesh.device)
        return dq_p, sb.stream_to_senders(stream, loc.tile_senders, take, 0, out, s=s, sp=sp)

    cases = {
        # name: (kernel, plain, bytes, flops, source, replaces)
        K1_: (lambda: eaf.edge_attention_sums(q, kv_all, *walk, **kw),
              lambda: eaf.edge_attention_sums_plain(q, kv_all, *walk, **kw),
              2 * q_bytes + kv_bytes + index_bytes, 4 * s * s * d * edges,
              "edge_attention_tc.cu", "edge_attention_fused.py:691"),
        K3_: (lambda: bwd.edge_attention_bwd_dq(q, kv_all, dsum, *walk, **kw),
              lambda: bwd.edge_attention_bwd_dq_plain(q, kv_all, dsum, *walk, **kw),
              3 * q_bytes + kv_bytes + index_bytes, 6 * s * s * d * edges,
              "edge_attention_bwd_dq_tc.cu", "edge_attention_bwd_scatterfree.py:167"),
        K4_: (lambda: bwd.edge_attention_bwd_dkv(qdm, kv, *snd, **kw),
              lambda: bwd.edge_attention_bwd_dkv_plain(qdm, kv, *snd, **kw),
              2 * q_bytes + 2 * kv_bytes + snd_index_bytes, 8 * s * s * d * edges,
              "edge_attention_bwd_tc.cu", "edge_attention_bwd_scatterfree.py:280"),
        K5_: (lambda: sb.stream_backward(q, kv_all, dsum, *walk, **kw),
              pass_b_plain,
              # the function from q, dsum, K|V to dQ and dK|dV, timed whole: its
              # inputs read once, its outputs written once (the per-edge stream
              # between K5 and pass B is the kernel's choice, not the function's)
              3 * q_bytes + 2 * kv_bytes + index_bytes,
              10 * s * s * d * edges,
              "edge_attention_bwd_stream_tc.cu + pass B (edge_attention_bwd.py)",
              "edge_attention_bwd.py:178"),
    }
    rows = {}
    on_card = mesh.device.type == "cuda"
    for name, (run, plain, nbytes, flops, source, replaces) in cases.items():
        eaf.reset_launch_counts()
        got, want = run(), plain()
        _sync(mesh.device)
        body = {b: n for b, n in eaf.body_launch_counts()[name].items() if n}
        if on_card and body != {"tc": 1}:
            raise RuntimeError(f"{name} at the partitioned shape ran {body}, expected one "
                               f"tensor-core launch")
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        if not all(torch.allclose(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                   for a, b in zip(got, want)):
            raise RuntimeError(f"{name} at the partitioned shape disagrees with its plain "
                               f"version (max abs err {err:.3g})")
        b, by = bound_ms(nbytes, flops, True)
        rows[name] = dict(name=name, route="cuda",
                          source=f"ampnet_tpu_torch/ops/hopper/csrc/{source}",
                          replaces=f"ampnet_tpu/ops/pallas/{replaces}", max_abs_err=err,
                          ms=cuda_ms(run, 20) if on_card else None,
                          plain_ms=cuda_ms(plain, 3) if on_card else None, bound_ms=b,
                          bound_by=by, library_ms=None, n_loc=n_loc, n_all=n_all,
                          q_grid=nt, kv_grid=ntg, live_edges=edges, s=s)
    return rows


def parallel_rank(rank: int, payload: dict) -> dict:
    """One of two gloo ranks sharing the card: (b) the recipe partitioned
    over graph=2 with the halo (eval log-probs, one step's gradients through
    K3 + K4 and through K5 + pass B, the step's eager ms, the kernels at
    this rank's shape), (d) the head-parallel forward (heads 4 -> 2 + 2) and
    the distributed GraphSAINT driver. Reports to the parent; prints no
    JSON line."""
    from ampnet_tpu_torch.experiments import cora_benchmark_graphsaint_distributed as dist_saint
    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.parallel import (amp_gcn_forward_local, build_halo_plan,
                                           make_mesh, make_partitioned_train_step,
                                           partition_graph, partition_layouts)
    from ampnet_tpu_torch.parallel.head_parallel import amp_gcn_forward_heads, tp_shard_model
    from ampnet_tpu_torch.train.state import TrainState

    pin_ieee_f32()
    cfg, state, stats = payload["cfg"], payload["state"], payload["stats"]
    out = {"rank": rank}
    dev = payload["device"]
    mesh = make_mesh(graph=2, device=dev)
    g = payload["graph"]
    pg = partition_graph(g, 2)
    plan = build_halo_plan(pg)
    lay = partition_layouts(pg, tile_nodes=PARALLEL_TILE_NODES, halo_plan=plan)
    i = (mesh.index("graph"),)
    shard, loc, halo = pg.local(i, mesh.device), lay.local(i, mesh.device), \
        plan.local(i, mesh.device)
    sidx = torch.from_numpy(payload["part_idx"][i]).to(mesh.device)
    model = AMPGCN(cfg, scaler_stats=stats, device=mesh.device)
    model.load_state_dict(state)
    out.update(n_loc=pg.x.shape[1], n_all=pg.x.shape[1] + plan.halo_width,
               halo_offsets=list(plan.offsets), halo_rows=list(plan.sizes),
               pair_rows=plan.pair_counts[i].tolist())
    eaf.reset_launch_counts()
    with torch.no_grad():
        out["logits"] = amp_gcn_forward_local(model, shard, mesh, layout=loc,
                                              tile_nodes=PARALLEL_TILE_NODES, halo=halo,
                                              sampled_idx=sidx).cpu().numpy()
    _sync(dev)
    out["eval_launches"] = _rank_launches(eaf)
    st = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0),
                    torch.Generator(device=mesh.device))
    step = make_partitioned_train_step(model, mesh, loss_mode="full", use_pallas=True,
                                       tile_nodes=PARALLEL_TILE_NODES, use_halo=True)
    for route, scatterfree in (("scatterfree", True), ("stream", False)):
        eaf.SCATTERFREE_BWD_DEFAULT = scatterfree
        eaf.reset_launch_counts()
        before = dict(mesh.staged)
        _, m = step(st, shard, loc, halo, sampled_idx=sidx)
        _sync(dev)
        out[f"step_{route}"] = dict(
            loss=float(m["loss"]), launches=_rank_launches(eaf), grads=_grads(model),
            staged={k: n - before.get(k, 0) for k, n in mesh.staged.items()})
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            step(st, shard, loc, halo, sampled_idx=sidx)
        _sync(dev)
        out[f"step_{route}"]["eager_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        # the same steps with the collectives timed (each synchronizes the
        # card before and after itself): ms per step in each, the wait for
        # the peer rank included, and the whole step's ms under that timing
        mesh.spans = {}
        t0 = time.perf_counter()
        for _ in range(reps):
            step(st, shard, loc, halo, sampled_idx=sidx)
        _sync(dev)
        out[f"step_{route}"].update(
            timed_ms=(time.perf_counter() - t0) * 1e3 / reps,
            collective_ms={k: v * 1e3 / reps for k, v in sorted(mesh.spans.items())})
        mesh.spans = None
    eaf.SCATTERFREE_BWD_DEFAULT = True
    # the kernels at this rank's shape, one rank after the other: the two
    # share the card, and a time taken beside the other's launches is not
    # the kernel's
    for r in range(2):
        if r == rank:
            out["kernels"] = _partitioned_kernel_rows(rank, mesh, lay, plan, pg,
                                                      cfg.num_sampled_vectors,
                                                      cfg.embedding_dim, cfg.num_heads)
        torch.distributed.barrier()

    # (d) heads 4 -> 2 + 2 on the whole graph, the same draw
    tp_mesh = make_mesh(heads=2, device=dev)
    tp_model = AMPGCN(cfg, scaler_stats=stats, device=mesh.device)
    tp_model.load_state_dict(state)
    tp_shard_model(tp_model, tp_mesh)
    with torch.no_grad():
        out["tp_logits"] = amp_gcn_forward_heads(
            tp_model, g.to(mesh.device), tp_mesh,
            sampled_idx=torch.from_numpy(payload["full_idx"]).to(mesh.device)).cpu().numpy()
    out["tp_staged"] = dict(tp_mesh.staged)
    out["driver"] = dist_saint.run_rank(rank, DRIVER_EPOCHS, DRIVER_STEPS, 2, device=dev)
    return out


def nccl_rank(rank: int, payload: dict) -> dict:
    """(c) a one-rank NCCL group: the data x graph = 1 x 1 partitioned step
    (layouts, halo plan with no offsets) on the whole graph, its gradients."""
    import torch.distributed as dist

    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.parallel import (build_halo_plan, make_dp_partitioned_train_step,
                                           make_mesh, partition_graph, partition_layouts,
                                           stack_halos, stack_layouts, stack_partitioned)
    from ampnet_tpu_torch.train.state import TrainState

    pin_ieee_f32()
    mesh = make_mesh(data=1, graph=1, device=payload["device"])
    pg = partition_graph(payload["graph"], 1)
    plan = build_halo_plan(pg)
    lay = partition_layouts(pg, tile_nodes=PARALLEL_TILE_NODES, halo_plan=plan)
    model = AMPGCN(payload["cfg"], scaler_stats=payload["stats"], device=mesh.device)
    model.load_state_dict(payload["state"])
    st = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0),
                    torch.Generator(device=mesh.device))
    step = make_dp_partitioned_train_step(model, mesh, loss_mode="full", use_pallas=True,
                                          tile_nodes=PARALLEL_TILE_NODES, use_halo=True)
    eaf.reset_launch_counts()
    _, m = step(st, stack_partitioned([pg]), stack_layouts([lay]), stack_halos([plan]),
                sampled_idx=payload["part_idx_1"][None])
    _sync(mesh.device)
    return dict(backend=dist.get_backend(), loss=float(m["loss"]), grads=_grads(model),
                launches=_rank_launches(eaf), staged=dict(mesh.staged),
                groups={a: g is not None for a, g in mesh.groups.items()})


def _grad_gap(name, got: dict, want: dict) -> float:
    """The largest gradient gap over the parameters, each over its
    gradient's largest entry; fails above GRAD_RTOL."""
    import numpy as np

    worst = 0.0
    for k, w in want.items():
        gap = float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
        if gap > GRAD_RTOL:
            fail(f"parallel {name}: gradient of {k} {gap:.3g} of its largest entry from "
                 f"the single-device step's")
        worst = max(worst, gap)
    return worst


def parallel_phase(recipe, data, graph, seed, dev) -> dict:
    """(a) dryrun_multichip(4) at the cora scale, (b) + (d) the 2-rank group
    (parallel_rank), (c) the one-rank NCCL step, each against what it must
    equal; the single-device references on the card in this process."""
    import numpy as np

    from ampnet_tpu_torch.graft_entry import dryrun_multichip
    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.ops.tokenize import fit_scaler, tfidf_sample_features
    from ampnet_tpu_torch.parallel import partition_graph
    from ampnet_tpu_torch.parallel.collectives import GLOO_CUDA
    from ampnet_tpu_torch.parallel.launch import spawn
    from ampnet_tpu_torch.train.losses import masked_mean_nll

    report = {"gloo_cuda": sorted(GLOO_CUDA)}
    t0 = time.perf_counter()
    ranks = dryrun_multichip(4, device=dev.type)
    want = {K1_: {"tc": 2}, K3_: {"tc": 2}, K4_: {"tc": 2}}
    for r in ranks:
        got = {k: {b: n for b, n in v.items() if n} for k, v in r["body_launches"].items()
               if r["launches"][k]}
        if got != want:
            fail(f"parallel (a): rank {r['rank']} launched {got}, expected {want}")
        if not (r["n_all"] > r["n_loc"] and r["backend"] == "gloo"):
            fail(f"parallel (a): rank {r['rank']} N_all {r['n_all']} vs N_loc {r['n_loc']}, "
                 f"backend {r['backend']}")
    if len({r["loss"] for r in ranks}) != 1 or not finite([ranks[0]["loss"]]):
        fail(f"parallel (a): losses {[r['loss'] for r in ranks]}")
    report["dryrun"] = dict(
        s=time.perf_counter() - t0, mesh=ranks[0]["mesh"], loss=ranks[0]["loss"],
        ranks=[{k: r[k] for k in ("rank", "data", "graph", "device", "n_loc", "n_all",
                                  "halo_offsets", "halo_rows", "pair_rows", "step_s",
                                  "staged")} for r in ranks],
        launches_per_rank=want)

    # the single-device port on the card: the recipe deterministic, one draw
    t0 = time.perf_counter()
    cfg = dataclasses.replace(recipe, dropout_rate=0.0)
    stats = fit_scaler(data.x)
    model = AMPGCN(cfg, scaler_stats=stats, generator=torch.Generator().manual_seed(seed),
                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sidx = tfidf_sample_features(graph.x, cfg.num_sampled_vectors, node_mask=graph.node_mask,
                                 generator=gen)
    layout = compute_layout(graph)
    logits = model(graph, sampled_idx=sidx, edge_layout=layout)
    masked_mean_nll(logits, graph.y, graph.train_mask & graph.node_mask).backward()
    want_grads = _grads(model)
    with torch.no_grad():
        plain = dataclasses.replace(cfg, use_pallas=False)
        plain_model = AMPGCN(plain, scaler_stats=stats, device=dev)
        plain_model.load_state_dict(model.state_dict())
        plain_logits = plain_model(graph, sampled_idx=sidx).cpu().numpy()
    host = graph.to("cpu")
    n_loc = partition_graph(host, 2).x.shape[1]
    idx = sidx.cpu().numpy()
    part_idx = np.zeros((2 * n_loc, idx.shape[1]), idx.dtype)
    part_idx[: idx.shape[0]] = idx
    payload = dict(cfg=cfg, state={k: v.cpu() for k, v in model.state_dict().items()},
                   stats=stats, graph=host, part_idx=part_idx.reshape(2, n_loc, -1),
                   part_idx_1=idx[None], full_idx=idx, device=dev.type)
    ref_logits = logits.detach().cpu().numpy()
    report["references_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    two = spawn(parallel_rank, 2, payload, device=dev.type)
    got_logits = np.concatenate([r["logits"] for r in two])[: graph.num_nodes_padded]
    err = float(np.abs(got_logits - ref_logits).max())
    if not np.allclose(got_logits, ref_logits, rtol=MODEL_RTOL, atol=MODEL_ATOL):
        fail(f"parallel (b): partitioned log-probs {err:.3g} from the single-device eval")
    for r in two:
        if r["eval_launches"] != {K1_: {"tc": 2}}:
            fail(f"parallel (b): rank {r['rank']}'s eval launched {r['eval_launches']}")
    steps = {}
    for route, launched in (("scatterfree", {K1_: {"tc": 2}, K3_: {"tc": 2}, K4_: {"tc": 2}}),
                            ("stream", {K1_: {"tc": 2}, K5_: {"tc": 2}})):
        for r in two:
            if r[f"step_{route}"]["launches"] != launched:
                fail(f"parallel (b): rank {r['rank']}'s {route} step launched "
                     f"{r[f'step_{route}']['launches']}, expected {launched}")
        steps[route] = dict(
            grad_gap=max(_grad_gap(f"(b) {route}", r[f"step_{route}"]["grads"], want_grads)
                         for r in two),
            loss=two[0][f"step_{route}"]["loss"],
            eager_ms=[r[f"step_{route}"]["eager_ms"] for r in two],
            timed_ms=[r[f"step_{route}"]["timed_ms"] for r in two],
            collective_ms=[r[f"step_{route}"]["collective_ms"] for r in two],
            staged=two[0][f"step_{route}"]["staged"], launches_per_rank=launched)
    tp_err = max(float(np.abs(r["tp_logits"] - plain_logits).max()) for r in two)
    if not all(np.allclose(r["tp_logits"], plain_logits, rtol=MODEL_RTOL, atol=MODEL_ATOL)
               for r in two):
        fail(f"parallel (d): head-parallel log-probs {tp_err:.3g} from the single-device "
             f"forward")
    losses = two[0]["driver"]["losses"]
    k = DRIVER_STEPS
    if not (finite(losses) and np.median(losses[-k:]) < np.median(losses[:k])):
        fail(f"parallel (d): the distributed driver's loss did not fall: {losses}")
    report["partitioned"] = dict(
        s=time.perf_counter() - t0, logits_max_abs_err=err,
        ranks=[{k_: r[k_] for k_ in ("rank", "n_loc", "n_all", "halo_offsets", "halo_rows",
                                     "pair_rows")} for r in two],
        steps=steps, kernels=[list(r["kernels"].values()) for r in two])
    report["tp"] = dict(logits_max_abs_err=tp_err, staged=two[0]["tp_staged"])
    report["driver"] = dict(losses=losses, test_acc=two[0]["driver"].get("test_acc"),
                            seconds=two[0]["driver"]["seconds"],
                            staged=two[0]["driver"]["staged"])

    t0 = time.perf_counter()
    (one,) = spawn(nccl_rank, 1, payload, backend="nccl" if dev.type == "cuda" else "gloo",
                   device=dev.type)
    if one["backend"] != "nccl" or one["staged"] or one["launches"] != {
            K1_: {"tc": 2}, K3_: {"tc": 2}, K4_: {"tc": 2}}:
        fail(f"parallel (c): {one['backend']}, staged {one['staged']}, launched "
             f"{one['launches']}")
    report["nccl"] = dict(s=time.perf_counter() - t0, loss=one["loss"], groups=one["groups"],
                          grad_gap=_grad_gap("(c) nccl", one["grads"], want_grads))
    return report


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from ampnet_tpu_torch.core.config import AMPGCNConfig, TrainConfig
    from ampnet_tpu_torch.ops.hopper import build
    from ampnet_tpu_torch.ops.hopper.format import compute_layout

    pin_ieee_f32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"precision": precision_state()}), flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs.values():
        print(lib.with_suffix(".log").read_text().strip())
    # per instantiation of the tensor-core kernels (by ceil(S/8); K2's
    # projection by its name): registers, spills
    ptxas = {(stem, tiles): r for stem in TENSOR_CORE_LIBS
             for tiles, r in build.ptxas_report(stem).items()}
    print(json.dumps({"ptxas": {f"{k[0]}<{k[1]}>": v for k, v in ptxas.items()}}), flush=True)

    data, graph = cora(args.seed, dev)
    layout = compute_layout(graph)
    # one block per receiver (K1-K3) or per sender (K4): the degrees are the
    # blocks' trip counts
    indeg = (layout.recv_ptr[1:] - layout.recv_ptr[:-1])[: graph.num_nodes_padded]
    outdeg = (layout.snd_ptr[1:] - layout.snd_ptr[:-1])[: graph.num_nodes_padded]
    print(json.dumps({"layout": {
        "tiles": layout.tile_senders.shape[0], "emax": layout.tile_senders.shape[1],
        "snd_emax": layout.snd_receivers.shape[1], "live_edges": int(indeg.sum()),
        "in_degree": [int(indeg.min()), int(indeg.max())],
        "out_degree": [int(outdeg.min()), int(outdeg.max())],
        "nodes_without_in_edge": int((indeg == 0).sum()),
        "nodes_without_out_edge": int((outdeg == 0).sum())}}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows, k8_launches = kernel_phases(graph, layout, gen, dev, ptxas)
    emit({"kernel_phases": rows})
    if k8_launches != 2:
        fail(f"K8's phase launched it {k8_launches} times, expected 2 (S=40 and S=20)")
    t0 = time.perf_counter()
    routes = route_phase(data, gen, dev)
    routes["phase_s"] = time.perf_counter() - t0
    emit({"routes": routes})

    recipe = AMPGCNConfig(num_sampled_vectors=40, token_sampling="tfidf",
                          scaler="precomputed", dropout_rate=0.3,
                          raw_residual="gcn2", use_pallas=True)
    counts_a, path_a, logits_a = drive_path("A S=40 recommended recipe", recipe, data,
                                            graph, layout, args.seed, dev)
    emit(path_a)
    if counts_a != launches(k1=16):
        fail(f"path A launched {counts_a}, expected 16 edge_attention_sums")

    reference = AMPGCNConfig(num_sampled_vectors=20, use_pallas=True)
    counts_b, path_b, logits_b = drive_path("B S=20 reference recipe", reference, data,
                                            graph, layout, args.seed, dev)
    emit(path_b)
    if counts_b != launches(k2=16):
        fail(f"path B launched {counts_b}, expected 16 edge_attention_layer")

    # path C: the recommended recipe's training loop at full width
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-3, epochs=TRAIN_EPOCHS,
                       seed=args.seed, cosine_t0=None, grad_clip=1.0,
                       select_best_every=10, num_eval_samples=8,
                       epochs_per_dispatch=10, log_every=10)
    counts_c, path_c = drive_training("C S=40 recommended recipe, training", recipe,
                                      tcfg, data, graph, args.seed, dev, True)
    emit(path_c)
    evals = TRAIN_EPOCHS // tcfg.select_best_every + 1      # selection + final
    want_c = launches(k1=2 * TRAIN_EPOCHS + 2 * 8 * evals, k3=2 * TRAIN_EPOCHS,
                      k4=2 * TRAIN_EPOCHS)
    if counts_c != want_c:
        fail(f"path C launched {counts_c}, expected {want_c}")

    # path D: a few steps at S=20 — the training forward is K1 where the
    # eval forward is K2, and K3/K4 run at a row stride SP=24 > S
    short = TrainConfig(learning_rate=3e-3, weight_decay=5e-4, epochs=SHORT_EPOCHS,
                        seed=args.seed, cosine_t0=None, log_every=1)
    counts_d, path_d = drive_training("D S=20 reference recipe, training", reference,
                                      short, data, graph, args.seed, dev, False)
    emit(path_d)
    want_d = launches(k1=2 * SHORT_EPOCHS, k2=2, k3=2 * SHORT_EPOCHS, k4=2 * SHORT_EPOCHS)
    if counts_d != want_d:
        fail(f"path D launched {counts_d}, expected {want_d}")

    # the sampler of E and F on both cores; then E and F on the native one
    t0 = time.perf_counter()
    native_report = native_phase(data, args.seed)
    native_report["phase_s"] = time.perf_counter() - t0
    emit({"native": native_report})

    # paths E and F: GraphSAINT subgraph training, through both backwards
    saint = dataclasses.replace(recipe, dropout_adj_rate=0.0)
    counts_e, path_e, counts_f, path_f, prep = drive_saint(saint, data, graph, args.seed, dev)
    emit(path_e)
    emit(path_f)

    # the captured steps against the eager bodies, and profile_steps' trace
    t0 = time.perf_counter()
    captured = captured_phase(recipe, saint, data, graph, layout, prep, args.seed, dev)
    captured["phase_s"] = time.perf_counter() - t0
    emit({"captured": captured})
    del prep
    emit({"profile_steps": profile_steps_phase(recipe, tcfg, data, graph, args.seed, dev)})

    # paths G, H, I: the non-default forward routes behind the same entry points
    with dispatch_flag("MM_SCATTER_DEFAULT"):
        counts_g40, path_g40, _ = drive_path(
            "G S=40 recommended recipe, mm_scatter", recipe, data, graph, layout,
            args.seed, dev, same_as=logits_a)
        counts_g20, path_g20, _ = drive_path(
            "G S=20 reference recipe, mm_scatter", reference, data, graph, layout,
            args.seed, dev, same_as=logits_b)
        emit(path_g40)
        emit(path_g20)
        if counts_g40 != launches(k6=16) or counts_g20 != launches(k7=16):
            fail(f"path G launched {counts_g40} at S=40 and {counts_g20} at S=20, expected "
                 f"16 edge_attention_sums_mm and 16 edge_attention_layer_mm")
        short40 = dataclasses.replace(short, weight_decay=1e-3, grad_clip=1.0)
        counts_h, path_h = drive_training(
            "H S=40 recommended recipe, training with mm_scatter", recipe, short40, data,
            graph, args.seed, dev, True, want_step=launches(k6=2, k3=2, k4=2))
        emit(path_h)
        # the final eval's one draw runs K6 twice more
        want_h = launches(k6=2 * SHORT_EPOCHS + 2, k3=2 * SHORT_EPOCHS, k4=2 * SHORT_EPOCHS)
        if counts_h != want_h:
            fail(f"path H launched {counts_h}, expected {want_h}")
        # and at S=20, as path D: K6 where D runs K1; the final eval's draw is K7
        counts_h20, path_h20 = drive_training(
            "H S=20 reference recipe, training with mm_scatter", reference, short, data,
            graph, args.seed, dev, False, want_step=launches(k6=2, k3=2, k4=2))
        emit(path_h20)
        want_h20 = launches(k6=2 * SHORT_EPOCHS, k7=2, k3=2 * SHORT_EPOCHS,
                            k4=2 * SHORT_EPOCHS)
        if counts_h20 != want_h20:
            fail(f"path H at S=20 launched {counts_h20}, expected {want_h20}")
    with dispatch_flag("DMA_V1_DEFAULT"):
        counts_i, path_i, _ = drive_path(
            "I S=40 recommended recipe, DMA_V1_DEFAULT", recipe, data, graph, layout,
            args.seed, dev, same_as=logits_a)
        emit(path_i)
        if counts_i != launches(k9=16):
            fail(f"path I launched {counts_i}, expected 16 edge_attention_sums_v1")

    # path K (the synthetic XOR recipe and its GraphSAINT variant), the
    # classifiers, the tokenizer modes
    t0 = t_k = time.perf_counter()
    counts_k, counts_k_saint, path_k_report = path_k(args.seed, dev)
    path_k_report["phase_s"] = time.perf_counter() - t0
    emit(dict(path_k_report, card=smi))
    slice_counts = {"K": counts_k, "K GraphSAINT": counts_k_saint}
    for key, phase in (("synthetic_models", synthetic_models_phase),
                       ("tokenizers", tokenizers_phase)):
        t0 = time.perf_counter()
        slice_counts[key], phase_report = phase(args.seed, dev)
        emit({key: dict(phase_report, phase_s=time.perf_counter() - t0, card=smi)})
    emit({"native_and_synthetic_s": native_report["phase_s"] + time.perf_counter() - t_k})
    xor_rows = xor_kernel_rows(args.seed, dev, counts_k, slice_counts)

    # the serving path: Predictor, one captured graph per bucket, hot swap
    emit({"serving": serving_phase(recipe, reference, data, graph, args.seed, dev)})

    # bf16: the bodies, the recipe in compute_dtype='bfloat16', stream_bf16,
    # mxu_bf16, serving bf16 models, the refusals
    bf16_report, bf16_rows = bf16_phase(recipe, reference, saint, tcfg, data, graph, layout,
                                        args.seed, dev, path_c)
    emit({"bf16": dict(bf16_report, card=smi)})

    # bf16 beyond the tensor cores: every routes shape as a bf16 conv and
    # under mxu_bf16, K8 on bf16 rows, the refusals that remain; path J
    wide, wide_ran = bf16_wide(data, gen, dev)
    emit({"bf16_wide": dict(wide, card=smi)})
    path_j_report, j_launches = path_j(recipe, data, graph, layout, args.seed, dev)
    emit(dict(path_j_report, card=smi))
    simt_rows = simt_bf16_rows(data, gen, dev, wide_ran)
    wide_rows = wide_tc_rows(graph, layout, gen, dev, j_launches)

    # SSL pretraining on the recipe's backbone, the main path's drivers as a
    # user runs them, the interpretation suite on the full driver's
    # checkpoint, the single-device entry
    emit({"release_graphs": release_graphs()})
    # parallelism over torch.distributed: the 4-rank dry run, the recipe
    # partitioned over 2 gloo ranks sharing the card, a one-rank NCCL group,
    # the head-parallel forward and the distributed driver
    t0 = time.perf_counter()
    emit({"parallel": dict(parallel_phase(recipe, data, graph, args.seed, dev),
                           phase_s=time.perf_counter() - t0, card=smi)})
    t0 = time.perf_counter()
    ssl_counts, ssl_report = ssl_phase(recipe, data, graph, layout, args.seed, dev)
    emit({"ssl": dict(ssl_report, phase_s=time.perf_counter() - t0, card=smi)})
    t0 = time.perf_counter()
    driver_counts, full_run, drivers_report = drivers_phase(dev)
    emit({"drivers": dict(drivers_report, phase_s=time.perf_counter() - t0, card=smi)})
    t0 = time.perf_counter()
    emit({"interpret": dict(interpret_phase(full_run, data, graph, args.seed, dev),
                            phase_s=time.perf_counter() - t0)})
    # the remaining drivers of experiments/, eval_checkpoint on the full
    # driver's run
    t0 = time.perf_counter()
    exp_counts, exp_report = experiments_phase(
        full_run, path_k_report["per_eval_launches"],
        path_k_report["graphsaint"]["per_eval_launches"], dev)
    emit({"experiments": dict(exp_report, phase_s=time.perf_counter() - t0, card=smi)})
    shutil.rmtree(RUNS_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    emit({"entry": dict(entry_phase(dev), phase_s=time.perf_counter() - t0, card=smi)})

    # launches: K2 from the inference path that runs it (B); K1, K3, K4 from
    # the training path C (K1's count includes that path's eval forwards); K5
    # from path F; K6 from the training path H, K7 from path G at S=20, K9
    # from path I; K8 from its own phase (no model path calls it)
    # K1's, K3's and K4's rows also carry their S=20 numbers (path D's shape)
    tc_keys = ("ms", "prev_ms", "speedup", "max_abs_err", "bound_ms", "plain_ms", "regs",
               "spills", "blocks_per_sm", "stages")
    for name in ("edge_attention_sums", "edge_attention_bwd_dq", "edge_attention_bwd_dkv",
                 "edge_attention_bwd_stream", "edge_attention_sums_mm",
                 "edge_attention_sums_chunked", "edge_attention_sums_v1"):
        rows[f"{name}_s40"]["s20"] = {k: rows[f"{name}_s20"][k] for k in tc_keys}
    rows["edge_attention_sums_mm_s40"]["s20"]["by_group_ms"] = \
        rows["edge_attention_sums_mm_s20"]["by_group_ms"]
    rows["edge_attention_sums_chunked_s40"]["s20"]["by_piece_ms"] = \
        rows["edge_attention_sums_chunked_s20"]["by_piece_ms"]
    # K1, K3, K4 also run in the SSL steps and the drivers: their launches there
    for name in ("edge_attention_sums", "edge_attention_bwd_dq", "edge_attention_bwd_dkv"):
        rows[f"{name}_s40"]["launches_by_path"] = {
            "C": counts_c[name], **{f"ssl {m}": c[name] for m, c in ssl_counts.items()},
            **{d: c[name] for d, c in driver_counts.items()}}
    # the experiments phase's drivers: eval_checkpoint at S=40 (K1), the
    # partitioned timing at S=20 (K1, K3, K4, K5), the XOR drivers at path
    # K's shape (their rows below)
    xor_drivers = ("synthetic_training_modular", "synthetic_training_modular_graphsaint",
                   "grid_search")
    for name in ("edge_attention_sums", "edge_attention_bwd_dq", "edge_attention_bwd_dkv",
                 "edge_attention_bwd_stream"):
        row = rows[f"{name}_s40"]
        row["launches_by_path"] = dict(row.get("launches_by_path", {}), **{
            d: c[name] for d, c in exp_counts.items() if c[name] and d not in xor_drivers})
    for row in xor_rows:
        row["launches_by_path"].update({d: exp_counts[d][row["name"]] for d in xor_drivers
                                        if exp_counts[d][row["name"]]})
    kernels = [
        dict(rows["edge_attention_sums_s40"], launches=counts_c["edge_attention_sums"]),
        dict(rows["edge_attention_layer_s20"], launches=counts_b["edge_attention_layer"]),
        dict(rows["edge_attention_bwd_dq_s40"], launches=counts_c["edge_attention_bwd_dq"]),
        dict(rows["edge_attention_bwd_dkv_s40"], launches=counts_c["edge_attention_bwd_dkv"]),
        dict(rows["edge_attention_bwd_stream_s40"],
             launches=counts_f["edge_attention_bwd_stream"]),
        dict(rows["edge_attention_sums_mm_s40"], launches=counts_h["edge_attention_sums_mm"]),
        dict(rows["edge_attention_layer_mm_s20"],
             launches=counts_g20["edge_attention_layer_mm"]),
        dict(rows["edge_attention_sums_chunked_s40"], launches=k8_launches),
        dict(rows["edge_attention_sums_v1_s40"], launches=counts_i["edge_attention_sums_v1"]),
    ]
    if len(kernels) != len(KERNELS) or any(k["launches"] < 1 for k in kernels):
        fail(f"a kernel of the paths was never launched: "
             f"{ {k['name']: k['launches'] for k in kernels} }")
    # K1-K4 at path K's shape (launches from path K; path K's GraphSAINT
    # variant, synthetic_models and tokenizers apart, by path), a row for
    # each bf16 body (launches from the bf16 phase's paths and bf16_wide),
    # and K1's, K3's and K4's tensor-core bodies at S=64 (path J)
    kernels += xor_rows + bf16_rows + simt_rows + wide_rows
    # a row's `s` (the bf16 rows') beside its launches: the shape they ran at
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "s",
            "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "prev_ms", "speedup", "regs",
            "spills", "blocks_per_sm", "stages", "smem_bytes", "precision", "projection_ms",
            "attention_ms", "out_projection_ms", "prev_projection_ms", "prev_attention_ms",
            "prev_out_projection_ms", "projection_library_ms", "k1_max_abs_err",
            "k2_max_abs_err", "by_group_ms", "by_piece_ms", "s20", "tf32_ms",
            "speedup_vs_tf32", "rel_err", "limit", "tf32_attention_ms", "tf32_projection_ms",
            "tf32_out_projection_ms", "pass_b_ms", "body", "d", "h", "f32_simt_ms",
            "speedup_vs_f32_simt", "device_memory", "graph", "group", "projection_spills")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
