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
  E  GraphSAINT training, the stabilized recipe (S=40, tfidf, gcn2 head, no
     edge dropout; sampler of 8 roots x 150 steps, coverage 100; lr 3e-3
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
PEAK_BYTES = 3.35e12
# the libraries of the tensor-core bodies (K1-K5; K6 and K9; K8; K7's
# projection launches are K2's library's)
TENSOR_CORE_LIBS = ("edge_attention_tc", "edge_attention_layer_tc", "edge_attention_bwd_dq_tc",
                    "edge_attention_bwd_tc", "edge_attention_bwd_stream_tc",
                    "edge_attention_groups_tc", "edge_attention_chunked_tc")
# the `routes` phase: AMPConv at shapes beyond the tensor-core range (S, D,
# H, training, the body K1-K4 (K6, K9) must run, the kernels whose working
# set must be in device memory, the forward route: K1, or K6 under
# MM_SCATTER_DEFAULT, or K9 under DMA_V1_DEFAULT). An eval runs on a graph
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
    (49, 128, 4, False, "simt", (), None),    # an eval through K1's CUDA-core body
    (40, 3, 1, True, "simt", (), None),       # odd D: no 16-byte copies
    (40, 100, 4, True, "tc", (), None),       # dh = 25: stays on the tensor cores
    (96, 128, 4, False, "simt", ("edge_attention_sums",), None),    # 345 KB a block
    (49, 128, 4, True, "simt", ("edge_attention_bwd_dkv",), None),  # 242 KB a block
    (96, 128, 4, False, "simt", ("edge_attention_sums_mm",), MM),   # K6 at group 1: 345 KB
    (96, 128, 4, False, "simt", ("edge_attention_sums_v1",), V1),   # K9: 296 KB
    (49, 128, 4, True, "simt", ("edge_attention_bwd_dkv",), MM),    # K6 beyond the tensor cores
    (40, 128, 8, True, "simt", (), MM),       # K6 beyond the warp limit
    (49, 128, 4, True, "simt", (), STREAM),   # K5 beyond the tensor cores: 216,880 B
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
        conv.use_pallas = False
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
    "edge_chunk_kernel", "projection_kernel")
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


def route_phase(data, gen, dev):
    """AMPConv at the shapes of ROUTES, forward and (training) one backward
    with dropout 0 on the card, each against the same layer in float64 on
    the CPU through the plain oracle: the output at the model limits, every
    gradient (x's too) within GRAD_RTOL of its largest entry. The launches
    must show the body that ran; the report names the kernels whose
    working set was in device memory."""
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
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
    no_sender_side = compute_layout(graphs[True][0], sender_layout=False)
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
        if any(b[want] != counts[k] for k, b in ran.items()):
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


def tensor_cores_only(name, counts):
    """Fail where a path at the recipes' shapes ran a CUDA-core body."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf

    bodies = eaf.body_launch_counts()
    if any(b["simt"] for b in bodies.values()):
        fail(f"path {name}: a kernel ran its CUDA-core body ({bodies}; launches {counts})")
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
                   fused=False, also=None):
    """One training forward + backward with dropout rates 0 and a fixed
    sampled_idx: the card's gradients against float64 autograd on the CPU
    through the plain oracle, every parameter. ``want``: the launches of
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
        conv.use_pallas = False
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
        if rel[worst] > GRAD_RTOL:
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
                   want_step=None):
    """create_train_state + train_full_batch (captured steps), counts read
    around it; before that, on models of their own, the gradient check, one
    captured step's launch counts (``want_step``, default 2 K1 + 2 K3 + 2
    K4), and the captured step against the eager body from the same
    initial state (step_costs of both, and where their states stand after
    the same steps)."""
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
                                                  want=want_step)

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
    tensor_cores_only(name, per_step)
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
    tensor_cores_only(name, counts)
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


def saint_sampler(data, seed_steps):
    from ampnet_tpu_torch.data.graphsaint import GraphSaintRandomWalkSampler

    return GraphSaintRandomWalkSampler(
        data.x, data.edge_index, y=data.y, train_mask=data.train_mask,
        val_mask=data.val_mask, test_mask=data.test_mask, batch_size=8,
        walk_length=150, num_steps=seed_steps, sample_coverage=100, seed=1)


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
    itemsize = next(pred.model.parameters()).element_size()
    tokens = cfg.num_sampled_vectors + (0 if cfg.average_pooling else 1)
    sp, d = -(-tokens // 8) * 8, cfg.embedding_dim
    gather = eaf._resolve_gather("auto", n_pad * sp, d, itemsize, tile_rows=tn * sp)
    v6 = eaf._v6_usable(n_pad, n_pad, sp, d, itemsize, tn, eaf._auto_group(sp), gather)
    return dict(gather=gather, v6_usable=v6,
                want=launches(k2=2) if v6 else launches(k1=2))


def serve(pred, name, x, edge_index, dev, want, check_f64=False, profile=False) -> dict:
    """One request through ``Predictor.predict`` (counts set to 0 just
    before it, read just after): its answer against the eager forward from
    the same generator state on the same graph and layout, bit for bit;
    its launches exact (``want``) and on the tensor cores; host wall ms,
    the layout's host ms (built from the host graph, as ``predict`` builds
    it), the device ms of a replay (CUDA events), and the capture's
    timings where the request captured its bucket's graph. With
    ``check_f64`` the padded answer of that draw (its sampled_idx taken
    from return_aux=True) against the CPU float64 forward; with
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
    tensor_cores_only(f"serving {name}", counts)
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
                  launches={k: v for k, v in counts.items() if v}, wall_ms=wall_ms,
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
        if not torch.allclose(padded.double(), ref, rtol=MODEL_RTOL, atol=MODEL_ATOL):
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

    # the serving path: Predictor, one captured graph per bucket, hot swap
    emit({"serving": serving_phase(recipe, reference, data, graph, args.seed, dev)})

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
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "prev_ms", "speedup", "regs",
            "spills", "blocks_per_sm", "stages", "smem_bytes", "precision", "projection_ms",
            "attention_ms", "out_projection_ms", "prev_projection_ms", "prev_attention_ms",
            "prev_out_projection_ms", "projection_library_ms", "k1_max_abs_err",
            "k2_max_abs_err", "by_group_ms", "by_piece_ms", "s20")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
