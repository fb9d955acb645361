"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the Hopper kernels from ampnet_tpu_torch/ops/hopper/csrc, holds each
against its plain torch version on the card at the main path's shapes
(K1 edge_attention_sums, K2 edge_attention_layer, K3 edge_attention_bwd_dq,
K4 edge_attention_bwd_dkv), then drives the port at full width on the
Cora-shaped surrogate:

  A  inference, the recommended recipe (S=40, tfidf, gcn2 head), 8-draw
     make_eval_step: K1 twice per draw;
  B  inference, the reference recipe's S=20: K2 twice per draw;
  C  training, the recommended recipe: create_train_state +
     train_full_batch (Adam with L2, clip 1.0, best-validation selection
     every 10 epochs with the 8-draw eval, 10 epochs per chunk). Each
     training step launches 2 K1 + 2 K3 + 2 K4 and no K2. One step's
     gradients (dropout rates 0, fixed sampled_idx) are held against
     float64 autograd on the CPU through the plain oracle, every parameter;
     the loss must be finite and fall;
  D  a few training steps at S=20 (row stride SP=24 > S): the training
     forward runs K1 where inference runs K2.

Each path's launch counts are set to 0 just before it runs and read right
after; for A and B one draw with a fixed sampled_idx is checked against the
same model and draw on the CPU in float64. Weights are random, made from
--seed. Prints the card's name and power limit, a `kernels` JSON line, and
last {"ok": true, "device": ...}. Exits non-zero when any phase fails or
there is no CUDA device.

All float32 math runs at IEEE precision: TF32 on the card (cuBLAS, cuDNN)
and reduced-precision float32 in oneDNN on the host are switched off, so
that neither the environment nor a library default can loosen the checks.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

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
# epochs of path C (the recipe's 150) and of the short S=20 path D
TRAIN_EPOCHS, SHORT_EPOCHS = 150, 3
# modules whose outputs are compared stage by stage when the logits disagree
STAGES = ("tokenizer", "conv1", "conv2", "raw_residual_proj", "raw_residual_conv1",
          "raw_residual_conv2", "final_linear_out")
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


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
             "matmul_precision": torch.get_float32_matmul_precision(),
             "cpu_threads": torch.get_num_threads()}
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
    hooks = [getattr(model, name).register_forward_hook(
        lambda mod, i, o, name=name: outs.__setitem__(
            name, (o[0] if isinstance(o, tuple) else o).detach().cpu().double()))
        for name in STAGES if hasattr(model, name)]
    try:
        with torch.no_grad():
            logp = model(graph, sampled_idx=sidx, edge_layout=layout)
    finally:
        for h in hooks:
            h.remove()
    return logp.detach().cpu(), outs


def cpu_f64_reference(model, graph, sidx):
    """The same model and draw on the CPU in float64, its convs on the plain
    oracle (the fused op computes in float32 only)."""
    ref = copy.deepcopy(model).to("cpu", torch.float64)
    for conv in (ref.conv1, ref.conv2):
        conv.use_pallas = False
    g = graph.to("cpu")
    g.x = g.x.double()
    return stage_outputs(ref, g, sidx.cpu(), None)


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


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, ref):
    err = float((got - ref).abs().max())
    if not torch.allclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        fail(f"{name}: kernel disagrees with its plain version (max abs err {err:.3g})")
    return err


def cora(seed: int, device):
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.data.planetoid import synthetic_cora

    d = synthetic_cora(seed)
    g = from_arrays(d.x, d.edge_index, y=d.y, train_mask=d.train_mask,
                    val_mask=d.val_mask, test_mask=d.test_mask,
                    pad_nodes_to=2752, pad_edges_to=10624)
    return d, g.to(device)


def kernel_phases(graph, layout, gen, dev):
    """K1, K3 and K4 at S=40 and S=20, K2 at S=20, each against its plain
    version."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import edge_slot_valid, snd_slot_valid
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
    rows = {}
    for s in (40, 20):
        sp = -(-s // 8) * 8
        qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=dev)
        kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
        got = eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw)
        ref = eaf.edge_attention_sums_plain(qkv[:, :d], qkv[:, d:], *idx, **kw)
        torch.cuda.synchronize()
        err = compare(f"edge_attention_sums S={s}", got, ref)
        b, by = bound_ms(4 * d * n * s * 4 + index_bytes, 4 * s * s * d * live_edges)
        rows[f"edge_attention_sums_s{s}"] = dict(
            name="edge_attention_sums", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_fused.py:942",
            max_abs_err=err,
            ms=cuda_ms(lambda: eaf.edge_attention_sums(qkv[:, :d], qkv[:, d:], *idx, **kw), 20),
            plain_ms=cuda_ms(lambda: eaf.edge_attention_sums_plain(
                qkv[:, :d], qkv[:, d:], *idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None)

        # K3 / K4 on the same rows, dsum random: [Q | dsum] packed per row
        qdm = torch.cat([qkv[:, :d], torch.randn(nt * sp, d, generator=gen, device=dev)], 1)
        q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
        got = bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw)
        ref = bwd.edge_attention_bwd_dq_plain(q, kv, dsum, *idx, **kw)
        torch.cuda.synchronize()
        err = compare(f"edge_attention_bwd_dq S={s}", got, ref)
        # q, dsum, k|v read and dq written once; 3 products of 2*S*S*D per edge
        b, by = bound_ms(5 * d * n * s * 4 + index_bytes, 6 * s * s * d * live_edges)
        rows[f"edge_attention_bwd_dq_s{s}"] = dict(
            name="edge_attention_bwd_dq", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:"
                     + ("211" if s == 40 else "167"),
            max_abs_err=err,
            ms=cuda_ms(lambda: bwd.edge_attention_bwd_dq(q, kv, dsum, *idx, **kw), 20),
            plain_ms=cuda_ms(lambda: bwd.edge_attention_bwd_dq_plain(
                q, kv, dsum, *idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None)
        got = bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw)
        ref = bwd.edge_attention_bwd_dkv_plain(qdm, kv, *snd_idx, **kw)
        torch.cuda.synchronize()
        err = compare(f"edge_attention_bwd_dkv S={s}", got, ref)
        # q|dsum, k|v read and dk|dv written once; 4 products per edge
        b, by = bound_ms(6 * d * n * s * 4 + snd_index_bytes, 8 * s * s * d * live_edges)
        rows[f"edge_attention_bwd_dkv_s{s}"] = dict(
            name="edge_attention_bwd_dkv", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py:"
                     + ("319" if s == 40 else "280"),
            max_abs_err=err,
            ms=cuda_ms(lambda: bwd.edge_attention_bwd_dkv(qdm, kv, *snd_idx, **kw), 20),
            plain_ms=cuda_ms(lambda: bwd.edge_attention_bwd_dkv_plain(
                qdm, kv, *snd_idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None)

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
    torch.cuda.synchronize()
    err = compare("edge_attention_layer S=20", got, ref)
    live_recv = int((count > 0).sum())
    flops = (2 * n * s * d * 3 * d + 4 * s * s * d * live_edges
             + 2 * s * d * d * live_recv)
    nbytes = 4 * (2 * n * s * d + 4 * d * d + 4 * d + nt) + index_bytes
    b, by = bound_ms(nbytes, flops)
    rows["edge_attention_layer_s20"] = dict(
        name="edge_attention_layer", route="cuda",
        source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention.cu "
               "+ ampnet_tpu_torch/ops/hopper/csrc/qkv_projection.cu",
        replaces="ampnet_tpu/ops/pallas/edge_attention_fused.py:763",
        max_abs_err=err,
        ms=cuda_ms(lambda: eaf.edge_attention_layer(x_rows, *w, invdeg, *idx, **kw), 20),
        plain_ms=cuda_ms(lambda: eaf.edge_attention_layer_plain(x_rows, *w, invdeg, *idx, **kw), 3),
        bound_ms=b, bound_by=by, library_ms=None)
    return rows


def recipe_model(cfg, data, seed, dev):
    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.tokenize import fit_scaler

    stats = fit_scaler(data.x) if cfg.scaler == "precomputed" else None
    return AMPGCN(cfg, scaler_stats=stats,
                  generator=torch.Generator().manual_seed(seed), device=dev)


def drive_path(name, cfg, data, graph, layout, seed, dev):
    """One 8-draw eval step through make_eval_step, counts read around it,
    then one fixed draw on the card against the same forward on the CPU."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import sample_present_features, tfidf_sample_features
    from ampnet_tpu_torch.train import make_eval_step

    model = recipe_model(cfg, data, seed, dev)
    step = make_eval_step(model, num_eval_samples=8)
    eaf.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(graph, torch.Generator(device=dev).manual_seed(seed), layout)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = eaf.launch_counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(map(lambda v: v == v and abs(v) != float("inf"), metrics.values())):
        fail(f"path {name}: non-finite metrics {metrics}")
    t0 = time.perf_counter()
    step(graph, torch.Generator(device=dev).manual_seed(seed + 1), layout)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3

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
        # draw repeat the first, and which stage leaves the reference first
        again, again_stages = stage_outputs(model, graph, sidx, layout)
        print(json.dumps({
            "stage_max_abs_err": stage_err,
            "second_card_forward_max_abs_err": float((again.double() - ref).abs().max()),
            "second_card_forward_stage_max_abs_err": {
                k: float((again_stages[k] - ref_stages[k]).abs().max()) for k in ref_stages},
            "precision": precision_state()}), file=sys.stderr)
        fail(f"path {name}: card logits disagree with the CPU float64 forward "
             f"(max abs err {err:.3g})")
    return counts, dict(path=name, metrics=metrics, eval_step_first_ms=first_ms,
                        eval_step_warm_ms=warm_ms, cpu_f64_max_abs_err=err,
                        stage_max_abs_err=stage_err)


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


def gradient_check(name, model, graph, layout, seed):
    """One training forward + backward with dropout rates 0 and a fixed
    sampled_idx: the card's gradients (through K1, K3, K4) against float64
    autograd on the CPU through the plain oracle, every parameter."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import tfidf_sample_features
    from ampnet_tpu_torch.train.losses import masked_mean_nll

    cfg = model.config
    gen = torch.Generator(device=graph.x.device).manual_seed(seed + 3)
    sidx = tfidf_sample_features(graph.x, cfg.num_sampled_vectors,
                                 node_mask=graph.node_mask, generator=gen)

    branches, flips = {}, {}

    def grads(m, g, idx, lay, record):
        m.config = dataclasses.replace(cfg, dropout_rate=0.0, dropout_adj_rate=0.0)
        hooks = relu_branch_hooks(m, branches, None if record else flips)
        try:
            m.zero_grad(set_to_none=True)
            logits = m(g, deterministic=False, sampled_idx=idx, edge_layout=lay)
            loss = masked_mean_nll(logits, g.y, g.train_mask & g.node_mask)
            loss.backward()
        finally:
            m.config = cfg
            for h in hooks:
                h.remove()
        out = {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
        return float(loss.detach()), out

    eaf.reset_launch_counts()
    loss_card, card = grads(model, graph, sidx, layout, True)
    torch.cuda.synchronize()
    counts = eaf.launch_counts()
    if counts != {"edge_attention_sums": 2, "edge_attention_layer": 0,
                  "edge_attention_bwd_dq": 2, "edge_attention_bwd_dkv": 2}:
        fail(f"path {name}: one forward + backward launched {counts}")
    ref_model = copy.deepcopy(model).to("cpu", torch.float64)
    for conv in (ref_model.conv1, ref_model.conv2):
        conv.use_pallas = False
    g = graph.to("cpu")
    g.x = g.x.double()
    loss_ref, ref = grads(ref_model, g, sidx.cpu(), None, False)
    rel = {}
    for k in ref:
        scale = float(ref[k].abs().max())
        if scale == 0.0 or not torch.isfinite(card[k]).all():
            fail(f"path {name}: gradient of {k}: reference max {scale}, "
                 f"card finite={bool(torch.isfinite(card[k]).all())}")
        rel[k] = float((card[k] - ref[k]).abs().max()) / scale
    worst = max(rel, key=rel.get)
    if rel[worst] > GRAD_RTOL:
        print(json.dumps({"grad_rel_err": rel, "relu_branches_moved": flips,
                          "precision": precision_state()}),
              file=sys.stderr)
        fail(f"path {name}: gradient of {worst} disagrees with float64 autograd on "
             f"the CPU (max abs err {rel[worst]:.3g} of its largest entry)")
    return dict(loss_card=loss_card, loss_cpu_f64=loss_ref, parameters=len(rel),
                grad_max_rel_err=rel[worst], grad_worst_parameter=worst,
                relu_branches_moved=flips)


def drive_training(name, cfg, tcfg, data, graph, seed, dev, check_gradients):
    """create_train_state + train_full_batch, counts read around it; before
    that, on a model of its own, the gradient check, one step's launch
    counts and the warm step time."""
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import (Logfile, create_train_state, make_optimizer,
                                        make_train_step, train_full_batch)

    layout = compute_layout(graph)
    probe = recipe_model(cfg, data, seed, dev)
    report = dict(path=name)
    if check_gradients:
        report["gradient_check"] = gradient_check(name, probe, graph, layout, seed)
    state = create_train_state(
        probe, make_optimizer(probe.parameters(), tcfg.learning_rate,
                              weight_decay=tcfg.weight_decay, cosine_t0=tcfg.cosine_t0,
                              grad_clip=tcfg.grad_clip), seed=seed)
    step = make_train_step(probe)
    eaf.reset_launch_counts()
    step(state, graph, layout)
    torch.cuda.synchronize()
    per_step = eaf.launch_counts()
    if per_step != {"edge_attention_sums": 2, "edge_attention_layer": 0,
                    "edge_attention_bwd_dq": 2, "edge_attention_bwd_dkv": 2}:
        fail(f"path {name}: one training step launched {per_step}, expected "
             f"2 K1 + 2 K3 + 2 K4 and no K2")
    step(state, graph, layout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step(state, graph, layout)
    torch.cuda.synchronize()
    report["train_step_warm_ms"] = (time.perf_counter() - t0) * 1e2

    model = recipe_model(cfg, data, seed, dev)
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_full_batch(model, graph, tcfg, log=Logfile())
    torch.cuda.synchronize()
    report["train_full_batch_s"] = time.perf_counter() - t0
    counts = eaf.launch_counts()
    history, final = result["history"], result["final_metrics"]
    losses = [row["loss"] for row in history]
    if len(history) != tcfg.epochs or not all(map(lambda v: v == v and abs(v) != float("inf"),
                                                  losses + list(final.values()))):
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
    return counts, report


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
    rows = kernel_phases(graph, layout, gen, dev)
    print(json.dumps({"kernel_phases": rows}), flush=True)

    recipe = AMPGCNConfig(num_sampled_vectors=40, token_sampling="tfidf",
                          scaler="precomputed", dropout_rate=0.3,
                          raw_residual="gcn2", use_pallas=True)
    counts_a, path_a = drive_path("A S=40 recommended recipe", recipe, data, graph,
                                  layout, args.seed, dev)
    print(json.dumps(path_a), flush=True)
    if counts_a != {"edge_attention_sums": 16, "edge_attention_layer": 0,
                    "edge_attention_bwd_dq": 0, "edge_attention_bwd_dkv": 0}:
        fail(f"path A launched {counts_a}, expected 16 edge_attention_sums")

    reference = AMPGCNConfig(num_sampled_vectors=20, use_pallas=True)
    counts_b, path_b = drive_path("B S=20 reference recipe", reference, data, graph,
                                  layout, args.seed, dev)
    print(json.dumps(path_b), flush=True)
    if counts_b != {"edge_attention_sums": 0, "edge_attention_layer": 16,
                    "edge_attention_bwd_dq": 0, "edge_attention_bwd_dkv": 0}:
        fail(f"path B launched {counts_b}, expected 16 edge_attention_layer")

    # path C: the recommended recipe's training loop at full width
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=1e-3, epochs=TRAIN_EPOCHS,
                       seed=args.seed, cosine_t0=None, grad_clip=1.0,
                       select_best_every=10, num_eval_samples=8,
                       epochs_per_dispatch=10, log_every=10)
    counts_c, path_c = drive_training("C S=40 recommended recipe, training", recipe,
                                      tcfg, data, graph, args.seed, dev, True)
    print(json.dumps(path_c), flush=True)
    evals = TRAIN_EPOCHS // tcfg.select_best_every + 1      # selection + final
    want_c = {"edge_attention_sums": 2 * TRAIN_EPOCHS + 2 * 8 * evals,
              "edge_attention_layer": 0, "edge_attention_bwd_dq": 2 * TRAIN_EPOCHS,
              "edge_attention_bwd_dkv": 2 * TRAIN_EPOCHS}
    if counts_c != want_c:
        fail(f"path C launched {counts_c}, expected {want_c}")

    # path D: a few steps at S=20 — the training forward is K1 where the
    # eval forward is K2, and K3/K4 run at a row stride SP=24 > S
    short = TrainConfig(learning_rate=3e-3, weight_decay=5e-4, epochs=SHORT_EPOCHS,
                        seed=args.seed, cosine_t0=None, log_every=1)
    counts_d, path_d = drive_training("D S=20 reference recipe, training", reference,
                                      short, data, graph, args.seed, dev, False)
    print(json.dumps(path_d), flush=True)
    want_d = {"edge_attention_sums": 2 * SHORT_EPOCHS, "edge_attention_layer": 2,
              "edge_attention_bwd_dq": 2 * SHORT_EPOCHS,
              "edge_attention_bwd_dkv": 2 * SHORT_EPOCHS}
    if counts_d != want_d:
        fail(f"path D launched {counts_d}, expected {want_d}")

    # launches: K2 from the inference path that runs it (B); K1, K3, K4 from
    # the training path C (K1's count includes that path's eval forwards)
    kernels = [
        dict(rows["edge_attention_sums_s40"], launches=counts_c["edge_attention_sums"]),
        dict(rows["edge_attention_layer_s20"], launches=counts_b["edge_attention_layer"]),
        dict(rows["edge_attention_bwd_dq_s40"], launches=counts_c["edge_attention_bwd_dq"]),
        dict(rows["edge_attention_bwd_dkv_s40"], launches=counts_c["edge_attention_bwd_dkv"]),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
