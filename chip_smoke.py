"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the Hopper kernels from ampnet_tpu_torch/ops/hopper/csrc, holds each
against its plain torch version on the card at the main path's shapes
(K1 edge_attention_sums, K2 edge_attention_layer, K3 edge_attention_bwd_dq,
K4 edge_attention_bwd_dkv, K5 edge_attention_bwd_stream with its pass B and
the chunked fold), then drives the port at full width on the Cora-shaped
surrogate:

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
     that K5 runs at the size of its kernel phase.

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
# paths E and F: the recipe's 50 epochs x 200 subgraphs cut to this depth
SAINT_EPOCHS, SAINT_STEPS = 3, 30
# the chunked fold of the stream backward, against the unchunked one
FOLD_BUDGET = 128 * 1024 * 1024
KERNELS = ("edge_attention_sums", "edge_attention_layer", "edge_attention_bwd_dq",
           "edge_attention_bwd_dkv", "edge_attention_bwd_stream")
# modules whose outputs are compared stage by stage when the logits disagree
STAGES = ("tokenizer", "conv1", "conv2", "raw_residual_proj", "raw_residual_conv1",
          "raw_residual_conv2", "final_linear_out")
# H100 SXM peaks (NVIDIA data sheet): f32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def launches(k1=0, k2=0, k3=0, k4=0, k5=0) -> dict:
    """Launch counts by wrapper, as launch_counts() reports them."""
    return dict(zip(KERNELS, (k1, k2, k3, k4, k5)))


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
    """K1, K3, K4 and K5 at S=40 and S=20, K2 at S=20, each against its plain
    version; K5's pass B and chunked fold beside it."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
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

        # K5 on the same rows: dq as K3, and the per-edge dk|dv stream on the
        # slots the walk visits (the others are never written)
        dq, stream = sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw)
        dq_ref, stream_ref = sb.edge_attention_bwd_stream_plain(q, kv, dsum, *idx, **kw)
        torch.cuda.synchronize()
        walked = layout.recv_slots.long()
        per_slot = (-1, sp, 2 * d)
        err = max(compare(f"edge_attention_bwd_stream S={s} dq", dq, dq_ref),
                  compare(f"edge_attention_bwd_stream S={s} stream",
                          stream.view(per_slot)[walked], stream_ref.view(per_slot)[walked]))
        del dq_ref, stream_ref
        # K3's bytes plus the stream's S rows per walked slot, written once; 5
        # products of 2*S*S*D per live edge
        stream_bytes = walked.numel() * s * 2 * d * 4
        b, by = bound_ms(5 * d * n * s * 4 + index_bytes + stream_bytes,
                         10 * s * s * d * live_edges)
        dkv = torch.zeros(nt, s, 2 * d, device=dev)
        rows[f"edge_attention_bwd_stream_s{s}"] = dict(
            name="edge_attention_bwd_stream", route="cuda",
            source="ampnet_tpu_torch/ops/hopper/csrc/edge_attention_bwd.cu",
            replaces="ampnet_tpu/ops/pallas/edge_attention_bwd.py:"
                     + ("694" if s == 40 else "178"),
            max_abs_err=err,
            ms=cuda_ms(lambda: sb.edge_attention_bwd_stream(q, kv, dsum, *idx, **kw), 10),
            plain_ms=cuda_ms(lambda: sb.edge_attention_bwd_stream_plain(
                q, kv, dsum, *idx, **kw), 3),
            bound_ms=b, bound_by=by, library_ms=None,
            stream_bytes=stream.numel() * 4, walked_stream_bytes=stream_bytes,
            pass_b_ms=cuda_ms(lambda: sb.stream_to_senders(
                stream, layout.tile_senders, walked, 0, dkv, s=s, sp=sp), 10))
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
    if not finite(metrics.values()):
        fail(f"path {name}: non-finite metrics {metrics}")
    t0 = time.perf_counter()
    for i in range(5):
        step(graph, torch.Generator(device=dev).manual_seed(seed + 1 + i), layout)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3 / 5

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
    if per_step != launches(k1=2, k3=2, k4=2):
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


def drive_saint(cfg, data, graph, seed, dev):
    """Paths E and F: GraphSAINT subgraph training of the stabilized recipe
    through train_saint (layouts with the sender side: K1 + K3 + K4) and
    through make_pallas_train_step on layouts without one (K1 + K5)."""
    from ampnet_tpu_torch.core.config import TrainConfig
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import (create_train_state, make_optimizer,
                                        make_train_step, train_saint)
    from ampnet_tpu_torch.train.loop import _saint_layout_budget
    from ampnet_tpu_torch.train.pallas_step import make_pallas_train_step

    total = SAINT_EPOCHS * SAINT_STEPS
    tcfg = TrainConfig(learning_rate=3e-3, weight_decay=5e-4, epochs=SAINT_EPOCHS,
                       seed=seed, cosine_t0=total, cosine_t_mult=1, grad_clip=1.0,
                       checkpoint_every=0, select_best_every=1, num_eval_samples=8,
                       log_every_steps=1, saint_loss="mean")

    def optimizer(model):
        return make_optimizer(model.parameters(), tcfg.learning_rate,
                              weight_decay=tcfg.weight_decay, cosine_t0=tcfg.cosine_t0,
                              cosine_t_mult=1, grad_clip=tcfg.grad_clip)

    t0 = time.perf_counter()
    sampler = saint_sampler(data, SAINT_STEPS)
    budget = _saint_layout_budget(sampler)
    name_e = "E S=40 GraphSAINT, train_saint"
    report_e = dict(path=name_e, cut=f"{SAINT_EPOCHS} epochs x {SAINT_STEPS} subgraphs "
                                     f"of the recipe's 50 x 200",
                    sampler_build_s=time.perf_counter() - t0,
                    pad_nodes_to=sampler.pad_nodes_to, pad_edges_to=sampler.pad_edges_to,
                    edge_budget=budget)

    # ten subgraphs of a sampler of their own, prepared once: both layouts on
    # the host (timed), everything moved to the card
    probe_sampler = saint_sampler(data, 10)
    host = list(probe_sampler)
    t0 = time.perf_counter()
    with_snd = [compute_layout(g, edges_per_tile=budget) for g in host]
    report_e["host_layout_ms"] = (time.perf_counter() - t0) * 1e2
    t0 = time.perf_counter()
    without = [compute_layout(g, edges_per_tile=budget, sender_layout=False) for g in host]
    host_layout_ms_f = (time.perf_counter() - t0) * 1e2
    subs = [g.to(dev) for g in host]
    with_snd = [lay.to(dev) for lay in with_snd]
    without = [lay.to(dev) for lay in without]
    report_e["subgraph_nodes_edges"] = [[g.num_nodes, g.num_edges] for g in host]

    probe = recipe_model(cfg, data, seed, dev)
    state = create_train_state(probe, optimizer(probe), seed=seed)
    step_e = make_train_step(probe, loss_mode="saint_mean")
    eaf.reset_launch_counts()
    step_e(state, subs[0], with_snd[0])
    torch.cuda.synchronize()
    per_step = eaf.launch_counts()
    if per_step != launches(k1=2, k3=2, k4=2):
        fail(f"path {name_e}: one step launched {per_step}, expected 2 K1 + 2 K3 + 2 K4")
    report_e["train_step_warm_ms"], report_e["train_step_warm_ms_range"] = warm_steps_ms(
        step_e, state, subs, with_snd)

    model = recipe_model(cfg, data, seed, dev)
    log = StepLog()
    eaf.reset_launch_counts()
    t0 = time.perf_counter()
    result = train_saint(model, sampler, graph, tcfg, log=log)
    torch.cuda.synchronize()
    report_e["train_saint_s"] = time.perf_counter() - t0
    counts_e = eaf.launch_counts()
    final = result["final_metrics"]
    if len(result["history"]) != SAINT_EPOCHS or len(log.losses) != total \
            or not finite(final.values()):
        fail(f"path {name_e}: {len(result['history'])} epochs, {len(log.losses)} step "
             f"rows, final metrics {final}")
    report_e.update(loss_fell(name_e, log.losses), budget_regrown=log.budget_lines,
                    final_test_acc=final.get("test_acc"),
                    final_val_acc=final.get("val_acc"),
                    per_step_launches=per_step, launches=counts_e)
    evals = SAINT_EPOCHS + 1                               # selection + final, 8 draws
    want_e = launches(k1=2 * total + 2 * 8 * evals, k3=2 * total, k4=2 * total)
    if counts_e != want_e:
        fail(f"path {name_e} launched {counts_e}, expected {want_e}")

    # ---- path F
    name_f = "F S=40 GraphSAINT, make_pallas_train_step without a sender side"
    report_f = dict(path=name_f, cut=f"{total} subgraphs", host_layout_ms=host_layout_ms_f)
    probe = recipe_model(cfg, data, seed, dev)
    state = create_train_state(probe, optimizer(probe), seed=seed)
    step_f = make_pallas_train_step(probe, loss_mode="saint_mean")
    eaf.reset_launch_counts()
    step_f(state, subs[0], without[0])
    torch.cuda.synchronize()
    per_step = eaf.launch_counts()
    if per_step != launches(k1=2, k5=2):
        fail(f"path {name_f}: one step launched {per_step}, expected 2 K1 + 2 K5 and "
             f"no K3 / K4")
    report_f["train_step_warm_ms"], report_f["train_step_warm_ms_range"] = warm_steps_ms(
        step_f, state, subs, without)
    # after the timing: the float64 reference keeps the host's cores busy
    report_f["gradient_check"] = gradient_check(
        name_f, recipe_model(cfg, data, seed, dev), subs[0], without[0], seed,
        want=launches(k1=2, k5=2), loss_mode="saint_mean", fused=True,
        also=(with_snd[0], launches(k1=2, k3=2, k4=2)))

    model = recipe_model(cfg, data, seed, dev)
    state = create_train_state(model, optimizer(model), seed=seed)
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
    if not finite([float(metrics["loss"])]):
        fail(f"path {name_f}: the full-graph step's loss is {float(metrics['loss'])}")
    report_f.update(loss_fell(name_f, losses), full_graph_step_loss=float(metrics["loss"]),
                    per_step_launches=per_step, launches=counts_f)
    want_f = launches(k1=2 * (total + 1), k5=2 * (total + 1))
    if counts_f != want_f:
        fail(f"path {name_f} launched {counts_f}, expected {want_f}")
    return counts_e, report_e, counts_f, report_f


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
    if counts_a != launches(k1=16):
        fail(f"path A launched {counts_a}, expected 16 edge_attention_sums")

    reference = AMPGCNConfig(num_sampled_vectors=20, use_pallas=True)
    counts_b, path_b = drive_path("B S=20 reference recipe", reference, data, graph,
                                  layout, args.seed, dev)
    print(json.dumps(path_b), flush=True)
    if counts_b != launches(k2=16):
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
    print(json.dumps(path_d), flush=True)
    want_d = launches(k1=2 * SHORT_EPOCHS, k2=2, k3=2 * SHORT_EPOCHS, k4=2 * SHORT_EPOCHS)
    if counts_d != want_d:
        fail(f"path D launched {counts_d}, expected {want_d}")

    # paths E and F: GraphSAINT subgraph training, through both backwards
    saint = dataclasses.replace(recipe, dropout_adj_rate=0.0)
    counts_e, path_e, counts_f, path_f = drive_saint(saint, data, graph, args.seed, dev)
    print(json.dumps(path_e), flush=True)
    print(json.dumps(path_f), flush=True)

    # launches: K2 from the inference path that runs it (B); K1, K3, K4 from
    # the training path C (K1's count includes that path's eval forwards); K5
    # from path F
    kernels = [
        dict(rows["edge_attention_sums_s40"], launches=counts_c["edge_attention_sums"]),
        dict(rows["edge_attention_layer_s20"], launches=counts_b["edge_attention_layer"]),
        dict(rows["edge_attention_bwd_dq_s40"], launches=counts_c["edge_attention_bwd_dq"]),
        dict(rows["edge_attention_bwd_dkv_s40"], launches=counts_c["edge_attention_bwd_dkv"]),
        dict(rows["edge_attention_bwd_stream_s40"],
             launches=counts_f["edge_attention_bwd_stream"]),
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
