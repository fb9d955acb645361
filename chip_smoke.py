"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py

Builds the Hopper kernels from ampnet_tpu_torch/ops/hopper/csrc, holds each
against its plain torch version on the card at the main path's shapes,
then drives the port's inference path (make_eval_step, 8-draw ensemble)
at full width on the Cora-shaped surrogate:

  A  the recommended recipe (S=40, tfidf, gcn2 head): runs K1
     (edge_attention_sums) twice per draw;
  B  the reference recipe's S=20: runs K2 (edge_attention_layer).

Each path's launch counts are read right after it runs, and one draw with
a fixed sampled_idx is checked against the same model and draw on the
CPU in float64. Weights are random, made from --seed. Prints the card's
name and power limit, a `kernels` JSON line, and last
{"ok": true, "device": ...}. Exits non-zero when any phase fails or there
is no CUDA device.

All float32 math runs at IEEE precision: TF32 on the card (cuBLAS, cuDNN)
and reduced-precision float32 in oneDNN on the host are switched off, so
that neither the environment nor a library default can loosen the checks.
"""
from __future__ import annotations

import argparse
import copy
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
    """K1 at S=40 and S=20, K2 at S=20, each against its plain version."""
    from ampnet_tpu_torch.models.layers import AMPConv
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper.format import edge_slot_valid
    from ampnet_tpu_torch.ops.segment import segment_count

    d, h = 128, 4
    n = graph.num_nodes_padded
    nt = layout.recv_ptr.numel() - 1
    # a runtime mask that drops every 50th live edge
    mask = graph.edge_mask.clone()
    mask[torch.nonzero(mask)[::50, 0]] = False
    valid = edge_slot_valid(layout, mask)
    idx = (layout.tile_senders, valid, layout.recv_ptr, layout.recv_slots)
    live_edges = int(valid.sum())
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


def drive_path(name, cfg, data, graph, layout, seed, dev):
    """One 8-draw eval step through make_eval_step, counts read around it,
    then one fixed draw on the card against the same forward on the CPU."""
    from ampnet_tpu_torch.models import AMPGCN
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.tokenize import fit_scaler, sample_present_features, \
        tfidf_sample_features
    from ampnet_tpu_torch.train import make_eval_step

    stats = fit_scaler(data.x) if cfg.scaler == "precomputed" else None
    model = AMPGCN(cfg, scaler_stats=stats,
                   generator=torch.Generator().manual_seed(seed), device=dev)
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
        print(json.dumps({"stage_max_abs_err": stage_err, "precision": precision_state()}),
              file=sys.stderr)
        fail(f"path {name}: card logits disagree with the CPU float64 forward "
             f"(max abs err {err:.3g})")
    return counts, dict(path=name, metrics=metrics, eval_step_first_ms=first_ms,
                        eval_step_warm_ms=warm_ms, cpu_f64_max_abs_err=err,
                        stage_max_abs_err=stage_err)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    from ampnet_tpu_torch.core.config import AMPGCNConfig
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
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = kernel_phases(graph, layout, gen, dev)
    print(json.dumps({"kernel_phases": rows}), flush=True)

    recipe = AMPGCNConfig(num_sampled_vectors=40, token_sampling="tfidf",
                          scaler="precomputed", dropout_rate=0.3,
                          raw_residual="gcn2", use_pallas=True)
    counts_a, path_a = drive_path("A S=40 recommended recipe", recipe, data, graph,
                                  layout, args.seed, dev)
    print(json.dumps(path_a), flush=True)
    if counts_a != {"edge_attention_sums": 16, "edge_attention_layer": 0}:
        fail(f"path A launched {counts_a}, expected 16 edge_attention_sums")

    reference = AMPGCNConfig(num_sampled_vectors=20, use_pallas=True)
    counts_b, path_b = drive_path("B S=20 reference recipe", reference, data, graph,
                                  layout, args.seed, dev)
    print(json.dumps(path_b), flush=True)
    if counts_b != {"edge_attention_sums": 0, "edge_attention_layer": 16}:
        fail(f"path B launched {counts_b}, expected 16 edge_attention_layer")

    k1 = dict(rows["edge_attention_sums_s40"], launches=counts_a["edge_attention_sums"])
    k2 = dict(rows["edge_attention_layer_s20"], launches=counts_b["edge_attention_layer"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
