"""Time the PyTorch port's K1-K9 bodies against each other across
the tensor-core range, on one NVIDIA GPU:  python3 scripts/torch_body_sweep.py [--seed N]

The port's route (``ampnet_tpu_torch/ops/hopper/launch.py::body``) runs a
kernel's tensor-core body wherever (S, D, H) lies in its instantiated range
and its CUDA-core body beyond it. This script checks that choice where both
bodies can run: on the Cora-shaped surrogate of ``chip_smoke.py`` (2708
nodes, 10,556 edges, every 50th masked at run time, random rows from the
seed), for each in-range shape it times each kernel's two bodies in turns
(CUDA-core, tensor-core, tensor-core, CUDA-core; each the mean of 5
launches after a warm-up) and holds them against each other at rtol/atol
1e-4. Prints the card's name and power limit, one JSON line per shape, and
last the shapes (if any) where the CUDA-core body was faster. Exits non-zero
without a CUDA device or when two bodies disagree.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

# (S, D, H): the recipes' shapes and the edges of the instantiated range
SHAPES = [(s, d, h) for s in (4, 8, 16, 20, 24, 32, 40, 48)
          for d, h in ((128, 4), (64, 2), (100, 4), (32, 1), (192, 6), (256, 8))]


def cuda_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    # read by cuBLAS when it loads: TF32 off whatever the environment says
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"
    if not torch.cuda.is_available():
        print("body_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.data.planetoid import synthetic_cora
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as sb
    from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
    from ampnet_tpu_torch.ops.hopper import edge_attention_fused as eaf
    from ampnet_tpu_torch.ops.hopper import edge_attention_variants as eav
    from ampnet_tpu_torch.ops.hopper.format import (chunk_slot_valid, compute_chunked_layout,
                                                    compute_layout, edge_slot_valid,
                                                    snd_slot_valid)
    from ampnet_tpu_torch.ops.hopper.launch import tensor_core_range_error

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    data = synthetic_cora(args.seed)
    graph = from_arrays(data.x, data.edge_index, pad_nodes_to=2752,
                        pad_edges_to=10624).to(dev)
    layout = compute_layout(graph)
    mask = graph.edge_mask.clone()
    mask[torch.nonzero(mask)[::50, 0]] = False
    r_idx = (layout.tile_senders, edge_slot_valid(layout, mask), layout.recv_ptr,
             layout.recv_slots)
    s_idx = (layout.snd_receivers, snd_slot_valid(layout, mask), layout.snd_ptr,
             layout.snd_slots)
    slots = (layout.tile_senders, layout.tile_recv, r_idx[1])
    chunked = compute_chunked_layout(graph)
    chunks = (chunked.senders, chunk_slot_valid(chunked, mask), chunked.chunk_start,
              chunked.chunk_count)
    walked = layout.recv_slots.long()
    nt = layout.recv_ptr.numel() - 1
    deg = torch.bincount(graph.receivers[mask], minlength=nt).float()
    invdeg = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    slower = []
    for s, d, h in SHAPES:
        if tensor_core_range_error(s, d, h) is not None:
            continue
        sp = -(-s // 8) * 8
        kw = dict(s=s, sp=sp, num_heads=h, softmax=True)
        qkv = torch.randn(nt * sp, 3 * d, generator=gen, device=dev)
        qdm = torch.cat([qkv[:, :d], torch.randn(nt * sp, d, generator=gen, device=dev)], 1)
        q, kv, dsum = qkv[:, :d], qkv[:, d:], qdm[:, d:]
        x_rows = q.contiguous()
        w = [t.contiguous() for t in (torch.randn(d, 3 * d, generator=gen, device=dev) * d ** -0.5,
                                      torch.randn(3 * d, generator=gen, device=dev) * 0.1,
                                      torch.randn(d, d, generator=gen, device=dev) * d ** -0.5,
                                      torch.randn(d, generator=gen, device=dev) * 0.1)]
        runs = {
            "edge_attention_sums": lambda b: eaf.edge_attention_sums(q, kv, *r_idx, **kw, body=b),
            "edge_attention_layer": lambda b: eaf.edge_attention_layer(
                x_rows, *w, invdeg, *r_idx, **kw, body=b),
            "edge_attention_bwd_dq": lambda b: bwd.edge_attention_bwd_dq(
                q, kv, dsum, *r_idx, **kw, body=b),
            "edge_attention_bwd_dkv": lambda b: bwd.edge_attention_bwd_dkv(
                qdm, kv, *s_idx, **kw, body=b),
            # K5: dQ and the stream rows of the walked slots (others are not written)
            "edge_attention_bwd_stream": lambda b: (lambda dq, st: torch.cat([
                dq.reshape(-1), st.view(-1, sp * 2 * d)[walked].reshape(-1)]))(
                *sb.edge_attention_bwd_stream(q, kv, dsum, *r_idx, **kw, body=b)),
            "edge_attention_layer_mm": lambda b: eav.edge_attention_layer_mm(
                x_rows, *w, invdeg, *slots, layout.tile_counts, **kw,
                tile_nodes=layout.tile_nodes, body=b),
            "edge_attention_sums_mm": lambda b: eav.edge_attention_sums_mm(
                q, kv, *slots, layout.tile_counts, **kw, tile_nodes=layout.tile_nodes, body=b),
            "edge_attention_sums_v1": lambda b: eav.edge_attention_sums_v1(
                q, kv, *slots, **kw, tile_nodes=layout.tile_nodes, group=8, body=b),
            "edge_attention_sums_chunked": lambda b: eav.edge_attention_sums_chunked(
                q, kv, *chunks, **kw, chunk=chunked.chunk_edges, body=b),
        }
        row = dict(s=s, d=d, h=h)
        for name, run in runs.items():
            tc, simt = run("tc"), run("simt")
            torch.cuda.synchronize()
            if not torch.allclose(tc, simt, rtol=1e-4, atol=1e-4):
                raise SystemExit(f"body_sweep: {name} at S={s}, D={d}, H={h}: the "
                                 f"bodies disagree ({float((tc - simt).abs().max()):.3g})")
            t = [cuda_ms(lambda: run(b)) for b in ("simt", "tc", "tc", "simt")]
            row[name] = dict(tc_ms=(t[1] + t[2]) / 2, simt_ms=(t[0] + t[3]) / 2)
            if row[name]["tc_ms"] > row[name]["simt_ms"]:
                slower.append([name, s, d, h])
        print(json.dumps(row), flush=True)
    print(json.dumps({"tensor_core_body_slower_at": slower}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
