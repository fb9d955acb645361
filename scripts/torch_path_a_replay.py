"""Runs down an error of path A (chip_smoke.py's S=40 eval against float64 on
the CPU) that shows in some processes and not in others.

    python3 scripts/torch_path_a_replay.py [--fill-uninitialized] [--phases P]
                                           [--path-a] [--offsets]
    (from the repo root, on the card)

Replays chip_smoke.py's phases in its order (``--phases``: ``kernels``,
``routes``, both by default, or ``none``) with path A's fixed draw (card vs
CPU float64, stage by stage; a GCN layer's product alone as its ``.lin``)
checked at the start and after each phase, with the raw residual's first
product against float64 on the CPU and on the card, taken again, in
another layout and against one TF32 product of the same operands
(``chip_smoke.raw_residual_product``). ``--path-a`` then runs
chip_smoke.py's own path A (``drive_path``: the 8-draw eval step, its warm
steps and profile, then the fixed draw; on a failure it prints the kernels
the second forward ran). ``--fill-uninitialized`` runs all of it with
``torch.use_deterministic_algorithms(True, warn_only=True)`` and
``torch.utils.deterministic.fill_uninitialized_memory``: every float buffer
from ``torch.empty`` starts as NaN, so a NaN in a kernel phase's result, a
stage or the logits names a buffer read before anything wrote it.
``--offsets`` takes the raw residual's first product (the standardized
2752 x 1433 features @ its 1433 x 128 weight) on views of a larger buffer
that start 0, 4, ..., 32 bytes in, each against float64, with the kernels
cuBLAS ran for it. ``--phases none`` without ``--path-a`` is the short run
to put under ``compute-sanitizer``. ``--no-checks`` leaves out the checks
between the phases: the phases and path A in chip_smoke.py's own order,
with no model forward on the card before path A's. ``--tf32`` is an experiment, not a
check: every f32 matmul of torch runs in TF32 (cuBLAS's override and
torch's precision set to it), so that the checks show what error, stage by
stage, TF32 products leave.

One JSON line per check. Exits non-zero without a CUDA device, and 2 where
a check failed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fill-uninitialized", action="store_true")
    p.add_argument("--phases", default="kernels,routes")
    p.add_argument("--path-a", action="store_true")
    p.add_argument("--offsets", action="store_true")
    p.add_argument("--tf32", action="store_true")
    p.add_argument("--no-checks", action="store_true")
    args = p.parse_args()
    phases = [] if args.phases == "none" else args.phases.split(",")
    if not set(phases) <= {"kernels", "routes"}:
        p.error(f"--phases takes kernels, routes or none, not {args.phases}")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from ampnet_tpu_torch.core.config import AMPGCNConfig
    from ampnet_tpu_torch.ops.hopper import build
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.ops.tokenize import standardize, tfidf_sample_features

    cs.pin_ieee_f32()
    if args.tf32:                 # before cuBLAS loads: it reads the override then
        os.environ["NVIDIA_TF32_OVERRIDE"] = "1"
        if hasattr(torch.backends, "fp32_precision"):   # torch >= 2.9: the new API only
            torch.backends.fp32_precision = "tf32"
            torch.backends.cuda.matmul.fp32_precision = "tf32"
        else:
            torch.backends.cuda.matmul.allow_tf32 = True
    if args.fill_uninitialized:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    dev = torch.device("cuda")
    build.build_all()
    ptxas = {(stem, tiles): r for stem in cs.TENSOR_CORE_LIBS
             for tiles, r in build.ptxas_report(stem).items()}
    data, graph = cs.cora(0, dev)
    layout = compute_layout(graph)
    recipe = AMPGCNConfig(num_sampled_vectors=40, token_sampling="tfidf",
                          scaler="precomputed", dropout_rate=0.3, raw_residual="gcn2",
                          use_pallas=True)
    print(json.dumps({"mode": vars(args), "precision": cs.precision_state()}), flush=True)
    failed = []

    def nan_count(t) -> int:
        return int(torch.isnan(t).sum()) if t.is_floating_point() else 0

    def check(tag):
        if args.no_checks:
            return
        model = cs.recipe_model(recipe, data, 0, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        sidx = tfidf_sample_features(graph.x, recipe.num_sampled_vectors, generator=gen,
                                     node_mask=graph.node_mask)
        card, card_stages = cs.stage_outputs(model, graph, sidx, layout)
        ref, ref_stages = cs.cpu_f64_reference(model, graph, sidx)
        err = float((card.double() - ref).abs().max())
        row = {"after": tag, "logits": err,
               **{k: float((card_stages[k] - ref_stages[k]).abs().max()) for k in ref_stages},
               "raw_residual_product": cs.raw_residual_product(
                   model, graph, card_stages["raw_residual_conv1.lin"]),
               "mem_alloc": torch.cuda.memory_allocated()}
        nans = {k: nan_count(v) for k, v in (("logits", card), *card_stages.items())}
        if any(nans.values()):
            row["nan"] = nans
        if any(nans.values()) or not torch.allclose(card.double(), ref, rtol=cs.MODEL_RTOL,
                                                     atol=cs.MODEL_ATOL):
            failed.append(tag)
        print(json.dumps(row), flush=True)

    def nan_rows(rows) -> dict:
        """The NaNs in a kernel phase's numbers (its errors and times)."""
        return {k: v for k, v in rows.items() if any(
            isinstance(x, float) and x != x for x in v.values())}

    check("start")
    gen = torch.Generator(device=dev).manual_seed(0)
    if "kernels" in phases:
        t0 = time.perf_counter()
        rows, _ = cs.kernel_phases(graph, layout, gen, dev, ptxas)
        if nan_rows(rows):
            failed.append("kernels")
            print(json.dumps({"kernel_phase_nan": nan_rows(rows)}), flush=True)
        check(f"kernel_phases ({time.perf_counter() - t0:.0f} s)")
    if "routes" in phases:
        cs.route_phase(data, gen, dev)
        check("routes")
    if args.path_a:
        try:
            _, report, logits = cs.drive_path("A S=40 recommended recipe", recipe, data,
                                              graph, layout, 0, dev)
            report["nan"] = nan_count(logits)
            print(json.dumps({"path_a": report}), flush=True)
            if report["nan"]:
                failed.append("path A")
        except SystemExit as e:           # chip_smoke's fail(): keep the diagnostics going
            print(json.dumps({"path_a_failed": str(e)}), flush=True)
            failed.append("path A")
    if args.offsets:
        offsets(cs, data, graph, recipe, dev, standardize, failed)
    print(json.dumps({"failed": failed}), flush=True)
    return 2 if failed else 0


def offsets(cs, data, graph, recipe, dev, standardize, failed):
    """The raw residual's first product on views that start 0..32 bytes into
    a larger buffer, against float64, and the kernels each ran."""
    model = cs.recipe_model(recipe, data, 0, dev)
    with torch.no_grad():
        x = standardize(graph.x, mean=model.scaler_mean, std=model.scaler_std,
                        node_mask=graph.node_mask)
        w = model.raw_residual_conv1.lin.weight
        ref = x.cpu().double() @ w.cpu().double().T
        cs.device_kernels(lambda: torch.nn.functional.linear(x, w))   # the profiler's first trace
        rows = []
        for offset in range(0, 33, 4):
            buf = torch.zeros(x.numel() + 16, device=dev)
            view = buf[offset // 4: offset // 4 + x.numel()].view_as(x)
            view.copy_(x)
            out = {}
            kernels = cs.device_kernels(
                lambda: out.update(y=torch.nn.functional.linear(view, w)))
            err = float((out["y"].cpu().double() - ref).abs().max())
            rows.append(dict(offset_bytes=offset, max_abs_err=err, kernels=kernels))
            if not torch.allclose(out["y"].cpu().double(), ref, rtol=cs.MODEL_RTOL,
                                  atol=cs.MODEL_ATOL):
                failed.append(f"offset {offset}")
    print(json.dumps({"raw_residual_product_by_offset": rows,
                      "ref_max_abs": float(ref.abs().max())}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
