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

``--cpu-cores`` needs no card either: pinned to each CPU core in turn (one
thread), it takes the float64 reference's suspect steps on the host, the
GCN normalization 1/sqrt(degree) of the Cora-shaped graph in float32 and in
float64 (and sqrt and 1/x apart), ``--reps`` times, and holds each core's
bits against the other cores' (by majority); then the same with all
threads, unpinned. A core, or a thread split, that computes other bits
shows there.

``--analyze FILE ...`` needs no card: it reads the files a failing path A
keeps (chip_smoke.save_evidence) and says which side leaves float64: the
card's and the reference's first GCN layer against float64 recomputed from
the kept operands; the card's first product (``.lin``) against cuBLAS's
own second product of the same operands (bit for bit), against float64
and against emulations of one TF32 product (round to nearest or toward
zero), of 3xTF32 and of one bf16 product; and the card's layer against
the float64 aggregate of its own product.

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
    p.add_argument("--analyze", nargs="+", metavar="FILE")
    p.add_argument("--cpu-cores", action="store_true")
    p.add_argument("--reps", type=int, default=50)
    args = p.parse_args()
    if args.analyze:
        return analyze(args.analyze)
    if args.cpu_cores:
        return cpu_cores(args.reps)
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


def cpu_cores(reps: int) -> int:
    """The host's float steps of the raw residual's normalization on each
    core, against the other cores' bits."""
    import collections

    sys.path.insert(0, ".")
    import chip_smoke as cs
    from ampnet_tpu_torch.ops.gcn import gcn_norm

    _, graph = cs.cora(0, "cpu")
    n = graph.num_nodes_padded
    deg = {dt: torch.arange(1, n + 1, dtype=dt) for dt in (torch.float32, torch.float64)}

    def steps():
        out = {}
        for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
            out[f"rsqrt_{name}"] = 1.0 / deg[dt].clamp_min(1.0).sqrt()
            out[f"sqrt_{name}"] = deg[dt].sqrt()
            out[f"recip_{name}"] = 1.0 / deg[dt]
            out[f"gcn_weights_{name}"] = gcn_norm(graph.senders, graph.receivers, n,
                                                  graph.edge_mask, dtype=dt)[2]
        return out

    def run(tag):
        first, changed = steps(), collections.Counter()
        for _ in range(reps - 1):
            for k, v in steps().items():
                changed[k] += not torch.equal(v, first[k])
        return tag, first, changed

    threads, cores = torch.get_num_threads(), sorted(os.sched_getaffinity(0))
    torch.set_num_threads(1)
    runs = []
    for core in cores:
        os.sched_setaffinity(0, {core})
        runs.append(run(f"core {core}"))
    os.sched_setaffinity(0, set(cores))
    torch.set_num_threads(threads)
    runs.append(run(f"{threads} threads, unpinned"))
    failed = False
    for key in runs[0][1]:
        votes = collections.Counter(bytes(r[1][key].numpy().tobytes()) for r in runs)
        majority = next(r[1][key] for r in runs
                        if r[1][key].numpy().tobytes() == votes.most_common(1)[0][0])
        for tag, first, changed in runs:
            diff = (first[key] != majority)
            rel = float(((first[key] - majority).abs() / majority.abs().clamp_min(1e-30)).max())
            if diff.any() or changed[key]:
                failed = True
                where = diff.nonzero().squeeze(1)
                print(json.dumps(dict(step=key, run=tag, elements_differing=int(diff.sum()),
                                      first=int(where[0]) if where.numel() else None,
                                      last=int(where[-1]) if where.numel() else None,
                                      max_rel=rel, reps_changed=changed[key])), flush=True)
    print(json.dumps({"cpu_cores": cores, "threads": threads, "reps": reps,
                      "steps": list(runs[0][1]), "all_cores_agree": not failed}), flush=True)
    return 2 if failed else 0


def implied_normalization(e, lin, out) -> dict:
    """The GCN normalization a layer's output implies, against 1/sqrt(deg):
    per receiver row i, out_i = sum over its in-edges of w_e lin_{s_e} is
    solved for the weights by least squares (<= 18 neighbours, 128
    columns); the self-loop's weight dinv_i^2 gives node i's factor
    dinv'_i / dinv_i - 1. Which nodes are off, and by how much at each
    degree."""
    from ampnet_tpu_torch.ops.gcn import gcn_norm
    from ampnet_tpu_torch.ops.segment import segment_count

    s, r, _, m = gcn_norm(e["senders"], e["receivers"], e["num_nodes"], e["edge_mask"])
    deg = segment_count(r, e["num_nodes"], m, torch.float64)
    eps = {}
    for i in range(e["num_nodes"]):
        u, inv = torch.unique(s[(r == i) & m], return_inverse=True)
        if not (u == i).any():
            continue
        coef = torch.linalg.lstsq(lin[u].T, out[i].unsqueeze(1)).solution.squeeze(1)
        k = int((u == i).nonzero()[0])
        mult = float((inv == k).sum())
        eps[i] = float((coef[k] * deg[i] / mult).sqrt()) - 1
    off = sorted(i for i, v in eps.items() if abs(v) > 2e-5)
    by_degree = {}
    for i in off:
        by_degree.setdefault(int(deg[i]), set()).add(round(eps[i], 6))
    return dict(nodes=len(eps), nodes_off=len(off), first_off=off[0] if off else None,
                last_off=off[-1] if off else None,
                factor_by_degree={d: sorted(v) for d, v in sorted(by_degree.items())})


def analyze(paths) -> int:
    """Where the kept raw residual of a failed path A leaves float64 (on
    the CPU, from the files alone)."""
    sys.path.insert(0, ".")
    from ampnet_tpu_torch.ops.gcn import gcn_aggregate

    def rounded(x, mantissa_bits, toward_zero=False):
        drop = 23 - mantissa_bits
        bits = x.contiguous().view(torch.int32)
        if not toward_zero:
            bits = bits + (1 << (drop - 1))
        return (bits & ~((1 << drop) - 1)).view(torch.float32)

    def product(x, w, mantissa_bits=None, toward_zero=False, split=False):
        """x @ w.T with each operand rounded as a reduced-precision product
        takes it (the products exact, summed in float64)."""
        if mantissa_bits is None:
            return x.double() @ w.double().T
        xh, wh = rounded(x, mantissa_bits, toward_zero), rounded(w, mantissa_bits, toward_zero)
        out = xh.double() @ wh.double().T
        if split:      # 3xTF32: lo*hi + hi*lo + hi*hi
            xl, wl = rounded(x - xh, mantissa_bits), rounded(w - wh, mantissa_bits)
            out = out + xl.double() @ wh.double().T + xh.double() @ wl.double().T
        return out

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    for path in paths:
        e = torch.load(path, weights_only=False)
        x, w1 = e["x"], e["w1"]
        f64 = product(x, w1)
        # the card's first product: its .lin stage where it was hooked, else
        # cuBLAS's product of the same operands taken after the failure
        lin = e["card"].get("raw_residual_conv1.lin", e["lin_again"])
        lin_report = dict(
            stage_hooked="raw_residual_conv1.lin" in e["card"],
            vs_second_card_product_bits_equal=bool(torch.equal(lin, e["lin_again"])),
            vs_f64=err(lin, f64), cpu_f32_vs_f64=err(x @ w1.T, f64),
            vs_one_tf32_rna=err(lin, product(x, w1, 10)),
            vs_one_tf32_rz=err(lin, product(x, w1, 10, toward_zero=True)),
            vs_3xtf32=err(lin, product(x, w1, 10, split=True)),
            vs_one_bf16=err(lin, product(x, w1, 7)),
            f64_vs_one_tf32_rna=err(f64, product(x, w1, 10)))
        # each side's first GCN layer against float64 recomputed here from
        # the kept operands: the side that leaves it is at fault
        redo = gcn_aggregate(f64, e["senders"], e["receivers"], e["num_nodes"],
                             e["edge_mask"]) + e["b1"].double()
        layer = "raw_residual_conv1"
        sides = dict(card_vs_f64=err(e["card"][layer], redo),
                     reference_vs_f64=err(e["reference_f64"][layer], redo),
                     card_vs_aggregate_of_its_lin=err(e["card"][layer], gcn_aggregate(
                         lin.double(), e["senders"], e["receivers"], e["num_nodes"],
                         e["edge_mask"]) + e["b1"].double()))
        if sides["reference_vs_f64"] > 1e-4:
            sides["reference_normalization"] = implied_normalization(
                e, f64, e["reference_f64"][layer] - e["b1"].double())
        at_fault = ("the float64 reference" if sides["reference_vs_f64"] > 1e-4 else
                    "the card's product" if lin_report["vs_f64"] > 1e-4 else
                    "the card's aggregate" if sides["card_vs_f64"] > 1e-4 else None)
        print(json.dumps({"evidence": path, "device": e.get("device"),
                          "raw_residual_conv1.lin": lin_report, layer: sides,
                          "leaves_float64_first": at_fault,
                          "second_forward_kernels": e["second_forward_kernels"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
