"""chip_smoke.py's kernel phases and `routes` phase in its order, with path
A's fixed draw (card vs CPU float64, stage by stage) checked before and
after each, twice over, and one f32 product at the raw residual's shape
(2752 x 1433 @ 1433 x 128) against float64 beside it: which phase, if any,
leaves the card's forward off the reference.

    python3 scripts/torch_path_a_replay.py      (from the repo root, on the card)

One JSON line per check. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from ampnet_tpu_torch.core.config import AMPGCNConfig
    from ampnet_tpu_torch.ops.hopper import build
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.ops.tokenize import tfidf_sample_features

    cs.pin_ieee_f32()
    dev = torch.device("cuda")
    build.build_all()
    ptxas = {(stem, tiles): r for stem in cs.TENSOR_CORE_LIBS
             for tiles, r in build.ptxas_report(stem).items()}
    data, graph = cs.cora(0, dev)
    layout = compute_layout(graph)
    recipe = AMPGCNConfig(num_sampled_vectors=40, token_sampling="tfidf",
                          scaler="precomputed", dropout_rate=0.3, raw_residual="gcn2",
                          use_pallas=True)
    xr = torch.randn(2752, 1433, generator=torch.Generator().manual_seed(5)).to(dev)
    w = torch.randn(128, 1433, generator=torch.Generator().manual_seed(6)).to(dev) * 0.05
    ref_product = xr.cpu().double() @ w.cpu().double().T

    def check(tag):
        model = cs.recipe_model(recipe, data, 0, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        sidx = tfidf_sample_features(graph.x, recipe.num_sampled_vectors, generator=gen,
                                     node_mask=graph.node_mask)
        card, card_stages = cs.stage_outputs(model, graph, sidx, layout)
        ref, ref_stages = cs.cpu_f64_reference(model, graph, sidx)
        product = float(((xr @ w.T).cpu().double() - ref_product).abs().max())
        print(json.dumps({
            "after": tag, "logits": float((card.double() - ref).abs().max()),
            **{k: float((card_stages[k] - ref_stages[k]).abs().max()) for k in ref_stages},
            "fixed_product": product, "mem_alloc": torch.cuda.memory_allocated()}), flush=True)

    check("start")
    for rep in range(2):
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        cs.kernel_phases(graph, layout, gen, dev, ptxas)
        check(f"kernel_phases {rep} ({time.perf_counter() - t0:.0f} s)")
        cs.route_phase(data, gen, dev)
        check(f"routes {rep}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
