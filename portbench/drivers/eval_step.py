"""``eval_step``: ``make_eval_step(model, draws)`` on the whole graph and
its layout, replayed back to back from one generator, as a selection or a
checkpoint evaluation calls it, after the mix's ``warmup_calls`` (the
first is its capture). A sample of the window's evaluations, drawn from
the seed with the first and the last in it, is compared with the
reference: each split's loss of the ensemble's log-probs."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench.lib.cells import (Outcome, Run, memory_peak, model_fields, phase, ref_graph,
                                 release, seeds, setup, sync, window_units)
from portbench.lib.trace import Window
from portbench.lib.work import Work


def drive(run: Run) -> Outcome:
    from ampnet_tpu_torch.ops.hopper.format import compute_layout
    from ampnet_tpu_torch.train import make_eval_step

    phases: Dict[str, float] = {}
    phase(run, phases, "imported")
    s = seeds(run.seed)
    st = setup(run, s)
    phase(run, phases, "model")
    draws = run.traffic["draws"]
    step = make_eval_step(st.model, num_eval_samples=draws)
    layout = compute_layout(st.graph)
    gen = torch.Generator(device=run.device).manual_seed(s["eval"])

    for _ in range(run.traffic["warmup_calls"]):
        step(st.graph, gen, layout)
    sync(run.device)
    calls = window_units(run)
    phase(run, phases, "warmed")
    rng = np.random.default_rng(s["sample"])
    sample = sorted({0, calls - 1, *rng.choice(calls, min(calls, run.traffic["compared"]),
                                               replace=False).tolist()})
    states, outs = {}, {}
    at = set(sample)
    release(run.device, empty=False)
    with Window(run.trace) as w:
        t0 = time.perf_counter()
        setup_s = time.time() - run.started
        for i in range(calls):
            if i in at:
                states[i] = gen.get_state()
                outs[i] = step(st.graph, gen, layout)
            else:
                step(st.graph, gen, layout)
        sync(run.device)
        window = time.perf_counter() - t0
    peak = memory_peak(run.device)
    got = {i: {k: float(v) for k, v in o.items()} for i, o in outs.items()}
    g = run.config["graph"]
    work = Work(steps=[], forwards=[(g["nodes"], g["directed_edges"])] * (calls * draws))
    del step, outs
    st.model = st.graph = None
    release(run.device)

    rg = ref_graph(run, st)
    fields = model_fields(run.config, run.traffic)

    def evals(p) -> Dict[int, Dict[str, float]]:
        return {i: run.ref.evaluate(st.weights, rg, fields, states[i], draws, p) for i in sample}

    want = evals(run.ref.precision_of(run.config))

    def readings(have: Dict[int, Dict[str, float]]) -> Dict[str, float]:
        return {"eval_loss_gap": max(abs(have[i][k] - want[i][k]) / abs(want[i][k])
                                     for i in sample
                                     for k in ("train_loss", "val_loss", "test_loss"))}

    return Outcome({"setup_s": setup_s, "eval_ms": window * 1e3 / calls}, work,
                   readings(got), peak, w.trace, attempted=calls,
                   versus=lambda p: readings(evals(p)), phases=phases)
