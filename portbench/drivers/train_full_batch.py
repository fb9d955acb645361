"""``train_full_batch``: the recipe's whole-graph training loop, as a user
runs it, with the mix's TrainConfig.

Set-up drives the loop's own call through the steps the reference follows:
the mix's ``first_calls``, a call of one epoch (its state gives step 1's
gradient as Adam took it), then calls of a whole dispatch each, which run
the window's captured program (``epochs_per_dispatch`` steps in one CUDA
graph) with their selection evaluations; these calls warm every shape the
window runs. The window is one call over a multiple of the selection
cadence in epochs. The reference follows every step of the first calls:
their losses, step 1's gradient, and the parameters' change after the
last."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict

from portbench.lib.cells import (Outcome, Quiet, Run, first_gradient, memory_peak, model_fields,
                                 params, phase, ref_graph, release, run_dir, seeds, setup, sync,
                                 train_state, training_check, window_units)
from portbench.lib.trace import Window
from portbench.lib.work import Work


def drive(run: Run) -> Outcome:
    from ampnet_tpu_torch.core.config import TrainConfig
    from ampnet_tpu_torch.train import train_full_batch

    phases: Dict[str, float] = {}
    phase(run, phases, "imported")
    s = seeds(run.seed)
    st = setup(run, s)
    phase(run, phases, "model")
    tcfg = TrainConfig(**run.traffic["train"], seed=s["noise"] % 2**63, run_dir=run_dir(run),
                       epochs=1)
    state = train_state(st.model, tcfg)
    gen0 = state.generator.get_state().clone()
    quiet = Quiet()

    def call(epochs: int):
        return train_full_batch(st.model, st.graph, dataclasses.replace(tcfg, epochs=epochs),
                                log=quiet, state=state)["history"]

    first = run.traffic["first_calls"]
    if first[0] != 1:
        raise ValueError(f"first_calls {first}: the first call is of one epoch (step 1's gradient)")
    losses = [row["loss"] for row in call(1)]
    grad = {k: v.clone() for k, v in first_gradient(state).items()}
    for epochs in first[1:]:
        losses += [row["loss"] for row in call(epochs)]
    after = params(st.model)
    cadence = tcfg.select_best_every or 1
    epochs = window_units(run, cadence)
    phase(run, phases, "warmed")

    release(run.device, empty=False)
    with Window(run.trace) as w:
        t0 = time.perf_counter()
        setup_s = time.time() - run.started
        call(epochs)
        sync(run.device)
        window = time.perf_counter() - t0
    peak = memory_peak(run.device)

    g, m = run.config["graph"], model_fields(run.config, run.traffic)
    live = g["directed_edges"] * (1.0 - m["dropout_adj_rate"])
    evals = (epochs // cadence if tcfg.select_best_every else 0) + 1
    work = Work(steps=[(g["nodes"], live)] * epochs,
                forwards=[(g["nodes"], g["directed_edges"])] * (evals * tcfg.num_eval_samples))
    del state
    st.model = st.graph = None
    release(run.device)

    readings, versus = training_check(run, st, [ref_graph(run, st)] * len(losses), gen0, "full",
                                      losses, grad, after)
    return Outcome({"setup_s": setup_s, "train_step_ms": window * 1e3 / epochs}, work,
                   readings, peak, w.trace, attempted=epochs, versus=versus, phases=phases)
