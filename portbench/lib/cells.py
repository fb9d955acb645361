"""What the cells' drivers share. A traffic mix names its ``entry``, the
driver ``portbench/drivers/<entry>.py`` whose ``drive(run)`` runs the loop
of the program that the window drives, and hands back an ``Outcome``.

Each driver makes the configuration's graph (its generator,
``portbench/graphs/<generator>.py``) and, from the seed, the weights
(the configuration's reference, ``portbench/reference/<reference>.py``),
hands them to the program, drives the same entry through the first steps
or calls that the reference follows, which warms every shape up, then runs
one window of a fixed amount of work: ``seconds`` times the cell's
``window.per_second`` (its rate when the cell was defined), so that every
run of a cell does the same work and lasts about ``seconds``. Afterwards
it frees the program's state and compares what the window's entry
produced with the reference."""
from __future__ import annotations

import gc
import shutil
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.lib.graphs import GraphArrays, scaler
from portbench.lib.manifest import ROOT, Manifest
from portbench.lib.trace import Trace
from portbench.lib.work import Work

RUNS = ROOT / ".portbench_cache" / "runs"     # a mix's run_dir, inside the checkout


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    cell_data: dict                     # cells/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float                      # process start, time.time()
    ref: ModuleType                     # the configuration's plain reference
    make_graph: Callable[[dict], GraphArrays]   # its graph generator


def make_run(m: Manifest, cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float, config: Optional[dict] = None,
             traffic: Optional[dict] = None) -> Run:
    """A ``Run`` of ``cell`` with the files its names point at (``config``,
    ``traffic``: these in place of the cell's own)."""
    w = m.cell(cell)
    config = config or m.config(w["config"])
    traffic = traffic or m.traffic(w["traffic"])
    return Run(cell=cell, config=config, traffic=traffic, cell_data=m.cell_data(cell),
               seed=seed, seconds=seconds, trace=trace, device=device, started=started,
               ref=m.reference(config["reference"]),
               make_graph=m.graph(config["graph"]["generator"]))


@dataclass
class Outcome:
    e2e: Dict[str, float]               # end-to-end metrics of the window
    work: Work                          # what the window did
    readings: Dict[str, float]          # the numbers compared with the limits
    memory_peak: int
    trace: Optional[Trace] = None
    host: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    # the same readings of the reference at another precision put in the
    # program's place (the control), against the reference
    versus: Optional[Callable[[object], Dict[str, float]]] = None
    phases: Dict[str, float] = field(default_factory=dict)   # set-up, s since start


class Quiet:
    """The loops' log sink: the messages are formatted, then dropped."""

    def log(self, msg: str) -> None:
        pass


def seeds(seed: int) -> Dict[str, int]:
    """Independent seeds for the weights, the training noise, the sampler,
    the evaluation draws and the choice of evaluations compared. The graph
    is the configuration's, the same for every seed (a dataset: every seed
    does the same work)."""
    names = ("weights", "noise", "sampler", "eval", "sample")
    state = np.random.SeedSequence(int(seed) % 2**64).generate_state(len(names), np.uint64)
    return {n: int(v) for n, v in zip(names, state)}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --- what the program is handed ----------------------------------------------

@dataclass
class Setup:
    data: GraphArrays
    stats: Tuple[np.ndarray, np.ndarray]
    weights: Dict[str, torch.Tensor]     # the initial parameters (kept for the reference)
    model: torch.nn.Module
    graph: object                        # the program's padded Graph on the device


def model_fields(config: dict, traffic: dict) -> dict:
    """The model's settings: the configuration's, with the mix's recipe
    (its dropout rates) over them."""
    return {**config["model"], **traffic.get("model", {})}


def setup(run: Run, s: Dict[str, int]) -> Setup:
    """The configuration's graph, the program's model (the port's registry
    entry the configuration names, ``program_model``) with the benchmark's
    weights from the seed loaded, and the program's padded graph on the
    device."""
    from ampnet_tpu_torch.core.graph import from_arrays
    from ampnet_tpu_torch.models import get_model

    g = run.config["graph"]
    data = run.make_graph(g)
    stats = scaler(data.x)
    fields = model_fields(run.config, run.traffic)
    model = get_model(run.config["program_model"], **fields, scaler_stats=stats,
                      generator=torch.Generator().manual_seed(0), device=run.device)
    weights = run.ref.make_weights(fields, s["weights"], run.device)
    own = dict(model.named_parameters())
    if {k: tuple(v.shape) for k, v in own.items()} != \
            {k: tuple(v.shape) for k, v in weights.items()}:
        raise RuntimeError(f"the program's parameters {sorted(own)} are not the "
                           f"reference's {sorted(weights)}")
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(weights[k])
    graph = from_arrays(data.x, data.edge_index, y=data.y, train_mask=data.train_mask,
                        val_mask=data.val_mask, test_mask=data.test_mask,
                        node_norm=np.ones(g["nodes"], np.float32),
                        pad_nodes_to=g["pad_nodes"], pad_edges_to=g["pad_edges"]).to(run.device)
    return Setup(data, stats, weights, model, graph)


def ref_graph(run: Run, st: Setup) -> Dict:
    d, g = st.data, run.config["graph"]
    return run.ref.padded(d.x, d.edge_index, d.y, d.train_mask, d.val_mask, d.test_mask, None,
                      g["pad_nodes"], g["pad_edges"], *st.stats, run.device)


def optimizer_fields(tr: dict) -> dict:
    return dict(lr=tr["learning_rate"], weight_decay=tr["weight_decay"],
                clip=tr["grad_clip"], t0=tr.get("cosine_t0"),
                t_mult=tr.get("cosine_t_mult", 1), eta_min=tr.get("eta_min", 0.0))


def train_state(model, tcfg):
    """The state a loop would make for ``tcfg`` (its optimizer, its noise)."""
    from ampnet_tpu_torch.train import create_train_state, make_optimizer

    opt = make_optimizer(model.parameters(), learning_rate=tcfg.learning_rate,
                         weight_decay=tcfg.weight_decay, cosine_t0=tcfg.cosine_t0,
                         cosine_t_mult=tcfg.cosine_t_mult, eta_min=tcfg.eta_min,
                         grad_clip=tcfg.grad_clip)
    return create_train_state(model, opt, seed=tcfg.seed)


def first_gradient(state) -> Dict[str, torch.Tensor]:
    """Step 1's gradient as Adam took it (clipped, with the L2 term), from
    its first moment after one step: m = (1 - beta1) g (zero where Adam
    holds no moment: it never stepped)."""
    b1 = state.optimizer.adam.param_groups[0]["betas"][0]
    adam = state.optimizer.adam.state
    return {k: adam[p]["exp_avg"].detach() / (1 - b1) if "exp_avg" in adam[p]
            else torch.zeros_like(p) for k, p in state.model.named_parameters()}


def params(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def release(device: torch.device, empty: bool = True) -> None:
    """Collect what earlier calls left (a captured graph and its memory pool
    live until the step that owns it, in a reference cycle, is collected),
    so that it is not collected inside the window; ``empty``: also hand the
    allocator's cache back to the card."""
    gc.collect()
    if device.type == "cuda":
        sync(device)
        if empty:
            torch.cuda.empty_cache()


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def run_dir(run: Run) -> Optional[str]:
    """The mix's ``run_dir`` (checkpoints and logs of the loop): None, or a
    directory of that name for the cell inside the checkout, emptied."""
    name = run.traffic.get("run_dir")
    if not name:
        return None
    path = RUNS / run.cell / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return str(path)


def window_units(run: Run, quantum: int = 1) -> int:
    """The window's work: ``seconds`` times the cell's rate, in whole
    ``quantum``s, at least one."""
    per = run.cell_data["window"]["per_second"]
    return quantum * max(1, round(run.seconds * per / quantum))


def phase(run: Run, phases: Dict[str, float], name: str) -> None:
    phases[name] = time.time() - run.started


# --- the training comparison -------------------------------------------------

def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Optional[Dict[str, torch.Tensor]] = None) -> List[float]:
    """Each leaf's gap of norms: |‖got‖ - ‖want‖| over the larger of
    ‖want‖ and the median leaf's ‖want‖; ``keep``: each leaf's entries that
    count (a leaf with none is left out)."""
    def part(t, k):
        t = t.double()
        return t if keep is None else t[keep[k]]

    names = [k for k in want if keep is None or bool(keep[k].any())]
    norms = {k: float(torch.linalg.vector_norm(part(want[k], k))) for k in names}
    median = float(np.median(list(norms.values())))
    return [abs(float(torch.linalg.vector_norm(part(got[k], k))) - norms[k])
            / max(norms[k], median) for k in names]


def training_readings(losses: List[float], grad: Dict[str, torch.Tensor],
                      delta: Dict[str, torch.Tensor], want,
                      p0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """A training cell's numbers against the reference: the steps' losses
    (the largest relative gap; ``_first``: step 1's), the first gradient's
    leaves and the parameters' change after the steps' leaves (the worst
    leaf; ``_median``: the median leaf). The change leaves out every entry
    whose first gradient in the reference is under a thousandth of the
    median leaf's root mean square (a key's bias under the softmax): under
    Adam such an entry moves by its round-off's sign. The cell's limits
    name the numbers it compares."""
    want_delta = {k: want.params[k] - p0[k].to(want.params[k].dtype) for k in p0}
    rms = [float(v.double().pow(2).mean().sqrt()) for v in want.first_grad.values()]
    floor = 1e-3 * float(np.median(rms))
    moved = {k: v.abs() >= floor for k, v in want.first_grad.items()}
    loss = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, want.losses)]
    grad_gaps = leaf_gaps(grad, want.first_grad)
    update_gaps = leaf_gaps(delta, want_delta, moved)
    return {"loss_gap": max(loss), "loss_gap_first": loss[0],
            "grad_gap": max(grad_gaps), "grad_gap_median": float(np.median(grad_gaps)),
            "update_gap": max(update_gaps), "update_gap_median": float(np.median(update_gaps))}


def training_check(run: Run, st: Setup, graphs: List[Dict], gen_state, loss: str,
                   losses: List[float], grad: Dict[str, torch.Tensor],
                   after: Dict[str, torch.Tensor]):
    """(readings, versus) of a training cell: the program's first steps
    against the reference's, which follow them from the same weights and
    generator state on the same graphs."""
    ref = run.ref
    o = optimizer_fields(run.traffic["train"])
    rates = [ref.cosine_rate(i, o["lr"], o["t0"], o["t_mult"], o["eta_min"])
             for i in range(len(graphs))]
    fields = model_fields(run.config, run.traffic)
    p0 = st.weights

    def steps(p):
        return ref.train_steps(p0, graphs, fields, o, gen_state, p, loss, rates)

    want = steps(ref.precision_of(run.config))
    delta = {k: after[k] - p0[k] for k in after}

    def versus(p) -> Dict[str, float]:
        other = steps(p)
        moved = {k: other.params[k] - p0[k].to(other.params[k].dtype) for k in p0}
        return training_readings(other.losses, other.first_grad, moved, want, p0)

    return training_readings(losses, grad, delta, want, p0), versus
