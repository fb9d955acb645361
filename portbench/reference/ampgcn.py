"""Plain-PyTorch reference of AMPGCN with the gcn2 head, its training step
(masked mean NLL or GraphSAINT's node_norm-weighted mean, global-norm clip,
Adam with L2 weight decay) and its ensemble evaluation. It imports nothing
of the program: it is written from the model's equations, and is given
only what the benchmark made (the graph, the scaler statistics, the
weights and the state of the random generator).

The model, per node n with S sampled features:

* tokens: S feature indices drawn with replacement, weighted by TF-IDF
  (idf_j = log(N_real / (1 + df_j))), through the inverse CDF of the row's
  weights; token = [table[j], z-scored x[n, j]];
* two AMPConv layers: per edge (s -> r), multi-head attention with the
  receiver's tokens as queries and the sender's as keys and values, the
  messages' mean over the receiver's live in-edges, then the output
  projection (0 for a node with no live in-edge); ReLU after each;
* the gcn2 head: two GCN hops (D^-1/2 (A + I) D^-1/2 X W + b, ReLU) on the
  z-scored raw features, concatenated to the tokens' mean, then a linear
  classifier and log-softmax.

Training draws, from one generator and in this order: edge dropout over
the padded edges, the token uniforms [N, S], dropout on the tokens before
each conv and after the second, dropout after each GCN hop. Evaluation
draws only the token uniforms, once a forward.

``Precision`` says what the arithmetic is: float64 throughout for the
float32 configurations; for a configuration whose convs compute in
bfloat16, float64 with every value the convs hold in bfloat16 rounded to
it. The lower-precision controls (TF32 products, fp8 convs) are the same
functions with other rounding: ``rounding`` below. Rounding is straight
through (the gradient passes it unchanged)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

FP8_MAX = 448.0          # float8_e4m3fn's largest finite value


def _straight(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    return x + (fn(x.detach()) - x.detach())


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (to nearest, ties to
    even), as the tensor cores read f32 operands in TF32."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32).to(t.dtype)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """float8_e4m3fn with one scale a tensor (its largest magnitude at 448),
    as fp8 training scales its tensors."""
    amax = t.abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return ((t * scale).to(torch.float32).to(torch.float8_e4m3fn).to(t.dtype)) / scale


ROUNDINGS = {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}


@dataclass(frozen=True)
class Precision:
    """``dtype``: the type the reference computes in. ``conv``: the rounding
    of every value the convs hold in their compute type (None: none).
    ``products``: the rounding of every product's operands (None: none)."""

    dtype: torch.dtype = torch.float64
    conv: Optional[str] = None
    products: Optional[str] = None

    def c(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.conv is None else _straight(t, ROUNDINGS[self.conv])

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.products is not None:
            a = _straight(a, ROUNDINGS[self.products])
            b = _straight(b, ROUNDINGS[self.products])
        return a @ b


def precision_of(config: dict) -> Precision:
    """The reference's precision for a configuration."""
    conv = {"float32": None, "bfloat16": "bf16"}[config["model"].get("compute_dtype", "float32")]
    return Precision(torch.float64, conv=conv)


def control_of(config: dict) -> Precision:
    """The control: the nearest precision below the configuration's, TF32
    products for float32, fp8 convs for bfloat16."""
    if config["model"].get("compute_dtype", "float32") == "bfloat16":
        return Precision(torch.float64, conv="fp8")
    return Precision(torch.float32, products="tf32")


# --- weights -----------------------------------------------------------------

# the settings the reference implements; another value is refused
SUPPORTED = {"token_sampling": "tfidf", "scaler": "precomputed", "average_pooling": True,
             "attn_softmax": True, "softmax_out": True, "transformer_block": False,
             "raw_residual": "gcn2", "frontend": "table", "downsample_feature_vectors": True}


def supported(m: dict) -> None:
    bad = {k: m.get(k) for k, v in SUPPORTED.items() if m.get(k) != v}
    if bad or m["embedding_dim"] != m["feat_emb_dim"] + m["val_emb_dim"]:
        raise ValueError(f"the reference does not implement {bad or 'these widths'}")


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation; 0: zeros) of every parameter, by the
    program's state-dict names. Matrices are normal at the variance of their
    initialization (Glorot for the projections and the head, N(0, 1) for the
    feature table, 1/(3 fan_in) for the output projections)."""
    supported(m)
    d, f, c, e = m["embedding_dim"], m["num_node_features"], m["output_dim"], m["feat_emb_dim"]
    spec = [("tokenizer.feature_embedding_table", (f, e), 1.0)]
    for i in (1, 2):
        spec += [(f"conv{i}.w_qkv", (d, 3 * d), math.sqrt(2.0 / (4 * d))),
                 (f"conv{i}.b_qkv", (3 * d,), 0.0),
                 (f"conv{i}.w_out", (d, d), 1.0 / math.sqrt(3 * d)),
                 (f"conv{i}.b_out", (d,), 0.0)]
    spec += [("raw_residual_conv1.lin.weight", (d, f), math.sqrt(2.0 / (f + d))),
             ("raw_residual_conv1.bias", (d,), 0.0),
             ("raw_residual_conv2.lin.weight", (d, d), math.sqrt(2.0 / (2 * d))),
             ("raw_residual_conv2.bias", (d,), 0.0),
             ("final_linear_out.weight", (c, 2 * d), math.sqrt(2.0 / (2 * d + c))),
             ("final_linear_out.bias", (c,), 0.0)]
    return spec


def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter, float32 on ``device``, from one draw of a generator
    on that device seeded with ``seed``."""
    spec = param_spec(m)
    sizes = [int(np.prod(shape)) for _, shape, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, std), size in zip(spec, sizes):
        out[name] = (flat[at:at + size] * std).reshape(shape) if std else \
            torch.zeros(shape, device=device)
        at += size
    return out


# --- the graph ---------------------------------------------------------------

def padded(x, edge_index, y, train, val, test, node_norm, n_pad: int, e_pad: int,
           mean, std, device) -> Dict[str, torch.Tensor]:
    """The padded graph the reference reads: padded nodes are masked out,
    padded edges point at node 0 and are masked out."""
    n, e = x.shape[0], edge_index.shape[1]
    if n > n_pad or e > e_pad:
        raise ValueError(f"graph ({n}, {e}) larger than its pads ({n_pad}, {e_pad})")

    def pad(a, size, dtype, fill=0):
        out = np.full((size,) + np.asarray(a).shape[1:], fill, dtype=dtype)
        out[: len(a)] = a
        return torch.from_numpy(out).to(device)

    g = dict(x=pad(x, n_pad, np.float32),
             senders=pad(edge_index[0], e_pad, np.int64),
             receivers=pad(edge_index[1], e_pad, np.int64),
             node_mask=pad(np.ones(n, bool), n_pad, bool),
             edge_mask=pad(np.ones(e, bool), e_pad, bool),
             y=pad(y, n_pad, np.int64), train=pad(train, n_pad, bool),
             val=pad(val, n_pad, bool), test=pad(test, n_pad, bool),
             mean=torch.from_numpy(mean).to(device), std=torch.from_numpy(std).to(device))
    g["node_norm"] = pad(node_norm, n_pad, np.float32) if node_norm is not None else None
    return g


# --- the model ---------------------------------------------------------------

def _rand(shape, gen) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def token_indices(g: Dict, s: int, gen: torch.Generator) -> torch.Tensor:
    """S TF-IDF-weighted feature indices a node, with replacement, from the
    float32 features (the draw is discrete: it is made in the type the
    features are given in)."""
    x = g["x"]
    present = x != 0
    n_real = g["node_mask"].to(torch.float32).sum()
    df = present.sum(dim=0).to(torch.float32)
    idf = torch.log(n_real / (1.0 + df))
    w = x.abs() * idf.clamp_min(1e-3)[None, :]
    any_present = present.any(dim=1, keepdim=True)
    w = torch.where(present, w, torch.zeros_like(w))
    w = torch.where(any_present, w, torch.ones_like(w))
    cdf = torch.cumsum(w, dim=1)
    u = _rand((x.shape[0], s), gen)
    idx = torch.searchsorted(cdf.contiguous(), (u * cdf[:, -1:]).contiguous(), right=True)
    return idx.clamp_max(x.shape[1] - 1)


def _dropout(x, rate, gen, p: Precision, conv_typed: bool):
    if rate == 0.0:
        return x
    keep = (_rand(x.shape, gen) >= rate).to(x.dtype)
    out = x * keep / (1.0 - rate)
    return p.c(out) if conv_typed else out


def amp_conv(x, w_qkv, b_qkv, w_out, b_out, g, emask, heads: int, p: Precision):
    """One AMPConv on [N, S, D] tokens."""
    n, s, d = x.shape
    dh = d // heads
    x, w_qkv, b_qkv = p.c(x), p.c(w_qkv), p.c(b_qkv)
    qkv = p.c(p.mm(x, w_qkv) + b_qkv)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    snd, rcv = g["senders"], g["receivers"]
    e = snd.shape[0]
    scale = p.c(torch.tensor(1.0 / math.sqrt(dh), dtype=x.dtype, device=x.device))
    qh = p.c(q[rcv].reshape(e, s, heads, dh).transpose(1, 2) * scale)
    kh = k[snd].reshape(e, s, heads, dh).transpose(1, 2)
    vh = v[snd].reshape(e, s, heads, dh).transpose(1, 2)
    att = torch.softmax(p.mm(qh, kh.transpose(-1, -2)), dim=-1)
    msg = p.c(p.mm(p.c(att), vh).transpose(1, 2).reshape(e, s, d))
    live = emask.to(x.dtype)
    total = torch.zeros_like(x).index_add(0, rcv, msg * live[:, None, None])
    count = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(0, rcv, live)
    mean = total / count.clamp_min(1.0)[:, None, None]
    out = p.mm(p.c(mean), p.c(w_out)) + p.c(b_out)
    out = torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))
    return p.c(out)


def gcn_hop(x, weight, bias, g, emask, p: Precision):
    """D^-1/2 (A + I) D^-1/2 (x W^T) + b over the live edges."""
    n = x.shape[0]
    h = p.mm(x, weight.t())
    loops = torch.arange(n, device=x.device)
    snd = torch.cat([g["senders"], loops])
    rcv = torch.cat([g["receivers"], loops])
    live = torch.cat([emask, torch.ones(n, dtype=torch.bool, device=x.device)]).to(x.dtype)
    deg = torch.zeros(n, dtype=x.dtype, device=x.device).index_add(0, rcv, live)
    dinv = torch.where(deg > 0, deg.clamp_min(1.0).rsqrt(), torch.zeros_like(deg))
    w = dinv[snd] * dinv[rcv] * live
    return torch.zeros_like(h).index_add(0, rcv, h[snd] * w[:, None]) + bias


def forward(P: Dict[str, torch.Tensor], g: Dict, m: dict, p: Precision,
            gen: torch.Generator, train: bool) -> torch.Tensor:
    """Log-probs [N, C] in ``p.dtype``; ``train`` applies the dropouts."""
    dt = p.dtype
    rate = m["dropout_rate"] if train else 0.0
    emask = g["edge_mask"]
    if train and m["dropout_adj_rate"] > 0.0:
        emask = emask & (_rand(emask.shape, gen) >= m["dropout_adj_rate"])
    idx = token_indices(g, m["num_sampled_vectors"], gen)
    std = torch.where(g["std"] == 0.0, torch.ones_like(g["std"]), g["std"])
    xn = ((g["x"].to(dt) - g["mean"].to(dt)) / std.to(dt))
    table = P["tokenizer.feature_embedding_table"]
    x = torch.cat([table[idx], torch.take_along_dim(xn, idx, dim=1)[..., None]], dim=-1)
    conv_typed = p.conv is not None
    for i in (1, 2):
        x = _dropout(x, rate, gen, p, conv_typed and i == 2)
        x = torch.relu(amp_conv(x, P[f"conv{i}.w_qkv"], P[f"conv{i}.b_qkv"],
                                P[f"conv{i}.w_out"], P[f"conv{i}.b_out"], g, emask,
                                m["num_heads"], p))
    x = _dropout(x, rate, gen, p, conv_typed)
    pooled = p.c(x.mean(dim=1))
    xr = torch.relu(gcn_hop(xn, P["raw_residual_conv1.lin.weight"],
                            P["raw_residual_conv1.bias"], g, emask, p))
    xr = _dropout(xr, rate, gen, p, False)
    xr = torch.relu(gcn_hop(xr, P["raw_residual_conv2.lin.weight"],
                            P["raw_residual_conv2.bias"], g, emask, p))
    xr = _dropout(xr, rate, gen, p, False)
    head = torch.cat([pooled, xr], dim=-1)
    logits = p.mm(head, P["final_linear_out.weight"].t()) + P["final_linear_out.bias"]
    return torch.log_softmax(logits, dim=-1)


def nll(logp, y, mask):
    w = mask.to(logp.dtype)
    return (-torch.gather(logp, 1, y[:, None])[:, 0] * w).sum() / w.sum().clamp_min(1.0)


def saint_mean_nll(logp, y, node_norm, mask):
    w = node_norm.to(logp.dtype) * mask.to(logp.dtype)
    return (-torch.gather(logp, 1, y[:, None])[:, 0] * w).sum() / w.sum().clamp_min(1e-12)


def loss_of(logp, g: Dict, loss: str):
    train = g["train"] & g["node_mask"]
    if loss == "saint_mean":
        return saint_mean_nll(logp, g["y"], g["node_norm"], train)
    return nll(logp, g["y"], train)


# --- training and evaluation -------------------------------------------------

def cosine_rate(step: int, base: float, t0: Optional[int], t_mult: int = 1,
                eta_min: float = 0.0) -> float:
    """The learning rate of optimizer step ``step`` (0-based): constant
    without ``t0``, else cosine annealing with warm restarts (cycles t0,
    t0 * t_mult, ...)."""
    if not t0:
        return base
    t_i, t_cur = t0, step
    while t_cur >= t_i:
        t_cur -= t_i
        t_i *= t_mult
    return eta_min + (base - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2


@dataclass
class Steps:
    losses: List[float]                  # each step's loss
    first_grad: Dict[str, torch.Tensor]  # step 1's gradient as Adam takes it
    params: Dict[str, torch.Tensor]      # the parameters after the last step


def train_steps(P0: Dict[str, torch.Tensor], graphs: List[Dict], m: dict, opt: dict,
                gen_state: torch.Tensor, p: Precision, loss: str = "full",
                rates: Optional[List[float]] = None) -> Steps:
    """One optimizer step a graph from ``P0``: the loss, its gradient, the
    global-norm clip (scaled by clip / norm when the norm reaches clip), the
    L2 term (+ wd * p), then Adam (betas 0.9 / 0.999, eps 1e-8, bias
    corrected) at ``rates[i]`` (default the constant ``opt['lr']``). The
    random draws continue one generator from ``gen_state``."""
    device = next(iter(P0.values())).device
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    P = {k: v.detach().to(p.dtype).clone().requires_grad_(True) for k, v in P0.items()}
    mom = {k: torch.zeros_like(v) for k, v in P.items()}
    sq = {k: torch.zeros_like(v) for k, v in P.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for t, g in enumerate(graphs, start=1):
        value = loss_of(forward(P, g, m, p, gen, train=True), g, loss)
        grads = dict(zip(P, torch.autograd.grad(value, list(P.values()))))
        losses.append(float(value.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((gr * gr).sum() for gr in grads.values()))
            scale = 1.0 if float(norm) < opt["clip"] else opt["clip"] / float(norm)
            grads = {k: gr * scale + opt["weight_decay"] * P[k] for k, gr in grads.items()}
            if first is None:
                first = {k: gr.clone() for k, gr in grads.items()}
            lr = rates[t - 1] if rates else opt["lr"]
            for k in P:
                mom[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                sq[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                denom = (sq[k] / (1 - b2 ** t)).sqrt() + eps
                P[k] -= lr * (mom[k] / (1 - b1 ** t)) / denom
    return Steps(losses, first, {k: v.detach() for k, v in P.items()})


@torch.no_grad()
def evaluate(P: Dict[str, torch.Tensor], g: Dict, m: dict, gen_state: torch.Tensor,
             draws: int, p: Precision) -> Dict[str, float]:
    """The ensemble eval: the mean of ``draws`` forwards' log-probs, then the
    masked accuracy and mean NLL of each split."""
    device = next(iter(P.values())).device
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    Pp = {k: v.to(p.dtype) for k, v in P.items()}
    logp = sum(forward(Pp, g, m, p, gen, train=False) for _ in range(draws)) / draws
    out = {}
    for split in ("train", "val", "test"):
        mask = g[split] & g["node_mask"]
        out[f"{split}_loss"] = float(nll(logp, g["y"], mask))
        hit = (logp.argmax(dim=-1) == g["y"]) & mask
        out[f"{split}_acc"] = float(hit.sum()) / max(1, int(mask.sum()))
    return out
