"""The per-layer quantities the files under ``portbench/metrics/`` report.
Each takes the traced run's ``Context`` and returns a number, or None
where it finds nothing to read (the metric is then left out of the line)."""
from __future__ import annotations

from typing import Optional

from portbench.lib.work import peak_flops


def edge_attn_roofline(ctx) -> Optional[float]:
    """The least time of the window's edge-attention work over the device
    time of the kernels that carry it, in %."""
    patterns = ctx.kernels("edge_attention")
    if not ctx.trace.matched(patterns):
        return None
    return 100.0 * ctx.work.edge_attention_least_s(ctx.shapes) / ctx.trace.device_s(patterns)


def mfu(ctx) -> Optional[float]:
    """The model FLOP of the window's work over the window and the peak of
    the configuration's type, in %."""
    flops = ctx.work.model_flops(ctx.shapes)
    if not flops:
        return None
    return 100.0 * flops / (ctx.trace.window_s * peak_flops(ctx.shapes))


def torch_glue_ms(ctx) -> Optional[float]:
    """Device ms a training step in operations that are neither edge
    attention nor GEMMs."""
    if not ctx.work.steps or not ctx.trace.device:
        return None
    glue = ctx.trace.device_s(exclude=(ctx.kernels("edge_attention"), ctx.kernels("gemm")))
    return glue * 1e3 / len(ctx.work.steps)


def device_idle(ctx) -> Optional[float]:
    """The share of the window in which no operation runs on the card, in %."""
    if not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def host(ctx, name: str) -> Optional[float]:
    """A number the driver measured on the host beside the window."""
    return ctx.host.get(name)
