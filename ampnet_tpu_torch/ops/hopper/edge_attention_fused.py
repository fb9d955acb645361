"""Fused AMPConv edge attention on Hopper: the JAX package's
``amp_edge_attention_pallas`` with its forward ``_pallas_core_dynamic`` and
its backward ``_pallas_bwd_dynamic``, scatter-free and stream branch
(``ampnet_tpu/ops/pallas/edge_attention_fused.py:1953-2098, 2430-2505,
2101-2296``).

Two hand-written forward kernels (``csrc/``), each beside its plain torch
version:

* ``edge_attention_sums`` (K1) — per-receiver SUM of per-edge multi-head
  attention messages over projected q / k|v rows. Counterpart of both
  ``_fused_kernel_vmem_v2`` ('vmem' gather) and ``_fused_kernel_vmem_v4``
  ('dma' gather): Hopper has no VMEM-resident/DMA split, K|V are read
  from device memory either way, so one kernel serves both modes.
* ``edge_attention_layer`` (K2) — the whole layer, counterpart of
  ``_fused_kernel_vmem_v6``: a projection launch (q|k|v for every row),
  then the K1 walk with the 1/degree fold and the out-projection and
  live-row bias in its epilogue.

Each has four bodies (``launch.body``): on the tensor cores in 3xTF32
(``csrc/edge_attention_tc.cu``, ``csrc/edge_attention_layer_tc.cu``, one
kernel template in ``csrc/edge_attention_tc.cuh``) within their
instantiated range, on the CUDA cores (``csrc/edge_attention.cu``, and
``csrc/qkv_projection.cu`` for K2's projection) beyond it, at any shape;
and for bf16 rows and for f32 rows under ``mxu_bf16`` the same two in bf16
products with f32 sums: on the tensor cores (``csrc/edge_attention_tc_bf16.cu``,
``csrc/edge_attention_layer_tc_bf16.cu``, template
``csrc/edge_attention_tc_bf16.cuh``) within the range, on the CUDA cores
(the same CUDA-core sources, templated on the rows' type) beyond it.

bf16, as the JAX package: ``x`` in bf16 (the model's
``compute_dtype='bfloat16'``) projects to bf16 q|k|v rows and a bf16
output; ``stream_bf16`` rounds the projected f32 rows to bf16 before the
kernels (and the backward's dsum rows after them), with a token-row stride
aligned to 16; ``mxu_bf16`` keeps f32 rows and rounds only the attention
products' operands, where the JAX body honours it (the 'vmem' gather's
bodies and the whole layer; its 'dma' body does not). Scores, softmax and
every sum stay f32. Each flag is resolved once per call, so forward and
backward agree.

The JAX package's non-default forward routes have their kernels in
``edge_attention_variants.py``: scatter-as-matmul (K6 sums, K7 whole
layer), the packed v1 groups (K9) and the receiver chunks (K8, no caller on
the model path). K6-K9 take bf16 rows as K1 and K2 do, and K6 and K7
``mxu_bf16`` where the JAX bodies honour it; the backward's kernels (K3,
K4, and K5 of the stream backward) take the bf16 rows of either route.

``amp_edge_attention_fused`` chooses between them with the JAX package's
own predicates and constants (``_resolve_gather``, ``_v6_usable``,
``MM_SCATTER_DEFAULT``, ``DMA_V1_DEFAULT``), so both packages take the same
math path for the same config: ``mm_scatter`` turns K1 into K6 and K2 into
K7; a 'dma' gather under ``DMA_V1_DEFAULT`` runs K9.
``amp_edge_attention_fused_core`` / ``make_fused_edge_attention`` are the
fixed-graph entry points (the JAX package's
``amp_edge_attention_pallas_core`` / ``make_pallas_edge_attention``). Around
K1, K6 and K9 the glue stays plain torch, as the JAX package leaves it to
XLA: the QKV projection, the mean, the out-projection.

The op is a ``torch.autograd.Function``. When a gradient is needed its
forward is a sums kernel (K1, or K6 / K9 on their routes) plus glue, never
a whole-layer kernel (the JAX rule: the training forward keeps the sums and
counts for the backward, which K2 and K7 never materialize). Its backward is kernels between
torch glue (the out-projection gradients and dsum before them, the
in-projection gradients ``_finish_bwd`` after): with the sender side of
the layout and ``scatterfree`` the two kernels of
``edge_attention_bwd_scatterfree.py`` (K3 pass R, K4 pass S); without a
sender side, or with ``scatterfree=False``, the stream backward of
``edge_attention_bwd.py`` (K5 pass A, then pass B in torch).
``fused_bwd=False`` takes the gradients by autograd through the plain op.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``, and by body in
``<wrapper>.body_launches``; ``device_memory_launch_counts()`` counts the
CUDA-core launches whose working set was in device memory.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.edge_attention import (
    MHAParams,
    amp_edge_attention,
    attend,
    promoted,
    widened,
)
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd as bwd_stream
from ampnet_tpu_torch.ops.hopper import edge_attention_bwd_scatterfree as bwd
from ampnet_tpu_torch.ops.hopper import edge_attention_variants as variants
from ampnet_tpu_torch.ops.hopper.format import (
    DEFAULT_TILE_NODES,
    TiledCSR,
    build_tiled_csr,
    receiver_index,
)
from ampnet_tpu_torch.ops.hopper.launch import (
    BODIES,
    I,
    P,
    body_of,
    check_node_rows,
    check_rows,
    check_same_dtype,
    check_walk,
    count_launch,
    device_memory_launches,
    entry,
    entry_of,
    f32_body,
    launch_body,
)
from ampnet_tpu_torch.ops.segment import segment_count

# Which fused backward a layout WITH a sender side gets when the caller does
# not say (the JAX package's environment variable and default): scatter-free
# unless AMPNET_SCATTERFREE_BWD is set to something other than 1.
SCATTERFREE_BWD_DEFAULT = os.environ.get("AMPNET_SCATTERFREE_BWD", "1") == "1"
# Scatter-as-matmul accumulate when the caller does not say (K6 for K1, K7
# for K2), and the packed v1 groups (K9) on the 'dma' gather: the JAX
# package's environment variables, both off by default, both read at call
# time.
MM_SCATTER_DEFAULT = os.environ.get("AMPNET_MM_SCATTER", "0") == "1"
DMA_V1_DEFAULT = os.environ.get("AMPNET_DMA_V1", "0") == "1"
# bf16 operands for the attention products of f32 rows (sums in f32), and
# bf16 projected row streams: the JAX package's environment variables, both
# off by default; the op's mxu_bf16 / stream_bf16 arguments override them.
MXU_BF16_DEFAULT = os.environ.get("AMPNET_MXU_BF16", "0") == "1"
STREAM_BF16_DEFAULT = os.environ.get("AMPNET_STREAM_BF16", "0") == "1"

# The JAX package's dispatch constants (its env-var defaults), mirrored so
# the choice between K1 and K2 is the one the JAX package makes.
_VMEM_KV_BUDGET = 80 * 1024 * 1024
_VMEM_TOTAL_BUDGET = 96 * 1024 * 1024
_V6_VMEM_LIMIT = 120 * 1024 * 1024


def _softmax_stack_bytes(group: int, sp: int) -> int:
    """JAX's estimate of the per-head softmax chain's lane-padded stack."""
    return 4 * group * sp * (-(-sp // 128) * 128) * 4


def _v6_fits(n_rows: int, d: int, itemsize: int, tile_rows: int,
             group_rows: int, sp: int) -> bool:
    resident = n_rows * 3 * d * itemsize
    weights = (3 * d * d + d * d + 4 * d) * itemsize
    per_tile = tile_rows * d * (2 * itemsize + 4)
    bufs = group_rows * 3 * d * itemsize
    stack = _softmax_stack_bytes(group_rows // sp, sp)
    return resident + weights + per_tile + bufs + stack + 2 * 1024 * 1024 <= _V6_VMEM_LIMIT


def _resolve_gather(gather: str, n_rows: int, d: int, itemsize: int,
                    tile_rows: int) -> str:
    """'auto' -> 'vmem' while the JAX package would keep K|V resident in
    VMEM, else 'dma'; an explicit 'vmem'/'dma' is honored."""
    if gather != "auto":
        return gather
    kv_bytes = n_rows * 2 * d * itemsize
    tile_overhead = 5 * tile_rows * d * 4 + 6 * 1024 * 1024
    return ("vmem" if kv_bytes <= _VMEM_KV_BUDGET
            and kv_bytes + tile_overhead <= _VMEM_TOTAL_BUDGET else "dma")


def _auto_group(sp: int) -> int:
    return max(1, 768 // sp)


def _stream_align(dtype: torch.dtype, stream_bf16: bool) -> int:
    """The token-row stride's alignment: 16 for bf16 rows, else 8 (the JAX
    package's (16, 128) and (8, 128) tilings)."""
    return 16 if (stream_bf16 or dtype == torch.bfloat16) else 8


def _v6_usable(n: int, n_tiles_nodes: int, sp: int, d: int, itemsize: int,
               tile_nodes: int, group: int, gather: str) -> bool:
    """The JAX predicate for its whole-layer kernel: vmem gather, a tile
    grid covering every node, and the VMEM accounting within budget."""
    return (gather == "vmem" and n_tiles_nodes >= n
            and _v6_fits(n_tiles_nodes * sp, d, itemsize,
                         tile_rows=tile_nodes * sp, group_rows=group * sp, sp=sp))


# ---------------------------------------------------------------- plain versions


def edge_attention_sums_plain(q_rows, kv_rows, tile_senders, tile_valid,
                              recv_ptr, recv_slots, *, s, sp, num_heads,
                              softmax, invdeg=None, mxu_bf16=False):
    """Per-receiver sums over the receiver-major index, in plain torch:
    gather q / k|v per live slot, attend over the S real key rows, scale by
    validity (times invdeg when given), index_add into receiver rows.
    kv_rows may hold more nodes than the receivers.
    The products' operands are in the rows' type (bf16 under ``mxu_bf16``),
    the messages and their sums f32, as the JAX bodies take them. Returns
    [NT*sp, D] f32 (f64 for f64 rows) with pad token rows 0."""
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    recv = torch.repeat_interleave(
        torch.arange(nt, device=q_rows.device),
        (recv_ptr[1:] - recv_ptr[:-1]).long())
    slots = recv_slots[: recv.numel()].long()      # the live slots; padding after
    snd = tile_senders.reshape(-1)[slots].long()
    acc_dtype = torch.promote_types(q_rows.dtype, torch.float32)
    w = tile_valid.reshape(-1)[slots].to(acc_dtype)
    if invdeg is not None:
        w = w * invdeg[recv]
    q = q_rows.reshape(nt, sp, d)[:, :s][recv]
    kv = kv_rows.reshape(-1, sp, 2 * d)[:, :s][snd]
    msg, _ = attend(q, kv[..., :d], kv[..., d:], num_heads, softmax,
                    torch.bfloat16 if mxu_bf16 else None)
    acc = torch.zeros(nt, s, d, dtype=acc_dtype, device=q_rows.device)
    acc.index_add_(0, recv, msg * w[:, None, None])
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, d)


def qkv_projection_plain(x_rows, w_qkv, b_qkv):
    """x_rows @ w_qkv + b_qkv summed in f32 and rounded once to x_rows'
    type (the JAX whole-layer kernel's f32 dot plus bias, then its bf16
    scratch)."""
    return (widened(x_rows) @ widened(w_qkv) + widened(b_qkv)).to(x_rows.dtype)


def edge_attention_layer_plain(x_rows, w_qkv, b_qkv, w_out, b_out, invdeg,
                               tile_senders, tile_valid, recv_ptr, recv_slots,
                               *, s, sp, num_heads, softmax, mxu_bf16=False):
    """Whole layer in plain torch: project, mean over in-edges (1/degree
    folded into each edge), out-projection, b_out on live rows only. In
    x_rows' type as the JAX kernel: with bf16 rows the f32 mean rounds to
    bf16 before the out-projection, whose f32 sum rounds to bf16 before the
    bias is added in bf16."""
    d = x_rows.shape[1]
    dt = x_rows.dtype
    nt = recv_ptr.numel() - 1
    qkv = qkv_projection_plain(x_rows, w_qkv, b_qkv)
    mean = edge_attention_sums_plain(
        qkv[:, :d], qkv[:, d:], tile_senders, tile_valid, recv_ptr, recv_slots,
        s=s, sp=sp, num_heads=num_heads, softmax=softmax, invdeg=invdeg,
        mxu_bf16=mxu_bf16)
    out = (widened(mean.reshape(nt, sp, d)[:, :s].to(dt)) @ widened(w_out)).to(dt)
    out = out + b_out * (invdeg > 0).to(dt)[:, None, None]
    return F.pad(out, (0, 0, 0, sp - s)).reshape(nt * sp, d)


# ---------------------------------------------------------------- kernels

_SIGNATURES = {
    "ampnet_edge_attention_sums": [P, I, P, I, P, P, P, P, P,
                                   I, I, I, I, I, I, P],
    "ampnet_edge_attention_layer": [P, I, P, P, P, P, P, P, P, P,
                                    I, I, I, I, I, I, P],
}
# the CUDA-core bodies also take their device-memory working set (pointer,
# blocks; 0, 0 for shared memory) before the stream
for _name in ("ampnet_edge_attention_sums", "ampnet_edge_attention_layer"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name + "_mxu"] = _SIGNATURES[_name]
    for _suffix in ("_simt", "_simt_bf16", "_simt_mxu"):
        _SIGNATURES[_name + _suffix] = _SIGNATURES[_name][:-1] + [P, I, P]
# (library, entry point) of each body on each row type (launch.entry_of):
# K1's sums, K2's attention launch (its projection launch is
# variants.layer_projection, K7's too); a bf16 body on f32 rows is
# mxu_bf16's (bf16 products of f32 rows)
F32, BF16 = torch.float32, torch.bfloat16
_SUMS = {("tc", F32): ("edge_attention_tc", "ampnet_edge_attention_sums"),
         ("simt", F32): ("edge_attention", "ampnet_edge_attention_sums_simt"),
         ("tc_bf16", BF16): ("edge_attention_tc_bf16", "ampnet_edge_attention_sums_bf16"),
         ("tc_bf16", F32): ("edge_attention_tc_bf16", "ampnet_edge_attention_sums_mxu"),
         ("simt_bf16", BF16): ("edge_attention", "ampnet_edge_attention_sums_simt_bf16"),
         ("simt_bf16", F32): ("edge_attention", "ampnet_edge_attention_sums_simt_mxu")}
_LAYER_ATTENTION = {
    ("tc", F32): ("edge_attention_layer_tc", "ampnet_edge_attention_layer"),
    ("simt", F32): ("edge_attention", "ampnet_edge_attention_layer_simt"),
    ("tc_bf16", BF16): ("edge_attention_layer_tc_bf16", "ampnet_edge_attention_layer_bf16"),
    ("tc_bf16", F32): ("edge_attention_layer_tc_bf16", "ampnet_edge_attention_layer_mxu"),
    ("simt_bf16", BF16): ("edge_attention", "ampnet_edge_attention_layer_simt_bf16"),
    ("simt_bf16", F32): ("edge_attention", "ampnet_edge_attention_layer_simt_mxu")}


def _entry(lib_name: str, fn_name: str):
    return entry(lib_name, fn_name, _SIGNATURES[fn_name])


def _check_layout(device, tile_senders, tile_valid, recv_ptr, recv_slots):
    check_walk(device, tile_senders, tile_valid, recv_ptr, recv_slots,
               ("tile_senders", "tile_valid", "recv_ptr", "recv_slots"))


def edge_attention_sums(q_rows, kv_rows, tile_senders, tile_valid, recv_ptr,
                        recv_slots, *, s, sp, num_heads, softmax, body=None,
                        mxu_bf16=False):
    """K1: per-receiver sums [NT*sp, D] f32 (pad token rows 0).

    q_rows [NT*sp, D] and kv_rows [KV*sp, 2D], both f32 or both bf16, may
    be row-strided views (e.g. column slices of one packed q|k|v buffer).
    KV, the whole nodes kv_rows hold, may exceed NT: the edge-partitioned path's
    queries are a shard's own nodes, its keys and values its own plus the
    exchanged ones (``fused_attention_aggregate``); the grid is NT, the
    gathered rows take 64-bit offsets.
    The tensor-core bodies gather kv_rows in 16-byte copies and take S <=
    48, D/H <= 32 and H * ceil(S/16) <= 12 warps (8 up to S=24), and 48 <
    S <= 64 with D/H <= 32 a multiple of 8 (one block per receiver and head;
    ``launch.tensor_core_range_error``); beyond that, or where kv_rows'
    address, row stride or width is not a multiple of 16 bytes, the
    CUDA-core body runs (``launch.body_of``; ``body`` names one, else the
    rule picks). bf16 rows, and f32 rows under ``mxu_bf16``, run a bf16
    body. The layout arrays are int32 (format.py). CPU tensors run the
    plain version."""
    if not q_rows.is_cuda:
        return edge_attention_sums_plain(
            q_rows, kv_rows, tile_senders, tile_valid, recv_ptr, recv_slots,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax, mxu_bf16=mxu_bf16)
    dev = q_rows.device
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    dt = check_same_dtype(("q_rows", q_rows), ("kv_rows", kv_rows))
    check_rows("q_rows", q_rows, dev, nt * sp, d, dt)
    check_node_rows("kv_rows", kv_rows, dev, sp, 2 * d, dt)
    _check_layout(dev, tile_senders, tile_valid, recv_ptr, recv_slots)
    body = body_of("edge_attention_sums", body, s, d, num_heads, ("kv_rows", kv_rows),
                   mxu_bf16=mxu_bf16)
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    lib_fn = _entry(*entry_of("edge_attention_sums", _SUMS, body, dt))
    launch_body("edge_attention_sums", body, lib_fn, (
        q_rows.data_ptr(), q_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        tile_senders.data_ptr(), tile_valid.data_ptr(), recv_ptr.data_ptr(),
        recv_slots.data_ptr(), out.data_ptr(), nt, s, sp, d, num_heads,
        int(softmax)), s, d, num_heads, nt, dev)
    count_launch(edge_attention_sums, body)
    return out


def _layer_attention(qkv, w_out, b_out, invdeg, tile_senders, tile_valid, recv_ptr,
                     recv_slots, *, s, sp, num_heads, softmax, body):
    """K2's second launch: the mean over in-edges, the out-projection and
    the live-row bias, over q|k|v rows; out in their type."""
    nt = recv_ptr.numel() - 1
    d = w_out.shape[0]
    out = torch.empty(nt * sp, d, dtype=qkv.dtype, device=qkv.device)
    launch_body("edge_attention_layer", body,
                _entry(*entry_of("edge_attention_layer", _LAYER_ATTENTION,
                                  body, qkv.dtype)), (
        qkv.data_ptr(), qkv.stride(0), tile_senders.data_ptr(), tile_valid.data_ptr(),
        recv_ptr.data_ptr(), recv_slots.data_ptr(), invdeg.data_ptr(), w_out.data_ptr(),
        b_out.data_ptr(), out.data_ptr(), nt, s, sp, d, num_heads, int(softmax)),
        s, d, num_heads, nt, qkv.device)
    return out


def edge_attention_layer(x_rows, w_qkv, b_qkv, w_out, b_out, invdeg,
                         tile_senders, tile_valid, recv_ptr, recv_slots, *,
                         s, sp, num_heads, softmax, body=None, mxu_bf16=False):
    """K2: the whole layer over raw token rows x_rows [NT*sp, D] -> output
    rows [NT*sp, D] in x_rows' type (pad token rows 0). invdeg [NT] (f32)
    is 1/degree of the runtime mask (0 for degree 0); the four weights are
    in x_rows' type. Two launches: the q|k|v projection, then attention
    with the mean, out-projection and live-row bias fused. The bodies and
    the rule between them are K1's (the tensor-core projection also copies
    x_rows and w_qkv in 16-byte pieces): bf16 rows run both launches in
    bf16 products; f32 rows under ``mxu_bf16`` only the attention's, the
    projection and out-projection staying f32 on the same cores (3xTF32 or
    the CUDA cores), as the JAX kernel."""
    if not x_rows.is_cuda:
        return edge_attention_layer_plain(
            x_rows, w_qkv, b_qkv, w_out, b_out, invdeg, tile_senders,
            tile_valid, recv_ptr, recv_slots, s=s, sp=sp,
            num_heads=num_heads, softmax=softmax, mxu_bf16=mxu_bf16)
    dev = x_rows.device
    nt = recv_ptr.numel() - 1
    d = x_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    dt = check_same_dtype(("x_rows", x_rows), ("w_qkv", w_qkv), ("w_out", w_out))
    check_rows("x_rows", x_rows, dev, nt * sp, d, dt)
    check_rows("w_qkv", w_qkv, dev, d, 3 * d, dt)
    check_rows("w_out", w_out, dev, d, d, dt)
    for name, t, numel, tdt in (("b_qkv", b_qkv, 3 * d, dt), ("b_out", b_out, d, dt),
                                ("invdeg", invdeg, nt, torch.float32)):
        if t.device != dev or t.dtype != tdt or not t.is_contiguous() or t.numel() != numel:
            raise ValueError(f"{name}: expected {numel} contiguous {tdt} on {dev}")
    if not w_qkv.is_contiguous() or not w_out.is_contiguous():
        raise ValueError("w_qkv and w_out must be contiguous")
    _check_layout(dev, tile_senders, tile_valid, recv_ptr, recv_slots)
    body = body_of("edge_attention_layer", body, s, d, num_heads,
                   ("x_rows", x_rows), ("w_qkv", w_qkv), mxu_bf16=mxu_bf16)
    # under mxu_bf16 the f32 projection stays f32, on the same cores
    qkv = variants.layer_projection(x_rows, w_qkv, b_qkv,
                                    f32_body(body) if dt == torch.float32 else body)
    out = _layer_attention(qkv, w_out, b_out, invdeg, tile_senders, tile_valid, recv_ptr,
                           recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax,
                           body=body)
    count_launch(edge_attention_layer, body)
    return out


for _wrapper in (edge_attention_sums, edge_attention_layer):
    _wrapper.launches = 0
    _wrapper.body_launches = dict.fromkeys(BODIES, 0)

KERNEL_WRAPPERS = (edge_attention_sums, edge_attention_layer,
                   bwd.edge_attention_bwd_dq, bwd.edge_attention_bwd_dkv,
                   bwd_stream.edge_attention_bwd_stream, *variants.KERNEL_WRAPPERS)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
        fn.body_launches = dict.fromkeys(BODIES, 0)
    device_memory_launches.clear()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def body_launch_counts() -> dict:
    """The launches of every kernel (K1-K9) by body: {wrapper: {'tc': n,
    'simt': m, 'tc_bf16': k, 'simt_bf16': l}}."""
    return {fn.__name__: dict(fn.body_launches) for fn in KERNEL_WRAPPERS}


def device_memory_launch_counts() -> dict:
    """The launches of a CUDA-core body whose working set was in device
    memory: {kernel: n}, K7's attention launch under K6's name."""
    return dict(device_memory_launches)


def counter_state() -> dict:
    """Every launch counter above, flat: {(wrapper, 'all' or body): n,
    ('device_memory', kernel): n}. A captured graph launches its kernels
    without calling a wrapper, so it records the counters' change over its
    capture (``counts_since``) and adds it at each replay (``add_counts``)."""
    state = {}
    for fn in KERNEL_WRAPPERS:
        state[(fn.__name__, "all")] = fn.launches
        state.update({(fn.__name__, b): n for b, n in fn.body_launches.items()})
    state.update({("device_memory", k): n for k, n in device_memory_launches.items()})
    return state


def counts_since(before: dict) -> dict:
    """The change of every counter since ``before`` (``counter_state``)."""
    return {k: n - before.get(k, 0) for k, n in counter_state().items()
            if n != before.get(k, 0)}


def add_counts(change: dict, times: int = 1) -> None:
    """Add ``times`` x a change of the counters (negative: take it back)."""
    wrappers = {fn.__name__: fn for fn in KERNEL_WRAPPERS}
    for (name, key), n in change.items():
        if name == "device_memory":
            device_memory_launches[key] = device_memory_launches.get(key, 0) + times * n
        elif key == "all":
            wrappers[name].launches += times * n
        else:
            wrappers[name].body_launches[key] += times * n


# ---------------------------------------------------------------- the op


def _grid(x, w_qkv, tile_senders, recv_ptr, tile_nodes, gather, stream_bf16):
    """Checks x against the layout; returns (nt, sp, gather) with the row
    stride and the gather resolved ONCE, so forward and backward agree. The
    stride aligns to 16 for bf16 rows; the gather is sized on the projected
    rows' item size (2 under stream_bf16, else x's type promoted against
    w_qkv's, as the JAX package sizes it)."""
    num_tiles = tile_senders.shape[0]
    n, s, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the fused op computes in float32 or bfloat16, got {x.dtype}")
    # tile_nodes must MATCH the value the layout was built with (recv_local
    # = receiver % tile_nodes); a mismatch reads wrong rows silently. The
    # tile grid must cover x's rows exactly.
    if not ((num_tiles - 1) * tile_nodes < n <= num_tiles * tile_nodes):
        raise ValueError(
            f"tile_nodes={tile_nodes} inconsistent with layout: {num_tiles} "
            f"tiles x {tile_nodes} vs {n} node rows — pass the tile_nodes "
            f"the layout was built with (compute_layout)")
    nt = num_tiles * tile_nodes
    if recv_ptr.numel() != nt + 1:
        raise ValueError(f"recv_ptr has {recv_ptr.numel()} entries, expected {nt + 1}")
    align = _stream_align(x.dtype, stream_bf16)
    sp = -(-s // align) * align          # the JAX package's token-row stride
    itemsize = 2 if stream_bf16 else torch.promote_types(x.dtype, w_qkv.dtype).itemsize
    gather = _resolve_gather(gather, max(n, nt) * sp, d, itemsize,
                             tile_rows=tile_nodes * sp)
    return nt, sp, gather


def _token_rows(x, nt, sp):
    """[N, S, C] -> [NT*sp, C]: tokens padded to the row stride and node
    rows to NT (the tile grid, or the K|V rows); pad rows are never read as
    keys or kept as queries."""
    n, s, d = x.shape
    return F.pad(x, (0, 0, 0, sp - s, 0, nt - n)).reshape(nt * sp, d)


def _finish_bwd(x, w_qkv, dq_nodes, dkv_nodes):
    """In-projection gradients without the [N, S, 3D] concat: dq and dkv go
    through separate products against the split w_qkv columns, in f32 (the
    kernels' gradients) against bf16 x and weights promoted, then rounded to
    x's and w_qkv's types as the JAX package's ``_finish_bwd``."""
    d = dq_nodes.shape[-1]
    xf, wf = widened(x), widened(w_qkv)
    dx = (dq_nodes @ wf[:, :d].T + dkv_nodes @ wf[:, d:].T).to(x.dtype)
    d_wqkv = torch.cat([torch.einsum("nsd,nse->de", xf, dq_nodes),
                        torch.einsum("nsd,nse->de", xf, dkv_nodes)], dim=1)
    d_bqkv = torch.cat([dq_nodes.sum(dim=(0, 1)), dkv_nodes.sum(dim=(0, 1))])
    return dx, d_wqkv.to(w_qkv.dtype), d_bqkv.to(w_qkv.dtype)


class _Route(NamedTuple):
    """What the forward dispatch reads beside x and the parameters."""
    receivers: torch.Tensor
    edge_mask: Optional[torch.Tensor]
    tile_senders: torch.Tensor
    tile_valid: torch.Tensor
    recv_ptr: torch.Tensor
    recv_slots: torch.Tensor
    tile_recv: Optional[torch.Tensor]     # K6, K7, K9 walk slots, not receivers
    tile_counts: Optional[torch.Tensor]   # K6, K7: structural trip counts
    num_heads: int
    softmax: bool
    tile_nodes: int
    gather: str
    mm_scatter: bool
    dma_v1: bool
    group: int                            # the JAX group, read by _v6_usable only
    mxu_bf16: bool = False                # bf16 operands of f32 rows' products
    stream_bf16: bool = False             # projected rows rounded to bf16


def _forward(x, w_qkv, b_qkv, w_out, b_out, r: _Route, keep_parts: bool):
    """The JAX package's forward dispatch (``_pallas_core_dynamic``).
    Returns (out, sums, count, sp, gather); sums and count are None on the
    whole-layer route, which ``keep_parts`` rules out (it never
    materializes the sums a fused backward needs)."""
    n, s, d = x.shape
    nt, sp, gather = _grid(x, w_qkv, r.tile_senders, r.recv_ptr, r.tile_nodes, r.gather,
                           r.stream_bf16)
    x_rows = _token_rows(x, nt, sp)
    count = segment_count(r.receivers, n, r.edge_mask)
    kw = dict(s=s, sp=sp, num_heads=r.num_heads, softmax=r.softmax)
    walk = (r.tile_senders, r.tile_valid, r.recv_ptr, r.recv_slots)
    v1 = gather != "vmem" and r.dma_v1
    if (v1 or r.mm_scatter) and r.tile_recv is None:
        raise ValueError("mm_scatter and the packed v1 groups walk the layout's "
                         "slots: pass tile_recv (and tile_counts for mm_scatter)")
    if r.mm_scatter and not v1 and r.tile_counts is None:
        raise ValueError("mm_scatter needs the layout's structural tile_counts")
    slots = (r.tile_senders, r.tile_recv, r.tile_valid)

    if not keep_parts and _v6_usable(n, nt, sp, d, x.element_size(), r.tile_nodes,
                                     r.group or _auto_group(sp), gather):
        invdeg = torch.where(count > 0, 1.0 / count.clamp_min(1.0),
                             torch.zeros_like(count))
        # the weights in x's type, as the JAX package's v6 call casts them
        weights = (*(t.to(x.dtype).contiguous() for t in (w_qkv, b_qkv, w_out, b_out)),
                   F.pad(invdeg, (0, nt - n)))
        if r.mm_scatter:
            rows = variants.edge_attention_layer_mm(
                x_rows, *weights, *slots, r.tile_counts, **kw, tile_nodes=r.tile_nodes,
                mxu_bf16=r.mxu_bf16)
        else:
            rows = edge_attention_layer(x_rows, *weights, *walk, **kw, mxu_bf16=r.mxu_bf16)
        return rows[: n * sp].reshape(n, sp, d)[:, :s], None, None, sp, gather

    q_rows, kv_rows = _projected_rows(x_rows, w_qkv, b_qkv, r.stream_bf16)
    # the JAX package's 'dma' body (v4) does not round to mxu_bf16; its
    # 'vmem' bodies do
    mxu = r.mxu_bf16 and gather == "vmem"
    if v1:       # mm_scatter is ignored on this route, as in the JAX package
        emax = r.tile_senders.shape[1]
        sums = variants.edge_attention_sums_v1(
            q_rows, kv_rows, *slots, **kw, tile_nodes=r.tile_nodes,
            group=8 if emax % 8 == 0 else 1, gather=gather)
    elif r.mm_scatter:
        sums = variants.edge_attention_sums_mm(
            q_rows, kv_rows, *slots, r.tile_counts, **kw, tile_nodes=r.tile_nodes,
            mxu_bf16=mxu)
    else:
        sums = edge_attention_sums(q_rows, kv_rows, *walk, **kw, mxu_bf16=mxu)
    sums = sums[: n * sp].reshape(n, sp, d)[:, :s]
    mean = sums / count.clamp_min(1.0)[:, None, None]
    mean, w_out, b_out = promoted(mean.to(x.dtype), w_out, b_out)
    out = mean @ w_out + b_out
    out = torch.where((count > 0)[:, None, None], out, torch.zeros_like(out))
    return out, sums, count, sp, gather


def _projected_rows(x_rows, w_qkv, b_qkv, stream_bf16):
    """q and k|v rows: x_rows @ w_qkv + b_qkv in the promoted type (bf16 x
    and weights: bf16, as XLA's projection), rounded to bf16 under
    stream_bf16."""
    x_rows, w_qkv, b_qkv = promoted(x_rows, w_qkv, b_qkv)
    qkv = x_rows @ w_qkv + b_qkv
    d = x_rows.shape[1]
    q_rows, kv_rows = qkv[:, :d], qkv[:, d:]
    if stream_bf16:
        q_rows, kv_rows = q_rows.to(torch.bfloat16), kv_rows.to(torch.bfloat16)
    return q_rows, kv_rows


class _FusedOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_out, b_out, args):
        route, senders, snd, backward = args
        # snd: None, or the sender-tiled side pass S walks (snd_receivers,
        # snd_valid, snd_ptr, snd_slots). backward: None (no gradient will be
        # asked), 'scatterfree' (K3 + K4), 'stream' (K5 + pass B) or 'plain'
        # (autograd through the plain op).
        out, sums, count, sp, gather = _forward(
            x, w_qkv, b_qkv, w_out, b_out, route, keep_parts=backward is not None)
        ctx.backward_route = backward
        if backward == "plain":
            ctx.save_for_backward(x, w_qkv, b_qkv, w_out, b_out, senders,
                                  route.receivers, route.edge_mask)
            ctx.kernel_args = dict(num_heads=route.num_heads, softmax=route.softmax)
        elif backward is not None:
            ctx.save_for_backward(x, w_qkv, b_qkv, w_out, sums, count,
                                  route.tile_senders, route.tile_valid, route.recv_ptr,
                                  route.recv_slots, *(snd or ()))
            ctx.kernel_args = dict(s=x.shape[1], sp=sp, num_heads=route.num_heads,
                                   softmax=route.softmax)
            ctx.stream_bf16 = route.stream_bf16
            # the JAX rule: only the dma gather folds its stream in chunks
            ctx.chunked = gather != "vmem"
        return out

    @staticmethod
    def backward(ctx, gout):
        if ctx.backward_route == "plain":
            return (*_plain_bwd(ctx.saved_tensors, gout, **ctx.kernel_args), None)
        (x, w_qkv, b_qkv, w_out, sums, count, tile_senders, tile_valid, recv_ptr,
         recv_slots, *snd) = ctx.saved_tensors
        kw = ctx.kernel_args
        n, s, d = x.shape
        nt, sp = recv_ptr.numel() - 1, kw["sp"]
        q_rows, kv_rows = _projected_rows(_token_rows(x, nt, sp), w_qkv, b_qkv,
                                          ctx.stream_bf16)

        # out-projection and mean, in torch as the JAX package leaves them to XLA
        gm = torch.where((count > 0)[:, None, None], gout, torch.zeros_like(gout))
        denom = count.clamp_min(1.0)[:, None, None]
        d_wout = torch.einsum("nsd,nse->de", sums / denom, widened(gm))
        d_bout = gm.sum(dim=(0, 1))
        # dsum = gradient of the per-receiver SUM of messages, 0 on pad token
        # rows and pad node rows; f32 (bf16 products promote against the f32
        # count), rounded to the rows' type for the kernels
        gm, w_out_t = promoted(gm, w_out.T)
        dsum_rows = _token_rows((gm @ w_out_t) / denom, nt, sp).to(q_rows.dtype)

        if ctx.backward_route == "scatterfree":
            qdm = torch.cat([q_rows, dsum_rows], dim=1)     # packed [Q | dsum]
            dq_rows = bwd.edge_attention_bwd_dq(
                q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                recv_ptr, recv_slots, **kw)
            dkv_rows = bwd.edge_attention_bwd_dkv(qdm, kv_rows, *snd, **kw)
            dkv_nodes = dkv_rows.reshape(nt, sp, 2 * d)[:n, :s]
        else:
            dq_rows, dkv_nodes = bwd_stream.stream_backward(
                q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                recv_ptr, recv_slots, **kw,
                chunk_bytes=bwd_stream._STREAM_CHUNK_BYTES if ctx.chunked else None)
            dkv_nodes = dkv_nodes[:n]
        dq_nodes = dq_rows.reshape(nt, sp, d)[:n, :s]
        dx, d_wqkv, d_bqkv = _finish_bwd(x, w_qkv, dq_nodes, dkv_nodes)
        return (dx, d_wqkv, d_bqkv, d_wout.to(w_out.dtype), d_bout.to(w_out.dtype),
                None)


def _plain_bwd(saved, gout, *, num_heads, softmax):
    """fused_bwd=False: the five gradients by autograd through the plain op
    (the JAX package's ``bwd_xla``), the forward recomputed."""
    x, w_qkv, b_qkv, w_out, b_out, senders, receivers, edge_mask = saved
    leaves = [t.detach().requires_grad_() for t in (x, w_qkv, b_qkv, w_out, b_out)]
    with torch.enable_grad():
        out, _ = amp_edge_attention(
            leaves[0], senders, receivers, edge_mask, MHAParams(*leaves[1:]),
            num_heads, softmax=softmax, return_weights=False)
    return torch.autograd.grad(out, leaves, gout)


def amp_edge_attention_fused(
    x: torch.Tensor,                 # [N, S, D]
    params: MHAParams,
    receivers: torch.Tensor,         # [E] (degree counts)
    edge_mask: Optional[torch.Tensor],
    tile_senders: torch.Tensor,      # [T, EMAX] int32 (compute_layout)
    tile_valid: torch.Tensor,        # [T, EMAX] int32, may carry a RUNTIME mask
    recv_ptr: torch.Tensor,          # [T*TN + 1] int32 STRUCTURAL trip counts
    recv_slots: torch.Tensor,        # [live slots] int32
    num_heads: int,
    softmax: bool = True,
    tile_nodes: int = DEFAULT_TILE_NODES,
    gather: str = "auto",
    snd_receivers: Optional[torch.Tensor] = None,  # [T, EMAXS] the sender-tiled
    snd_valid: Optional[torch.Tensor] = None,      # side (snd_valid may carry
    snd_ptr: Optional[torch.Tensor] = None,        # the RUNTIME mask): needed
    snd_slots: Optional[torch.Tensor] = None,      # by passes R and S
    scatterfree: Optional[bool] = None,  # None = AMPNET_SCATTERFREE_BWD
    fused_bwd: bool = True,
    senders: Optional[torch.Tensor] = None,        # [E], for fused_bwd=False
    mm_scatter: Optional[bool] = None,   # None = AMPNET_MM_SCATTER
    tile_recv: Optional[torch.Tensor] = None,      # [T, EMAX] receiver rows and
    tile_counts: Optional[torch.Tensor] = None,    # [T] STRUCTURAL counts: the
    #                                    mm_scatter and v1 routes walk slots
    mxu_bf16: Optional[bool] = None,     # None = AMPNET_MXU_BF16
    stream_bf16: Optional[bool] = None,  # None = AMPNET_STREAM_BF16
) -> torch.Tensor:
    """AMPConv through the Hopper kernels; same result and gradients as
    ``ops.edge_attention.amp_edge_attention`` ([N, S, D]).

    ``gather`` ('auto' | 'vmem' | 'dma') only feeds the JAX package's
    dispatch rule, which picks K2 (its v6 whole-layer kernel) or K1 plus
    torch glue for a forward that needs no gradient; each kernel is the same
    for both gathers. When autograd will ask for a gradient the forward is
    K1 plus glue. The backward is the scatter-free one (K3, K4) when the
    four ``snd_*`` arrays are given and ``scatterfree`` holds, else the
    stream backward (K5, then pass B in torch, folded in tile chunks under
    the 'dma' gather); ``fused_bwd=False`` recomputes through the plain op
    under autograd instead and needs ``senders``.

    ``mm_scatter`` takes the scatter-as-matmul forward: K7 where K2 would
    run, K6 where K1 would (also under autograd: the backward does not
    depend on how the forward accumulates). With ``DMA_V1_DEFAULT`` a 'dma'
    gather runs the packed v1 groups (K9) whatever ``mm_scatter`` says.
    These routes need ``tile_recv`` (and ``tile_counts`` for mm_scatter).

    ``mxu_bf16`` rounds the attention products' operands of f32 rows to
    bf16 where the JAX body does (K2, K7; K1 and K6 on the 'vmem' gather);
    ``stream_bf16`` rounds the projected q and k|v rows (and the backward's
    dsum rows) to bf16 and aligns the row stride to 16; bf16 x runs the
    whole op in bf16 rows with a bf16 output. Both flags are resolved here,
    once, for the forward and the backward.

    K1-K7 and K9 each run the body ``launch.body`` picks at x's (S, D),
    ``num_heads`` and the rows' type: the tensor cores within their range,
    else the CUDA cores; in bf16 products on bf16 rows, or under
    ``mxu_bf16`` where it reaches, else in f32."""
    snd = (snd_receivers, snd_valid, snd_ptr, snd_slots)
    if any(t is None for t in snd):
        if any(t is not None for t in snd):
            raise ValueError("pass all of snd_receivers, snd_valid, snd_ptr and "
                             "snd_slots, or none of them")
        snd = None
    elif snd_receivers.shape[0] != tile_senders.shape[0]:
        raise ValueError(
            f"sender layout has {snd_receivers.shape[0]} tiles vs receiver "
            f"layout's {tile_senders.shape[0]} — both must be built with the "
            f"same tile_nodes over the same padded node count")
    if scatterfree is None:
        scatterfree = SCATTERFREE_BWD_DEFAULT
    if not scatterfree:
        snd = None
    if mm_scatter is None:
        mm_scatter = MM_SCATTER_DEFAULT
    if mxu_bf16 is None:
        mxu_bf16 = MXU_BF16_DEFAULT
    if stream_bf16 is None:
        stream_bf16 = STREAM_BF16_DEFAULT
    if not fused_bwd and senders is None:
        raise ValueError("fused_bwd=False differentiates the plain op and needs "
                         "the edge list's senders")
    # whether autograd will record this call (Function.forward cannot tell:
    # it runs with grad mode off and sees needs_input_grad under no_grad too),
    # and which backward it then gets
    backward = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        backward = ("plain" if not fused_bwd
                    else "scatterfree" if snd is not None else "stream")
    route = _Route(receivers, edge_mask, tile_senders, tile_valid, recv_ptr,
                   recv_slots, tile_recv, tile_counts, num_heads, softmax, tile_nodes,
                   gather, mm_scatter, DMA_V1_DEFAULT, 0, mxu_bf16, stream_bf16)
    return _FusedOp.apply(x, *params, (route, senders, snd, backward))


# ---------------------------------------------------------------- the partitioned op


class _AggregateOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_tokens, kv_tokens, args):
        walk, snd, kw, ntg = args
        n_loc, s, d = q_tokens.shape
        n_all = kv_tokens.shape[0]
        nt = walk[2].numel() - 1
        q_rows = _token_rows(q_tokens, nt, kw["sp"])
        kv_rows = _token_rows(kv_tokens, n_all, kw["sp"])
        sums = edge_attention_sums(q_rows, kv_rows, *walk, **kw)
        ctx.save_for_backward(q_tokens, kv_tokens, *walk, *(snd or ()))
        ctx.kw, ctx.ntg, ctx.scatterfree = kw, ntg, snd is not None
        return sums[: n_loc * kw["sp"]].reshape(n_loc, kw["sp"], d)[:, :s]

    @staticmethod
    def backward(ctx, g):
        q_tokens, kv_tokens, *arrays = ctx.saved_tensors
        walk, snd = arrays[:4], arrays[4:]
        kw = ctx.kw
        sp = kw["sp"]
        n_loc, s, d = q_tokens.shape
        n_all = kv_tokens.shape[0]
        nt = walk[2].numel() - 1
        q_rows = _token_rows(q_tokens, nt, sp)
        kv_rows = _token_rows(kv_tokens, n_all, sp)
        dsum_rows = _token_rows(g.to(q_rows.dtype), nt, sp)
        if ctx.scatterfree:
            # dQ by local receiver, dK|dV by sender over the sender tiles of
            # the K|V axis (K|V padded to that grid, Q|dsum gathered by
            # local receiver)
            dq_rows = bwd.edge_attention_bwd_dq(q_rows, kv_rows, dsum_rows, *walk, **kw)
            qdm = torch.cat([q_rows, dsum_rows], dim=1)
            kv_g = _token_rows(kv_tokens, ctx.ntg, sp)
            dkv = bwd.edge_attention_bwd_dkv(qdm, kv_g, *snd, **kw)
            dkv = dkv.reshape(ctx.ntg, sp, 2 * d)[:n_all, :s]
        else:
            dq_rows, dkv = bwd_stream.stream_backward(q_rows, kv_rows, dsum_rows, *walk, **kw)
        dq = dq_rows.reshape(nt, sp, d)[:n_loc, :s]
        return dq.to(q_tokens.dtype), dkv.to(kv_tokens.dtype), None


def fused_attention_aggregate(
    q_tokens: torch.Tensor,          # [N_loc, S, D] projected queries (local nodes)
    kv_tokens: torch.Tensor,         # [N_all, S, 2D] projected packed K|V
    tile_senders: torch.Tensor,      # [T, EMAX] int32 sender rows of kv_tokens
    tile_valid: torch.Tensor,        # [T, EMAX] int32 (may carry a runtime mask)
    recv_ptr: torch.Tensor,          # [T*TN + 1] int32 receiver-major index
    recv_slots: torch.Tensor,        # [live slots] int32
    num_heads: int,
    softmax: bool = True,
    tile_nodes: int = DEFAULT_TILE_NODES,
    snd_receivers: Optional[torch.Tensor] = None,  # [Tg, EMAXS] LOCAL receiver ids
    snd_valid: Optional[torch.Tensor] = None,      # the sender side over the
    snd_ptr: Optional[torch.Tensor] = None,        # Tg tiles of the K|V axis:
    snd_slots: Optional[torch.Tensor] = None,      # the scatter-free backward
    scatterfree: Optional[bool] = None,  # None = AMPNET_SCATTERFREE_BWD
) -> torch.Tensor:
    """Fused per-edge attention + per-receiver SUM on projected tensors
    (the JAX package's ``fused_attention_aggregate``,
    ``ampnet_tpu/ops/pallas/edge_attention_fused.py:2508-2660``): the
    building block of the edge-partitioned path (``parallel/edge_partition.py``).
    Q comes from the shard's local nodes, K|V from the exchanged rows
    (local plus halo, or all-gathered); the layout covers the local
    receivers with sender ids into K|V. The exchange stays outside, so its
    own backward carries the boundary rows' gradients home.

    Returns the SUM of messages per local receiver [N_loc, S, D] (f32; the
    mean, the out-projection and the zero-degree mask are the caller's).
    Forward K1 over N_loc receivers gathering from N_all K|V rows. Backward:
    with the sender side (four ``snd_*`` arrays, Tg tiles covering N_all)
    and ``scatterfree``, K3 over the receivers plus K4 over the Tg sender
    tiles; else K5 plus pass B summing into N_all rows."""
    num_tiles = tile_senders.shape[0]
    n_loc, s, d = q_tokens.shape
    n_all = kv_tokens.shape[0]
    if kv_tokens.shape[1:] != (s, 2 * d):
        raise ValueError(f"kv_tokens {tuple(kv_tokens.shape)} vs q_tokens "
                         f"{tuple(q_tokens.shape)}: expected [N_all, {s}, {2 * d}]")
    # tile_nodes must match the value the layout was built with: the tile
    # grid must cover the local rows exactly
    if not ((num_tiles - 1) * tile_nodes < n_loc <= num_tiles * tile_nodes):
        raise ValueError(
            f"tile_nodes={tile_nodes} inconsistent with layout: {num_tiles} "
            f"tiles x {tile_nodes} vs {n_loc} local node rows — pass the "
            f"tile_nodes the layout was built with (partition_layouts)")
    if recv_ptr.numel() != num_tiles * tile_nodes + 1:
        raise ValueError(f"recv_ptr has {recv_ptr.numel()} entries, expected "
                         f"{num_tiles * tile_nodes + 1}")
    snd = (snd_receivers, snd_valid, snd_ptr, snd_slots)
    if any(t is None for t in snd):
        if any(t is not None for t in snd):
            raise ValueError("pass all of snd_receivers, snd_valid, snd_ptr and "
                             "snd_slots, or none of them")
        snd = None
    if scatterfree is None:
        scatterfree = SCATTERFREE_BWD_DEFAULT
    ntg = 0
    if snd is not None and scatterfree:
        t_g = snd_receivers.shape[0]
        # the sender grid tiles the K|V axis (local + halo, or all-gathered)
        if not ((t_g - 1) * tile_nodes < n_all <= t_g * tile_nodes):
            raise ValueError(
                f"sender layout grid {t_g} x {tile_nodes} inconsistent with "
                f"{n_all} K|V node rows — build it over the exchanged axis "
                f"with the same tile_nodes (partition_layouts)")
        ntg = t_g * tile_nodes
        if snd_ptr.numel() != ntg + 1:
            raise ValueError(f"snd_ptr has {snd_ptr.numel()} entries, expected {ntg + 1}")
    else:
        snd = None
    align = _stream_align(q_tokens.dtype, False)
    kw = dict(s=s, sp=-(-s // align) * align, num_heads=num_heads, softmax=softmax)
    walk = (tile_senders, tile_valid, recv_ptr, recv_slots)
    return _AggregateOp.apply(q_tokens, kv_tokens, (walk, snd, kw, ntg))


# ---------------------------------------------------------------- fixed graphs


def _flag(value: Optional[bool], default: bool) -> bool:
    return default if value is None else value


def _route_of(tcsr: TiledCSR, device, receivers, edge_mask, num_heads, softmax,
              gather, group, mxu_bf16=None, stream_bf16=None) -> _Route:
    """A host-side TiledCSR as the dispatch reads it, its arrays on device."""
    counts = (tcsr.counts if tcsr.counts is not None
              else (np.asarray(tcsr.valid) != 0).sum(-1))
    ptr, slots = receiver_index(np.asarray(tcsr.recv_local), counts, tcsr.tile_nodes)
    t = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)).to(device)
         for k, v in dict(senders=tcsr.senders, recv=tcsr.recv_local, valid=tcsr.valid,
                          counts=counts, ptr=ptr, slots=slots).items()}
    return _Route(receivers, edge_mask, t["senders"], t["valid"], t["ptr"], t["slots"],
                  t["recv"], t["counts"], num_heads, softmax, tcsr.tile_nodes, gather,
                  MM_SCATTER_DEFAULT, DMA_V1_DEFAULT, group,
                  _flag(mxu_bf16, MXU_BF16_DEFAULT), _flag(stream_bf16, STREAM_BF16_DEFAULT))


def amp_edge_attention_fused_core(
    x: torch.Tensor,                 # [N, S, D]
    params: MHAParams,
    tcsr: TiledCSR,                  # host layout (build_tiled_csr)
    receivers: torch.Tensor,         # [E] (degree counts)
    edge_mask: Optional[torch.Tensor],
    num_heads: int,
    softmax: bool = True,
    gather: str = "auto",
    group: int = 0,
    mxu_bf16: Optional[bool] = None,     # None = AMPNET_MXU_BF16
    stream_bf16: Optional[bool] = None,  # None = AMPNET_STREAM_BF16
) -> torch.Tensor:
    """Forward only, over a host-side layout (the JAX package's
    ``amp_edge_attention_pallas_core``): the dispatch of
    ``amp_edge_attention_fused`` for a forward that keeps nothing, with
    ``mm_scatter`` taken from ``MM_SCATTER_DEFAULT``. ``group`` is the JAX
    edge group (0 = its automatic choice); here it only enters the
    ``_v6_usable`` accounting. No autograd graph is recorded."""
    route = _route_of(tcsr, x.device, receivers, edge_mask, num_heads, softmax,
                      gather, group, mxu_bf16, stream_bf16)
    with torch.no_grad():
        return _forward(x, *params, route, keep_parts=False)[0]


class _FixedGraphOp(torch.autograd.Function):
    """The forward through the kernels, whole-layer route included; the
    backward by autograd through the plain op."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, w_out, b_out, args):
        route, senders = args
        ctx.save_for_backward(x, w_qkv, b_qkv, w_out, b_out, senders,
                              route.receivers, route.edge_mask)
        ctx.kernel_args = dict(num_heads=route.num_heads, softmax=route.softmax)
        return _forward(x, w_qkv, b_qkv, w_out, b_out, route, keep_parts=False)[0]

    @staticmethod
    def backward(ctx, gout):
        return (*_plain_bwd(ctx.saved_tensors, gout, **ctx.kernel_args), None)


def make_fused_edge_attention(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_mask: np.ndarray,
    num_nodes_padded: int,
    num_heads: int,
    softmax: bool = True,
    tile_nodes: int = DEFAULT_TILE_NODES,
    group: int = 0,
    gather: str = "auto",
    mxu_bf16: Optional[bool] = None,     # None = AMPNET_MXU_BF16
    stream_bf16: Optional[bool] = None,  # None = AMPNET_STREAM_BF16
):
    """A fused edge-attention closure for a FIXED graph structure (the JAX
    package's ``make_pallas_edge_attention``): the layout is built once on
    the host and moved to the device of the first x it sees. Returns
    fn(x [N, S, D], params) -> out [N, S, D]; its backward recomputes the
    gradients through the plain op. ``MM_SCATTER_DEFAULT``,
    ``DMA_V1_DEFAULT`` and, where their arguments are None,
    ``MXU_BF16_DEFAULT`` and ``STREAM_BF16_DEFAULT`` are read at each
    call."""
    tcsr = build_tiled_csr(senders, receivers, edge_mask, num_nodes_padded,
                           tile_nodes, max(group, 1))
    on_device = {}

    def fused(x: torch.Tensor, params: MHAParams) -> torch.Tensor:
        if x.device not in on_device:
            on_device[x.device] = (
                _route_of(tcsr, x.device, torch.as_tensor(receivers, device=x.device),
                          torch.as_tensor(edge_mask, device=x.device), num_heads,
                          softmax, gather, group),
                torch.as_tensor(senders, device=x.device))
        route, snd = on_device[x.device]
        route = route._replace(mm_scatter=MM_SCATTER_DEFAULT, dma_v1=DMA_V1_DEFAULT,
                               mxu_bf16=_flag(mxu_bf16, MXU_BF16_DEFAULT),
                               stream_bf16=_flag(stream_bf16, STREAM_BF16_DEFAULT))
        return _FixedGraphOp.apply(x, *params, (route, snd))

    return fused
