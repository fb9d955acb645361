"""Scatter-free backward of the fused edge attention on Hopper: passes R
and S of the JAX package's ``fused_edge_bwd_dq`` / ``fused_edge_bwd_dkv``
(``ampnet_tpu/ops/pallas/edge_attention_bwd_scatterfree.py``).

Two hand-written kernels, each beside its plain torch version:

* ``edge_attention_bwd_dq`` (K3) — pass R: per edge, recompute the scores
  and the softmax, dW = dMsg V^T, the softmax backward, dQ = dS K / sqrt(dh);
  summed per receiver over the receiver-major index. Counterpart of both
  ``_dq_kernel_vmem`` and ``_dq_kernel_dma``.
* ``edge_attention_bwd_dkv`` (K4) — pass S: the same recompute over the
  sender-tiled side, dV = W^T dMsg and dK = dS^T Q / sqrt(dh), summed per
  sender over the sender-major index (``format.py``: ``snd_ptr``,
  ``snd_slots``). Counterpart of ``_dkv_kernel_vmem`` and ``_dkv_kernel_dma``.

Each has four bodies (``launch.body``): on the tensor cores in 3xTF32
(``csrc/edge_attention_bwd_dq_tc.cu``, ``csrc/edge_attention_bwd_tc.cu``)
within their instantiated range, on the CUDA cores (``csrc/edge_attention_bwd.cu``)
beyond it, at any shape, and for bf16 rows (the JAX package's bf16 model
and ``stream_bf16``) the same two in bf16 products with f32 sums: on the
tensor cores (``csrc/edge_attention_bwd_dq_tc_bf16.cu``,
``csrc/edge_attention_bwd_tc_bf16.cu``) within the range, on the CUDA
cores (``csrc/edge_attention_bwd.cu`` templated on the rows' type) beyond
it. Their outputs are f32 whatever the rows' type.

One kernel per pass serves both gathers: Hopper reads the gathered rows
from device memory either way. Neither uses atomics, so the sums are taken
in slot order and repeat bit for bit.

The plain versions spell the same arithmetic out in tensor math over the
same index (gather, recompute, softmax backward, ``index_add_``); they are
not autograd of the forward. They round where the JAX bodies round: the
products' operands in the rows' type (q times 1/sqrt(dh) in that type, the
f32 W and dS rounded to it), the sums f32, dQ and dK scaled by 1/sqrt(dh)
in f32 after their products. A wrapper given CPU tensors runs its plain
version; given CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in ``<wrapper>.launches``, and by body in
``<wrapper>.body_launches``.
"""
from __future__ import annotations


import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.edge_attention import head_scale, widened
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
    entry,
    entry_of,
    launch_body,
)

_LIB = "edge_attention_bwd"
_SIGNATURES = {
    "ampnet_edge_attention_bwd_dq": [P, I, P, I, P, I, P, P, P, P, P,
                                     I, I, I, I, I, I, P],
    "ampnet_edge_attention_bwd_dkv": [P, I, P, I, P, P, P, P, P,
                                      I, I, I, I, I, I, P],
}
# the CUDA-core bodies also take their device-memory working set (pointer,
# blocks; 0, 0 for shared memory) before the stream
for _name in ("ampnet_edge_attention_bwd_dq", "ampnet_edge_attention_bwd_dkv"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]
    _SIGNATURES[_name + "_simt"] = _SIGNATURES[_name + "_simt_bf16"] = \
        _SIGNATURES[_name][:-1] + [P, I, P]
# (library, entry point) of each body on each row type (launch.entry_of)
F32, BF16 = torch.float32, torch.bfloat16
_DQ = {("tc", F32): ("edge_attention_bwd_dq_tc", "ampnet_edge_attention_bwd_dq"),
       ("simt", F32): (_LIB, "ampnet_edge_attention_bwd_dq_simt"),
       ("tc_bf16", BF16): ("edge_attention_bwd_dq_tc_bf16", "ampnet_edge_attention_bwd_dq_bf16"),
       ("simt_bf16", BF16): (_LIB, "ampnet_edge_attention_bwd_dq_simt_bf16")}
_DKV = {("tc", F32): ("edge_attention_bwd_tc", "ampnet_edge_attention_bwd_dkv"),
        ("simt", F32): (_LIB, "ampnet_edge_attention_bwd_dkv_simt"),
        ("tc_bf16", BF16): ("edge_attention_bwd_tc_bf16", "ampnet_edge_attention_bwd_dkv_bf16"),
        ("simt_bf16", BF16): (_LIB, "ampnet_edge_attention_bwd_dkv_simt_bf16")}


# ---------------------------------------------------------------- plain versions


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[E, S, D] -> [E, H, S, Dh]."""
    e, s, d = t.shape
    return t.reshape(e, s, num_heads, d // num_heads).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[E, H, S, Dh] -> [E, S, D]."""
    e, h, s, dh = t.shape
    return t.transpose(1, 2).reshape(e, s, h * dh)


def dot_in(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to ``dtype``, summed in f32 (the JAX
    bodies' dots with ``preferred_element_type=float32``; f64 in f64)."""
    return widened(a.to(dtype)) @ widened(b.to(dtype))


def _recompute(q, k, v, dm, num_heads, softmax):
    """Per edge and head: the queries (unscaled), keys, dMsg, the f32
    weights W [E, H, Sq, Sk] and dS, the gradient of the scaled scores, and
    the f32 1/sqrt(dh). The scores take q times 1/sqrt(dh) in q's type."""
    head_dim = q.shape[-1] // num_heads
    scale = 1.0 / head_dim ** 0.5
    dt = q.dtype
    qh, kh, vh, dmh = (_heads(t, num_heads) for t in (q, k, v, dm))
    scores = dot_in(qh * head_scale(head_dim, dt), kh.transpose(-1, -2), dt)
    dw = dot_in(dmh, vh.transpose(-1, -2), dt)
    if softmax:
        w = torch.softmax(scores, dim=-1)
        ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True))
    else:
        w, ds = scores, dw
    return qh, kh, dmh, w, ds, scale


def _walk(peer_ids, valid, ptr, slots):
    """Per walked slot: its node (block), its peer and its validity. Slots
    past the walk (a fixed-capacity layout's padding) are not walked."""
    nodes = ptr.numel() - 1
    own = torch.repeat_interleave(torch.arange(nodes, device=ptr.device),
                                  (ptr[1:] - ptr[:-1]).long())
    slots = slots[: own.numel()].long()
    return own, peer_ids.reshape(-1)[slots].long(), \
        valid.reshape(-1)[slots].to(torch.float32)


def edge_attention_bwd_dq_plain(q_rows, kv_rows, dsum_rows, tile_senders,
                                tile_valid, recv_ptr, recv_slots, *, s, sp,
                                num_heads, softmax):
    """Pass R in plain torch: dQ rows [NT*sp, D] f32 (pad token rows 0)
    from f32 or bf16 rows; kv_rows may hold more nodes than NT."""
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    recv, snd, w = _walk(tile_senders, tile_valid, recv_ptr, recv_slots)
    q = q_rows.reshape(nt, sp, d)[:, :s][recv]
    dm = dsum_rows.reshape(nt, sp, d)[:, :s][recv]
    kv = kv_rows.reshape(-1, sp, 2 * d)[:, :s][snd]
    _, kh, _, _, ds, scale = _recompute(q, kv[..., :d], kv[..., d:], dm,
                                        num_heads, softmax)
    dq = _merge(dot_in(ds, kh, q.dtype)) * scale
    acc = torch.zeros(nt, s, d, dtype=torch.float32, device=q_rows.device)
    acc.index_add_(0, recv, dq * w[:, None, None])
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, d)


def edge_attention_bwd_dkv_plain(qdm_rows, kv_rows, snd_receivers, snd_valid,
                                 snd_ptr, snd_slots, *, s, sp, num_heads,
                                 softmax):
    """Pass S in plain torch: dK|dV rows [NT*sp, 2D] f32 (pad token rows 0)
    from f32 or bf16 rows; qdm_rows may hold fewer nodes than NT."""
    nt = snd_ptr.numel() - 1
    d = kv_rows.shape[1] // 2
    snd, recv, w = _walk(snd_receivers, snd_valid, snd_ptr, snd_slots)
    qdm = qdm_rows.reshape(-1, sp, 2 * d)[:, :s][recv]
    kv = kv_rows.reshape(nt, sp, 2 * d)[:, :s][snd]
    qh, _, dmh, wts, ds, scale = _recompute(qdm[..., :d], kv[..., :d], kv[..., d:],
                                            qdm[..., d:], num_heads, softmax)
    dt = kv_rows.dtype
    dk = _merge(dot_in(ds.transpose(-1, -2), qh, dt)) * scale
    dv = _merge(dot_in(wts.transpose(-1, -2), dmh, dt))
    acc = torch.zeros(nt, s, 2 * d, dtype=torch.float32, device=kv_rows.device)
    acc.index_add_(0, snd, torch.cat([dk, dv], dim=-1) * w[:, None, None])
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, 2 * d)


# ---------------------------------------------------------------- kernels


def edge_attention_bwd_dq(q_rows, kv_rows, dsum_rows, tile_senders, tile_valid,
                          recv_ptr, recv_slots, *, s, sp, num_heads, softmax, body=None):
    """K3, pass R: dQ rows [NT*sp, D] f32 (pad token rows 0).

    q_rows, dsum_rows [NT*sp, D] and kv_rows [KV*sp, 2D], all f32 or all
    bf16, may be row-strided views; dsum is the gradient of the
    per-receiver SUM of messages. KV, the whole nodes kv_rows hold, may
    exceed NT (K1's rule): the grid is NT receivers, the gathered k|v rows
    any. The tensor-core bodies gather kv_rows in 16-byte copies and take S
    <= 48, D/H <= 32 and H * ceil(S/16) <= 12 warps (8 up to S=24), and 48 <
    S <= 64 with D/H <= 32 a multiple of 8 (one block per receiver and head;
    ``launch.tensor_core_range_error``); beyond that, or on rows they cannot
    copy, the CUDA-core body of the rows' type runs (``launch.body_of``;
    ``body`` names one, else the rule picks). The index
    arrays are int32 (format.py). CPU tensors run the plain version."""
    if not q_rows.is_cuda:
        return edge_attention_bwd_dq_plain(
            q_rows, kv_rows, dsum_rows, tile_senders, tile_valid, recv_ptr,
            recv_slots, s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    dev = q_rows.device
    nt = recv_ptr.numel() - 1
    d = q_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    dt = check_same_dtype(("q_rows", q_rows), ("dsum_rows", dsum_rows), ("kv_rows", kv_rows))
    check_rows("q_rows", q_rows, dev, nt * sp, d, dt)
    check_rows("dsum_rows", dsum_rows, dev, nt * sp, d, dt)
    check_node_rows("kv_rows", kv_rows, dev, sp, 2 * d, dt)
    check_walk(dev, tile_senders, tile_valid, recv_ptr, recv_slots,
               ("tile_senders", "tile_valid", "recv_ptr", "recv_slots"))
    body = body_of("edge_attention_bwd_dq", body, s, d, num_heads, ("kv_rows", kv_rows))
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    lib_name, name = entry_of("edge_attention_bwd_dq", _DQ, body, dt)
    launch_body("edge_attention_bwd_dq", body, entry(lib_name, name, _SIGNATURES[name]), (
        q_rows.data_ptr(), q_rows.stride(0), dsum_rows.data_ptr(),
        dsum_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        tile_senders.data_ptr(), tile_valid.data_ptr(), recv_ptr.data_ptr(),
        recv_slots.data_ptr(), out.data_ptr(), nt, s, sp, d, num_heads,
        int(softmax)), s, d, num_heads, nt, dev)
    count_launch(edge_attention_bwd_dq, body)
    return out


def edge_attention_bwd_dkv(qdm_rows, kv_rows, snd_receivers, snd_valid, snd_ptr,
                           snd_slots, *, s, sp, num_heads, softmax, body=None):
    """K4, pass S: dK|dV rows [NT*sp, 2D] f32 (pad token rows 0).

    qdm_rows [Q*sp, 2D] packs [Q | dsum] per row; kv_rows [NT*sp, 2D]; both
    f32 or both bf16, and may be row-strided views. NT is the sender grid
    (``snd_ptr``), Q the whole nodes of qdm_rows (the receivers), which
    the edge-partitioned path makes fewer than its senders. The tensor-core bodies
    gather qdm_rows in 16-byte copies and take S <= 48, D/H <= 32 and H *
    ceil(S/16) <= 12 warps (8 up to S=24), and 48 < S <= 64 with D/H <= 32 a
    multiple of 8 (one block per sender and head;
    ``launch.tensor_core_range_error``);
    beyond that, or on rows they cannot copy, the CUDA-core body of the
    rows' type runs (``launch.body_of``; ``body`` names one, else the rule
    picks). snd_receivers holds GLOBAL
    receiver ids over the sender-tiled slots, snd_valid may carry a runtime
    mask, snd_ptr / snd_slots are the sender-major index. CPU tensors run
    the plain version."""
    if not kv_rows.is_cuda:
        return edge_attention_bwd_dkv_plain(
            qdm_rows, kv_rows, snd_receivers, snd_valid, snd_ptr, snd_slots,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    dev = kv_rows.device
    nt = snd_ptr.numel() - 1
    d = kv_rows.shape[1] // 2
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    dt = check_same_dtype(("qdm_rows", qdm_rows), ("kv_rows", kv_rows))
    check_node_rows("qdm_rows", qdm_rows, dev, sp, 2 * d, dt)
    check_rows("kv_rows", kv_rows, dev, nt * sp, 2 * d, dt)
    check_walk(dev, snd_receivers, snd_valid, snd_ptr, snd_slots,
               ("snd_receivers", "snd_valid", "snd_ptr", "snd_slots"))
    body = body_of("edge_attention_bwd_dkv", body, s, d, num_heads, ("qdm_rows", qdm_rows))
    out = torch.empty(nt * sp, 2 * d, dtype=torch.float32, device=dev)
    lib_name, name = entry_of("edge_attention_bwd_dkv", _DKV, body, dt)
    launch_body("edge_attention_bwd_dkv", body, entry(lib_name, name, _SIGNATURES[name]), (
        qdm_rows.data_ptr(), qdm_rows.stride(0), kv_rows.data_ptr(),
        kv_rows.stride(0), snd_receivers.data_ptr(), snd_valid.data_ptr(),
        snd_ptr.data_ptr(), snd_slots.data_ptr(), out.data_ptr(), nt, s, sp, d,
        num_heads, int(softmax)), s, d, num_heads, nt, dev)
    count_launch(edge_attention_bwd_dkv, body)
    return out


for _wrapper in (edge_attention_bwd_dq, edge_attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.body_launches = dict.fromkeys(BODIES, 0)
