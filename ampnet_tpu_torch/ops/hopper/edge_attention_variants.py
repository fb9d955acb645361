"""The non-default forward routes of the fused AMPConv op on Hopper: the
JAX package's scatter-as-matmul bodies, its receiver-chunked body and its
packed v1 groups (``ampnet_tpu/ops/pallas/edge_attention_fused.py``), each
a hand-written kernel (``csrc/``) beside its plain torch version. All four
compute what K1 ``edge_attention_sums`` / K2 ``edge_attention_layer``
compute, by another cut of the work:

* ``edge_attention_sums_mm`` (K6) — ``_fused_kernel_vmem_v2_mm`` and
  ``_fused_kernel_dma_v8``: work cut by EDGE GROUPS (a run of G layout slots
  of one tile), the group's messages kept on chip and summed onto their
  receivers as a {0,1} one-hot product, validity as a select. One kernel
  for both gathers (Hopper reads K|V from device memory either way).
* ``edge_attention_layer_mm`` (K7) — ``_fused_kernel_vmem_v6_mm``: the whole
  layer over K6's body: the projection launch, K6's attention launch, then
  a launch with the mean as a per-receiver row scale AFTER the reduce, the
  out-projection and the bias on live rows. On the tensor cores the first
  and the last are K2's tiled 3xTF32 product (``csrc/projection_tc.cuh``).
* ``edge_attention_sums_chunked`` (K8) — ``_fused_kernel_chunked`` over
  ``format.build_chunked_csr``: chunks of up to C edges of one receiver; per
  receiver the sum over the live slots of its chunks. On the tensor cores
  the chunk is only an index (K1's per-edge steps over the receiver's live
  slots, ``csrc/edge_attention_chunked_tc.cu``); the CUDA-core body
  (``csrc/edge_attention_chunked.cu``) takes one Q read, a piece of the
  chunk's K|V side by side, per-edge softmax, one value product over the
  contracted rows, one accumulate. No caller on the model path, as in the
  JAX package.
* ``edge_attention_sums_v1`` (K9) — ``_fused_kernel`` ('dma') and
  ``_fused_kernel_vmem`` ('vmem'): G packed edges per step (G | EMAX), every
  group walked, each message scaled by its validity and added on its own.
  One kernel for both gathers; the 'vmem' body's skip of a group whose first
  slot is padding is a per-slot skip here, so a runtime mask on a group's
  first slot cannot drop the group.

K6, K8 and K9 have two bodies each (``launch.body``), as K1 has: on the
tensor cores in 3xTF32 (``csrc/edge_attention_groups_tc.cu``: one warp per
head and 16-row query tile, each receiver's run of slots in a group summed
in registers and added to the output with f32 atomics;
``csrc/edge_attention_chunked_tc.cu``: K1's walk over the chunks' live
slots) within their instantiated range, on the CUDA cores
(``csrc/edge_attention_groups.cu``, K6's group of messages buffered in
shared memory; ``csrc/edge_attention_chunked.cu``, K8's piece of a chunk)
beyond it, at any shape: where that body's working set exceeds a block's
shared memory it is kept in device memory (``launch.simt_work``). K7's
attention launch is K6's, on K6's route, and its projection launches follow
it (``layer_mm_body``).

Each has the same two bodies in bf16 products for bf16 rows (the JAX
package's bf16 model and ``stream_bf16``): ``tc_bf16`` on the tensor cores
with f32 sums (``csrc/edge_attention_groups_tc_bf16.cu``, K1's bf16
per-edge steps in K6's walk; ``csrc/edge_attention_chunked_tc_bf16.cu``,
the same steps in K8's walk) within the range, and ``simt_bf16`` on the
CUDA cores (the CUDA-core sources above, templated on the rows' type)
beyond it. K6 and K7's attention also take f32 rows on them under
``mxu_bf16`` (the JAX 'vmem' bodies v2_mm and v6_mm round their products'
operands; v8, the v1 bodies and the chunked body do not). The messages and
their reduction stay f32, as the JAX package's one-hot product and adds
are, and K8's sums are f32 as ``_fused_edge_sums_chunked`` returns them; K7
on bf16 rows projects with K2's bf16 product and rounds its mean and its
output to bf16 where v6_mm does.

K6, K7 and K9 reduce across warps and blocks with f32 atomics into a zeroed
output: right to rounding, but not bit-reproducible from launch to launch
(K1, K2 and K8 are). The group of K6 is the port's own launch parameter
(``MM_GROUP``); it moves the order of summation only.

A wrapper given CPU tensors runs its plain version, which repeats the
kernel's arithmetic (groups and one-hot reduce, packed groups and per-edge
adds, chunks and per-edge softmax segments); given CUDA tensors it launches
its kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``, and by body in ``<wrapper>.body_launches``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ampnet_tpu_torch.ops.edge_attention import (
    _merge_heads,
    _scores,
    _split_heads,
    attend,
    widened,
)
from ampnet_tpu_torch.ops.hopper import build
from ampnet_tpu_torch.ops.hopper.launch import (
    BODIES,
    I,
    MAX_SMEM,
    P,
    SIMT_BODIES,
    body_of,
    check_index,
    check_rows,
    check_same_dtype,
    count_launch,
    entry,
    entry_of,
    f32_body,
    launch_body,
    simt_smem_bytes,
    stream,
)

# K6's edge group where the caller names none. On the tensor cores: how
# many layout slots a run of register sums may span before it is added to
# the output (the fastest of 1, 4, 8 and the JAX group in chip_smoke.py's
# by_group_ms, at S=40 and S=20; smaller groups balance the blocks' walks
# better than larger ones save flushes). On the CUDA cores: the largest
# group up to it whose buffer of messages leaves the working set in shared
# memory (4 x 20 KB beside 87 KB at S=40, D=128), else 1; there at most
# SIMT_MAX_GROUP (csrc kMaxGroup).
MM_GROUP = 4
SIMT_MAX_GROUP = 32

_SIGNATURES = {
    "ampnet_edge_attention_sums_mm": [P, I, P, I, P, P, P, P, P,
                                      I, I, I, I, I, I, I, I, I, P],
    "ampnet_edge_attention_sums_v1": [P, I, P, I, P, P, P, P,
                                      I, I, I, I, I, I, I, I, I, P],
    "ampnet_edge_attention_sums_chunked": [P, I, P, I, P, P, P, P, P,
                                           I, I, I, I, I, I, I, P],
    "ampnet_edge_attention_sums_chunked_simt": [P, I, P, I, P, P, P, P, P,
                                                I, I, I, I, I, I, I, I, P, I, P],
    "ampnet_qkv_projection": [P, I, P, P, P, I, I, I, I, P],
    "ampnet_mean_out_projection": [P, I, P, P, P, P, I, I, I, I, I, I, P],
}
for _name in ("ampnet_edge_attention_sums_mm", "ampnet_edge_attention_sums_v1",
              "ampnet_edge_attention_sums_chunked"):
    _SIGNATURES[_name + "_bf16"] = _SIGNATURES[_name]
_SIGNATURES["ampnet_edge_attention_sums_chunked_simt_bf16"] = \
    _SIGNATURES["ampnet_edge_attention_sums_chunked_simt"]
_SIGNATURES["ampnet_edge_attention_sums_mm_mxu"] = _SIGNATURES["ampnet_edge_attention_sums_mm"]
# the projections on the tensor cores, and the CUDA cores' bf16 ones, take
# the CUDA-core f32 launches' arguments
for _name in ("ampnet_edge_attention_layer_projection",
              "ampnet_edge_attention_layer_projection_bf16", "ampnet_qkv_projection_bf16"):
    _SIGNATURES[_name] = _SIGNATURES["ampnet_qkv_projection"]
for _name in ("ampnet_edge_attention_layer_mm_out_projection",
              "ampnet_edge_attention_layer_mm_out_projection_bf16",
              "ampnet_mean_out_projection_bf16"):
    _SIGNATURES[_name] = _SIGNATURES["ampnet_mean_out_projection"]
# the CUDA-core bodies also take their device-memory working set (pointer,
# blocks; 0, 0 for shared memory) before the stream
for _name in ("ampnet_edge_attention_sums_mm", "ampnet_edge_attention_sums_v1"):
    for _suffix in ("_simt", "_simt_bf16"):
        _SIGNATURES[_name + _suffix] = _SIGNATURES[_name][:-1] + [P, I, P]
_SIGNATURES["ampnet_edge_attention_sums_mm_simt_mxu"] = \
    _SIGNATURES["ampnet_edge_attention_sums_mm_simt"]
# (library, entry point) of each body of K6 and K9 on each row type
# (launch.entry_of); K6's bf16 body on f32 rows is mxu_bf16's
F32, BF16 = torch.float32, torch.bfloat16
_SUMS_MM = {("tc", F32): ("edge_attention_groups_tc", "ampnet_edge_attention_sums_mm"),
            ("simt", F32): ("edge_attention_groups", "ampnet_edge_attention_sums_mm_simt"),
            ("tc_bf16", BF16): ("edge_attention_groups_tc_bf16",
                                "ampnet_edge_attention_sums_mm_bf16"),
            ("tc_bf16", F32): ("edge_attention_groups_tc_bf16",
                               "ampnet_edge_attention_sums_mm_mxu"),
            ("simt_bf16", BF16): ("edge_attention_groups",
                                  "ampnet_edge_attention_sums_mm_simt_bf16"),
            ("simt_bf16", F32): ("edge_attention_groups",
                                 "ampnet_edge_attention_sums_mm_simt_mxu")}
_SUMS_V1 = {("tc", F32): ("edge_attention_groups_tc", "ampnet_edge_attention_sums_v1"),
            ("simt", F32): ("edge_attention_groups", "ampnet_edge_attention_sums_v1_simt"),
            ("tc_bf16", BF16): ("edge_attention_groups_tc_bf16",
                                "ampnet_edge_attention_sums_v1_bf16"),
            ("simt_bf16", BF16): ("edge_attention_groups",
                                  "ampnet_edge_attention_sums_v1_simt_bf16")}
_SUMS_CHUNKED = {
    ("tc", F32): ("edge_attention_chunked_tc", "ampnet_edge_attention_sums_chunked"),
    ("simt", F32): ("edge_attention_chunked", "ampnet_edge_attention_sums_chunked_simt"),
    ("tc_bf16", BF16): ("edge_attention_chunked_tc_bf16",
                        "ampnet_edge_attention_sums_chunked_bf16"),
    ("simt_bf16", BF16): ("edge_attention_chunked",
                          "ampnet_edge_attention_sums_chunked_simt_bf16")}
# (library, entry point) on each body of the q|k|v projection (K2's first
# launch and K7's) and of K7's last launch: the tensor cores' tiled 3xTF32
# product (csrc/projection_tc.cuh, and its kMean epilogue), or the CUDA
# cores' one; on bf16 rows the tensor cores' tiled bf16 product
# (csrc/edge_attention_layer_tc_bf16.cu, and its kMean epilogue) or the
# CUDA cores' in bf16; by (body, row type), as launch.entry_of reads it.
# Under mxu_bf16 (f32 rows) both stay on the f32 product of the same cores
# (launch.f32_body), as the JAX kernels round only their attention's
# operands.
_PROJECTION = {
    ("tc", F32): ("edge_attention_layer_tc", "ampnet_edge_attention_layer_projection"),
    ("simt", F32): ("qkv_projection", "ampnet_qkv_projection"),
    ("tc_bf16", BF16): ("edge_attention_layer_tc_bf16",
                        "ampnet_edge_attention_layer_projection_bf16"),
    ("simt_bf16", BF16): ("qkv_projection", "ampnet_qkv_projection_bf16")}
_LAYER_MM_OUT_PROJECTION = {
    ("tc", F32): ("edge_attention_layer_tc", "ampnet_edge_attention_layer_mm_out_projection"),
    ("simt", F32): ("qkv_projection", "ampnet_mean_out_projection"),
    ("tc_bf16", BF16): ("edge_attention_layer_tc_bf16",
                        "ampnet_edge_attention_layer_mm_out_projection_bf16"),
    ("simt_bf16", BF16): ("qkv_projection", "ampnet_mean_out_projection_bf16")}


def _entry(lib_name: str, fn_name: str):
    return entry(lib_name, fn_name, _SIGNATURES[fn_name])


# ---------------------------------------------------------------- plain versions


def _messages(q_rows, kv_rows, recv, snd, *, s, sp, num_heads, softmax, mxu_bf16=False):
    """[L, s, D] f32 attention messages of L (receiver node, sender node)
    pairs, the products' operands in the rows' type (bf16 under mxu_bf16)."""
    d = q_rows.shape[1]
    q = q_rows.reshape(-1, sp, d)[:, :s][recv]
    kv = kv_rows.reshape(-1, sp, 2 * d)[:, :s][snd]
    return attend(q, kv[..., :d], kv[..., d:], num_heads, softmax,
                  torch.bfloat16 if mxu_bf16 else None)[0]


def _pad_rows(acc, sp):
    """[NT, s, D] -> [NT*sp, D] with pad token rows 0."""
    nt, s, d = acc.shape
    return F.pad(acc, (0, 0, 0, sp - s)).reshape(nt * sp, d)


def edge_attention_sums_mm_plain(q_rows, kv_rows, tile_senders, tile_recv,
                                 tile_valid, tile_counts, *, s, sp, num_heads,
                                 softmax, tile_nodes, group, mxu_bf16=False):
    """K6 in plain torch: the messages of each tile's live groups in a
    buffer [T, EG, s, D] (EG = the slots padded to whole groups; a slot
    that is masked, or beyond the tile's structural trip count, stays 0),
    then per tile the one-hot product sel [TN, EG] . msg [EG, s*D] with
    sel = (receiver row == n) & valid. bf16 rows (or ``mxu_bf16``) give
    bf16 products' operands and f32 messages, as the JAX bodies."""
    t, emax = tile_senders.shape
    d = q_rows.shape[1]
    dev = q_rows.device
    eg = -(-emax // group) * group
    pad = (0, eg - emax)
    snd, recv, valid = (F.pad(a, pad) for a in (tile_senders, tile_recv, tile_valid))
    live_groups = (tile_counts + group - 1) // group                      # [T]
    selected = ((torch.arange(eg, device=dev)[None, :] // group < live_groups[:, None])
                & (valid != 0))                                           # [T, EG]
    tile_idx, pos = torch.nonzero(selected, as_tuple=True)
    msg = torch.zeros(t, eg, s, d, dtype=torch.float32, device=dev)
    msg[tile_idx, pos] = _messages(
        q_rows, kv_rows, tile_idx * tile_nodes + recv[tile_idx, pos].long(),
        snd[tile_idx, pos].long(), s=s, sp=sp, num_heads=num_heads, softmax=softmax,
        mxu_bf16=mxu_bf16)
    sel = ((torch.arange(tile_nodes, device=dev)[None, :, None] == recv[:, None, :])
           & selected[:, None, :]).to(torch.float32)                      # [T, TN, EG]
    acc = torch.einsum("tne,tesd->tnsd", sel, msg)
    return _pad_rows(acc.reshape(t * tile_nodes, s, d), sp)


def edge_attention_layer_mm_plain(x_rows, w_qkv, b_qkv, w_out, b_out, invdeg,
                                  tile_senders, tile_recv, tile_valid, tile_counts,
                                  *, s, sp, num_heads, softmax, tile_nodes, group,
                                  mxu_bf16=False):
    """K7 in plain torch: project, K6's sums, then the mean as a row scale
    after the reduce, the out-projection, b_out on live rows only. In
    x_rows' type as the JAX kernel (v6_mm): q|k|v and the mean rounded to
    it, the out-projection summed in f32, the bias added in f32 on live
    rows, and the sum rounded once (v6, K2's, rounds before the bias)."""
    d = x_rows.shape[1]
    dt = x_rows.dtype
    qkv = (widened(x_rows) @ widened(w_qkv) + widened(b_qkv)).to(dt)
    sums = edge_attention_sums_mm_plain(
        qkv[:, :d], qkv[:, d:], tile_senders, tile_recv, tile_valid, tile_counts,
        s=s, sp=sp, num_heads=num_heads, softmax=softmax, tile_nodes=tile_nodes,
        group=group, mxu_bf16=mxu_bf16)
    mean = sums.reshape(-1, sp, d)[:, :s] * invdeg[:, None, None]
    live = (invdeg > 0).to(torch.float32)[:, None, None]
    out = (widened(mean.to(dt)) @ widened(w_out) + widened(b_out) * live).to(dt)
    return _pad_rows(out, sp)


def edge_attention_sums_v1_plain(q_rows, kv_rows, tile_senders, tile_recv,
                                 tile_valid, *, s, sp, num_heads, softmax,
                                 tile_nodes, group):
    """K9 in plain torch: every slot of every packed group, padding
    included, gets its message (bf16 rows: the products' operands in bf16,
    the messages f32); each is scaled by its validity and added to its
    receiver's rows on its own, in f32."""
    t, emax = tile_senders.shape
    if emax % group:
        raise ValueError(f"the packed groups need group | EMAX, got {group} and {emax}")
    d = q_rows.shape[1]
    dev = q_rows.device
    recv = (torch.arange(t, device=dev)[:, None] * tile_nodes + tile_recv).reshape(-1)
    msg = _messages(q_rows, kv_rows, recv, tile_senders.reshape(-1).long(),
                    s=s, sp=sp, num_heads=num_heads, softmax=softmax)
    acc = torch.zeros(t * tile_nodes, s, d, dtype=torch.float32, device=dev)
    acc.index_add_(0, recv, msg * tile_valid.reshape(-1).to(torch.float32)[:, None, None])
    return _pad_rows(acc, sp)


def edge_attention_sums_chunked_plain(q_rows, kv_rows, chunk_senders, chunk_valid,
                                      chunk_start, chunk_count, *, s, sp, num_heads,
                                      softmax, chunk):
    """K8 in plain torch: per live chunk one Q read, the chunk's K|V side by
    side [C*s, 2D] (an invalid slot is not gathered and holds zeros), scores
    [H, s, C*s], a softmax over each edge's own segment of s columns, the
    invalid segments' weights 0, ONE value product over the C*s contracted
    rows, and one accumulate per chunk."""
    nt = chunk_start.numel()
    d = q_rows.shape[1]
    dev = q_rows.device
    count = chunk_count.long()
    recv = torch.repeat_interleave(torch.arange(nt, device=dev), count)   # [NC]
    nc = recv.numel()
    first_of_recv = torch.cumsum(count, 0) - count
    flat = chunk_start.long()[recv] + torch.arange(nc, device=dev) - first_of_recv[recv]
    snd = chunk_senders.reshape(-1, chunk)[flat].long()                   # [NC, C]
    ok = chunk_valid.reshape(-1, chunk)[flat] != 0                        # [NC, C]
    q = q_rows.reshape(nt, sp, d)[:, :s][recv]                            # [NC, s, D]
    kv = kv_rows.reshape(nt, sp, 2 * d)[:, :s][snd]                       # [NC, C, s, 2D]
    kv = torch.where(ok[:, :, None, None], kv, torch.zeros_like(kv))
    k2 = kv[..., :d].reshape(nc, chunk * s, d)
    v2 = kv[..., d:].reshape(nc, chunk * s, d)
    w = _scores(q, k2, num_heads).reshape(nc, num_heads, s, chunk, s)
    if softmax:
        w = torch.softmax(w, dim=-1)
    w = torch.where(ok[:, None, None, :, None], w, torch.zeros_like(w))
    out = _merge_heads(widened(w.reshape(nc, num_heads, s, chunk * s).to(q.dtype))
                       @ widened(_split_heads(v2, num_heads)))
    acc = torch.zeros(nt, s, d, dtype=torch.float32, device=dev)
    acc.index_add_(0, recv, out)
    return _pad_rows(acc, sp)


# ---------------------------------------------------------------- kernels


def _check_rows(q_rows, kv_rows, nt, sp, num_heads):
    """(D, the rows' one type: f32 or bf16)."""
    d = q_rows.shape[1]
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    dt = check_same_dtype(("q_rows", q_rows), ("kv_rows", kv_rows))
    check_rows("q_rows", q_rows, q_rows.device, nt * sp, d, dt)
    check_rows("kv_rows", kv_rows, q_rows.device, nt * sp, 2 * d, dt)
    return d, dt


def _check_tiled(device, tile_senders, tile_recv, tile_valid, tile_counts=None):
    check_index("tile_senders", tile_senders, device)
    check_index("tile_recv", tile_recv, device, tile_senders.numel())
    check_index("tile_valid", tile_valid, device, tile_senders.numel())
    if tile_counts is not None:
        check_index("tile_counts", tile_counts, device, tile_senders.shape[0])


def _mm_group(body, s, d, num_heads, group):
    """K6's group on ``body``: the caller's (1..SIMT_MAX_GROUP on the CUDA
    cores), else MM_GROUP on the tensor cores (3xTF32 and bf16) and on the
    CUDA cores (f32 and bf16) the largest up to MM_GROUP that keeps the
    working set in shared memory (else 1: in device memory)."""
    if group is None:
        if body not in SIMT_BODIES:
            return MM_GROUP
        return max([g for g in range(1, MM_GROUP + 1) if simt_smem_bytes(
            "edge_attention_sums_mm", s, d, num_heads, g) <= MAX_SMEM], default=1)
    top = SIMT_MAX_GROUP if body in SIMT_BODIES else None
    if group < 1 or (top is not None and group > top):
        raise ValueError(f"group={group} must be at least 1"
                         + (f" and at most {top} on the CUDA cores" if top else ""))
    return group


def _launch_groups(kernel, body, ptrs, tile_senders, tile_recv, tile_valid, tile_counts,
                   *, s, sp, d, num_heads, softmax, tile_nodes, group,
                   dtype: torch.dtype = torch.float32):
    """One launch of K6 (``tile_counts`` given) or K9 on ``body`` over q and
    k|v rows of ``dtype`` at ``ptrs`` = (q, ldq, kv, ldkv), into a zeroed
    [NT*sp, D] f32 buffer (no checks, no count)."""
    t, emax = tile_senders.shape
    dev = tile_senders.device
    out = torch.zeros(t * tile_nodes * sp, d, dtype=torch.float32, device=dev)
    counts = () if tile_counts is None else (tile_counts.data_ptr(),)
    lib_fn = _entry(*entry_of(kernel, _SUMS_MM if tile_counts is not None else _SUMS_V1,
                              body, dtype))
    launch_body(kernel, body, lib_fn, (
        *ptrs, tile_senders.data_ptr(), tile_recv.data_ptr(), tile_valid.data_ptr(), *counts,
        out.data_ptr(), t, emax, group, tile_nodes, s, sp, d, num_heads, int(softmax)),
        s, d, num_heads, t * -(-emax // group), dev, group)
    return out


def edge_attention_sums_mm(q_rows, kv_rows, tile_senders, tile_recv, tile_valid,
                           tile_counts, *, s, sp, num_heads, softmax, tile_nodes,
                           group: Optional[int] = None, body: Optional[str] = None,
                           mxu_bf16: bool = False):
    """K6: per-receiver sums [NT*sp, D] f32 (pad token rows 0) by edge
    groups. The layout arrays are the tiled layout's own ([T, EMAX] int32
    senders, receiver rows and validity, which may carry a runtime mask, and
    the [T] STRUCTURAL counts). The body is K1's rule (``launch.body_of`` on
    kv_rows; ``body`` names one): bf16 rows, and f32 rows under
    ``mxu_bf16``, run a bf16 body; ``group`` None = its default
    (``_mm_group``). CPU tensors run the plain version."""
    if not q_rows.is_cuda:
        return edge_attention_sums_mm_plain(
            q_rows, kv_rows, tile_senders, tile_recv, tile_valid, tile_counts,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax,
            tile_nodes=tile_nodes, group=MM_GROUP if group is None else group,
            mxu_bf16=mxu_bf16)
    nt = tile_senders.shape[0] * tile_nodes
    d, dt = _check_rows(q_rows, kv_rows, nt, sp, num_heads)
    _check_tiled(q_rows.device, tile_senders, tile_recv, tile_valid, tile_counts)
    body = body_of("edge_attention_sums_mm", body, s, d, num_heads, ("kv_rows", kv_rows),
                   mxu_bf16=mxu_bf16)
    out = _launch_groups(
        "edge_attention_sums_mm", body,
        (q_rows.data_ptr(), q_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0)),
        tile_senders, tile_recv, tile_valid, tile_counts, s=s, sp=sp, d=d,
        num_heads=num_heads, softmax=softmax, tile_nodes=tile_nodes,
        group=_mm_group(body, s, d, num_heads, group), dtype=dt)
    count_launch(edge_attention_sums_mm, body)
    return out


def layer_mm_body(body, s, d, num_heads, x_rows, w_qkv, w_out, kv_rows,
                  mxu_bf16: bool = False) -> str:
    """K7's body, one for its three launches: K6's rule on the k|v view of
    its projected rows, where x_rows, w_qkv and w_out take 16-byte copies
    too (the tensor cores' tiled product copies its A and B operands in
    16-byte pieces: addresses, row strides and widths multiples of 16 bytes);
    a bf16 body on bf16 rows and under ``mxu_bf16``; ``body`` names one."""
    return body_of("edge_attention_sums_mm", body, s, d, num_heads, ("kv_rows", kv_rows),
                   ("x_rows", x_rows), ("w_qkv", w_qkv), ("w_out", w_out), mxu_bf16=mxu_bf16)


def layer_projection(x_rows, w_qkv, b_qkv, body, qkv=None):
    """K2's and K7's first launch on ``body``: q|k|v rows [rows, 3D] =
    x_rows @ w_qkv + b_qkv in x_rows' type (into ``qkv`` where given,
    contiguous); the bf16 bodies take bf16 rows and weights, sum in f32 and
    round once."""
    rows, d = x_rows.shape
    if qkv is None:
        qkv = torch.empty(rows, 3 * d, dtype=x_rows.dtype, device=x_rows.device)
    lib, proj = _entry(*entry_of("q|k|v projection", _PROJECTION, body, x_rows.dtype))
    build.check(lib, proj(x_rows.data_ptr(), x_rows.stride(0), w_qkv.data_ptr(),
                          b_qkv.data_ptr(), qkv.data_ptr(), 3 * d, rows, 3 * d, d,
                          stream()), f"q|k|v projection ({body})")
    return qkv


def _layer_mm_out_projection(sums, invdeg, w_out, b_out, *, s, sp, body):
    """K7's last launch on ``body``: the mean as a row scale of the f32 sums,
    the out-projection, b_out on live rows, pad token rows 0; out in
    w_out's type (the bf16 bodies: bf16 rows, the mean and the output
    rounded to bf16)."""
    rows, d = sums.shape
    out = torch.empty(rows, d, dtype=w_out.dtype, device=sums.device)
    lib, epi = _entry(*entry_of("edge_attention_layer_mm out-projection",
                                _LAYER_MM_OUT_PROJECTION, body, w_out.dtype))
    build.check(lib, epi(sums.data_ptr(), d, invdeg.data_ptr(), w_out.data_ptr(),
                         b_out.data_ptr(), out.data_ptr(), d, rows, d, d, sp, s, stream()),
                f"edge_attention_layer_mm out-projection ({body})")
    return out


def edge_attention_layer_mm(x_rows, w_qkv, b_qkv, w_out, b_out, invdeg,
                            tile_senders, tile_recv, tile_valid, tile_counts, *,
                            s, sp, num_heads, softmax, tile_nodes,
                            group: Optional[int] = None, body: Optional[str] = None,
                            mxu_bf16: bool = False):
    """K7: the whole layer over raw token rows x_rows [NT*sp, D] -> output
    rows [NT*sp, D] in x_rows' type (pad token rows 0; a receiver of degree
    0 exactly 0). invdeg [NT] (f32) is 1/degree of the runtime mask (0 for
    degree 0); the four weights are in x_rows' type, as the fused op casts
    them (K2's contract). Three launches on one body (``layer_mm_body``):
    the q|k|v projection, K6's attention into zeroed f32 sums, then the mean
    row scale, out-projection and live-row bias; on the tensor cores the
    first and the last are the tiled 3xTF32 product of K2's projection
    launch, on the CUDA cores ``csrc/qkv_projection.cu``. bf16 rows run all
    three in bf16 products (K2's bf16 projection, K6's bf16 body, the bf16
    epilogue, on the tensor cores or on the CUDA cores); f32 rows under
    ``mxu_bf16`` only the attention's, as the JAX kernel. CPU tensors run
    the plain version."""
    if not x_rows.is_cuda:
        return edge_attention_layer_mm_plain(
            x_rows, w_qkv, b_qkv, w_out, b_out, invdeg, tile_senders, tile_recv,
            tile_valid, tile_counts, s=s, sp=sp, num_heads=num_heads,
            softmax=softmax, tile_nodes=tile_nodes,
            group=MM_GROUP if group is None else group, mxu_bf16=mxu_bf16)
    dev = x_rows.device
    nt = tile_senders.shape[0] * tile_nodes
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
    _check_tiled(dev, tile_senders, tile_recv, tile_valid, tile_counts)
    qkv = torch.empty(nt * sp, 3 * d, dtype=dt, device=dev)
    body = layer_mm_body(body, s, d, num_heads, x_rows, w_qkv, w_out, qkv[:, d:], mxu_bf16)
    # under mxu_bf16 the f32 projections stay f32, on the same cores
    products = f32_body(body) if dt == torch.float32 else body
    layer_projection(x_rows, w_qkv, b_qkv, products, qkv)
    sums = _launch_groups(
        "edge_attention_sums_mm", body,
        (qkv.data_ptr(), 3 * d, qkv.data_ptr() + d * qkv.element_size(), 3 * d),
        tile_senders, tile_recv, tile_valid, tile_counts, s=s, sp=sp, d=d,
        num_heads=num_heads, softmax=softmax, tile_nodes=tile_nodes,
        group=_mm_group(body, s, d, num_heads, group), dtype=dt)
    out = _layer_mm_out_projection(sums, invdeg, w_out, b_out, s=s, sp=sp, body=products)
    count_launch(edge_attention_layer_mm, body)
    return out


def edge_attention_sums_v1(q_rows, kv_rows, tile_senders, tile_recv, tile_valid, *,
                           s, sp, num_heads, softmax, tile_nodes, group,
                           gather: str = "dma", body: Optional[str] = None):
    """K9: per-receiver sums [NT*sp, D] f32 (pad token rows 0) by packed
    groups of ``group`` edges (``group`` must divide EMAX), every group
    walked, each slot scaled by its validity. ``gather`` names the JAX body
    ('dma': ``_fused_kernel``, 'vmem': ``_fused_kernel_vmem``); one kernel
    serves both. The body is K6's rule (``body`` names one; at most
    SIMT_MAX_GROUP on the CUDA cores): bf16 rows run a bf16 body (the JAX
    v1 bodies have no mxu_bf16). CPU tensors run the plain version."""
    if gather not in ("dma", "vmem"):
        raise ValueError(f"gather must be 'dma' or 'vmem', got {gather!r}")
    t, emax = tile_senders.shape
    if not q_rows.is_cuda:
        return edge_attention_sums_v1_plain(
            q_rows, kv_rows, tile_senders, tile_recv, tile_valid, s=s, sp=sp,
            num_heads=num_heads, softmax=softmax, tile_nodes=tile_nodes, group=group)
    if emax % group:
        raise ValueError(f"the packed groups need group | EMAX, got {group} and {emax}")
    nt = t * tile_nodes
    d, dt = _check_rows(q_rows, kv_rows, nt, sp, num_heads)
    _check_tiled(q_rows.device, tile_senders, tile_recv, tile_valid)
    body = body_of("edge_attention_sums_v1", body, s, d, num_heads, ("kv_rows", kv_rows))
    if body in SIMT_BODIES and group > SIMT_MAX_GROUP:
        raise ValueError(f"group={group} must be at most {SIMT_MAX_GROUP} on the CUDA cores")
    out = _launch_groups(
        "edge_attention_sums_v1", body,
        (q_rows.data_ptr(), q_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0)),
        tile_senders, tile_recv, tile_valid, None, s=s, sp=sp, d=d, num_heads=num_heads,
        softmax=softmax, tile_nodes=tile_nodes, group=group, dtype=dt)
    count_launch(edge_attention_sums_v1, body)
    return out


def _chunk_piece(s, d, num_heads, chunk, piece):
    """Edges of a chunk per step on the CUDA cores: the caller's (1..chunk),
    else the chunk in the fewest equal pieces whose working set fits a
    block's shared memory (1 where none fits: then in device memory)."""
    if piece is None:
        fits = max((p for p in range(1, chunk + 1) if simt_smem_bytes(
            "edge_attention_sums_chunked", s, d, num_heads, p) <= MAX_SMEM), default=1)
        return -(-chunk // -(-chunk // fits))
    if not 1 <= piece <= chunk:
        raise ValueError(f"piece={piece} must be in 1..chunk={chunk}")
    return piece


def edge_attention_sums_chunked(q_rows, kv_rows, chunk_senders, chunk_valid,
                                chunk_start, chunk_count, *, s, sp, num_heads,
                                softmax, chunk, piece: Optional[int] = None,
                                body: Optional[str] = None):
    """K8: per-receiver sums [NT*sp, D] f32 (pad token rows 0) over the
    chunked layout (``format.compute_chunked_layout``): [T, NCMAX*chunk]
    int32 senders and validity (which may carry a runtime mask), and each
    receiver's first flat chunk and number of chunks ([NT] int32 each).
    The body is K1's rule (``launch.body_of`` on kv_rows; ``body`` names
    one). ``piece`` (1..chunk): on the CUDA cores, the edges of a chunk
    taken per step, None = ``_chunk_piece``'s choice; the working set goes
    to device memory where it does not fit shared memory. The tensor cores
    take one edge a step whatever the piece. bf16 rows run a bf16 body (the
    JAX chunked body has no mxu_bf16); the sums are f32. CPU tensors run the
    plain version."""
    if not q_rows.is_cuda:
        return edge_attention_sums_chunked_plain(
            q_rows, kv_rows, chunk_senders, chunk_valid, chunk_start, chunk_count,
            s=s, sp=sp, num_heads=num_heads, softmax=softmax, chunk=chunk)
    dev = q_rows.device
    nt = chunk_start.numel()
    d, dt = _check_rows(q_rows, kv_rows, nt, sp, num_heads)
    check_index("chunk_senders", chunk_senders, dev)
    check_index("chunk_valid", chunk_valid, dev, chunk_senders.numel())
    check_index("chunk_start", chunk_start, dev)
    check_index("chunk_count", chunk_count, dev, nt)
    if chunk_senders.numel() % chunk or not 1 <= chunk <= 32:
        raise ValueError(f"chunk={chunk} must be in 1..32 and divide the "
                         f"{chunk_senders.numel()} slots")
    body = body_of("edge_attention_sums_chunked", body, s, d, num_heads, ("kv_rows", kv_rows))
    piece = _chunk_piece(s, d, num_heads, chunk, piece)
    # the tensor cores take one edge a step
    per_step = (piece,) if body in SIMT_BODIES else ()
    out = torch.empty(nt * sp, d, dtype=torch.float32, device=dev)
    lib_fn = _entry(*entry_of("edge_attention_sums_chunked", _SUMS_CHUNKED, body, dt))
    launch_body("edge_attention_sums_chunked", body, lib_fn, (
        q_rows.data_ptr(), q_rows.stride(0), kv_rows.data_ptr(), kv_rows.stride(0),
        chunk_senders.data_ptr(), chunk_valid.data_ptr(), chunk_start.data_ptr(),
        chunk_count.data_ptr(), out.data_ptr(), nt, chunk, *per_step,
        s, sp, d, num_heads, int(softmax)), s, d, num_heads, nt, dev, piece)
    count_launch(edge_attention_sums_chunked, body)
    return out


for _wrapper in (edge_attention_sums_mm, edge_attention_layer_mm,
                 edge_attention_sums_chunked, edge_attention_sums_v1):
    _wrapper.launches = 0
    _wrapper.body_launches = dict.fromkeys(BODIES, 0)

KERNEL_WRAPPERS = (edge_attention_sums_mm, edge_attention_layer_mm,
                   edge_attention_sums_chunked, edge_attention_sums_v1)
