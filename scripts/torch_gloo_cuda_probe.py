"""Which collectives a gloo group takes on CUDA tensors: each collective
the port's parallel paths use, called directly (not staged through host
memory) on CUDA tensors by two gloo ranks sharing the card, each in a group
of its own (a collective that crashes its ranks spoils no other), its
result checked. Prints one JSON line per collective and a summary line
last: {"gloo_cuda": {name: "ok" | error}}. ``parallel/collectives.py``'s
``GLOO_CUDA`` names the ones gloo takes; the others are staged.

    python3 scripts/torch_gloo_cuda_probe.py     (one card, ~1.5 min)
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

COLLECTIVES = ("all_reduce", "broadcast", "all_gather_into_tensor", "all_gather",
               "reduce_scatter_tensor", "send_recv", "all_to_all_single")


def probe_rank(rank: int, name: str) -> str:
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank
    other = torch.arange(8, dtype=torch.float32, device=dev) + 100 * (1 - rank)
    if name == "all_reduce":
        dist.all_reduce(x)
        want = torch.arange(8, device=dev) * 2.0 + 100
    elif name == "broadcast":
        dist.broadcast(x, src=0)
        want = torch.arange(8, dtype=torch.float32, device=dev)
    elif name == "all_gather_into_tensor":
        out = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(out, x)
        x, want = out, torch.cat([torch.arange(8, device=dev) + 100.0 * r for r in range(2)])
    elif name == "all_gather":
        outs = [torch.empty(8, device=dev) for _ in range(2)]
        dist.all_gather(outs, x)
        x, want = torch.cat(outs), torch.cat([torch.arange(8, device=dev) + 100.0 * r
                                             for r in range(2)])
    elif name == "reduce_scatter_tensor":
        big = torch.arange(16, dtype=torch.float32, device=dev)
        out = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(out, big)
        x, want = out, 2 * torch.arange(8 * rank, 8 * rank + 8, dtype=torch.float32, device=dev)
    elif name == "send_recv":
        got = torch.empty(8, device=dev)
        ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, got, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        x, want = got, other
    else:
        out = torch.empty(8, device=dev)
        dist.all_to_all_single(out, x)
        # rank r receives block r of every rank's x, in rank order
        want = torch.cat([(torch.arange(8, device=dev) + 100.0 * r)[4 * rank: 4 * rank + 4]
                          for r in range(2)])
        x = out
    torch.cuda.synchronize()
    if not torch.equal(x, want.to(x.dtype)):
        return f"wrong result {x.tolist()} != {want.tolist()}"
    return "ok"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    from ampnet_tpu_torch.parallel.launch import spawn

    summary = {}
    for name in COLLECTIVES:
        try:
            res = spawn(probe_rank, 2, name, backend="gloo", device="cuda", timeout=120,
                        grace=5)
            summary[name] = "ok" if all(r == "ok" for r in res) else "; ".join(
                r for r in res if r != "ok")
        except RuntimeError as e:       # the rank raised (gloo refused) or died
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            summary[name] = lines[-1][:300] if lines else "failed"
        print(json.dumps({"collective": name, "result": summary[name]}), flush=True)
    print(json.dumps({"gloo_cuda": summary, "torch": torch.__version__,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
