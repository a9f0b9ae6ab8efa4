"""Which collectives two processes on one card can run, by backend.

    python scripts/torch_collectives_probe.py [--backends gloo nccl]
        [--timeout 90]

Starts two processes on cuda:0 for each backend (a tcp://localhost
rendezvous), and in each tries the collectives the PyTorch package's
parallel code calls, on CUDA tensors: all_reduce (fp32 and bf16),
broadcast, all_gather, all_gather_into_tensor and reduce_scatter_tensor,
each checked against the sum or the gather it should give. Prints one
JSON object: {backend: {collective: "ok" | the error's first line}}, or
"timeout" for a backend whose processes did not finish. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

OPS = ("all_reduce", "all_reduce_bf16", "broadcast", "all_gather",
       "all_gather_into_tensor", "reduce_scatter_tensor")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _try(op, rank):
    import torch
    import torch.distributed as tdist
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    both = torch.stack([torch.arange(8, dtype=torch.float32) + 10 * r
                        for r in range(2)]).to(dev)
    if op == "all_reduce":
        tdist.all_reduce(x)
        ok = torch.equal(x, both.sum(0))
    elif op == "all_reduce_bf16":
        y = x.to(torch.bfloat16)
        tdist.all_reduce(y)
        ok = torch.equal(y.float(), both.sum(0))
    elif op == "broadcast":
        tdist.broadcast(x, 0)
        ok = torch.equal(x, both[0])
    elif op == "all_gather":
        out = [torch.empty_like(x) for _ in range(2)]
        tdist.all_gather(out, x)
        ok = torch.equal(torch.stack(out), both)
    elif op == "all_gather_into_tensor":
        out = torch.empty(16, device=dev)
        tdist.all_gather_into_tensor(out, x)
        ok = torch.equal(out, both.reshape(-1))
    else:
        out = torch.empty(4, device=dev)
        tdist.reduce_scatter_tensor(out, x)
        ok = torch.equal(out, both.sum(0)[4 * rank:4 * rank + 4])
    torch.cuda.synchronize()
    return "ok" if ok else "wrong result"


def child(backend, port, rank):
    import torch
    import torch.distributed as tdist
    torch.cuda.set_device(0)
    tdist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                             world_size=2, rank=rank)
    out = {}
    for op in OPS:
        try:
            out[op] = _try(op, rank)
        except Exception as e:  # the backend's refusal is the finding
            out[op] = (str(e).strip().splitlines() or [type(e).__name__])[0]
    tdist.destroy_process_group()
    print(json.dumps(out), flush=True)


def probe(backends=("gloo", "nccl"), timeout=90.0):
    """{backend: {collective: "ok" | error}} of two processes on cuda:0,
    the backends' pairs of processes started together."""
    procs = {}
    for backend in backends:
        port = _free_port()
        procs[backend] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", backend,
             str(port), str(r)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
    found = {}
    try:
        for backend, pair in procs.items():
            res = []
            for p in pair:
                try:
                    out, err = p.communicate(timeout=timeout)
                except subprocess.TimeoutExpired:
                    res.append({"process": "timeout"})
                    continue
                lines = [ln for ln in out.splitlines() if ln.startswith("{")]
                res.append(json.loads(lines[-1]) if lines else
                           {"process": (err.strip().splitlines() or
                                        [f"exit {p.returncode}"])[-1]})
            # a collective counts as run when both processes ran it
            found[backend] = res[0] if all(r == res[0] for r in res) \
                else {"ranks": res}
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return found


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    ap = argparse.ArgumentParser()
    ap.add_argument("--backends", nargs="+", default=["gloo", "nccl"])
    ap.add_argument("--timeout", type=float, default=90.0)
    args = ap.parse_args()
    print(json.dumps(probe(args.backends, args.timeout)))
