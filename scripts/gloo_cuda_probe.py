"""Which of the collectives that ``pies_tpu_torch/parallel/ranks.py`` issues
the gloo backend takes on CUDA tensors, on this machine's torch.

Several ranks on one card cannot use NCCL (it refuses two ranks on one
device), so they use gloo, and ``ranks.Transport`` stages through pinned
host buffers the calls that gloo refuses on device tensors (on an H100 with
torch 2.11: the point-to-point sends only).  This script tries each call in
two fresh gloo ranks
on ``cuda:0`` (each call in its own pair of processes, so that a refusal
that ends a process cannot hide the others) and checks the values it
gives:

* ``p2p``: ``batch_isend_irecv`` of one isend and one irecv per rank;
* ``all_gather_into_tensor``: in place, each rank's slice of the output;
* ``all_reduce``: MAX of an int32 word and SUM of an int64 one.

Run on a card: ``python3 scripts/gloo_cuda_probe.py``.  It prints one line
per call, then the table ``{call: takes CUDA tensors}``.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

CALLS = ("p2p", "all_gather_into_tensor", "all_reduce")


def probe(call: str) -> bool:
    """One rank's try of ``call`` on CUDA tensors: whether the values are
    right."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    dev = torch.device("cuda", 0)
    if call == "p2p":
        peer = 1 - rank
        out = torch.full((4,), float(rank + 1), device=dev)
        into = torch.zeros(4, device=dev)
        ops = [dist.P2POp(dist.isend, out, peer), dist.P2POp(dist.irecv, into, peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        return bool((into == peer + 1).all())
    if call == "all_gather_into_tensor":
        buf = torch.zeros(6, device=dev)
        buf[rank * 3:rank * 3 + 3] = rank + 1
        dist.all_gather_into_tensor(buf, buf[rank * 3:rank * 3 + 3])
        torch.cuda.synchronize()
        return buf.tolist() == [1.0] * 3 + [2.0] * 3
    word = torch.tensor([0, rank], dtype=torch.int32, device=dev)
    count = torch.tensor([rank + 1], dtype=torch.int64, device=dev)
    dist.all_reduce(word, dist.ReduceOp.MAX)
    dist.all_reduce(count)
    torch.cuda.synchronize()
    return word.tolist() == [0, 1] and count.tolist() == [3]


def main() -> int:
    from pies_tpu_torch.parallel import ranks

    table = {}
    with tempfile.TemporaryDirectory() as tmp:
        for call in CALLS:
            try:
                ok = ranks.launch(probe, 2, "gloo", call, store_dir=tmp, timeout=60)
                table[call] = all(ok)
                print(f"{call}: {'takes CUDA tensors' if all(ok) else 'wrong values'}")
            except Exception as e:  # a refusal: the call does not take them
                table[call] = False
                first = str(e).strip().splitlines()
                print(f"{call}: refused ({type(e).__name__}: "
                      f"{first[-1] if first else ''})"[:300])
    print(f"gloo on CUDA tensors: {table}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
