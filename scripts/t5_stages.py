#!/usr/bin/env python3
"""Stage times inside kernel T5's cooperative launch on one GPU.

    python3 scripts/t5_stages.py [n_tets] [--set NAME=VALUE ...] [--reps N]

Builds an instrumented copy of ``pies_tpu_torch/kernels/csrc/
body_broadphase.cu`` apart from the package's library (under the system's
temporary directory): block (0, 0)'s thread 0 reads ``clock64()`` at the
kernel's start, before and after each grid barrier and at its end.  Each
``--set`` changes one of the source's ``constexpr int`` constants in the
copy (``--set kGroup=16 --set kThreads=256 --set kBlocksPerSm=4``).  Then,
on phase 2b's state (``bench.py``'s soup with self-contact, 125,000 tets by
default, after 45 ticks of the package's kernels), it calls the copy
through ``broadphase.body_broadphase`` as found and with a rebuild forced,
holds each call's cache, latch and rebuilt flag to the plain twin's, and
prints the mean stamps in µs (at the card's SM clock read from
``nvidia-smi``; the stamps of block (0, 0): a barrier's "after" minus the
last block's "before" is not visible, so a barrier's wait includes the
other blocks' lateness) and the CUDA-event ms a call.  Prints the card's
name and power limit first and the copy's ``-Xptxas -v`` line.  Imports no
JAX.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCENE = dict(spacing=1.6, scale=0.8, w=2000.0, height=0.5, jitter=0.05)
CONTACT_WARMUP = 45
ENTRIES = ("pies_body_broadphase", "pies_body_broadphase_grid", "pies_body_broadphase_words")
STAMP = "if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) t5_stamps[{}] = clock64();"


def instrumented(source: str, sets: dict[str, str]) -> str:
    """``source`` with its constants set and the stamps put in."""
    for name, value in sets.items():
        source, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                            source)
        if n != 1:
            raise SystemExit(f"no constant {name} in the source")
    source = source.replace("namespace {\n", "__device__ long long t5_stamps[16];\nnamespace {\n", 1)
    head, sep, body = source.partition("bp_kernel(Geo g0) {")
    count = [0]

    def barrier(m):
        count[0] += 1
        return (STAMP.format(2 * count[0] - 1) + "\n  " + m.group(0) + "\n  "
                + STAMP.format(2 * count[0]))

    body = STAMP.format(0) + re.sub(r"cg::this_grid\(\)\.sync\(\);", barrier, body, count=7)
    body = body.replace("\n}\n\nint resident", "\n  " + STAMP.format(15) + "\n}\n\nint resident", 1)
    return (head + sep + "\n  " + body + '\nextern "C" int t5_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, t5_stamps, 16 * sizeof(long long));\n}\n")


def build(sets: dict[str, str], work: Path):
    from pies_tpu_torch import kernels

    csrc = ROOT / "pies_tpu_torch" / "kernels" / "csrc"
    for path in csrc.glob("*.cuh"):
        (work / path.name).write_text(path.read_text())
    src = work / "body_broadphase.cu"
    src.write_text(instrumented((csrc / "body_broadphase.cu").read_text(), sets))
    so = work / "libt5_stages.so"
    r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                        str(so), str(src)], capture_output=True, text=True)
    log = (r.stdout + r.stderr).splitlines()
    if r.returncode:
        raise SystemExit("\n".join(line for line in log if "error" in line))
    for i, line in enumerate(log):
        if "Function properties" in line and "bp_kernel" in line:
            print("ptxas:", " | ".join(x.strip() for x in log[i + 1:i + 3]))
    lib = ctypes.CDLL(str(so))
    for name in ENTRIES:
        getattr(lib, name).argtypes = kernels.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.t5_read.argtypes = [ctypes.c_void_p]
    return lib


def main(n_tets=125_000, sets=None, reps=20):
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import pies_tpu_torch as pt
    from pies_tpu_torch import kernels
    from pies_tpu_torch.collision import broadphase
    from pies_tpu_torch.solver import pd
    from pies_tpu_torch.state import clone_state

    query = ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"]
    smi = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout.strip()
    mhz = float(smi.split(",")[-1].split()[0])
    print(f"card: {smi}; settings {sets or 'as in the source'}")
    dev = torch.device("cuda", 0)
    kernels.lib()
    s = pt.Solver(pt.SolverOptions(solver=pt.SolverName.PD), enable_collisions=True, device=dev)
    s.create_tet_soup(n_tets, **SCENE)
    s.run_ticks(CONTACT_WARMUP)
    st, topo, cfg, params = s.state, s.topology, s.config, s.current_params()
    lay = broadphase.body_layout(cfg, topo.tri_mask.shape[0])
    sc = broadphase.scalars(params)
    x = pd.substep_head_plain(clone_state(st), topo, params, cfg, True)[0]
    prev, tmask, failed = st.prev_positions, topo.tri_mask, st.sim_failed

    with tempfile.TemporaryDirectory() as tmp:
        lib = build(sets or {}, Path(tmp))

        class Lib:  # (the wrapper's entry points from the instrumented copy)
            pass

        copy = Lib()
        for name in ENTRIES:
            setattr(copy, name, getattr(lib, name))
        kernels.lib = lambda: copy
        broadphase.broadphase_grid.cache_clear()
        print(f"grid, words: {broadphase.broadphase_grid(dev, 1, lay.k, lay.h)}")

        def call(force, plain=False):
            c = st.bp.clone()
            if force:
                c.fresh.zero_()
            ov = torch.zeros(1, dtype=torch.int32, device=dev)
            fn = broadphase.body_broadphase_plain if plain else broadphase.body_broadphase
            return c, ov, fn(x, prev, tmask, c, lay, sc, ov, failed).clone()

        for force in (False, True):
            (ck, ok, rk), (cp, op, rp) = call(force), call(force, plain=True)
            same = (all(torch.equal(getattr(ck, f), getattr(cp, f))
                        for f in ("pairs", "valid", "ref", "fresh"))
                    and torch.equal(ok, op) and torch.equal(rk, rp))
            acc = [0.0] * 16
            for _ in range(reps):
                call(force)
                torch.cuda.synchronize()
                out = (ctypes.c_longlong * 16)()
                lib.t5_read(ctypes.addressof(out))
                acc = [a + v for a, v in zip(acc, out)]
            us = [(a - acc[0]) / reps / mhz for a in acc]
            marks = ", ".join(f"{i}: {u:.2f}" for i, u in enumerate(us) if i and acc[i] > acc[0])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(reps):
                call(force)
            ev[1].record()
            torch.cuda.synchronize()
            print(f"{'rebuild' if force else 'as found'}: equal to the twin {same}, rebuilt"
                  f" {int(rk[0])}; stamps µs (2i-1 before, 2i after barrier i; 15 the end):"
                  f" {marks}; {ev[0].elapsed_time(ev[1]) / reps:.4f} ms a call with its"
                  " cache copy")
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    sets = dict(argv[i + 1].split("=", 1) for i, a in enumerate(argv) if a == "--set")
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 20
    nums = [int(a) for i, a in enumerate(argv) if a.isdigit() and argv[i - 1] != "--reps"]
    sys.exit(main(*nums[:1], sets=sets, reps=reps))
