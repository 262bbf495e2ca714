"""Hand-written CUDA kernels of the port: build, load and launch checks.

The sources live in ``csrc/``.  At first use :func:`lib` compiles all of them
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, under ``pies_tpu_torch/_build/`` (git-ignored; the file name
carries a hash of the sources and flags, so an edited source is rebuilt),
and loads it with ``ctypes``.  Nothing is compiled or loaded at import time.

Each C entry point launches one kernel on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.  The
wrappers that call them sit beside their plain PyTorch twins:

* T1 ``pies_tet_force12`` — ``constraints/projections.py:tet_force12``
* T2 ``pies_tet_cols_substep``, ``pies_tet_cols_contact`` —
  ``solver/tetcols.py:substep_cols``, ``contact_substep`` (the contact
  substep one cooperative launch, ``csrc/coop.cuh``)
* T3 ``pies_substep_head`` — ``solver/pd.py:substep_head``
* T4 ``pies_substep_tail`` — ``solver/pd.py:substep_tail``
* T5 ``pies_body_broadphase`` — ``collision/broadphase.py:body_broadphase``
  (one cooperative launch a call; ``pies_body_broadphase_grid`` gives its
  grid, ``pies_body_broadphase_words`` its scratch)
* T6 ``pies_pt_narrowphase`` — ``collision/broadphase.py:pt_narrowphase``
  (a cooperative launch, ``csrc/coop.cuh``; ``pies_pt_narrowphase_grid``
  gives its grid)
* T7 ``pies_pt_coupling_setup``, ``pies_pt_force`` —
  ``solver/tetcols.py:pt_coupling_setup``, ``pt_force`` (the setup a
  cooperative launch, its grid from ``pies_pt_coupling_grid``)
* T8 ``pies_pt_tail`` — ``solver/pd.py:pt_tail`` (one cooperative launch
  a call)
* T9 ``pies_tet_force12_gather``, ``pies_assemble_force`` —
  ``constraints/projections.py:tet_force12_gathered``,
  ``solver/assembly.py:assemble_force``
* T10 ``pies_ell_matvec`` — ``solver/assembly.py:apply_system``
* T11 ``pies_cg_init``, ``pies_cg_update``, ``pies_cg_direction`` —
  ``solver/assembly.py:pcg_solve`` (across ranks each stage writes the
  rank's block partials at its offset of a gathered buffer and sums all
  of them)
* T12 ``pies_distance_rows``, ``pies_bend_rows`` —
  ``constraints/projections.py:distance_rows``, ``bend_rows``
* T13 ``pies_shape_rows``, ``pies_goal_rows`` —
  ``constraints/projections.py:shape_rows``, ``goal_rows``
* T14 ``pies_super_broadphase`` — ``collision/broadphase.py:super_broadphase``
* T15 ``pies_super_narrowphase`` —
  ``collision/broadphase.py:super_narrowphase``
* T16 ``pies_tri_candidates`` — ``collision/broadphase.py:tri_candidates``
* T17 ``pies_tri_ccd`` — ``collision/broadphase.py:tri_ccd``
* T18 ``pies_pbd_rows``, ``pies_pbd_apply``, ``pies_pbd_head``,
  ``pies_pbd_floor``, ``pies_pbd_tail`` —
  ``constraints/projections.py:jacobi_rows``, ``solver/pbd.py:apply_jacobi``,
  ``substep_head``, ``floor_clamp``, ``substep_tail``
* T19 ``pies_pbd_chains``, ``pies_pbd_color_class`` —
  ``solver/pbd.py:chain_scan``, ``color_classes``
* T20 ``pies_node_pairs`` — ``collision/broadphase.py:node_pairs``
* T21 ``pies_node_response`` — ``collision/broadphase.py:node_response``
* T22 ``pies_tet_block_factor`` — ``solver/assembly.py:tet_block_factor``
  (its solve is a mode of T11's init and update stages)
* T23 — full contact coupling, device functions in ``csrc/pt_full.cuh``
  that run inside T10 (``apply_system``) and T9's stage 2
  (``assemble_force``)
* T24 ``pies_floor_entries`` — ``solver/pd.py:floor_entries`` (the force's
  per-entry sum runs inside T9's stage 2, ``csrc/floor_entries.cuh``)
* T25 ``pies_edge_ccd`` — ``collision/broadphase.py:edge_ccd``
* T26 ``pies_edge_setup`` — ``solver/assembly.py:edge_setup`` (its
  stabilization pass runs inside T8, its force and operator terms inside
  T9's stage 2 and T10: ``csrc/edge_terms.cuh``)
* T27 ``pies_node_setup``, ``pies_node_friction`` —
  ``solver/assembly.py:node_setup``, ``solver/pd.py:node_friction`` (its
  force term runs inside T9's stage 2, ``csrc/node_contacts.cuh``)

* T28 ``pies_constraint_residuals`` — ``diagnostics.py:
  constraint_residuals`` (one launch per family present and one reduction)
* T29 ``pies_occupancy`` — ``collision/broadphase.py:occupancy``, the count
  modes of T5's packed-body grid and T16's all-pairs and cell-list front
  ends in one source of their own (``csrc/occupancy.cu``, over
  ``grid.cuh``), behind ``candidate_occupancy`` and
  ``diagnostics.broadphase_health``

* T30 ``pies_halo_refresh``, ``pies_halo_reduce``, ``pies_halo_merge``,
  ``pies_halo_merge_pairs`` — ``parallel/halo.py``: the domain
  decomposition's halo exchange between the slabs of one device and, across
  ranks, the two outer bands the neighbouring ranks send
  (``parallel/ranks.py``), the count-averaged applies and the CG's
  partials of its reduce, and the gather of the slabs' contact lists
  (``parallel/domain.py``)

T1-T8 (ROADMAP item 10a), the generic path's T9-T13 and T22 (item 10b-i),
its point-triangle contacts and entry-list floor, T14-T17, T23 and T24
(item 10b-ii), its edge-edge and node-node contacts, T20 and T25-T27
(item 10b-iii), and the PBD tick's T18, T19 and T21 (item 10b-iv, with
T20's pair cache kept per member across ticks) take an ensemble's member
axis (``pies_tpu/parallel/ensemble.py``): their last int argument is the
member count, each launch's ``blockIdx.y`` is the member, and a single
scene is one member.  The row kernels (T9's stage 1, T12, T13) and T9's
stage 2 also take the row buffer's member stride, in rows, since each
family writes its part of one buffer.

Each source compiles to an object in its own ``nvcc`` process, all started
together, and the objects link into one library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import OrderedDict
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
# -fmad=false: no contraction of a*b+c into one FMA, so every kernel does the
# same float32 roundings, in the same order, as its plain PyTorch twin, and
# the two agree bit for bit on the card.  No --use_fast_math: division and
# square root stay IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)
SCAN_BLOCK = 256  # pies::kBlock in csrc/compact.cuh

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every entry point: c_void_p for each pointer and the stream.
SIGNATURES = {
    "pies_tet_force12": [_P] * 10 + [_I, _I, _P, _I, _P],
    "pies_tet_force12_attrs": [_P],
    "pies_tet_cols_substep": [_P] * 18 + [_I, _I, _I, _F] + [_P] * 5 + [_I, _P],
    "pies_tet_cols_contact": [_P] * 20 + [_I, _I, _I, _F] + [_P] * 9 + [_I, _F, _I, _P],
    "pies_tet_cols_contact_occupancy": [],
    "pies_substep_head": [_P] * 11 + [_I, _F, _F, _F, _P, _I, _I, _P],
    "pies_substep_tail": [_P] * 11 + [_I, _F, _F, _F, _F, _F] + [_P] * 7 + [_I, _P],
    "pies_body_broadphase": [_P] * 11 + [_I] * 11 + [_F] * 6 + [_I, _I, _P],
    "pies_body_broadphase_grid": [_I, _I],
    "pies_body_broadphase_words": [_I, _I, _I],
    "pies_pt_narrowphase": [_P] * 14 + [_I] * 6 + [_F, _I, _I, _I, _P],
    "pies_pt_narrowphase_grid": [_I, _I],
    "pies_pt_coupling_setup": [_P] * 17 + [_I, _I, _F, _I, _I, _P],
    "pies_pt_coupling_grid": [_I, _I],
    "pies_super_broadphase": [_P] * 17 + [_I] * 11 + [_F] * 6 + [_I, _P],
    "pies_super_narrowphase": [_P] * 16 + [_I] * 11 + [_F, _I, _I, _P],
    "pies_pt_force": [_P] * 10 + [_I, _I, _F, _I, _P],
    "pies_pt_tail": [_P] * 25 + [_I] * 6 + [_F] * 6 + [_I, _P],
    "pies_tet_force12_gather": [_P] * 11 + [_I, _I, _P] + [_I] * 3 + [_P],
    "pies_assemble_force": [_P] * 9 + [_I, _F] + [_P] * 8 + [_I, _F] + [_P] * 3 + [_I]
    + [_P] * 7 + [_I, _F, _I] + [_P] * 8 + [_I] * 4 + [_P],
    "pies_ell_matvec": [_P] * 8 + [_I] + [_P] * 2 + [_I, _F] + [_P] * 4 + [_I, _I, _F]
    + [_P] * 5 + [_I] + [_P] * 7 + [_I, _F, _I, _I, _P],
    "pies_cg_init": [_P] * 13 + [_I, _P, _I, _I, _I, _P],
    "pies_cg_update": [_P] * 13 + [_I] * 3 + [_F, _P, _I, _I, _I, _P],
    "pies_cg_direction": [_P] * 5 + [_I] * 3 + [_F, _P, _I, _I, _I, _P],
    "pies_distance_rows": [_P] * 5 + [_I, _P] + [_I] * 3 + [_P],
    "pies_bend_rows": [_P] * 6 + [_I, _P] + [_I] * 3 + [_P],
    "pies_shape_rows": [_P] * 12 + [_I, _I, _I, _P] + [_I] * 3 + [_P],
    "pies_goal_rows": [_P] * 6 + [_I, _P, _I, _I, _P],
    "pies_tri_candidates": [_P] * 18 + [_I] * 12 + [_F] * 3 + [_I, _I, _P],
    "pies_tri_ccd": [_P] * 12 + [_I] * 4 + [_F, _I, _I, _P],
    "pies_pbd_rows": [_I] + [_P] * 8 + [_I, _I, _F, _I, _P, _I, _P],
    "pies_pbd_apply": [_P] * 4 + [_I, _I, _P, _I, _P],
    "pies_pbd_head": [_P] * 4 + [_I, _F, _F, _P, _I, _I, _P],
    "pies_pbd_floor": [_P] * 3 + [_I, _F, _P, _I, _P],
    "pies_pbd_tail": [_P] * 6 + [_I] + [_F] * 4 + [_P, _I, _P],
    "pies_pbd_chains": [_P] * 5 + [_I, _I, _I, _P, _I, _P],
    "pies_pbd_color_class": [_P] * 4 + [_I, _I, _I, _P, _I, _P],
    "pies_node_pairs": [_P] * 25 + [_I] * 5 + [_F] * 2 + [_I, _P],
    "pies_node_response": [_P] * 13 + [_I, _I, _F, _F, _P, _I, _P],
    "pies_tet_block_factor": [_P] * 3 + [_I, _P, _I, _P],
    "pies_floor_entries": [_P] * 4 + [_F] + [_P] * 5 + [_I, _I, _P, _I, _P],
    "pies_edge_ccd": [_P] * 14 + [_I] * 6 + [_P],
    "pies_edge_setup": [_P] * 23 + [_I] * 4 + [_F, _I, _P],
    "pies_node_setup": [_P] * 16 + [_I] * 4 + [_F, _I, _P],
    "pies_node_friction": [_P] * 17 + [_I] * 3 + [_F] * 5 + [_I, _P],
    "pies_constraint_residuals": ([_P] * 3 + [_I]) + ([_P] * 3 + [_I]) * 2
    + ([_P] * 5 + [_I]) * 2 + ([_P] * 3 + [_I]) + [_P] * 5,
    "pies_occupancy": [_P] * 7 + [_I] * 8 + [_F] * 3 + [_P],
    "pies_halo_refresh": [_P] * 2 + [_I] * 5 + [_P] * 3,
    "pies_halo_reduce": [_P] * 2 + [_I] * 5 + [_P] * 10,
    "pies_halo_merge": [_P] * 3 + [_I] * 5 + [_P] * 4,
    "pies_halo_merge_pairs": [_P] * 12 + [_I] * 4 + [_P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build
build_log: str = ""  # nvcc's output of this process's build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # locates the toolkit only

    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        CUDA_HOME and Path(CUDA_HOME) / "bin" / "nvcc",
        shutil.which("nvcc"),
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def scan_partials(n: int) -> int:
    """Ints of scratch a two-level scan of ``n`` values needs."""
    return max(1, -(-n // SCAN_BLOCK))


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the build directory unless a library for
    the same sources and flags is already there; returns its path.  One
    ``nvcc -c`` per source, all running at once, then one link.
    ``verbose`` adds ``-Xptxas -v`` (registers, spills) to the log."""
    global build_seconds, build_log
    sources = sorted(_CSRC.glob("*.cu"))
    flags = NVCC_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(_CSRC.iterdir()):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    tag = digest.hexdigest()[:16]
    out = _BUILD / f"libpies_kernels_{tag}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ("-Xptxas", "-v") if verbose else ()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources:
        obj = _BUILD / f"{src.stem}_{tag}.{os.getpid()}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *flags, *ptxas, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(f"== {s.name}\n{log}" for s, log in zip(sources, logs))
    failed = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *flags[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log += link.stdout + link.stderr
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


_SCRATCH: OrderedDict = OrderedDict()
SCRATCH_KEPT = 16  # scratch tensors kept, the least recently used dropped first


def scratch(name: str, shape: tuple, dtype: torch.dtype, device: torch.device,
            zeroed: bool = False) -> torch.Tensor:
    """A kernel's scratch tensor, kept across calls per name, shape, dtype,
    device and current stream instead of allocated each call: the launches
    of one stream run in order, so one call's use of it ends before the
    next one's begins.  The kernel either writes it before reading it or,
    with ``zeroed`` (made with zeros the first time), leaves it all 0."""
    key = (name, tuple(shape), dtype, device, stream())
    t = _SCRATCH.get(key)
    if t is None:
        t = (torch.zeros if zeroed else torch.empty)(shape, dtype=dtype, device=device)
        _SCRATCH[key] = t
        while len(_SCRATCH) > SCRATCH_KEPT:
            _SCRATCH.popitem(last=False)
    else:
        _SCRATCH.move_to_end(key)
    return t


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def require(device: torch.device, *tensors: torch.Tensor | None) -> None:
    """Raise unless every tensor is a contiguous float32/int32 tensor on
    ``device`` — what the kernels take."""
    for t in tensors:
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"dtype {t.dtype}: the kernels take float32/int32")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")


def launch_members(x: torch.Tensor, failed: torch.Tensor, *batched: torch.Tensor | None) -> int:
    """The member count a kernel launches with for the positions (or
    vectors) ``x`` f32[..., N, 3]: B for an ensemble's f32[B, N, 3], 1 for
    a single scene.  Raises unless the latch ``failed`` and the per-member
    arrays ``batched`` (None skipped) carry the same member axis."""
    lead = x.shape[:-2]
    if failed.shape[:-1] != lead or any(t is not None and t.shape[:len(lead)] != lead
                                        for t in batched):
        raise ValueError("the latch and the per-member arrays need the positions' member axis")
    return lead[0] if lead else 1


def row_stride(device: torch.device, rows: torch.Tensor) -> int:
    """The member stride, in rows, of a force-row output f32[R, 3] or f32[B,
    R, 3]: an ensemble's family writes its part of one row buffer, a view
    whose members are ``stride`` rows apart.  Raises unless each member's
    rows are contiguous float32 on ``device``."""
    if rows.device != device or rows.dtype != torch.float32:
        raise ValueError(f"rows on {rows.device} as {rows.dtype}, expected float32 on {device}")
    if rows.stride(-1) != 1 or rows.stride(-2) != 3 or (rows.dim() == 3
                                                        and rows.stride(0) % 3):
        raise ValueError("the row kernels take rows of 3 contiguous floats per member")
    return rows.stride(0) // 3 if rows.dim() == 3 else rows.shape[0]


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain twin), False for a CUDA tensor (kernel);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")
