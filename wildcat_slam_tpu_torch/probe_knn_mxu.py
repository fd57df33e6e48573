"""What bounds K2 mxu (``csrc/knn_mxu.cu``) on the card: the kernel against
variants of its own source with a part of its work cut out.

    python -m wildcat_slam_tpu_torch.probe_knn_mxu

Each variant is built from the source by a text edit, into its own library
under ``_build/probe/``, and timed on the same inputs (descriptor clouds made
from a seed) at Q=8192, T=16384 (the main path's larger search) and Q=16384,
T=65536:

- ``kernel``: the source as it is;
- ``fold1``: the fold keeps one of its 32 scores a thread (the product and
  everything else unchanged), so the difference to ``kernel`` is what the
  fold costs beyond what overlaps it;
- ``mma1``: one wgmma a group (hi*lo) instead of three;
- ``fold1_mma1``: both cuts: the pipeline, the copies and the stores.

The variants compute wrong results; only their times mean anything. For each
it prints the main kernel's device time from ``torch.profiler`` (the prologue
kernel apart) and the device time of back-to-back calls of both kernels, and
ptxas's line for the main kernel (registers, spills, and a "wgmma ...
serialized" warning if ptxas made every wgmma wait for the one before).
Needs a CUDA card; it exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from wildcat_slam_tpu_torch.ops import _build, knn

FOLD = "  for (int v = 0; v < kAcc; ++v) {\n    float keep;"
MMA23 = "  wgmma_tf32<1>(acc, a_hi, d_lo);\n  wgmma_tf32<1>(acc, a_hi, d_hi);\n"


def variants(src: str) -> dict:
    if FOLD not in src or MMA23 not in src:
        raise RuntimeError("csrc/knn_mxu.cu no longer has the fold loop or the three products "
                           "this probe cuts")
    fold1 = FOLD.replace("v < kAcc", "v < 1")
    return {"kernel": src, "fold1": src.replace(FOLD, fold1), "mma1": src.replace(MMA23, ""),
            "fold1_mma1": src.replace(FOLD, fold1).replace(MMA23, "")}


def build(srcs: dict) -> dict:
    """{name: (loaded library, ptxas line of the main kernel)}, one nvcc each, together."""
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in srcs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lines = err.splitlines()
        notes = [ln for ln in lines if "C75" in ln]
        notes += [lines[i + 1] for i, ln in enumerate(lines[:-1])
                  if "Function properties" in ln and "14knn_mxu_kernel" in ln]
        note = "; ".join(ln.split("info    :")[-1].strip() for ln in notes)
        lib = _build.declare(ctypes.CDLL(str((out_dir / f"{name}.cu").with_suffix(".so"))))
        libs[name] = (lib, note)
    return libs


def _cloud(rng, n: int) -> np.ndarray:
    c = rng.uniform(-5.0, 5.0, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([c, nrm / 0.0873], axis=1).astype(np.float32)


def _times(fn) -> tuple:
    """(main kernel us a call by the profiler, us a call of back-to-back calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    main = [e.device_time_total / e.count for e in prof.key_averages()
            if e.device_time_total > 0 and "knn_mxu_kernel" in e.key]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        fn()
    b.record()
    b.synchronize()
    return (main[0] if main else float("nan")), a.elapsed_time(b) / 20 * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_knn_mxu: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"probe_knn_mxu: {smi}", flush=True)
    libs = build(variants((_build.SRC_DIR / "knn_mxu.cu").read_text()))
    for name, (_, note) in libs.items():
        print(f"  {name}: {note}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)
    for q, t in ((8192, 16384), (16384, 65536)):
        nb = 512
        dq = torch.as_tensor(_cloud(rng, q), device=dev)
        dt = torch.as_tensor(_cloud(rng, t), device=dev)
        dq_aug, dtt_aug = knn.mxu_embedding(dq, dt)
        plan = knn.mxu_plan(q, nb, sms)
        staged = torch.empty((t // nb) * plan.padded_bins * 16, device=dev)
        vals = torch.empty((q, nb), device=dev)
        idx = torch.empty((q, nb), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, (lib, _) in libs.items():
            def call(lib=lib):
                err = lib.wc_knn_mxu(dq_aug.data_ptr(), dtt_aug.data_ptr(), staged.data_ptr(),
                                     vals.data_ptr(), idx.data_ptr(), q, t, nb, *plan, stream)
                if err:
                    raise RuntimeError(f"wc_knn_mxu ({name}) failed: CUDA error {err}")
            main_us, call_us = _times(call)
            print(f"Q={q} T={t} {name}: main kernel {main_us:.2f} us (profiler), "
                  f"{call_us:.2f} us a call back to back", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
