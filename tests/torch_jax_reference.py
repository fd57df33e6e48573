"""Recorded runs of the JAX package: the references the port is held to over
long runs at the shipped config.

    python tests/torch_jax_reference.py [NAME ...] [--out DIR]
    python tests/torch_jax_reference.py --lm-cap [--out DIR] [--checkpoints DIR]
                                       [--resume-from DIR]

Not a test module (pytest collects ``test_*.py`` only). It imports the JAX
package and runs it on the CPU (x64 on for a float64 record only, each
record in a process of its own). Each record feeds a synthetic sequence in
the order of the port's ``cli.synthetic_events`` to the JAX package's
``LidarOdometry`` and writes ``DIR/NAME.npz`` (default
``tests/torch_reference/``) holding, per sweep, the back time ``t`` and the
22 packed outputs ``packed`` of ``process_sweep`` (position 0:3, quaternion
3:7, then ``chip_smoke.PACKED_STATS``), and ``meta``, a JSON string: the sequence's
keyword arguments, the config's keyword arguments and every config field,
the JAX and numpy versions, the CPU model, the command, the seconds it took
and the ATE, largest and final position errors against ground truth.

``tests/test_torch_longrun.py`` holds the records' metadata and their first
sweeps to fresh runs of both packages; ``chip_smoke.py`` phase (l) holds the
port on the card to them (it reads the files and never imports this one).
The four records written at once on an 8-core CPU took 6 minutes
(``room50_f32``), 30-35 (the soaks) and 90 (``room50_f64``).

``--lm-cap`` settles where a float32 sweep runs to the LM loop's iteration
cap: the port runs the 50 s room on the CPU at the shipped config and saves
a checkpoint after every sweep; for each sweep k that reached the cap, the
checkpoint taken before it is resumed in the JAX package and in the port,
both on the CPU (the port also with its exact search where its run searched
by bins), and sweep k's LM loop is traced iteration by iteration in each
(cost, new cost, predicted decrease, gain ratio, lambda, accept). It prints the tables side by side and writes them to
``DIR/lm_cap.npz`` (``DIR/lm_cap_resumed.npz`` with ``--resume-from``,
checkpoints written elsewhere: ``probe_spline_fit --checkpoints`` on a card).
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_reference")
sys.path.insert(0, ROOT)

# the runs and their layout are chip_smoke.py's (which reads the records and
# never imports this file): bench.py's room, benchmarks/longrun.py's regimes,
# the packed row's statistics and count columns
from chip_smoke import ROOM50, SOAKS, errors, packed_rows  # noqa: E402

F64 = dict(dtype="float64", linear_solver="pcg_xla", match_knn_approx=False)
# name -> (SyntheticSequence keyword arguments, WildcatConfig keyword arguments)
RECORDS = {
    "room50_f64": (ROOM50, F64),
    # on the CPU the shipped config computes the same (approx_max_k is exact there)
    "room50_f32": (ROOM50, dict(match_knn_approx=False)),
    "travel300_f32": (SOAKS["travel300_f32"], {}),
    "fastrot300_f32": (SOAKS["fastrot300_f32"], {}),
    # room50_f64 with every gyroscope reading's x moved up by one float64 ulp
    # (after three sweeps the window's positions differ by ~1e-14 m, as the
    # port's and the JAX package's do after one sweep from one state): how
    # far the JAX package's own float64 run moves when its inputs change in
    # the last bit
    "room50_f64_ulp": (ROOM50, F64),
}
# records whose input is moved by one ulp (see room50_f64_ulp)
ULP_RECORDS = ("room50_f64_ulp",)


def _jax_cpu(x64: bool):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    return jax


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def record(name: str, out_dir: str) -> str:
    """Run one record in this process and write ``out_dir/name.npz``."""
    seq_kw, cfg_kw = RECORDS[name]
    jax = _jax_cpu(cfg_kw.get("dtype") == "float64")
    from wildcat_slam_tpu.config import WildcatConfig
    from wildcat_slam_tpu.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu.odometry.pipeline import LidarOdometry
    from wildcat_slam_tpu_torch.cli import synthetic_events

    t0 = time.perf_counter()
    seq = SyntheticSequence(**seq_kw)
    if name in ULP_RECORDS:
        seq.imu = [(t, acc, np.concatenate([np.nextafter(gyr[:1], np.inf), gyr[1:]]))
                   for t, acc, gyr in seq.imu]
    cfg = WildcatConfig(**cfg_kw)
    lo = LidarOdometry(cfg)
    for ev in synthetic_events(seq):
        n = lo.sweep_id
        (lo.add_imu if ev[0] == "imu" else lo.add_scan)(*ev[1:])
        if lo.sweep_id != n and lo.sweep_id % 50 == 0:
            print(f"{name}: sweep {lo.sweep_id}, {time.perf_counter() - t0:.0f} s", flush=True)
    t, packed = packed_rows(lo.trajectory, lo.stats)
    seconds = time.perf_counter() - t0
    err = errors(t, packed[:, 0:3], seq)
    meta = dict(name=name, sequence=seq_kw, config_kw=cfg_kw, ulp=name in ULP_RECORDS,
                config=json.loads(cfg.to_json()), sweeps=len(t),
                jax=jax.__version__, numpy=np.__version__, x64=bool(jax.config.jax_enable_x64),
                cpu=_cpu_model(), command=f"python tests/torch_jax_reference.py {name}",
                seconds=round(seconds, 1), errors_m={k: err[k] for k in ("ate", "max", "final")},
                capped=[int(i) for i in np.flatnonzero(packed[:, 8] >= cfg.inner_iter_num_max)])
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.npz")
    np.savez_compressed(path, t=t, packed=packed, meta=json.dumps(meta, sort_keys=True))
    print(f"{name}: {len(t)} sweeps in {seconds:.0f} s, {meta['errors_m']}, capped "
          f"{meta['capped']} -> {path}", flush=True)
    return path


def _cells(fn) -> dict:
    """The closure variables of a nested function, by name."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


_JAX_ROWS: list = []


def _jax_lm_tap():
    """A ``lax.while_loop`` that runs the JAX package's LM loop (the body
    named ``lm_step``) with a recording tap, and every other loop as it is.
    The tap recomputes, inside the traced body, the quantities ``lm_step``
    keeps to itself (the step, the candidate's cost, the predicted decrease,
    the gain ratio, the accept test and the lambda it leads to), from the
    same closure, and hands them with the loop state after the step to the
    host (``_JAX_ROWS``: the compiled sweep keeps the callback, so the list
    stays one); ``_disagreements`` holds them to what the step did."""
    import jax
    import jax.numpy as jnp

    from wildcat_slam_tpu.odometry import solver

    real = jax.lax.while_loop

    def while_loop(cond, body, init):
        if getattr(body, "__name__", "") != "lm_step":
            return real(cond, body, init)
        c = _cells(body)
        if c["use_fused_pcg"]:
            raise RuntimeError("the tap follows the portable PCG and Cholesky paths only")

        def traced(state):
            out = body(state)
            cor, lam, nu, cost, h, g, _, k, _ = state
            d = jnp.clip(jnp.diag(h), 1e-6, 1e32)
            h_damped = h + lam * jnp.diag(d)
            if c["linear_solver"] in ("pcg", "pcg_xla"):
                delta = solver._pcg_solve(h_damped, -g, c["s_cap"], c["pcg_iters"], c["pcg_tol"])
            else:
                delta = -jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(h_damped), g)
            delta = c["remap_step"](delta)
            new_cost = c["eval_cost"](cor + delta)
            tiny = jnp.finfo(c["dtype"]).tiny
            pred = 0.5 * (jnp.sum(delta * (lam * d * delta)) - jnp.sum(delta * g))
            rho = (cost - new_cost) / jnp.maximum(pred, tiny)
            accept = (new_cost < cost) & jnp.isfinite(new_cost) & (pred > 0)
            shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            lam_tap = jnp.clip(jnp.where(accept, lam * shrink, lam * nu), 1e-12, 1e10)
            jax.debug.callback(
                lambda *v: _JAX_ROWS.append(dict(zip(_LM_KEYS, (float(x) for x in v)))),
                k, cost, new_cost, pred, rho, lam, accept, lam_tap, out[1], out[3], out[8])
            return out

        return real(cond, traced, init)

    return while_loop


# one LM iteration: its index, the cost before it, the candidate's cost, the
# predicted decrease, the gain ratio, lambda before, accept and the lambda it
# leads to (all recomputed by a tap), and after the step lambda, the cost and done
_LM_KEYS = ("k", "cost", "new_cost", "pred", "rho", "lam", "accept", "lam_tap", "lam_out",
            "cost_out", "done")


def _disagreements(rows: list) -> list:
    """The iterations where a tap's recomputed accept or lambda is not what
    the real step did (it accepted where its cost went down; lambda to a
    float32 rounding or two)."""
    return [r["k"] for r in rows
            if bool(r["accept"]) != (r["cost_out"] < r["cost"])
            or abs(r["lam_tap"] - r["lam_out"]) > 1e-6 * abs(r["lam_out"])]


def _port_lm_tap(rows: list):
    """``solver.lm_loop_eager`` of the port with the same tap: before each
    call of ``lm_step`` the step and the candidate's cost are computed from
    its closure (the CPU computes them bit for bit as ``lm_step`` does)."""
    import torch

    def lm_loop(lm_step, relinearize, max_iterations):
        c = _cells(lm_step)
        h, g, lam, nu, cor, cost = c["h"], c["g"], c["lam"], c["nu"], c["cor"], c["cost"]
        for k in range(max_iterations):
            d = torch.clip(torch.diagonal(h), 1e-6, 1e32)
            delta = c["remap_step"](c["linear_solve"](h, g, lam, d))
            new_cost = c["eval_cost"](cor + delta)
            pred = 0.5 * (torch.sum(delta * (lam * d * delta)) - torch.sum(delta * g))
            rho = (cost - new_cost) / torch.clamp(pred, min=c["tiny"])
            accept = (new_cost < cost) & torch.isfinite(new_cost) & (pred > 0)
            shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
            lam_tap = torch.clip(torch.where(accept, lam * shrink, lam * nu), 1e-12, 1e10)
            row = [k, cost, new_cost, pred, rho, lam, accept, lam_tap]
            row = [float(x) for x in row]  # before lm_step updates lam and cost in place
            flags = lm_step()
            rows.append(dict(zip(_LM_KEYS, row + [float(lam), float(cost), float(flags[1])])))
            if bool(flags[1]):
                break
            if bool(flags[0]):
                relinearize()

    return lm_loop


def _summary(rows: list, cap: int) -> dict:
    """What one traced LM loop shows: its iterations, whether it reached the
    cap, the last accepted iteration, and at that point the cost, its float32
    rounding step, the last accepted decrease and the predicted decreases of
    the rejected steps after it."""
    acc = [r for r in rows if r["accept"]]
    last = acc[-1]["k"] if acc else None
    after = [r for r in rows if last is None or r["k"] > last]
    cost = rows[-1]["cost_out"] if rows else float("nan")
    return dict(iterations=len(rows), capped=len(rows) >= cap, last_accepted=last,
                accepted=len(acc), final_cost=cost,
                cost_ulp_f32=float(np.spacing(np.float32(abs(cost)))),
                last_decrease=(acc[-1]["cost"] - acc[-1]["cost_out"]) if acc else None,
                pred_after=[r["pred"] for r in after[:8]],
                decrease_after=[r["cost"] - r["new_cost"] for r in after[:8]],
                lam_final=rows[-1]["lam_out"] if rows else None)


def lm_cap(out_dir: str, ckpt_dir=None, resume_from=None) -> int:
    """The LM cap from one shared state (see the module doc). Writes
    ``out_dir/lm_cap.npz`` or ``lm_cap_resumed.npz`` (a JSON string ``result``)."""
    import tempfile

    import torch

    jax = _jax_cpu(False)
    from wildcat_slam_tpu.odometry import checkpoint as jax_checkpoint
    from wildcat_slam_tpu_torch.cli import feed_events, synthetic_events
    from wildcat_slam_tpu_torch.config import WildcatConfig
    from wildcat_slam_tpu_torch.io.synthetic import SyntheticSequence
    from wildcat_slam_tpu_torch.odometry import checkpoint, solver
    from wildcat_slam_tpu_torch.odometry.pipeline import LidarOdometry

    cfg = WildcatConfig()
    t0 = time.perf_counter()
    events = list(synthetic_events(SyntheticSequence(**ROOM50)))
    result = dict(sequence=ROOM50, jax=jax.__version__, torch=torch.__version__,
                  cpu=_cpu_model(), sweeps={},
                  command="python tests/torch_jax_reference.py --lm-cap"
                  + (" --resume-from DIR" if resume_from else ""))
    if resume_from:
        # checkpoints written elsewhere (probe_spline_fit --checkpoints on a card)
        ckpt_dir = resume_from
        with open(os.path.join(ckpt_dir, "marks.json")) as f:
            marks = {int(k): v for k, v in json.load(f).items()}
        iters = None
        todo = sorted(marks)
        with np.load(os.path.join(ckpt_dir, f"after{todo[0]}.npz")) as d:
            cfg = WildcatConfig.from_json(json.loads(str(d["__meta__"]))["config"])
    else:
        ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="lm_cap_")
        os.makedirs(ckpt_dir, exist_ok=True)
        # the port's run, a checkpoint after every sweep (kept where the next sweep caps)
        lo = LidarOdometry(cfg, device="cpu")
        given, marks = 0, {}
        for ev in events:
            n = lo.sweep_id
            feed_events(lo, [ev])
            given += 1
            if lo.sweep_id == n:
                continue
            k = lo.sweep_id - 1  # the sweep that just ran
            marks[lo.sweep_id] = given
            checkpoint.save(os.path.join(ckpt_dir, f"after{lo.sweep_id}.npz"), lo)
            old = os.path.join(ckpt_dir, f"after{k}.npz")
            if os.path.exists(old) and lo.stats[k]["iterations"] < cfg.inner_iter_num_max:
                os.remove(old)
            if lo.sweep_id % 20 == 0:
                print(f"lm-cap: port sweep {lo.sweep_id}, {time.perf_counter() - t0:.0f} s",
                      flush=True)
        iters = [s["iterations"] for s in lo.stats]
        todo = capped = [i for i, n in enumerate(iters) if n >= cfg.inner_iter_num_max]
        result.update(port_iterations=iters, port_capped=capped)
        print(f"lm-cap: port run {len(iters)} sweeps, capped {capped}; tracing {todo}", flush=True)
    # sweep k (0-based) runs after the checkpoint "after{k}" (k sweeps done)
    real_loop = solver.lm_loop_eager
    real_while = jax.lax.while_loop
    for k in todo:
        path = os.path.join(ckpt_dir, f"after{k}.npz")
        rest = events[marks[k]:]
        traces = {}
        _JAX_ROWS.clear()
        jax.lax.while_loop = _jax_lm_tap()
        try:
            jlo = jax_checkpoint.load(path)
            n = jlo.sweep_id
            for ev in rest:
                (jlo.add_imu if ev[0] == "imu" else jlo.add_scan)(*ev[1:])
                if jlo.sweep_id > n:
                    break
            jax.effects_barrier()
        finally:
            jax.lax.while_loop = real_while
        traces["jax"] = sorted(_JAX_ROWS, key=lambda r: r["k"])
        # the port from the same file: its run's config, and (where that
        # searches by bins) with the exact search the JAX package's CPU run takes
        variants = {"port": cfg}
        if cfg.match_knn_approx:
            variants["port_exact"] = cfg.replace(match_knn_approx=False)
        stats = {"jax": jlo.stats[-1]}
        for name, vcfg in variants.items():
            rows = []
            solver.lm_loop_eager = _port_lm_tap(rows)
            try:
                plo = checkpoint.load(path, device="cpu")
                plo.cfg = vcfg
                feed_events(plo, rest, until_sweep=k + 1)
                stats[name] = plo.stats[-1]
            finally:
                solver.lm_loop_eager = real_loop
            traces[name] = rows
        for name, rows in traces.items():
            bad = _disagreements(rows)
            if bad:
                raise RuntimeError(f"sweep {k}: the {name} tap is not what lm_step did at "
                                   f"iterations {bad}")
        entry = dict(port_run_iterations=iters[k] if iters else None, trace=traces)
        for name, rows in traces.items():
            st = stats[name]
            entry[name] = dict(
                _summary(rows, cfg.inner_iter_num_max), packed_iterations=int(st["iterations"]),
                initial_cost=float(st["initial_cost"]),
                counts=[int(st[n]) for n in ("n_new_surfels", "n_pairs_sld", "n_pairs_fix")],
                first_accept_difference_to_jax=next(
                    (i for i, (a, b) in enumerate(zip(traces["jax"], rows))
                     if a["accept"] != b["accept"]), None))
        result["sweeps"][str(k)] = entry
        print(f"lm-cap: sweep {k} (port run: {entry['port_run_iterations']} iterations)",
              flush=True)
        for name in traces:
            print(f"  {name}: {entry[name]}", flush=True)
        names = list(traces)
        for i in range(max(len(r) for r in traces.values())):
            cells = []
            for name in names:
                r = traces[name][i] if i < len(traces[name]) else None
                cells.append("{:>10}".format("") if r is None else (
                    "{} cost {:.9g} new {:.9g} pred {:.4g} rho {:.4g} lam {:.3g} acc {:.0f}".format(
                        name, r["cost"], r["new_cost"], r["pred"], r["rho"], r["lam"],
                        r["accept"])))
            print(f"  k {i:3d}  " + " | ".join(cells), flush=True)
    result["seconds"] = round(time.perf_counter() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    name = "lm_cap_resumed.npz" if resume_from else "lm_cap.npz"
    np.savez_compressed(os.path.join(out_dir, name), result=json.dumps(result))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help=f"records to write (default all: {sorted(RECORDS)})")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--lm-cap", action="store_true")
    ap.add_argument("--checkpoints", default=None,
                    help="with --lm-cap: where the port's per-sweep checkpoints go")
    ap.add_argument("--resume-from", default=None,
                    help="with --lm-cap: trace from these checkpoints (after{k}.npz and "
                         "marks.json, e.g. probe_spline_fit --checkpoints) instead of a CPU run")
    args = ap.parse_args(argv)
    if args.lm_cap:
        return lm_cap(args.out, args.checkpoints, args.resume_from)
    names = args.names or sorted(RECORDS)
    if len(names) == 1:
        record(names[0], args.out)
        return 0
    # one process a record: x64 is set once, before JAX computes anything
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), n, "--out", args.out])
             for n in names]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
