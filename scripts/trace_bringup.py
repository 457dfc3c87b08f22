"""Device-time breakdown of the two bring-up workloads on one GPU.

    python scripts/trace_bringup.py [--out results/trace_bringup.json]
                                    [--command-buffers]

Traces, with jax.profiler, the workloads that chip_smoke.py checks:
  sweep       its 256^3 x 16-source full-radius sweep pass (f32, type-1
              LLS, one batch of 16), 3 passes after a compiling pass;
  production  its 512^3 timestep with 10^4 sources on adaptive windowed
              sweeps, after an identical untraced step that compiled every
              program,
and sums the device time of every kernel by the innermost named scope on
the op_name path the profiler attaches to it (ops/sweep.py, solver.py):
march (the shell scan, without its one-hot reflections), mirror (those
reflections), stage (centering and face staging),
deposition (rate pass, rolls back to the grid, batch sum), window_gather,
scatter_add, chemistry (the fused per-iteration tail); everything else is
"other".  Also reports the device busy time, the idle share of the window
and the host wall time of the window.

XLA's command buffers are off unless --command-buffers is given: inside a
command buffer every kernel carries the op name of the enclosing loop, so
the scan's kernels lose their scopes.  Kernel durations do not depend on
the setting; launch gaps, and with them the idle share, do, so read idle
shares from a --command-buffers run.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "results", "trace_bringup")
SCOPES = ("march", "mirror", "stage", "deposition", "window_gather",
          "scatter_add", "chemistry")

if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if "--command-buffers" not in sys.argv:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

_WRAPPED = re.compile(r"^(?:\w+\()+(\w+)\)+$")


def scope_of_op_name(op_name: str):
    """Innermost SCOPES entry on an op_name path, or None.  Transforms
    wrap a scope's path component, e.g. "vmap(march)"."""
    hit = None
    for part in op_name.split("/"):
        part = _WRAPPED.sub(r"\1", part)
        if part in SCOPES:
            hit = part
    return hit


def device_events(xspace_path: str):
    """(start_ns, duration_ns, op_name path, "module:hlo_op") of every
    kernel the trace shows on the first GPU; a trace without one is an
    error.  The path is the kernel's tf_op stat followed by its name
    stat, which carries the HLO instruction's op_name."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xspace_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU:0")]
    if not planes:
        raise RuntimeError(f"no GPU device plane in {xspace_path}")
    evs = []
    for plane in planes:
        for line in plane.lines:
            for e in line.events:
                st = {k: str(v) for k, v in e.stats}
                if "hlo_op" in st:
                    label = f"{st.get('hlo_module', '')}:{st['hlo_op']}"
                    path = f"{st.get('tf_op', '')}/{st.get('name', e.name)}"
                    evs.append((e.start_ns, e.duration_ns, path, label))
    return evs


def summarize(evs) -> dict:
    """Per-scope device time, busy time and idle share of the window
    spanned by the kernels `evs` (as device_events returns them)."""
    if not evs:
        raise RuntimeError("no device kernels in the trace")
    per = collections.Counter()
    count = collections.Counter()
    unscoped = collections.Counter()
    unscoped_n = collections.Counter()
    for start, dur, op_name, label in evs:
        sc = scope_of_op_name(op_name) or "other"
        per[sc] += dur
        count[sc] += 1
        if sc == "other":
            unscoped[f"{label} {op_name}"[:120]] += dur
            unscoped_n[f"{label} {op_name}"[:120]] += 1
    iv = sorted((s, s + d) for s, d, _, _ in evs)
    busy, cur_s, cur_e = 0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = iv[-1][1] - iv[0][0]
    return {
        "kernels": len(evs),
        "device_ms_by_scope": {k: v / 1e6 for k, v in per.most_common()},
        "kernels_by_scope": dict(count.most_common()),
        "kernel_sum_ms": sum(per.values()) / 1e6,
        "busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "top_other": {k: [v / 1e6, unscoped_n[k]]
                      for k, v in unscoped.most_common(8)},
    }


def traced(name: str, fn) -> dict:
    """Runs fn under jax.profiler and summarizes its device kernels."""
    import jax
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(d):
        fn()
    wall = time.perf_counter() - t0
    path = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                     recursive=True)[0]
    return dict(wall_ms=wall * 1e3, **summarize(device_events(path)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "results",
                                                  "trace_bringup.json"))
    ap.add_argument("--command-buffers", action="store_true",
                    help="keep XLA's command buffers (scopes inside them "
                         "read as the enclosing loop)")
    ap.add_argument("--sweep-mesh", type=int, default=256)
    ap.add_argument("--prod-mesh", type=int, default=512)
    ap.add_argument("--prod-sources", type=int, default=10_000)
    args = ap.parse_args(argv)

    import chip_smoke

    dev = chip_smoke.require_gpu()
    import jax

    from c2ray_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    result = {"device": dev, "nvidia_smi": chip_smoke.nvidia_smi(),
              "command_buffers": args.command_buffers}

    passes = 3
    sweep, sweep_args = chip_smoke.sweep_pass(
        chip_smoke.sweep_inputs(args.sweep_mesh))
    jax.block_until_ready(sweep(*sweep_args))

    def run_sweep():
        for _ in range(passes):
            out = sweep(*sweep_args)
        jax.block_until_ready(out)

    result["sweep"] = dict(passes=passes, **traced("sweep", run_sweep))
    print("sweep", json.dumps(result["sweep"], indent=1), flush=True)

    step = chip_smoke.production_step(args.prod_mesh, args.prod_sources)
    step()
    infos = []
    result["production"] = traced("production",
                                  lambda: infos.append(step()))
    result["production"].update(
        niter=infos[0].niter, converged=infos[0].converged,
        photon_cons=infos[0].photon_stats.get("photon_cons"))
    print("production", json.dumps(result["production"], indent=1),
          flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
