#!/usr/bin/env python3
"""Where the time of the port's fixed-topology fit goes, on one GPU.

    python3 tools/profile_torch_fit.py [nt] [aa]    # from the repo root

For each problem (chip_smoke.py's bench problems from the same seed:
128 taxa x 4096 sites under GTR+G4 or LG+G4) the CLI fit that
chip_smoke.py drives runs four times in this process:

1. the first run (CUDA context set-up and the kernel library's load;
   the kernels are built before it, and the build is timed apart);
2. a second, warm run: the fit wall-clock;
3. a run under torch.profiler: device busy time (the sum of kernel and
   copy time on the card), the idle share of the profiled wall-clock
   and of the warm one, and device time by owner: the port's kernels
   (K1..K5), PyTorch's own kernels, copies;
4. a run under cProfile: host time in the port's main functions.

It prints a summary per problem and one JSON line with its numbers.
Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import contextlib
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the bench problems and the CLI flags)

# mangled-name fragment of each port kernel (csrc/*.cu)
KERNELS = [("slot_site_lse_stream_kernel", "K4"),
           ("slot_site_lse_kernel", "K1"),
           ("batched_uppass_kernel", "K3"),
           ("edge_dotprods_stream_kernel", "K5"),
           ("edge_dotprods_kernel", "K2")]
# host functions whose cumulative time the cProfile run reports
HOST = ["round_optimize", "optimize_branch_lengths", "optimize_scalars",
        "edge_lnl_terms", "edge_dotprods_sys", "_loglik_sys", "_system",
        "_pmats", "read_alignment", "format_stats", "parsimony_score"]


def owner(name: str) -> str:
    for frag, k in KERNELS:
        if frag in name:
            return k
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    return "torch"


def run_cli(argv):
    import torch
    from phyml_tpu_torch import cli

    torch.cuda.synchronize()
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        sys.exit(f"profile_torch_fit: the fit returned {rc}")
    return time.time() - t


def device_times(prof):
    """(kernel or copy name -> (ms, count)) from the profiler's device
    rows only, so host-side rows are not counted twice."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        rows[e.key] = (e.self_device_time_total / 1e3, e.count)
    return rows


def profile_problem(dt, tmp):
    import torch
    from torch.profiler import ProfilerActivity, profile

    aln, tree = chip_smoke.write_problem(os.path.join(tmp, dt), dt,
                                         chip_smoke.N_TAXA,
                                         chip_smoke.N_SITES,
                                         chip_smoke.SEED)
    argv = chip_smoke.cli_argv(dt, aln, tree, "gpu") + ["--quiet"]
    first = run_cli(argv)
    warm = run_cli(argv)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = run_cli(argv)
    rows = device_times(prof)
    if not rows:
        sys.exit("profile_torch_fit: the profiler recorded no device time")
    by_owner: dict[str, float] = {}
    counts: dict[str, int] = {}
    for name, (ms, n) in rows.items():
        o = owner(name)
        by_owner[o] = by_owner.get(o, 0.0) + ms
        counts[o] = counts.get(o, 0) + n
    busy = sum(by_owner.values())
    top_torch = sorted(((ms, n, name) for name, (ms, n) in rows.items()
                        if owner(name) == "torch"), reverse=True)[:8]

    host = cProfile.Profile()
    host.enable()
    host_wall = run_cli(argv)
    host.disable()
    stats = pstats.Stats(host)
    host_s = {}
    for (path, _, fn), (_, _, _, cum, _) in stats.stats.items():
        if "phyml_tpu_torch" in path and fn in HOST:
            host_s[fn] = max(host_s.get(fn, 0.0), cum)

    print(f". [{dt}] fit wall-clock: first run {first:.3f} s, warm "
          f"{warm:.3f} s, under the profiler {profiled:.3f} s, under "
          f"cProfile {host_wall:.3f} s")
    print(f". [{dt}] device busy {busy:.1f} ms: idle share "
          f"{1 - busy / 1e3 / profiled:.3f} of the profiled run, "
          f"{1 - busy / 1e3 / warm:.3f} of the warm run")
    for o, ms in sorted(by_owner.items(), key=lambda kv: -kv[1]):
        print(f"    {o:7s} {ms:10.1f} ms  {100 * ms / busy:5.1f} %  "
              f"{counts[o]} launches")
    print(f". [{dt}] PyTorch's largest kernels:")
    for ms, n, name in top_torch:
        print(f"    {ms:9.1f} ms  x{n:<6d} {name[:90]}")
    print(f". [{dt}] host (cProfile, cumulative s):")
    for fn in HOST:
        if fn in host_s:
            print(f"    {fn:24s} {host_s[fn]:.3f}")
    return dict(problem=dt, first_s=first, warm_s=warm,
                profiled_s=profiled, busy_ms=busy,
                idle_profiled=1 - busy / 1e3 / profiled,
                idle_warm=1 - busy / 1e3 / warm,
                device_ms=by_owner, launches=counts, host_s=host_s)


def main() -> int:
    import torch
    from phyml_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        sys.exit("profile_torch_fit: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f". card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.library()
    print(f". kernel library built and loaded in {time.time() - t0:.1f} s")
    problems = sys.argv[1:] or ["nt", "aa"]
    with tempfile.TemporaryDirectory() as tmp:
        for dt in problems:
            out = profile_problem(dt, tmp)
            out["card"] = smi
            print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
