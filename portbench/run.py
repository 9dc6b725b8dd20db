"""Run one cell of the benchmark of ``bts_tpu_torch`` once, on the card:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the port's kernels built or found in ``build/torch_kernels/``,
seeded weights and inputs, the cell's shapes warmed up), then the window of
``--seconds``, then with ``--trace 1`` a short traced window, then the
check of what the window produced against the plain reference.  The last
line of standard output is the result as one JSON object; the compared
numbers and their limits are also the last lines of standard error.
Everything the cell is made of is found by name from ``BENCHMARK.json``
(``harness/manifest.py``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench_cache"  # kernel caches of anything that compiles, inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be >= 0")

    from portbench.harness import cell, device, manifest

    bench = manifest.Manifest(ROOT)
    device.require(bench.workload(args.workload)["chips"])
    out, notes = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0, bench)
    found = device.forbidden_loaded()
    if found:
        print(f"portbench: modules that must not load were loaded: {found}", file=sys.stderr)
        return 4
    notes["power_limit_w"] = device.power_limit_w()
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
