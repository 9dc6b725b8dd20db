"""The readings that a cell's limits are set from, at the cell's own size,
on the card, in one process:

    python3 portbench/control.py --workload <name> --first-seed <n> \\
        [--seeds 12] [--control-seeds 3] [--fault-seeds 3] [--seconds 3] [--out FILE]

- ``program``: sound runs of the program, one per seed (set-up, a short
  window at the cell's load, the check): the lower readings;
- ``control``: the plain reference with every conv operand in fp8
  (``reference/quant.py``) in the program's place, against the float32
  reference, on the same frames or steps: the upper readings;
- ``fault:*``: runs with the timed path broken (``faults.py``; by
  default the driver's ``READ_FAULTS``), read the same way;
- with ``--compute-dtype float32``, the program's readings in another
  precision than the configuration's, as a witness (the control then
  compares fp8 against the same float32 reference).

Each reading is one JSON line (to ``--out`` too).  The benchmark's own runs
do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def program_reading(workload: str, seed: int, seconds: float, device: str) -> dict:
    from portbench.harness import cell

    drv, _ = cell.driver(workload, seed, device)
    drv.setup()
    drv.window(seconds)
    drv.free()
    return drv.check()


def control_reading(workload: str, seed: int, device: str) -> dict:
    from portbench.harness import cell

    drv, bench = cell.driver(workload, seed, device)
    return bench.driver(workload).control(drv)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", default=None, help="comma-separated, of the driver's faults (default: its READ_FAULTS)")
    p.add_argument("--compute-dtype", default="",
                   help="run the program in this compute dtype instead of the configuration's (a witness)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from portbench import faults
    from portbench.harness import manifest

    if args.compute_dtype:
        config = manifest.Manifest.config

        def witness(self, name):
            c = config(self, name)
            c["model"]["compute_dtype"] = args.compute_dtype
            return c

        manifest.Manifest.config = witness

    bench = manifest.Manifest()
    if args.device == "cuda":
        from portbench.harness import program

        program.build_kernels()
    out = open(args.out, "a") if args.out else None

    def emit(what: str, seed: int, numbers: dict, t: float) -> None:
        line = json.dumps({"workload": args.workload, "what": what, "seed": seed, **numbers,
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seed = args.first_seed
    for _ in range(args.seeds):
        t = time.perf_counter()
        emit("program", seed, program_reading(args.workload, seed, args.seconds, args.device), t)
        seed += 1
    for _ in range(args.control_seeds):
        t = time.perf_counter()
        emit("control", seed, control_reading(args.workload, seed, args.device), t)
        seed += 1
    module, traffic = bench.driver(args.workload), bench.traffic(bench.workload(args.workload)["traffic"])
    names = module.READ_FAULTS if args.faults is None else [n for n in args.faults.split(",") if n]
    for name in names:
        for _ in range(args.fault_seeds):
            t = time.perf_counter()
            with faults.planted(module, name, traffic):
                numbers = program_reading(args.workload, seed, args.seconds, args.device)
            emit(f"fault:{name}", seed, numbers, t)
            seed += 1
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
