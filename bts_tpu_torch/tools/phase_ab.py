"""Run ``chip_smoke.py``'s kernel phases of two checkouts in turns within one
run on one CUDA card, so that their kernels' device times compare.

    git archive <commit> | tar -x -C build/parent     # a gitignored directory
    python -m bts_tpu_torch.tools.phase_ab build/parent   # from the repo root

Tree A is the checkout given, tree B this one; each of ``--rounds``
rounds runs A, B, B, A.  Each run is one
process started in its tree's root: it imports that tree's ``chip_smoke``
and ``bts_tpu_torch``, builds its CUDA sources (into its own
``build/torch_kernels/``) and runs the phases named (default: kernel,
kernel_bwd, kernel_lpg, tail, kernel_nyu), passing each the arguments its
own signature asks for.  Output: every phase line of every run, tagged
with its tree and run, then one summary line per kernel row: the row's
``ms`` (through the wrapper) and ``kernel_only_ms`` (launched directly,
where the tree's phase measures it) in each run, and their medians per
tree; then the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = """
import inspect, json
from concurrent.futures import ThreadPoolExecutor
import chip_smoke as cs
from bts_tpu_torch.ops import _build, lpg_cuda, tail_cuda
card = cs.card_line()
jobs = [(name, ()) for name in cs.SOURCES] + [("fused_tail", ("K6_STAGE_CLOCKS",))]
with ThreadPoolExecutor(len(jobs)) as pool:
    libs = list(pool.map(lambda job: _build.build(*job), jobs))
lpg_cuda._lib(), tail_cuda._lib()
given = {"card": card, "clocks_lib": libs[2].path}
if hasattr(cs, "phase_floor"):
    given["floors"] = cs.phase_floor(card)
for name in PHASES:
    fn = getattr(cs, "phase_" + name)
    fn(**{p: given[p] for p in inspect.signature(fn).parameters})
"""
TOTALS = ("per_training_step", "per_config3_step", "per_op", "per_forward")


def run_tree(root: Path, phases: list) -> list:
    """One run of ``phases`` in the checkout at ``root``; its phase lines."""
    proc = subprocess.run([sys.executable, "-c", f"PHASES = {phases!r}\n{RUN}"], cwd=root,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"phases failed in {root} (exit {proc.returncode}):\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"phase"')]


def rows_of(lines: list) -> dict:
    """{row key: {"ms": ..., "kernel_only_ms": ...}} of a run's phase lines:
    each kernel row by phase, kernel, shape and dtype, and each phase's
    per-step, per-op and per-forward sums."""
    out = {}
    for line in lines:
        for row in line.get("shapes", []):
            dtype = row.get("raw_dtype") or row.get("plane_dtype") or "float32"
            key = " ".join(map(str, (line["phase"], row.get("kernel", "K1"), row["shape"], row.get("k", ""),
                                     dtype, row.get("path", ""))))
            out[key] = {m: row[m] for m in ("ms", "kernel_only_ms") if m in row}
        for total in TOTALS:
            for kernel, t in line.get(total, {}).items():
                for dtype, sums in (t.items() if "ms" not in t else [("", t)]):
                    if isinstance(sums, dict) and "ms" in sums:
                        key = f"{line['phase']} {total} {kernel} {dtype}".strip()
                        out[key] = {m: sums[m] for m in ("ms", "kernel_only_ms") if m in sums}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", type=Path, help="root of the other checkout (tree A)")
    parser.add_argument("--phases", default="kernel,kernel_bwd,kernel_lpg,tail,kernel_nyu")
    parser.add_argument("--rounds", type=int, default=1, help="ABBA rounds (each runs each tree twice)")
    args = parser.parse_args()
    trees = {"A": args.other.resolve(), "B": Path(__file__).resolve().parents[2]}
    phases = args.phases.split(",")
    runs = []
    for _ in range(args.rounds):
        for tree in ("A", "B", "B", "A"):
            lines = run_tree(trees[tree], phases)
            for line in lines:
                print(json.dumps({"tree": tree, "run": len(runs), **line}), flush=True)
            runs.append((tree, rows_of(lines)))
    keys = dict.fromkeys(k for _, rows in runs for k in rows)
    for key in keys:
        summary = {"row": key}
        for metric in ("ms", "kernel_only_ms"):
            for tree in trees:
                got = [rows[key][metric] for t, rows in runs if t == tree and metric in rows.get(key, {})]
                if got:
                    summary[f"{tree}_{metric}"] = got
                    summary[f"{tree}_{metric}_median"] = statistics.median(got)
        print(json.dumps({"summary": summary, "trees": {t: str(p) for t, p in trees.items()}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
