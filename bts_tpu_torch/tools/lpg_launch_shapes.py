"""Compare launch shapes of the LPG kernels (``csrc/lpg_fused.cu``) within
one run on one CUDA card: K1 and K2, the fused LPG head's forward and
backward, at the config-4 training heads; K1, K3 (the public op's forward)
and K5 (the head as phase planes) at the b1 serving heads, and K5 at the
b4 export heads.

    python -m bts_tpu_torch.tools.lpg_launch_shapes   # from the repo root

Each variant is the same source with one launch setting changed: the
warps per block (``kWarps``, the unsplit K1-K4 block size), K2 with a
register cap (``__launch_bounds__`` asking for 4 blocks of 256 threads per
SM: at most 64 registers), the split of K1's and K3's rows at k = 8 on
small grids (none, or 2 or 8 warps per cell row in place of 4), the warps
per block of a split launch, and K5's warps per block.  All variants are
built at once (one nvcc each) into ``build/torch_kernels/variants/``.  Then
the kernels are launched directly, the variants in turns over several
rounds: K1 and K2 on the three head shapes of the config-4 training step
(b16, 352x704, bf16 raw, as the training path calls them); K1 (f32 raw),
K3 (f32 plane) and K5 (f32 and bf16 raw) on the three b1 352x1216 serving
heads; K5 (f32 raw) on the three b4 export heads.  The median device time
per head is printed with each variant's launch at each head (warps per
cell row, warps per block, blocks) and its ptxas registers and spills.
Each variant's K1, K3 and K5 must equal the built source's bit for bit and
its K2 must agree within one bf16 step.  Output: one JSON line per
variant, then the card's name and power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from bts_tpu_torch.ops import _build

HEADS = [(16, 44, 88, 8), (16, 88, 176, 4), (16, 176, 352, 2)]  # (B, h, w, k), config 4
SERVING = [(1, 44, 152, 8), (1, 88, 304, 4), (1, 176, 608, 2)]  # b1 at 352x1216
EXPORT = [(4, 44, 152, 8), (4, 88, 304, 4), (4, 176, 608, 2)]  # the exported b4 serving heads
VARIANTS = {  # name: (text in csrc/lpg_fused.cu, its replacement), each found once
    "as_built": [],
    "bwd_regs_capped_64": [("__launch_bounds__(kWarps * 32)\nlpg_bwd_kernel",
                            "__launch_bounds__(kWarps * 32, 4)\nlpg_bwd_kernel")],
    "warps_4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "warps_16": [("constexpr int kWarps = 8;", "constexpr int kWarps = 16;")],
    "no_split": [("constexpr int kSplitBelow = 7;", "constexpr int kSplitBelow = 0;")],
    "split_rows_2": [("constexpr int kSplitRows = 4;", "constexpr int kSplitRows = 2;")],
    "split_rows_8": [("constexpr int kSplitRows = 4;", "constexpr int kSplitRows = 8;")],
    "split_warps_8": [("constexpr int kSplitWarps = 4;", "constexpr int kSplitWarps = 8;")],
    "k5_warps_8": [("constexpr int kK5Warps = 4;", "constexpr int kK5Warps = 8;")],
}
ROUNDS, RUNS, REPEATS = 5, 50, 3
F32, BF16 = 0, 1  # the kernels' dtype codes


def variant_source(changes: list) -> str:
    """csrc/lpg_fused.cu with each (text, replacement) of ``changes`` made."""
    src = (_build.CSRC / "lpg_fused.cu").read_text()
    for old, new in changes:
        if src.count(old) != 1:
            raise RuntimeError(f"lpg_fused.cu: expected one {old!r}")
        src = src.replace(old, new)
    return src


def build_variant(name: str) -> tuple:
    """Compile one variant; returns (ctypes library, ptxas log)."""
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / f"lpg_fused-{name}.cu", out / f"liblpg_fused-{name}.so"
    src.write_text(variant_source(VARIANTS[name]))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    for entry in ("lpg_fused_forward", "lpg_forward", "lpg_phase_forward"):
        getattr(cdll, entry).argtypes = [vp, i32, i64, i64, i64, i64, vp, i32, i32, i32, i32, vp]
    cdll.lpg_fused_backward.argtypes = [vp, i32, i64, i64, i64, i64, vp, i64, i64, i64, vp,
                                        i32, i32, i32, i32, vp]
    cdll.lpg_forward_launch.argtypes = [i32, i32, i32, i32, i32, vp]
    return cdll, proc.stdout + proc.stderr


def registers(log: str) -> dict:
    """ptxas registers and spill-store bytes of the training path's
    instances: K1 on bf16 raw and K2 on bf16 raw with vector loads of g."""
    filt = Path(_build.find_nvcc()).parent / "cu++filt"
    report, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = None
            if "lpg_fwd_kernel" in mangled or "lpg_bwd_kernel" in mangled:
                # e.g. void <unnamed>::lpg_fwd_kernel<(bool)1, (int)8, __nv_bfloat16>(const T3 *, ...)
                demangled = subprocess.run([str(filt), mangled], capture_output=True, text=True,
                                           check=True).stdout
                name = re.search(r"lpg_\w+_kernel<[^>]*>", demangled)[0]
                on_path = name.startswith("lpg_fwd_kernel<(bool)1,") or "(bool)0, (bool)1," in name
                if "__nv_bfloat16" not in name or not on_path:
                    name = None
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            report.setdefault(name, {})["spill_store_bytes"] = int(m[1])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report.setdefault(name, {})["registers"] = int(m[1])
    return report


def device_ms(launch) -> float:
    """Device time per launch: RUNS launches queued behind a sleep kernel
    that outlasts their enqueueing, timed by CUDA events; the median of
    REPEATS such batches."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RUNS):
        launch()
    torch.cuda.synchronize()
    sleep_cycles = int(2 * 2e9 * (time.perf_counter() - t0))  # twice the enqueue time at 2 GHz
    times = []
    for _ in range(REPEATS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(RUNS):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / RUNS)
    return statistics.median(times)


def head_inputs(b, h, w, k):
    rng = np.random.default_rng(1000 * k + h)
    nchw = torch.from_numpy(rng.standard_normal((b, 3, h, w), dtype=np.float32)).cuda()
    raw = nchw.to(torch.bfloat16).permute(0, 2, 3, 1)  # the (B, h, w, 3) view the decoder passes
    g = torch.from_numpy(np.random.default_rng(k).standard_normal((b, h * k, w * k), dtype=np.float32)).cuda()
    return raw, g


def launch_of(lib, kernel: int, b, h, w, k) -> list:
    """[warps per cell row, warps per block, blocks] of a forward launch
    (kernel 0: K1 and K3, 1: K5) in this variant."""
    shape = (ctypes.c_int * 4)()
    if lib.lpg_forward_launch(kernel, b, h, w, k, shape):
        raise RuntimeError("lpg_forward_launch failed")
    return list(shape)[:3]


def forward(lib, entry, x, dtype, k, out_shape):
    """Forward ``entry`` (K1, K3 or K5) launched directly on x; returns the
    launch function and its output buffer."""
    b, h, w, _ = x.shape
    out = torch.empty(out_shape, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn = getattr(lib, entry)

    def launch():
        if fn(x.data_ptr(), dtype, *x.stride(), out.data_ptr(), b, h, w, k, stream):
            raise RuntimeError(f"{entry} launch failed")

    return launch, out


def serving_inputs(b, h, w, k):
    """f32 and bf16 raw (the decoder's NCHW view) and the f32 plane of its
    transform, at one serving head."""
    rng = np.random.default_rng(1000 * k + h)
    nchw = torch.from_numpy(rng.standard_normal((b, 3, h, w), dtype=np.float32)).cuda()
    raw = nchw.permute(0, 2, 3, 1)
    t, p = torch.sigmoid(raw[..., 0]) * (np.pi / 3), torch.sigmoid(raw[..., 1]) * (2 * np.pi)
    plane = torch.stack([torch.sin(t) * torch.cos(p), torch.sin(t) * torch.sin(p), torch.cos(t),
                         torch.sigmoid(raw[..., 2])], dim=-1)
    return raw, raw.to(torch.bfloat16), plane


def serving_calls(lib, shapes, kinds):
    """Per head, {name: (launch, out)} of the forward kinds named."""
    calls = []
    for b, h, w, k in shapes:
        raw, raw16, plane = serving_inputs(b, h, w, k)
        full, phase = (b, h * k, w * k), (b, 4, h * k // 2, w * k // 2)
        made = {"K1": ("lpg_fused_forward", raw, F32, full), "K3": ("lpg_forward", plane, F32, full),
                "K5": ("lpg_phase_forward", raw, F32, phase), "K5_bf16": ("lpg_phase_forward", raw16, BF16, phase)}
        calls.append({name: forward(lib, *made[name][:3], k, made[name][3]) for name in kinds})
    return calls


def launches(lib, raw, g, k):
    """K1 and K2 launched directly on (raw, g); returns the two launch
    functions and their output buffers."""
    b, h, w, _ = raw.shape
    out = torch.empty((b, h * k, w * k), device="cuda")
    draw = torch.empty((b, 3, h, w), dtype=raw.dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def k1():
        if lib.lpg_fused_forward(raw.data_ptr(), BF16, *raw.stride(), out.data_ptr(), b, h, w, k, stream):
            raise RuntimeError("K1 launch failed")

    def k2():
        if lib.lpg_fused_backward(raw.data_ptr(), BF16, *raw.stride(), g.data_ptr(), *g.stride(),
                                  draw.data_ptr(), b, h, w, k, stream):
            raise RuntimeError("K2 launch failed")

    return k1, k2, out, draw


def main() -> int:
    if not torch.cuda.is_available():
        print("lpg_launch_shapes: no CUDA device", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS)))
    heads = [head_inputs(*shape) for shape in HEADS]
    calls = {name: [launches(lib, raw, g, shape[3]) for shape, (raw, g) in zip(HEADS, heads)]
             for name, (lib, _) in built.items()}
    serve = {name: serving_calls(lib, SERVING, ("K1", "K3", "K5", "K5_bf16")) for name, (lib, _) in built.items()}
    export = {name: serving_calls(lib, EXPORT, ("K5",)) for name, (lib, _) in built.items()}
    for name, per_head in calls.items():  # same function: K1 bit for bit, K2 within one bf16 step
        for (k1, k2, out, draw), ref in zip(per_head, calls["as_built"]):
            k1(), k2(), ref[0](), ref[1]()
            torch.cuda.synchronize()
            if not torch.equal(out, ref[2]):
                raise RuntimeError(f"{name}: K1 differs from the built source's")
            if not torch.allclose(draw.float(), ref[3].float(), rtol=2**-7, atol=0):
                raise RuntimeError(f"{name}: K2 differs from the built source's")
        for mine, ref in zip(serve[name] + export[name], serve["as_built"] + export["as_built"]):
            for kind, (launch, out) in mine.items():  # K1, K3 and K5 bit for bit
                launch(), ref[kind][0]()
                torch.cuda.synchronize()
                if not torch.equal(out, ref[kind][1]):
                    raise RuntimeError(f"{name}: {kind} differs from the built source's")
    times = {name: [{"K1": [], "K2": []} for _ in HEADS] for name in VARIANTS}
    serve_times = {name: [{kind: [] for kind in head} for head in serve[name]] for name in VARIANTS}
    export_times = {name: [{kind: [] for kind in head} for head in export[name]] for name in VARIANTS}
    for _ in range(ROUNDS):
        for name, per_head in calls.items():
            for t, (k1, k2, _, _) in zip(times[name], per_head):
                t["K1"].append(device_ms(k1))
                t["K2"].append(device_ms(k2))
            for per, got in ((serve_times, serve), (export_times, export)):
                for t, head in zip(per[name], got[name]):
                    for kind, (launch, _) in head.items():
                        t[kind].append(device_ms(launch))

    def medians(lib, shapes, per_head, kernel_of):
        rows = [{"shape": list(shape), **{kind: statistics.median(v) for kind, v in t.items()},
                 "launch": {kind: launch_of(lib, kernel_of(kind), *shape) for kind in t}}
                for shape, t in zip(shapes, per_head)]
        return rows, {kind: sum(r[kind] for r in rows) for kind in per_head[0]}

    for name, (lib, log) in built.items():
        rows = [{"k": shape[3], **{key: statistics.median(v) for key, v in t.items()}}
                for shape, t in zip(HEADS, times[name])]
        serving, per_forward = medians(lib, SERVING, serve_times[name], lambda kind: int(kind.startswith("K5")))
        exported, per_export = medians(lib, EXPORT, export_times[name], lambda kind: 1)
        print(json.dumps({"variant": name, "changes": VARIANTS[name], "heads_ms": rows,
                          "per_step_ms": {key: sum(r[key] for r in rows) for key in ("K1", "K2")},
                          "serving_heads_ms": serving, "per_b1_forward_ms": per_forward,
                          "export_heads_ms": exported, "per_b4_forward_ms": per_export,
                          "rounds": ROUNDS, "ptxas": registers(log)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
