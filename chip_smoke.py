#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root; one CUDA card, nvcc

Phases, one JSON line each, then the result:

1. device  - torch and CUDA versions, the card's name and power limit.
2. build   - builds every kernel of the path from csrc/ (nvcc, sm_90a).
3. kernel  - the fused LPG head kernel against its plain PyTorch version at
             the three shapes of a 352x1216 forward, one ragged shape with
             B=2; rule rtol 2e-5, atol 2e-6*max|ref| on pixels with
             |denominator| >= 1e-3 (the excluded count is printed).  Times
             from CUDA events: device time per call (batches of 50 calls
             queued behind a sleep kernel) and the median single-call
             latency of 50 calls, host dispatch included.
4. slice   - create_model + bts_test.predict, DenseNet-161, bts_size 512,
             352x1216, batch 1, KITTI focal, seeded weights, float32 and
             bfloat16.  Counts 3 kernel launches per forward; outputs finite
             where the LPG denominators are non-zero; depth in (0, max_depth];
             the kernel path against use_pallas="never"; the f32 model against
             the same weights on the CPU at 64x96; median ms per forward and
             peak memory of both paths.
5. result  - {"kernels": [...]} (launches: the count of the main-path
             forwards; ms / plain_ms: device time of the three slice-shape
             calls, i.e. per forward; max_abs_err: over those shapes), the
             nvidia-smi line, and the contract line {"ok": true, ...} last.

Any failed check raises, so the script exits non-zero and prints no result.
Nothing falls back to the CPU or to the plain version.  It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SLICE_SHAPES = [(1, 44, 152, 8), (1, 88, 304, 4), (1, 176, 608, 2)]  # (B, h, w, k) at 352x1216
RAGGED_SHAPE = (2, 13, 37, 8)  # W = 296, not a multiple of 32
RTOL, ATOL_SCALE, DENOM_MIN = 2e-5, 2e-6, 1e-3
KERNEL_SOURCE = "bts_tpu_torch/csrc/lpg_fused.cu"
KERNEL_REPLACES = "bts_tpu/ops/lpg_pallas.py:376"  # _fused_fwd_kernel, via _fused_fwd_call :443
H, W, FOCAL, MAX_DEPTH = 352, 1216, 721.5377, 80.0
TIMED_FORWARDS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _events():
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


def call_median_ms(fn, runs: int = 50, warmup: int = 5) -> float:
    """Median over ``runs`` single calls, CUDA events around each, the card
    idle before each: the call's latency, host dispatch included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = _events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_median_ms(fn, host_ms: float, runs: int = 50, repeats: int = 7) -> float:
    """Device time per call: ``runs`` calls queued behind a sleep kernel that
    outlasts their enqueueing (``host_ms`` per call, twice over at up to
    2 GHz), so the card never waits for the host between them, timed by CUDA
    events; the median over ``repeats`` such batches."""
    sleep_cycles = int(2 * 2e6 * runs * host_ms)
    fn()
    times = []
    for _ in range(repeats):
        start, end = _events()
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def compare_lpg(out, ref, den) -> dict:
    """The kernel rule on pixels whose denominator is not near zero."""
    keep = den.abs() >= DENOM_MIN
    diff = (out - ref).abs()[keep]
    scale = ref[keep].abs().max().item()
    bound = RTOL * ref[keep].abs() + ATOL_SCALE * scale
    ok = bool(torch.isfinite(out[keep]).all()) and bool((diff <= bound).all())
    return {
        "max_abs_err": diff.max().item(),
        "max_rel_err": (diff / ref[keep].abs().clamp_min(1e-30)).max().item(),
        "excluded_pixels": int((~keep).sum()),
        "pixels": out.numel(),
        "within_rule": ok,
    }


def phase_kernel(card: str) -> dict:
    from bts_tpu_torch.ops.lpg_cuda import fused_denominator, lpg_fused, lpg_fused_plain

    rows, errs, ms, plain_ms = [], [], 0.0, 0.0
    for b, h, w, k in SLICE_SHAPES + [RAGGED_SHAPE]:
        rng = np.random.default_rng(1000 * k + h)
        nchw = torch.from_numpy(rng.standard_normal((b, 3, h, w), dtype=np.float32)).cuda()
        raw = nchw.permute(0, 2, 3, 1)  # the (B, h, w, 3) view the decoder passes
        out = lpg_fused(raw, k)
        ref = lpg_fused_plain(raw, k)
        torch.cuda.synchronize()
        row = {"shape": [b, h, w, 3], "k": k, "out": list(out.shape)}
        row.update(compare_lpg(out, ref, fused_denominator(raw, k)))
        check(row["within_rule"], f"kernel disagrees with plain at {row}")
        row["call_ms"] = call_median_ms(lambda: lpg_fused(raw, k))
        row["plain_call_ms"] = call_median_ms(lambda: lpg_fused_plain(raw, k))
        row["ms"] = device_median_ms(lambda: lpg_fused(raw, k), row["call_ms"])
        row["plain_ms"] = device_median_ms(lambda: lpg_fused_plain(raw, k), row["plain_call_ms"])
        row["card"] = card
        rows.append(row)
        if (b, h, w, k) in SLICE_SHAPES:
            errs.append(row["max_abs_err"])
            ms += row["ms"]
            plain_ms += row["plain_ms"]
    emit({"phase": "kernel", "rule": f"rtol {RTOL}, atol {ATOL_SCALE}*max|ref|, |den|>={DENOM_MIN}",
          "shapes": rows})
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def _forward(cfg, model, batch):
    from bts_tpu_torch.cli.bts_test import predict

    outs = next(predict(cfg, model, [batch], "cuda"))
    torch.cuda.synchronize()
    return outs


def phase_slice(card: str) -> int:
    from bts_tpu.config import Config
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.ops.lpg_cuda import fused_denominator, lpg_fused

    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8),
             "focal": np.array([FOCAL], np.float32)}
    cfgs = {dt: Config(mode="test", encoder="densenet161_bts", bts_size=512, max_depth=MAX_DEPTH,
                       dataset="kitti", input_height=H, input_width=W, compute_dtype=dt, seed=0)
            for dt in ("float32", "bfloat16")}
    models = {dt: create_model(cfg, "cuda") for dt, cfg in cfgs.items()}
    heads = {}  # raw reduction outputs of the last forward, for the denominators
    for model in models.values():
        for name in ("reduc8x8", "reduc4x4", "reduc2x2"):
            getattr(model.decoder, name).register_forward_hook(
                lambda mod, args, out, name=name: heads.__setitem__(name, out))

    # the main path: every count to 0, one forward per compute dtype
    lpg_fused.launches = 0
    outs = {}
    for dt in cfgs:
        before = lpg_fused.launches
        outs[dt] = (_forward(cfgs[dt], models[dt], batch), dict(heads))
        check(lpg_fused.launches - before == 3, f"{dt}: {lpg_fused.launches - before} launches, not 3")
    launches = lpg_fused.launches

    for dt, cfg in cfgs.items():
        model, (kernel_outs, raw_heads) = models[dt], outs[dt]
        rec = {"phase": "slice", "compute_dtype": dt, "card": card,
               "shapes": [list(o.shape) for o in kernel_outs]}
        check(all(tuple(o.shape) == (1, 1, H, W) for o in kernel_outs), f"{dt}: shapes {rec['shapes']}")
        # finite where the denominators are non-zero; depth in (0, max_depth]
        for i, (name, k) in enumerate((("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))):
            den = fused_denominator(raw_heads[name].permute(0, 2, 3, 1), k)
            check(bool(torch.isfinite(kernel_outs[i][:, 0][den != 0]).all()), f"{dt}: LPG {k} not finite")
        check(all(bool(torch.isfinite(o).all()) for o in kernel_outs[3:]), f"{dt}: non-finite depth")
        depth = kernel_outs[4] / (FOCAL / 715.0873)  # before the focal scaling
        rec["final_depth_min_max"] = [depth.min().item(), depth.max().item()]
        check(0 < rec["final_depth_min_max"][0] and rec["final_depth_min_max"][1] <= MAX_DEPTH,
              f"{dt}: depth range {rec['final_depth_min_max']}")

        # the same model through use_pallas="never"
        model.decoder.use_pallas = "never"
        count = lpg_fused.launches
        plain_outs = _forward(cfg, model, batch)
        check(lpg_fused.launches == count, "use_pallas='never' launched the kernel")
        model.decoder.use_pallas = cfg.use_pallas
        lpg_rows = []
        for i, (name, k) in enumerate((("reduc8x8", 8), ("reduc4x4", 4), ("reduc2x2", 2))):
            den = fused_denominator(raw_heads[name].permute(0, 2, 3, 1), k)
            row = compare_lpg(kernel_outs[i][:, 0], plain_outs[i][:, 0], den)
            check(row["within_rule"], f"{dt}: LPG {k} kernel vs never {row}")
            lpg_rows.append(dict(row, k=k))
        rec["lpg_kernel_vs_never"] = lpg_rows
        a, b = kernel_outs[4], plain_outs[4]
        # f32: 1e-5 relative.  bf16: the f32 LPG maps are cast to bf16 for
        # conv1, whose rounding step is 2^-8 relative, so a last-bit change in
        # a map can move a bf16 input by one step; 1e-2 bounds what follows.
        rtol = 1e-5 if dt == "float32" else 1e-2
        rec["final_vs_never"] = {"max_abs_err": (a - b).abs().max().item(),
                                 "max_rel_err": ((a - b).abs() / b.abs()).max().item(), "rtol": rtol}
        check(bool(torch.allclose(a, b, rtol=rtol, atol=0.0)), f"{dt}: final vs never {rec['final_vs_never']}")

        if dt == "float32":  # the same weights on the CPU, at a small input
            small = {"image": batch["image"][:, :64, :96], "focal": batch["focal"]}
            gpu_small = _forward(cfg, model, small)
            from bts_tpu_torch.cli.bts_test import predict

            cpu_small = next(predict(cfg, model.to("cpu"), [small], "cpu"))
            model.to("cuda")
            worst = 0.0
            for g, c in zip(gpu_small, cpu_small):
                g = g.cpu()
                scale = c.abs().max().item()
                check(bool(torch.allclose(g, c, rtol=2e-4, atol=2e-4 * scale)), "f32 GPU vs CPU at 64x96")
                worst = max(worst, (g - c).abs().max().item() / scale)
            rec["gpu_vs_cpu_64x96_max_err_over_scale"] = worst

        # both paths in turns (kernel, never, never, kernel, ...), so drift
        # in the host's or the card's speed falls on both alike
        setting = {"kernel": cfg.use_pallas, "never": "never"}
        times = {"kernel": [], "never": []}
        for path in setting:
            model.decoder.use_pallas = setting[path]
            for _ in range(3):
                _forward(cfg, model, batch)
            torch.cuda.reset_peak_memory_stats()
            _forward(cfg, model, batch)
            rec[f"{path}_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        count = lpg_fused.launches
        for i in range(TIMED_FORWARDS):
            for path in ("kernel", "never") if i % 2 == 0 else ("never", "kernel"):
                model.decoder.use_pallas = setting[path]
                t0 = time.perf_counter()
                _forward(cfg, model, batch)
                times[path].append((time.perf_counter() - t0) * 1e3)
        model.decoder.use_pallas = cfg.use_pallas
        n = lpg_fused.launches - count
        check(n == 3 * TIMED_FORWARDS, f"{n} launches in {TIMED_FORWARDS} kernel-path forwards")
        for path, t in times.items():
            q = statistics.quantiles(t, n=4)
            rec[f"{path}_ms_per_forward"] = {"median": statistics.median(t), "q1": q[0], "q3": q[2],
                                             "n": len(t)}
        emit(rec)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from bts_tpu_torch.ops import _build, lpg_cuda  # fails outside a checkout of the repo

    card = card_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "card": card})
    built = _build.build("lpg_fused")
    lpg_cuda._lib()
    emit({"phase": "build", "kernel": "lpg_fused", "seconds": built.seconds,
          "ptxas": [l for l in built.log.splitlines() if "registers" in l or "spill" in l]})

    kernel = phase_kernel(card)
    launches = phase_slice(card)
    check(launches > 0, "the main path launched no lpg_fused kernel")
    emit({"kernels": [{"name": "lpg_fused", "route": "cuda", "source": KERNEL_SOURCE,
                       "replaces": KERNEL_REPLACES, "launches": launches,
                       "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
                       "plain_ms": kernel["plain_ms"]}]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
