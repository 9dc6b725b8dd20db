"""The counts behind the mfu and roofline shares, against hand-worked
values."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import flops, lpg, peaks


def test_one_conv_counts_two_flops_per_multiply_add():
    # a 3x3 conv, 8 -> 16 channels, on a 1 x 8 x 10 x 12 input with padding 1:
    # 16 * 10 * 12 outputs, each 8 * 3 * 3 multiply-adds, 2 FLOP each
    x, w = torch.empty(1, 8, 10, 12, device="meta"), torch.empty(16, 8, 3, 3, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        F.conv2d(x, w, padding=1)
    assert counter.get_total_flops() == 2 * 16 * 10 * 12 * 8 * 9 == 276480


def test_model_flops_scale_with_pixels_and_steps():
    m = {"encoder": "densenet161_bts", "bts_size": 512, "max_depth": 80.0}
    one = flops.per_image(m, "serve", 64, 96)
    assert flops.per_image(m, "train", 64, 96) == 3 * one
    # every conv's work is per pixel (stride and padding aside): 4x the pixels ~ 4x the work
    assert 3.9 < flops.per_image(m, "serve", 128, 192) / one < 4.1


def test_the_published_model_costs_what_its_widths_say():
    # DenseNet-161 BTS at 352x1216: the encoder ~7.7 GMAC at 224^2 x 8.5 and
    # the literal decoder ~108 GMAC, ~0.35 TFLOP in all
    m = {"encoder": "densenet161_bts", "bts_size": 512, "max_depth": 80.0}
    assert 0.30e12 < flops.per_image(m, "serve", 352, 1216) < 0.38e12


def test_lpg_head_bytes_and_flops():
    # a k = 4 head on a 1 x 8 x 16 frame: 1 x 2 x 4 cells, 128 pixels
    cells, pixels = 8, 128
    f, b = lpg.k1(1, 8, 16, 4, raw_bytes=2)
    assert (f, b) == (cells * 40 + pixels * 5, cells * 3 * 2 + pixels * 4) == (960, 560)
    f, b = lpg.k2(1, 8, 16, 4, raw_bytes=2)
    assert (f, b) == (cells * 60 + pixels * 14, 2 * cells * 3 * 2 + pixels * 4) == (2272, 608)


def test_bound_is_the_larger_of_the_two():
    assert lpg.bound_s(1e6, 3.35e6, 67e12, 3.35e12) == 1e-6
    assert lpg.bound_s(67e7, 1.0, 67e12, 3.35e12) == 1e-5


def test_peaks_of_unknown_cards_are_none():
    assert peaks.peak("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert peaks.peak("some other card", "bfloat16") is None
