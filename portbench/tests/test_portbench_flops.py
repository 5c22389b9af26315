"""The benchmark's counts of operations and bytes against hand counts."""

from __future__ import annotations

import json
import os

import pytest

from portbench import flops
from portbench.spec import ROOT, load_family

centernet = load_family("centernet")


def config(name):
    return json.load(open(os.path.join(ROOT, "portbench", "configs", name + ".json")))


def test_conv_ops_by_hand():
    # a 3x3 conv, 2 -> 4 channels, on a 3x3 output grid, 2 images
    assert flops.conv_ops(2, 2, 4, 3, 9) == 2 * 2 * 9 * (2 * 9) * 4


def test_centernet_step_of_a_tiny_network():
    cfg = {"batch_size": 1, "num_cams": 1, "out_hw": [8, 8], "widths": [1, 1, 1, 1],
           "blocks": [1, 1, 1, 1], "deconv_filters": [1], "deconv_kernel": 4, "head_conv": 1,
           "num_classes": 1}
    stem = 2 * 16 * 49 * 3  # 4x4 outputs of a 7x7 conv of 3 channels
    blocks = 2 * (4 * 9 * 2)  # 2x2 after the pool: two 3x3 convs
    blocks += 2 * (1 * (9 * 2 + 1)) * 3  # three 1x1 grids: two 3x3 convs and a shortcut
    deconv = 2 * 1 * 16  # one input pixel, a 4x4 kernel
    heads = 3 * 2 * 4 * 9 + 2 * 4 * (1 + 2 + 2)  # 2x2 outputs: a 3x3 conv per head, 1x1s of 1, 2, 2
    fwd = stem + blocks + deconv + heads
    assert centernet.step_flops(cfg) == 3 * fwd - stem


def test_centernet_step_at_the_cell_size():
    cfg = config("centernet_6cam")
    n = 96  # 16 samples x 6 cameras of 256x704
    macs = 128 * 352 * 3 * 49 * 64  # stem
    macs += 4 * 64 * 176 * 64 * 64 * 9  # stage 1
    for px, cin, cout in ((32 * 88, 64, 128), (16 * 44, 128, 256), (8 * 22, 256, 512)):
        macs += px * (cin * cout * 9 + 3 * cout * cout * 9 + cin * cout)
    macs += 8 * 22 * 512 * 256 * 16 + 16 * 44 * 256 * 256 * 16 + 32 * 88 * 256 * 256 * 16
    macs += 64 * 176 * (3 * 256 * 64 * 9 + 64 * 14)
    fwd = 2 * n * macs
    assert centernet.step_flops(cfg) == pytest.approx(3 * fwd - 2 * n * 128 * 352 * 3 * 49 * 64)
    # about 3.0 TFLOP forward, 8.9 a step
    assert fwd == pytest.approx(2.99e12, rel=0.01)


def test_raster_bound_counts_the_maps_twice_and_the_targets_once():
    cfg = config("centernet_6cam")
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    maps = 96 * 10 * 64 * 176 * 4
    assert flops.raster_bound_s(cfg, peak) == pytest.approx(
        (2 * maps + 96 * 32 * 17) / 3.35e12)
    assert flops.raster_bound_s(cfg, peak) * 1e3 == pytest.approx(0.0258, rel=0.01)


def test_image_chain_bound_reads_the_frames_once_and_writes_the_images_once():
    cfg = config("centernet_6cam")
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    frames = 16 * 372 * 1024 * 3  # one camera field of 16 samples, uint8
    images = 16 * 256 * 704 * 3 * 4  # float32 at 256x704
    assert frames + images == 52_887_552
    assert flops.image_chain_bound_s(cfg, peak) == pytest.approx((frames + images) / 3.35e12)
    # six fields a batch: the kernel table's 317.3 MB, 0.0947 ms
    assert 6 * flops.image_chain_bound_s(cfg, peak) * 1e3 == pytest.approx(0.0947, rel=0.001)
