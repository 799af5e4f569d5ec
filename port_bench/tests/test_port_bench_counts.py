"""The yardstick's work counters against hand counts at tiny shapes."""
import pytest

from port_bench.lib import counts, peaks

TINY = {"image_size": 32, "width": 2, "batch_size_list": [1, 2], "in_channels": 3, "num_classes": 2,
        "domain_idxs": [0, 1], "rec": True}


def test_conv_flops_is_two_macs_an_output_tap():
    assert counts.conv_flops(rows=2, cin=3, cout=4, k=3, side=5) == 2 * 2 * 3 * 4 * 9 * 25


def test_step_flops_against_a_hand_count():
    # n=2 widths 2, 4, 8, 16, 32 at sides 32, 16, 8, 4, 2; B = 3, seg path 6 rows, rec path 3
    f = counts.conv_flops
    enc = (f(6, 3, 2, 3, 32) + 2 * f(6, 2, 2, 3, 32) + f(6, 2, 4, 3, 16) + 2 * f(6, 4, 4, 3, 16)
           + f(6, 4, 8, 3, 8) + 2 * f(6, 8, 8, 3, 8) + f(6, 8, 16, 3, 4) + 2 * f(6, 16, 16, 3, 4)
           + f(6, 16, 32, 3, 2) + 2 * f(6, 32, 32, 3, 2))
    seg = (f(6, 32, 16, 1, 4) + f(6, 32, 32, 3, 4)
           + f(6, 32, 16, 3, 4) + f(6, 16, 8, 1, 8) + f(6, 16, 16, 3, 8)
           + f(6, 16, 8, 3, 8) + f(6, 8, 4, 1, 16) + f(6, 8, 8, 3, 16)
           + f(6, 8, 4, 3, 16) + f(6, 4, 2, 1, 32) + f(6, 4, 4, 3, 32)
           + f(6, 4, 2, 3, 32))
    rec = (f(3, 32, 16, 3, 2) + f(3, 16, 16, 1, 4) + f(3, 16, 16, 3, 4)
           + f(3, 16, 8, 3, 4) + f(3, 8, 8, 1, 8) + f(3, 8, 8, 3, 8)
           + f(3, 8, 4, 3, 8) + f(3, 4, 4, 1, 16) + f(3, 4, 4, 3, 16)
           + f(3, 4, 2, 3, 16) + f(3, 2, 2, 1, 32) + f(3, 2, 2, 3, 32)
           + f(3, 2, 3, 3, 32))
    first = f(6, 3, 2, 3, 32)  # no input gradient for the image
    assert counts.step_flops(TINY) == pytest.approx(3 * (enc + seg + rec) - first, rel=1e-12)


def test_the_reference_configuration_matches_the_analytic_baseline():
    # benchmarks/torch_baseline.json counts 1.120281821184 TFLOP a fundus step,
    # three times the forward including the first convolution's input gradient
    fundus = {"image_size": 256, "width": 16, "batch_size_list": [3, 6, 7], "in_channels": 3, "num_classes": 2,
              "domain_idxs": [1, 2, 3], "rec": True}
    first = counts.conv_flops(32, 3, 16, 3, 256)
    assert counts.step_flops(fundus) + first == pytest.approx(1.120281821184e12, rel=1e-9)


def test_norm_bytes_five_float32_passes_of_every_normalised_activation():
    one = {"image_size": 32, "width": 2, "batch_size_list": [1], "in_channels": 3, "num_classes": 2,
           "domain_idxs": [0], "rec": False}
    elems = 2 * (3 * 2 * 32 * 32 + 3 * 4 * 16 * 16 + 3 * 8 * 8 * 8 + 3 * 16 * 4 * 4 + 3 * 32 * 2 * 2
                 + 16 * 4 * 4 + 32 * 4 * 4 + 16 * 4 * 4 + 8 * 8 * 8 + 16 * 8 * 8 + 8 * 8 * 8 + 4 * 16 * 16
                 + 8 * 16 * 16 + 4 * 16 * 16 + 2 * 32 * 32 + 4 * 32 * 32)
    assert counts.norm_bytes(one) == 5 * 4 * elems


def test_upsample_bytes_read_once_and_written_once_both_ways():
    one = {"image_size": 32, "width": 2, "batch_size_list": [1], "in_channels": 3, "num_classes": 2,
           "domain_idxs": [0], "rec": False}
    inputs = [2 * 32 * 2 * 2, 2 * 16 * 4 * 4, 2 * 8 * 8 * 8, 2 * 4 * 16 * 16]
    assert counts.upsample_bytes(one) == sum(2 * 4 * 5 * e for e in inputs)


def test_k1_bytes_of_the_delta_mode():
    # b = 3 at 32^2: a (7 x 4) band of each of 3 x 3 planes, 20 bytes an element, 4 a ratio
    cfg = dict(TINY)
    assert counts.ram_mix_bytes(cfg) == 20 * 3 * 3 * 7 * 4 + 4 * 3


def test_peaks_know_the_h100_and_nothing_else():
    assert peaks.peaks("NVIDIA H100 80GB HBM3")["tf32_flops"] == 495e12
    assert peaks.peaks("cpu") is None
