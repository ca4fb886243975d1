"""The frozen yardstick on hand-computed cases: the kernels' work, least
times, interval arithmetic, the readers' rates, and the reference's FLOP
counts at the cells' sizes (pinned: a change to them changes every later
MFU reading)."""

from __future__ import annotations

import json

import pytest

from portbench import readers, run, work
from portbench.harness import ROOT, Check, Record
from portbench.series import spread

H100 = work.PEAKS["H100"]


def test_peaks_are_the_data_sheet_rates():
    assert H100 == {"bytes_per_s": 3.35e12, "bfloat16": 989e12,
                    "float32": 165e12}
    assert work.peaks_for("NVIDIA H100 80GB HBM3") is H100
    with pytest.raises(KeyError):
        work.peaks_for("cpu")


def test_kernel_work_formulas():
    # q, k, v: 8, 8, 8 elements of 2 bytes; out 8; LSE 2 fp32
    assert work.flash_fwd_work(1, 2, 2, 1, 4, 2) == (72, 64)
    bwd = work.backward_work(1, 2, 3, 1, 4, 2)
    assert bwd["flash_bwd_dq"] == (112, 144)
    assert bwd["flash_bwd_dkv"] == (144, 192)
    assert work.vq_work(2, 3, 4) == (112, 48)


def test_least_seconds_takes_the_longer_bound():
    assert work.least_seconds(H100, 3.35e12, 1.0, "bfloat16") == 1.0
    assert work.least_seconds(H100, 1.0, 989e12, "bfloat16") == 1.0
    assert work.least_seconds(H100, 1.0, 165e12, "float32") == 1.0


def test_union_and_idle():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert work.merge(iv) == [(0, 3), (5, 6), (9, 12)]
    assert work.union_seconds(iv, 0, 10) == 5
    assert work.idle_gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert work.idle_gaps([], 0, 4) == [(0, 4)]


def test_convolution_taps():
    # 3x3 SAME at [2, 64, 32, 32] -> 128: the in-image taps, not 9 a pixel
    assert work.conv_taps_flops((2, 64, 32, 32), (128, 64, 3, 3),
                                (2, 128, 32, 32), [1], [1], [1],
                                False) == 289_538_048


def test_spread_is_the_quartile_distance_over_the_median():
    assert spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(3.0 / 3.0)


def _record(**kw):
    base = dict(host={}, counters={}, attempted=1, failed=0, checks={},
                memory_peak_bytes=0, chips=1)
    return Record(**{**base, **kw})


def test_rates_and_mfu_readers():
    rec = _record(host={"samples": 800, "steps": 100, "window_s": 10.0,
                        "input_wait_s": 0.5, "setup_s": 3.0},
                  work={"step_flops": 989e12 * 0.05})
    assert run.load_reader("train_samples_per_s")(rec) == 80.0
    assert run.load_reader("input_wait_ms.train")(rec) == 5.0
    assert run.load_reader("setup_s")(rec) == 3.0
    assert run.load_reader("mfu.train")(rec) == pytest.approx(50.0)
    rec.chips = 4
    assert run.load_reader("mfu.train")(rec) == pytest.approx(12.5)
    gen = _record(host={"images": 64, "requests": 4, "window_s": 4.0,
                        "steps_per_request": 150},
                  work={"request_flops": 989e12})
    assert run.load_reader("gen_images_per_s")(gen) == 16.0
    assert run.load_reader("mfu.gen")(gen) == pytest.approx(100.0)
    assert run.load_reader("gen_images_per_s")(rec) is None


def test_trace_readers():
    trace = {"device_name": "NVIDIA H100 80GB HBM3", "steps": 2,
             "requests": 1, "busy_s": 0.5, "window_s": 2.0,
             "device": [("void flash_fwd_kernel<bf16>(Params)", 0, 10),
                        ("void flash_fwd_kernel<bf16>(Params)", 20, 30),
                        ("ampere_conv", 100, 400)],
             "ranges": {"portbench.generate": [(0, 50)],
                        "portbench.decode": [(90, 500)]},
             "launches": {"flash_fwd": {(8, 1024, 1, 512, "bfloat16"): 2}}}
    rec = _record(trace=trace, host={"steps_per_request": 10})
    least = 2 * max(work.flash_fwd_work(8, 1024, 1024, 1, 512, 2)[0]
                    / 3.35e12,
                    work.flash_fwd_work(8, 1024, 1024, 1, 512, 2)[1]
                    / 989e12)
    assert run.load_reader("flash_fwd_roofline.train")(rec) == \
        pytest.approx(100 * least / 20e-6)
    assert run.load_reader("vq_roofline.train")(rec) is None
    assert run.load_reader("step_device_ms.train")(rec) == 250.0
    assert run.load_reader("device_idle_pct.train")(rec) == 75.0
    assert run.load_reader("ddim_step_device_ms.gen")(rec) == \
        pytest.approx(1000 * 20e-6 / 10)
    assert run.load_reader("decode_device_ms.gen")(rec) == \
        pytest.approx(1000 * 300e-6)
    # a count the trace does not bear out reads nothing
    trace["launches"]["flash_fwd"] = {(8, 1024, 1, 512, "bfloat16"): 3}
    assert run.load_reader("flash_fwd_roofline.train")(rec) is None


def test_checks_decide_correct():
    rec = _record(checks={"a": Check(0.1, 0.2), "b": Check(0.3, 0.2)})
    assert not rec.correct
    rec.checks["b"] = Check(0.2, 0.2)
    assert rec.correct
    rec.checks["b"] = Check(float("nan"), 0.2)
    assert not rec.correct
    assert not _record(attempted=0).correct
    assert not _record(failed=1).correct


def _config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def test_reference_flops_at_the_cells_sizes():
    from portbench.reference.ldm import request_flops, unet_step_flops
    from portbench.reference.vqgan import vqgan_step_flops

    assert vqgan_step_flops(_config("vqgan-f8-k128-256px"), 8) == \
        16_243_840_237_568
    ldm = _config("ldm-cfg-unet-d96")
    assert unet_step_flops(ldm, 8) == 146_767_675_392
    assert request_flops(ldm, 16) == 20_941_515_702_272
