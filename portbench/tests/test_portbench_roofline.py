"""Each work formula against a count made by hand at one shape, and the
readers' arithmetic on a hand-made run."""

import numpy as np

from portbench.tests._tiny import load
from portbench.roofline import flash, grouped_gemm, model, peaks


def test_flash_call_by_hand():
    # two rows: a decode row at depth 10 and a 3-token chunk at depth 4; one idle row
    ops, nbytes = flash.call([1, 3, 0], [10, 4, 7], heads=4, kv_heads=2, head_dim=8)
    keys = (1 * 10 + 1) + (3 * 4 + 1 + 2 + 3)               # keys seen per query, summed
    assert ops == 4 * 4 * 8 * keys
    q_rows = 1 + 3
    kv_rows = (10 + 1) + (4 + 3)
    assert nbytes == 2 * 8 * (2 * q_rows * 4 + 2 * kv_rows * 2)


def test_grouped_gemm_call_by_hand():
    ops, nbytes = grouped_gemm.call([3, 0, 5, 0], k=16, n=8)
    assert ops == 2 * 8 * 16 * 8
    assert nbytes == 2 * (2 * 16 * 8 + 8 * 16 + 8 * 8)


def test_bound_is_the_larger_term():
    p = peaks.of("NVIDIA H100 80GB HBM3")
    assert peaks.bound_s(989e12, 0, p) == 1.0
    assert peaks.bound_s(0, 3.35e12, p) == 1.0
    assert peaks.of("a card not listed") is None


def test_model_flops_by_hand():
    q3 = load("configs", "qwen3-14b")
    d, ff = 5120, 17408
    per_layer = d * 5120 * 2 + d * 1024 * 2 + 3 * d * ff
    assert model.layer_weights_per_token(q3) == per_layer
    # 40 layers × (14.0e9 / 40) weights: the published 14.8B less the embedding and head
    assert abs(40 * per_layer - 13.21e9) < 0.01e9
    f = model.forward_flops(q3, 2, 100)
    assert f == 40 * (2 * per_layer * 2 + 4 * 40 * 128 * (2 * 100 + 3))
    assert model.forward_flops(q3, 0, 100) == 0
    moe = load("configs", "qwen2-moe-a2.7b")
    d = 2048
    per_layer = 4 * d * d + d * 60 + 4 * 3 * d * 1408 + 3 * d * 5632
    assert model.layer_weights_per_token(moe) == per_layer
    # the published "A2.7B": 2.7e9 active with the embedding and head (2 × 311M)
    assert abs(24 * per_layer + 2 * 151936 * d - 2.69e9) < 0.05e9
    assert model.head_flops(moe, 3) == 2 * d * 151936 * 3


def test_readers_on_a_hand_made_run():
    from portbench.harness import bench
    from portbench.harness.driver import Window
    from portbench.harness.trace import DeviceTrace

    cfg = load("configs", "qwen3-14b")
    fw = [(0.0, 0.1, 2, 4, np.array([1, 4]), np.array([10, 0]))]
    tr = DeviceTrace(window_s=1.0, busy_s=0.75,
                     by_name={"flash_fwd_mma_kernel": (0.002, 40), "nvjet": (0.5, 10)})
    run = bench.RunRecord(cfg=cfg, mix={}, window=Window(0.0, 1.0, 1.0), recs=[], setup_s=1.0,
                          steps=[(0.0, 0.12, 0, 1)], forwards=fw, trace=tr, traced_from=0.0,
                          peak=peaks.of("NVIDIA H100 80GB HBM3"))
    assert bench.reader("metrics", "useful_row_share")(run) == 100.0 * 5 / 8
    assert abs(bench.reader("metrics", "step_host_ms")(run) - 20.0) < 1e-9
    assert bench.reader("metrics", "device_idle_share")(run) == 25.0
    ops, nb = flash.call([1, 4], [10, 0], 40, 8, 128)
    want = 100.0 * 40 * peaks.bound_s(ops, nb, run.peak) / 0.002
    assert abs(bench.reader("metrics", "flash_roofline")(run) - want) < 1e-9
    mfu = 100.0 * (model.forward_flops(cfg, 1, 10) + model.forward_flops(cfg, 4, 0)) / 989e12
    assert abs(bench.reader("metrics", "mfu")(run) - mfu) < 1e-12
    # nothing to read: no number, never a 0
    assert bench.reader("metrics", "grouped_gemm_roofline")(run) is None
    assert bench.reader("metrics", "prefix_hit_share")(run) is None
