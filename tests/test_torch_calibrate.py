"""The port's calibration of the cost model's batch-invariant fractions
against the JAX reference's.

The reference counts XLA's ``cost_analysis()["bytes accessed"]`` of each
compiled computation; the port sums the bytes of every ATen op's inputs
and outputs under a ``TorchDispatchMode``.  Where the two programs move
the same tensors — ``matmul``, ``conv``, ``einsum`` and ``ssd``, whose
ATen ops line up with XLA's fusions — the counts agree within 3% at every
batch width.  ``scan`` and ``softmax`` are one ATen op each in the port
(``cumsum``, ``softmax``, input read once and output written once), while
XLA's CPU lowering of ``associative_scan`` and of ``jax.nn.softmax`` moves
~15.5× and ~6.1× the input: their counts differ by construction, and both
are held to what the fit consumes — purely per-request bytes, linear in
the batch.  Every fitted fraction agrees within 0.01.
"""

import json

import pytest
import torch

from repro.launch import calibrate_invariant as j_cal
from repro.core.costmodel import calibrate_invariant_frac as j_fit
from repro_torch.launch import calibrate_invariant as t_cal

CPU = torch.device("cpu")
BATCHES = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def reference_bytes():
    return j_cal.collect(BATCHES)


@pytest.fixture(scope="module")
def port_bytes():
    return t_cal.collect(BATCHES, CPU)


def test_same_classes_as_reference():
    assert list(t_cal.OPS) == list(j_cal.OPS)
    assert (t_cal.D_MODEL, t_cal.D_HEAD, t_cal.N_HEADS, t_cal.SEQ, t_cal.CONV_K,
            t_cal.SSD_CHUNK) == (j_cal.D_MODEL, j_cal.D_HEAD, j_cal.N_HEADS, j_cal.SEQ,
                                 j_cal.CONV_K, j_cal.SSD_CHUNK)


@pytest.mark.parametrize("cls", ["matmul", "conv", "einsum", "ssd"])
def test_bytes_match_reference(cls, reference_bytes, port_bytes):
    for b in BATCHES:
        assert port_bytes[cls][b] == pytest.approx(reference_bytes[cls][b], rel=0.03), b
    if cls in ("matmul", "conv"):   # one op, its operands and result: exact
        assert port_bytes[cls] == reference_bytes[cls]


@pytest.mark.parametrize("cls", ["scan", "softmax"])
def test_single_op_classes_are_per_request(cls, reference_bytes, port_bytes):
    one = port_bytes[cls][1]
    assert one > 0
    for b in BATCHES:
        assert port_bytes[cls][b] == b * one
        assert reference_bytes[cls][b] == pytest.approx(b * reference_bytes[cls][1], rel=1e-3)


def test_fractions_match_reference(reference_bytes, port_bytes):
    want, got = j_fit(reference_bytes), t_cal.calibrate_invariant_frac(port_bytes)
    assert got.keys() == want.keys()
    for cls in want:
        assert got[cls] == pytest.approx(want[cls], abs=0.01), cls
    assert got["matmul"] > 0.99 and got["conv"] == pytest.approx(4 / 9)


def test_byte_counter_counts_each_tensor_once_and_skips_views():
    x = torch.zeros((4, 8))
    with t_cal.ByteCounter() as c:
        y = x.t().reshape(32)          # a transpose (a view) then a copy
        _ = y.view(4, 8)               # a view
    assert c.bytes == 2 * 128 and [name for name, _ in c.ops] == ["aten::clone"]


def test_cli_writes_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "calib.json"
    assert t_cal.main(["--batches", "1,2", "--device", "cpu", "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert set(payload) == {"batches", "bytes_by_batch", "fractions", "shipped_defaults"}
    assert payload["batches"] == [1, 2]
    assert payload["shipped_defaults"]["conv"] == 0.15
    assert "matmul" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        t_cal.main(["--batches", "4", "--device", "cpu"])
