"""The plain reference against the port at smoke size: logits of a whole
sequence (dense and MoE), the reference's own prefix reuse, and the fp8
control, which must read wider gaps than the program."""

import dataclasses

import pytest
import torch

from portbench.tests._tiny import tiny_cfg
from portbench.harness import program, weights
from portbench.reference import family
from portbench.reference.common import Precision


@pytest.mark.parametrize("name", ["qwen3-14b", "qwen2-moe-a2.7b"])
def test_reference_logits_match_the_port(name):
    from repro_torch.models.model import build_model

    cfg = tiny_cfg(name)
    params = weights.make(cfg, 2**33 + 1, "cpu")
    pcfg = dataclasses.replace(program.port_config(cfg), attention_impl="naive")
    tokens = torch.randint(1, cfg["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(0))
    want, _ = build_model(pcfg).train_forward(params, {"tokens": tokens})
    got, _ = family(cfg["model_type"]).forward(params, cfg, tokens[0], torch.arange(40))
    assert torch.allclose(got, want[0].float(), atol=2e-4, rtol=1e-4), (got - want[0]).abs().max()


@pytest.mark.parametrize("name", ["qwen3-14b", "qwen2-moe-a2.7b"])
def test_prefix_then_suffix_equals_the_whole(name):
    cfg = tiny_cfg(name)
    params = weights.make(cfg, 5, "cpu")
    ref = family(cfg["model_type"])
    toks = torch.randint(1, cfg["vocab_size"], (50,), generator=torch.Generator().manual_seed(1))
    whole, _ = ref.forward(params, cfg, toks, torch.arange(30, 50))
    _, past = ref.forward(params, cfg, toks[:30], torch.zeros(0, dtype=torch.int64))
    part, _ = ref.forward(params, cfg, toks[30:], torch.arange(20), past=past)
    assert torch.allclose(whole, part, atol=1e-5, rtol=1e-5)


def test_fp8_rounds_to_e4m3():
    prec = Precision("fp8")
    w = torch.tensor([[1.0, 448.0], [0.3, -100.0]])
    got = prec.weight(w)
    assert got[0, 1] == 448.0 and got[1, 1] in (-96.0, -104.0)
    assert got[1, 0] != 0.3 and abs(got[1, 0] - 0.3) < 0.3 / 8
    assert torch.equal(Precision("fp32").weight(w), w)
    with pytest.raises(ValueError):
        Precision("int8")
