"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
reference's, on the CPU.

* ``input_specs`` gives the reference's shapes, dtypes and specs for every
  arch × shape on both production meshes (the reference on a
  ``jax.sharding.AbstractMesh``), and ``_accum_steps`` its accumulation
  steps for every arch at ``train_4k``.
* A rank's argument bytes — params, optimizer state, batch, cache — for a
  dense, an MoE (pure DP × EP at this batch), a hybrid and an enc-dec
  ``.smoke()`` config on a (2 × 4) mesh of fake ranks equal the
  reference's ``memory_analysis().argument_size_in_bytes`` of
  ``roofline_fd._lower_cell``, compiled in a subprocess on 8 forced CPU
  devices with Auto axes.  The reference's programs take: ``train_fwdbwd``
  the params and the batch; ``opt`` the params twice (params and
  gradients) and the moments; ``prefill`` the params and the batch;
  ``decode`` the params, the batch, the cache and its int32 position —
  less, for enc-dec, the encoder's weights and the cross-attention's K/V
  projections, which its decode step never reads and ``jax.jit`` drops
  from its arguments.  No shard here is
  uneven, so XLA pads none.
* The per-device count of Trap 1: a ``[256, 4096]`` replicated x times a
  ``[4096, 14336]`` w sharded ``(Replicate, Shard(1))`` on a (16 × 16)
  mesh of 256 fake ranks is the rank's own ``x @ w_local`` (1 879 048 192
  FLOPs), not the global product's (30 064 771 072); redistributing the
  result to replicated is one all-gather of its gathered bytes.
* ``run_cell`` runs llama3.2-1b × ``decode_32k`` on the production mesh
  on CPU fakes, skips ``long_500k`` for a full-attention arch, ``main``
  records a bad shape as an error and returns 1, no process group
  outlives a cell, and a cell refuses to start over a running group.
* Fake and real tensors give the same counts (a 1-rank mesh on the CPU).
"""

import json
import os
from dataclasses import replace

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from _torch_ranks import start_reference
from repro.configs import ARCHS, SHAPES, get_config
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.roofline import ByteCounter, StepCounter

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _j_dryrun():
    """The reference's dry-run module.  Importing it sets a default
    ``XLA_FLAGS`` (a 512-device host platform); the import here leaves the
    environment as it was."""
    before = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = before or ""
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if before is None:
            del os.environ["XLA_FLAGS"]
        else:
            os.environ["XLA_FLAGS"] = before
    return j_dryrun


def _t_shape(shape):
    return ShapeConfig(shape.name, seq_len=shape.seq_len, global_batch=shape.global_batch,
                       kind=shape.kind)


def _entry(e):
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return tuple(e) if isinstance(e, tuple) else e


def _norm(spec):
    return tuple(_entry(e) for e in spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh, tmesh = AbstractMesh(sizes, names), Mesh(sizes, names)
    j_dryrun = _j_dryrun()
    for shape in SHAPES.values():
        want = j_dryrun.input_specs(get_config(arch), shape, jmesh)
        got = dryrun.input_specs(t_get_config(arch), _t_shape(shape), tmesh)
        assert set(got) == set(want), shape.name
        for k, w in want.items():
            g = got[k]
            assert g.shape == tuple(w.shape), (shape.name, k)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (shape.name, k)
            assert _norm(g.spec) == _norm(w.sharding.spec), (shape.name, k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_accum_steps_match_reference(mesh_name):
    sizes, names = MESHES[mesh_name]
    j_dryrun = _j_dryrun()
    shape = SHAPES["train_4k"]
    for arch in ARCHS:
        want = j_dryrun._accum_steps(get_config(arch), shape, AbstractMesh(sizes, names))
        assert dryrun._accum_steps(t_get_config(arch), _t_shape(shape), Mesh(sizes, names)) \
            == want, arch


# ------------------------------------------------------------ argument bytes

FAMILIES = ("llama3.2-1b", "qwen2-moe-a2.7b", "zamba2-2.7b", "seamless-m4t-large-v2")
SHAPES_SMOKE = {"train": (32, 8), "prefill": (32, 8), "decode": (64, 8)}

_REFERENCE_ARGS = """
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.roofline_fd import _lower_cell

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
OUT = {}
for arch, shapes in ARGS:
    cfg = get_config(arch).smoke()
    for kind, shape_kind in (("train_fwdbwd", "train"), ("opt", "train"),
                             ("prefill", "prefill"), ("decode", "decode")):
        s, b = shapes[shape_kind]
        shape = ShapeConfig(shape_kind, seq_len=s, global_batch=b, kind=shape_kind)
        mem = _lower_cell(cfg, shape, mesh, kind).compile().memory_analysis()
        OUT[(arch, kind)] = mem.argument_size_in_bytes
"""


def _port_parts(arch):
    """The port's argument bytes by part for each kind, on a (2 × 4) mesh
    of fake ranks; ``"unread"``: the bytes of the params an enc-dec decode
    step never reads (the encoder's, and the cross-attention's K and V
    projections: the cross K/V come from the cache)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = t_get_config(arch).smoke()
    cpu = torch.device("cpu")
    out = {}
    with dryrun.fake_ranks(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        for kind, (s, b) in SHAPES_SMOKE.items():
            shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
            out[kind] = dryrun.run_step(cfg, shape, mesh, device=cpu).argument_parts
        with FakeTensorMode():
            params = dryrun._params(cfg, mesh, False, cpu, True, 0)
            cross = [{k: layer["cross_attn"][k] for k in ("wk", "wv")}
                     for layer in params.get("decoder", [])]
            out["unread"] = dryrun._storage_bytes(
                [params.get("encoder"), params.get("ln_enc_final"), cross])
    return out


@pytest.fixture(scope="module")
def reference_argument_bytes(tmp_path_factory):
    ref = start_reference(8, _REFERENCE_ARGS, tmp_path_factory.mktemp("args"),
                          [(a, SHAPES_SMOKE) for a in FAMILIES], timeout=300)
    return ref.results()[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_match_reference_memory_analysis(reference_argument_bytes, arch):
    parts = _port_parts(arch)
    train, prefill, decode = parts["train"], parts["prefill"], parts["decode"]
    got = {
        "train_fwdbwd": train["params"] + train["batch"],
        "opt": 2 * train["params"] + train["opt"],
        "prefill": prefill["params"] + prefill["batch"],
        # jax.jit drops the arguments its program never reads
        # (keep_unused=False): an enc-dec decode step's encoder weights and
        # cross K/V projections
        "decode": decode["params"] - parts["unread"] + decode["batch"] + decode["cache"],
    }
    want = {k: reference_argument_bytes[(arch, k)] for k in got}
    assert got == want


# ------------------------------------------------------------ per device


def _trap1(counter_cls):
    """Trap 1's product on 256 fake CPU ranks under ``counter_cls``, and
    the result made whole again."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_ranks(256):
        dm = make_mesh((16, 16), ("data", "model"), "cpu").device_mesh
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(256, 4096), dm, [Replicate(), Replicate()],
                                   run_check=False)
            w = DTensor.from_local(torch.empty(4096, 14336 // 16), dm, [Replicate(), Shard(1)],
                                   run_check=False)
            assert tuple(w.shape) == (4096, 14336)
            with counter_cls() as c:
                y = x @ w
                y.redistribute(dm, [Replicate(), Replicate()])
    return c


def test_flops_are_the_ranks_own_work():
    c = _trap1(StepCounter)
    assert c.flops == 2 * 256 * 4096 * (14336 // 16) == 1_879_048_192
    assert c.flops != 2 * 256 * 4096 * 14336
    # the redistribution: one all-gather of the whole [256, 14336] fp32 result
    assert c.collectives == {"total": 256 * 14336 * 4.0,
                             "by_kind": {"all-gather": 256 * 14336 * 4.0},
                             "counts": {"all-gather": 1}}


def test_bytes_are_the_ranks_own_traffic():
    c = _trap1(ByteCounter)
    mm = [n for name, n in c.ops if name == "aten::mm"]
    # x, the local w and the local result, fp32
    assert mm == [4 * (256 * 4096 + 4096 * 896 + 256 * 896)]


# ------------------------------------------------------------ cells


def test_run_cell_llama_decode_on_production_mesh():
    r = dryrun.run_cell("llama3.2-1b", "decode_32k", device="cpu", verbose=False)
    assert r["status"] == "ok" and r["n_devices"] == 256
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "collectives", "params", "active_params", "quant8_opt", "memory", "elapsed_s",
                "fit_estimate_gb", "fits_80gb", "t_compute_s", "t_memory_s", "t_collective_s",
                "dominant", "model_flops", "useful_flops_ratio", "step_time_lb_s"):
        assert key in r, key
    assert set(r["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                "temp_size_in_bytes"}
    # a rank holds 1/16 of the 128 rows and 1/16 of the 32k-token cache
    # (8 KV heads do not divide over the 16 model ranks: the sequence is cut)
    cache = 2 * 16 * (128 // 16) * (32768 // 16) * 8 * 64 * 2
    assert r["memory"]["argument_size_in_bytes"] > cache
    assert r["memory"]["output_size_in_bytes"] >= cache
    assert r["fits_80gb"] and r["dominant"] == "memory"
    assert not dist.is_initialized()


def test_long_context_is_skipped_for_full_attention():
    r = dryrun.run_cell("llama3.2-1b", "long_500k", device="cpu", verbose=False)
    assert r["status"] == "skipped" and "quadratic" in r["reason"]


def test_main_records_a_bad_shape_and_fails(tmp_path):
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape", "nope", "--device", "cpu",
                      "--out", str(tmp_path)])
    assert rc == 1
    (fp,) = tmp_path.glob("*.json")
    res = json.loads(fp.read_text())
    assert res["status"] == "error" and "nope" in res["error"]
    assert not dist.is_initialized()


def test_cell_refuses_a_running_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            dryrun.run_cell("llama3.2-1b", "decode_32k", device="cpu", verbose=False)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("kind,seq,batch", [("decode", 128, 4), ("prefill", 64, 2),
                                            ("train", 32, 4)])
def test_fake_and_real_tensors_count_the_same(arch, kind, seq, batch):
    cfg = replace(t_get_config(arch).smoke(), dtype="bfloat16")
    shape = ShapeConfig(kind, seq_len=seq, global_batch=batch, kind=kind)
    runs = [dryrun.run_cell(arch, kind, device="cpu", fake=fake, mesh_shape=(1, 1), cfg=cfg,
                            shape=shape, verbose=False) for fake in (True, False)]
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "memory"):
        assert runs[0][key] == runs[1][key], key
    assert runs[0]["flops_per_device"] > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-moe-a2.7b", "zamba2-2.7b"])
def test_repeated_micro_batches_count_as_every_one_run(arch):
    """The counted train step runs two micro-batches and counts the second
    ``accum - 2`` more times: FLOPs, bytes, collectives and the peak equal
    the count of a step that runs all four."""
    cfg = t_get_config(arch).smoke()
    shape = ShapeConfig("train", seq_len=32, global_batch=16, kind="train")
    runs = []
    with dryrun.fake_ranks(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        for every in (False, True):
            c = dryrun.run_step(cfg, shape, mesh, device=torch.device("cpu"), accum=4,
                                every_micro=every).counter
            runs.append((c.flops, c.bytes, c.collectives, c.peak_bytes))
    assert runs[0] == runs[1]
    assert runs[0][0] > 0 and runs[0][2]["total"] > 0


def test_production_cells_take_the_plain_paths():
    """Every config default, as the reference's cells: no cell's config
    asks for a kernel."""
    from repro_torch.models.layers import uses_kernels

    assert not any(uses_kernels(t_get_config(a)) for a in ARCHS)


def test_remat_recomputes_under_the_forward_context():
    """A CUDA tensor's backward runs on autograd's device thread, which the
    (thread-local) parallel context does not reach: the recomputation of a
    rematted block must still run under the forward's context (here the
    backward is started on another thread, as the device thread would)."""
    import threading

    from repro_torch.models.transformer import remat
    from repro_torch.parallel.context import (ParallelContext, current_context,
                                              parallel_context)

    seen = []

    def block(x):
        seen.append(current_context())
        return x * x                           # saves x: the backward recomputes

    ctx = ParallelContext(Mesh((2, 2), ("data", "model")), tp_axis="model")
    x = torch.ones(3, requires_grad=True)
    with parallel_context(ctx):
        y = remat(block, True)(x).sum()
    worker = threading.Thread(target=y.backward)
    worker.start()
    worker.join()
    assert seen == [ctx, ctx]                  # the forward, then the recomputation
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_a_redistributed_shard_owns_its_storage():
    """The update keeps each new param and moment: one that is a slice of a
    gathered buffer would keep the whole buffer alive (torch 2.11's
    shard-to-shard redistribution returns such slices; the dry-run found
    arctic's update holding most of its peak in them)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.train.optimizer import _compact

    with dryrun.fake_ranks(4):
        dm = make_mesh((2, 2), ("data", "model"), "cpu").device_mesh
        whole = torch.arange(64.0).reshape(8, 8)
        view = whole[:, :4]                       # a slice of a larger storage
        x = DTensor.from_local(view, dm, [Replicate(), Shard(1)], run_check=False,
                               shape=torch.Size((8, 8)), stride=(8, 1))
        y = _compact(x)
        local = y.to_local()
        assert local.untyped_storage().nbytes() == local.numel() * local.element_size()
        assert torch.equal(local, view) and y.placements == x.placements
        assert y.shape == x.shape and y.stride() == (8, 1)
        owned = DTensor.from_local(whole.clone(), dm, [Replicate(), Replicate()],
                                   run_check=False)
        assert _compact(owned) is owned
