"""The benchmark's ViT-L files on the CPU: the reference embedder found by
its name at the configuration's widths, the counts of its work, and the
three readers that the ``vit_l.crowd`` cell adds (the embedder's launch,
the attention's and the LayerNorm's rooflines) on synthetic traces and
spans.  This file imports no JAX."""

import copy
import importlib.util
import json
import os
from types import SimpleNamespace

import pytest
import torch

from facerecognition_infrenceengine_tpu_torch.core.metrics import Span
from facerecognition_infrenceengine_tpu_torch.models import vit
from portbench import count, data, spec, trace
from portbench.count import vit as count_vit

ROOT = spec.ROOT
MS = 1_000_000  # ns
FACE_OPS = 50_675_589_120
ATTENTION_OPS = 2 * 2 * 144 ** 2 * 96 * 8 * 24
ATTENTION_BYTES = 884_736 * 24
LAYERNORM_BYTES = 49 * 2 * 144 * 768 * 2
FLASH = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<96, 128, 64, 4, false, "
         "false, cutlass::bfloat16_t, Flash_kernel_traits<96, 128, 64, 4, cutlass::bfl")
LAYER_NORM = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<c10::BFloat16, "
              "float, false>(int, float, c10::BFloat16 const*, c10::BFloat16 const*, c10::B")


def _config(name: str = "vit_l") -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _reader(name: str):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    module_spec = importlib.util.spec_from_file_location(f"test_vit_reader_{name}", path)
    mod = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(mod)
    return mod


def test_the_files_widths_build_the_ports_module():
    rec = _config()["recognizer"]
    with torch.device("meta"):
        model = spec.embedder("vit_l").build(rec)
    assert (model.tokens, len(model.blocks), model.blocks[0].attn.heads) == (144, 24, 8)
    assert data.layout(lambda: model) == data.layout(vit.vit_l)


@pytest.mark.parametrize("key,value", [("tokens", 145), ("act", "gelu"), ("qkv_bias", True),
                                       ("ln_eps", 1e-5), ("bn_eps", 1e-5), ("heads", 7)])
def test_a_width_the_module_fixes_is_refused(key, value):
    rec = dict(_config()["recognizer"], **{key: value})
    with torch.device("meta"), pytest.raises(ValueError):
        spec.embedder("vit_l").build(rec)


def test_frame_flops_of_vit_l():
    """The embedder on each of a frame's 32 slots; the detector and heads
    as in ``buffalo_l``."""
    got, buffalo = count.frame_flops(_config()), count.frame_flops(_config("buffalo_l"))
    assert got["embedder"] == 32 * FACE_OPS
    assert (got["detector"], got["heads"]) == (buffalo["detector"], buffalo["heads"])
    share = got["embedder"] / sum(got.values())
    assert 0.979 < share < 0.98


def test_the_work_counted_from_the_reference_shapes():
    rec = _config()["recognizer"]
    assert count_vit.attention_work(rec, 112, "bfloat16") == (ATTENTION_OPS, ATTENTION_BYTES)
    assert count_vit.layernorm_bytes(rec, 112, "bfloat16") == LAYERNORM_BYTES
    assert count_vit.layernorm_bytes(rec, 112, "float32") == 2 * LAYERNORM_BYTES
    r50 = _config("buffalo_l")["recognizer"]
    assert count_vit.attention_work(r50, 112, "bfloat16") == (0.0, 0.0)
    assert count_vit.layernorm_bytes(r50, 112, "bfloat16") == 0.0


def _s(id_, name, a_ms, b_ms, parent=None, **attrs):
    return Span(id_, name, 100, int(a_ms * MS), int(b_ms * MS), int((b_ms - a_ms) * MS), parent,
                attrs)


def _program(embedder=True) -> SimpleNamespace:
    """Batch 1 wholly inside the traced interval (0.5-20 ms); batch 0's
    dispatch began before it (so its span was not recorded) and embedded
    inside it; batch 2 embedded after the stop."""
    spans = [
        _s(1, "microbatch.dispatch", 1.0, 11.0, batch=1, frames=32),
        _s(2, "engine.fused", 3.0, 9.0, 1),
        _s(3, "engine.embedder", 4.0, 8.0, 2, arch="vit_l", crops=1024),
        _s(4, "engine.embedder", 0.6, 0.9, None, arch="vit_l", crops=512),
        _s(5, "microbatch.dispatch", 12.0, 30.0, batch=2, frames=32),
        _s(6, "engine.fused", 21.0, 29.0, 5),
        _s(7, "engine.embedder", 22.0, 28.0, 6, arch="vit_l", crops=1024),
    ]
    if not embedder:
        spans = [s for s in spans if s.name != "engine.embedder"]
    clock = {"host_ns": 0, "trace_us": 1000.0, "us_per_ns": 1e-3, "start_ns": MS // 2,
             "stop_ns": 20 * MS, "error_ns": 1000.0}
    return SimpleNamespace(spans=spans, clock=clock, idents={}, timers={})


def _run(kernels: dict, embedder=True, config="vit_l") -> SimpleNamespace:
    ops = [(1500.0 + i, 1500.0 + i + us, name, 100) for i, (name, us) in enumerate(kernels.items())]
    tr = trace.Trace(1500.0, 21000.0, [(a, b) for a, b, *_ in ops], dict(kernels), ops)
    return SimpleNamespace(trace=tr, program=_program(embedder), config=_config(config))


def test_the_traced_crops_are_the_embedder_spans_inside_the_interval():
    assert count_vit.traced_crops(_run({})) == 1024 + 512
    assert count_vit.traced_crops(_run({}, embedder=False)) == 0


@pytest.mark.parametrize("name,kernel,bound_s", [
    ("kernel.attention.roofline_pct", FLASH, 1536 * ATTENTION_BYTES / count.HBM_BYTES_PER_S),
    ("kernel.layernorm.roofline_pct", LAYER_NORM, 1536 * LAYERNORM_BYTES / count.HBM_BYTES_PER_S)])
def test_a_roofline_reader_on_a_synthetic_trace(name, kernel, bound_s):
    """The bytes bound both (the attention's operations take a quarter of
    its bytes' time) over the crops embedded in the interval, against the
    kernel's device time; cuBLAS's and the other kernels' time is not
    read."""
    reader = _reader(name)
    kernels = {kernel: 20_000.0, "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN": 50_000.0}
    assert reader.read(_run(kernels)) == pytest.approx(100.0 * bound_s / 20e-3)
    assert 1536 * ATTENTION_OPS / count.PEAK_FLOPS["bfloat16"] < bound_s
    assert reader.read(_run({"nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN": 5e4})) is None
    assert reader.read(_run(kernels, embedder=False)) is None
    assert reader.read(_run(kernels, config="buffalo_l")) is None
    assert reader.read(SimpleNamespace(trace=None, program=_program(),
                                       config=_config())) is None


def test_the_embedder_launch_reader():
    """The self time of the traced batches' ``engine.embedder`` spans, a
    batch; nothing from a port that records none."""
    reader = _reader("embedder.launch_ms")
    program = _program()
    child = _s(8, "inner", 5.0, 6.5, 3)
    assert reader.read(SimpleNamespace(program=program)) == pytest.approx(4.0)
    program.spans.append(child)
    assert reader.read(SimpleNamespace(program=program)) == pytest.approx(2.5)
    assert reader.read(SimpleNamespace(program=_program(embedder=False))) is None
    empty = copy.copy(program)
    empty.spans = []
    assert reader.read(SimpleNamespace(program=empty)) is None
